"""Dispatch around the LUT/int8/T-MAC kernels + the quantized matmuls every
model projection calls (port of ``repro.kernels.lutmul.ops``).

Backends:
  * ``"cuda"`` — the hand-written kernels (``kernel.py``); a tensor on the
    CPU takes each kernel's plain version inside the wrapper
  * ``"ref"``  — the plain PyTorch versions (``ref.py``), unfused epilogue
Default: ``"cuda"`` when a GPU is present, else ``"ref"``; override with
:func:`set_backend` or ``REPRO_TORCH_KERNEL_BACKEND``.

On ``cuda`` the dequant epilogue is fused into the kernel (``pick_variant``
default); :func:`set_variant` forces either variant, which is how the
unfused entry points are driven end to end.  With autotuning on
(:func:`set_autotune`, or ``REPRO_TORCH_LUTMUL_AUTOTUNE=1``),
``pick_formulation`` times tmac against one-hot per (bits, shape) on the
card, and ``pick_variant`` times the callables it is given.  The
activation quantizer stays plain PyTorch outside the kernels, as the
reference leaves it to XLA: IEEE division by tensors (never by a Python
scalar, which CUDA PyTorch turns into a reciprocal multiply) and
round-half-to-even, like ``jnp.round``.
"""
from __future__ import annotations

import os
import re
import time
from typing import Optional

import torch

from repro_torch.core.lut import (pack_bitplanes, pack_int4,
                                  plane_decomposition, planes_from_codes,
                                  truncate_plane_spec, unpack_int4,
                                  validate_weight_bits, weight_bits)
from repro_torch.dist import tp as tp_lib
from repro_torch.kernels.lutmul import kernel, ref

_BACKENDS = ("ref", "cuda")
_BACKEND: Optional[str] = None
_VARIANT: Optional[str] = None
_AUTOTUNE: Optional[bool] = None

# bumped on every weight quantization event (cached layers must quantize
# once at load, never per forward call)
WEIGHT_QUANT_COUNT = 0


def set_backend(name: Optional[str]) -> None:
    if name is not None and name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}: expected one of "
                         f"{_BACKENDS}")
    global _BACKEND
    _BACKEND = name


def get_backend() -> str:
    if _BACKEND is not None:
        return _BACKEND
    env = os.environ.get("REPRO_TORCH_KERNEL_BACKEND")
    if env:
        if env not in _BACKENDS:
            raise ValueError(f"REPRO_TORCH_KERNEL_BACKEND={env!r}: expected "
                             f"one of {_BACKENDS}")
        return env
    return "cuda" if torch.cuda.is_available() else "ref"


def set_autotune(enabled: Optional[bool]) -> None:
    """Turn the timed pickers on or off (None: the environment decides)."""
    global _AUTOTUNE
    _AUTOTUNE = enabled


def autotune_enabled() -> bool:
    if _AUTOTUNE is not None:
        return _AUTOTUNE
    return os.environ.get("REPRO_TORCH_LUTMUL_AUTOTUNE", "0") == "1"


def _event_ms(fn) -> float:
    """Milliseconds of one ``fn()`` on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# ---------------------------------------------------------------------------
# quant-mode grammar
# ---------------------------------------------------------------------------

_TMAC_MODE = re.compile(r"^(?:w(\d+)|(ternary))_?a(\d+)(_tmac)?$")


def parse_mode(mode: str) -> tuple[str, object, int]:
    """Parse a quant-mode string -> (formulation, wbits_spec, abits).

    "w4a4_mxu"/""/"none" -> ("int", 4, 4); "w8a8" -> ("int", 8, 8);
    "w4a4_lut" -> ("onehot", 4, 4); "w{1,2,3,4}a{4,8}_tmac" and
    "ternary_a{4,8}_tmac" -> ("tmac", spec, abits); suffix-free sub-4-bit
    modes -> ("auto", spec, abits).  The grammar is the reference's in full.
    """
    if mode in ("", "none", "w4a4_mxu"):
        return ("int", 4, 4)
    if mode == "w8a8":
        return ("int", 8, 8)
    if mode == "w4a4_lut":
        return ("onehot", 4, 4)
    m = _TMAC_MODE.match(mode)
    if m:
        spec = "ternary" if m.group(2) else int(m.group(1))
        validate_weight_bits(spec)
        abits = int(m.group(3))
        if abits not in (4, 8):
            raise ValueError(
                f"unsupported activation bit width a{abits} in {mode!r}: "
                "the quantizers support a4 and a8")
        return ("tmac" if m.group(4) else "auto", spec, abits)
    raise ValueError(
        f"unknown quant mode {mode!r}: expected one of w4a4_mxu | w4a4_lut | "
        "w8a8 | w{{1,2,3,4}}a{{4,8}}[_tmac] | ternary_a{{4,8}}[_tmac]")


def tmac_group_size(abits: int) -> int:
    """Activation-group width g: a4 uses g=2 (partial-sum tables whose
    entries are int8 pair sums); a8 uses g=1 (the table degenerates to the
    activation itself)."""
    return 1 if abits >= 8 else 2


def _check_lut_shapes(a_codes: torch.Tensor, w_packed: torch.Tensor) -> None:
    K = a_codes.shape[1]
    if K % 2:
        raise ValueError(
            f"lutmul requires even K for nibble-packed weights, got K={K}; "
            "pad the contraction dim to a multiple of 2 (models do this by "
            "construction)")
    if w_packed.dim() != 2:
        raise ValueError(
            f"w_packed must be 2D [K//2, N], got shape "
            f"{tuple(w_packed.shape)}; 3D [P, K//8, N] bitplane leaves "
            "belong to the tmac formulation")
    if w_packed.shape[0] * 2 != K:
        raise ValueError(
            f"w_packed rows ({w_packed.shape[0]}) must be K//2 = {K // 2} "
            f"for activation K={K}: the weight was packed for "
            f"K={w_packed.shape[0] * 2} (mismatched quantize/packing?)")


def _check_tmac_shapes(a_q: torch.Tensor, w_planes: torch.Tensor,
                       wbits) -> None:
    validate_weight_bits(wbits)
    n_planes = plane_decomposition(wbits)[0]
    K = a_q.shape[1]
    if w_planes.dim() != 3:
        raise ValueError(
            f"tmac weights must be 3D [P, K//8, N] packed bitplanes, got "
            f"shape {tuple(w_planes.shape)} (2D leaves belong to the "
            "one-hot/int formulations)")
    if w_planes.shape[0] != n_planes:
        raise ValueError(
            f"tmac weight has {w_planes.shape[0]} bitplanes but wbits="
            f"{wbits!r} decomposes into {n_planes} planes (was the leaf "
            "quantized at a different width?)")
    if K % 8:
        raise ValueError(
            f"tmac requires K % 8 == 0 for byte-packed bitplanes, got K={K}")
    if w_planes.shape[1] * 8 != K:
        raise ValueError(
            f"tmac w_planes rows ({w_planes.shape[1]}) must be K//8 = "
            f"{K // 8} for activation K={K}: the weight was packed for "
            f"K={w_planes.shape[1] * 8}")


def truncate_planes(w_planes: torch.Tensor, wbits, keep: int
                    ) -> tuple[torch.Tensor, int, int]:
    """Top-``keep`` plane suffix of a packed w{wbits} stack (plane axis -3):
    ``(draft_planes, draft_wbits, scale_mult)``.  A view of the target's
    bytes, no copy; ``scale_mult = 2^(wbits-keep)`` folds into the scale."""
    kept, mult = truncate_plane_spec(wbits, keep)
    n_planes = plane_decomposition(wbits)[0]
    if w_planes.dim() < 3 or w_planes.shape[-3] != n_planes:
        raise ValueError(
            f"cannot truncate: leaf has plane axis {tuple(w_planes.shape)} "
            f"but wbits={wbits!r} decomposes into {n_planes} planes")
    return w_planes[..., n_planes - kept:, :, :], kept, mult


# ---------------------------------------------------------------------------
# raw integer matmuls (int32 out, no scales)
# ---------------------------------------------------------------------------

def lutmul(a_codes: torch.Tensor, w_packed: torch.Tensor, *,
           a_signed: bool = True, backend: Optional[str] = None,
           impl: str = "onehot",
           table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LUT matmul on 4-bit codes. a_codes [M, K] u8; w_packed [K//2, N] u8.

    ``impl``: "onehot" (``csrc/lutmul.cu``, the kernel that serves) or
    "gather" (``csrc/lutmul_gather.cu``, the A/B baseline); both compute
    the same int32 sums.  ``table`` (int32 [16, 16], row = weight code,
    gather only) replaces the product table of ``a_signed``."""
    if impl not in ("onehot", "gather"):
        raise ValueError(f"unknown lutmul impl {impl!r}: expected 'onehot' "
                         "or 'gather'")
    if table is not None and impl != "gather":
        raise ValueError("table= is taken by impl='gather' only: the onehot "
                         "kernel selects from the product table's words")
    _check_lut_shapes(a_codes, w_packed)
    be = backend or get_backend()
    if be == "ref":
        if table is not None:
            return ref.lutmul_gather_ref(a_codes, w_packed, table)
        return ref.lutmul_ref(a_codes, w_packed, a_signed)
    if impl == "onehot":
        return kernel.lutmul(a_codes.contiguous(), w_packed.contiguous(),
                             a_signed=a_signed)
    return kernel.lutmul_gather(a_codes.contiguous(), w_packed.contiguous(),
                                a_signed=a_signed, table=table)


def lutmul_gather(a_codes: torch.Tensor, w_packed: torch.Tensor, *,
                  a_signed: bool = True,
                  backend: Optional[str] = None) -> torch.Tensor:
    """The retained gather kernel (A/B baseline for the benches)."""
    return lutmul(a_codes, w_packed, a_signed=a_signed, backend=backend,
                  impl="gather")


def int_matmul(a: torch.Tensor, w: torch.Tensor,
               backend: Optional[str] = None) -> torch.Tensor:
    """int8 x int8 -> int32."""
    be = backend or get_backend()
    if be == "ref":
        return ref.int_matmul_ref(a, w)
    return kernel.int_matmul(a.contiguous(), w.contiguous())


def lutmul_tmac(a_q: torch.Tensor, w_planes: torch.Tensor, wbits, *,
                g: Optional[int] = None, abits: int = 4,
                backend: Optional[str] = None) -> torch.Tensor:
    """T-MAC matmul: a_q [M, K] int8 codes x w_planes [P, K//8, N] packed
    bitplanes of spec ``wbits`` -> int32 [M, N]."""
    _check_tmac_shapes(a_q, w_planes, wbits)
    g = tmac_group_size(abits) if g is None else g
    if g == 2 and abits > 4:
        raise ValueError(
            f"tmac g=2 tables hold int8 pair sums of a4 codes; a{abits} "
            "activations take g=1")
    be = backend or get_backend()
    if be == "ref":
        return ref.tmac_ref(a_q, w_planes, wbits)
    return kernel.lutmul_tmac(a_q.contiguous(), w_planes.contiguous(), wbits,
                              g=g)


def _fused_lut(a_codes, w_packed, a_scale, w_scale, *, a_signed: bool,
               out_dtype) -> torch.Tensor:
    _check_lut_shapes(a_codes, w_packed)
    return kernel.lutmul_fused(
        a_codes.contiguous(), w_packed.contiguous(),
        a_scale.to(torch.float32).contiguous(),
        w_scale.to(torch.float32).contiguous(), a_signed=a_signed,
        out_dtype=out_dtype)


def _fused_int(a_q, w_int, a_scale, w_scale, *, out_dtype) -> torch.Tensor:
    return kernel.int_matmul_fused(
        a_q.contiguous(), w_int.contiguous(),
        a_scale.to(torch.float32).contiguous(),
        w_scale.to(torch.float32).contiguous(), out_dtype=out_dtype)


def _fused_tmac(a_q, w_planes, a_scale, w_scale, *, wbits, g: int,
                out_dtype) -> torch.Tensor:
    _check_tmac_shapes(a_q, w_planes, wbits)
    return kernel.lutmul_tmac_fused(
        a_q.contiguous(), w_planes.contiguous(), wbits,
        a_scale.to(torch.float32).contiguous(),
        w_scale.to(torch.float32).contiguous(), g=g, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# epilogue-variant selection (fused vs unfused dequant)
# ---------------------------------------------------------------------------

def set_variant(name: Optional[str]) -> None:
    """Force "fused" | "unfused" on every kernel call (None: the backend's
    default, see :func:`pick_variant`)."""
    if name not in (None, "fused", "unfused"):
        raise ValueError(f"unknown variant {name!r}: expected 'fused', "
                         "'unfused' or None")
    global _VARIANT
    _VARIANT = name


_VARIANT_CACHE: dict[tuple, str] = {}
_TIMED_VARIANTS: dict[tuple, str] = {}    # timed choices off the default


def _default_variant(backend: str) -> str:
    return "fused" if backend == "cuda" else "unfused"


def pick_variant(op: str, M: int, K: int, N: int, backend: str,
                 bench_fns=None) -> str:
    """"fused" | "unfused" for one call of ``op`` at [M, K] x [K, N]:
    :func:`set_variant`'s, else the cached choice of the shape, else the
    backend's default ("fused" on ``cuda``: the kernel writes the compute
    dtype directly; "unfused" on ``ref``).  With autotuning on and
    ``bench_fns`` ({"fused": fn, "unfused": fn}, nullary callables) the
    first call of a shape runs each twice, then takes the median of 5 timed
    calls (host clock, the card synchronized around each) and caches the
    winner; without ``bench_fns`` it returns the default uncached, as the
    reference's."""
    if _VARIANT is not None:
        return _VARIANT
    key = (op, M, K, N, backend)
    hit = _VARIANT_CACHE.get(key)
    if hit is not None:
        return hit
    default = _default_variant(backend)
    if not autotune_enabled():
        _VARIANT_CACHE[key] = default
        return default
    if not bench_fns:
        return default
    sync = torch.cuda.synchronize if backend == "cuda" else (lambda: None)
    best, best_t = default, float("inf")
    for name, run in bench_fns.items():
        run()
        run()
        reps = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            reps.append(time.perf_counter() - t0)
        dt = sorted(reps)[len(reps) // 2]
        if dt < best_t:
            best, best_t = name, dt
    _VARIANT_CACHE[key] = best
    if best != default:
        _TIMED_VARIANTS[key] = best
    return best


def variant_key(backend: str):
    """What decides the variant of every call of a round (a graph key
    element): the forced variant, else the backend's default with the
    timed choices that differ from it."""
    if _VARIANT is not None:
        return _VARIANT
    default = _default_variant(backend)
    if not _TIMED_VARIANTS:
        return default
    return (default,) + tuple(sorted(_TIMED_VARIANTS.items()))


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def _divide(x: torch.Tensor, q: int) -> torch.Tensor:
    """``x / q`` as an IEEE division on every device."""
    return x / torch.full((), float(q), dtype=x.dtype, device=x.device)


def _quantize_with_scale(x2: torch.Tensor, a_scale: torch.Tensor,
                         qmax: int) -> torch.Tensor:
    """Symmetric round/clip to int8 codes under a precomputed scale."""
    return torch.clamp(torch.round(x2 / a_scale), -qmax - 1,
                       qmax).to(torch.int8)


def quantize_activations(x2: torch.Tensor, bits: int):
    """Per-token symmetric quant: [M, K] f32 -> (int8 codes, [M, 1] scale)."""
    if bits not in (4, 8):
        raise ValueError(
            f"unsupported activation bit width {bits!r}: activations "
            "quantize to a4 or a8 (sub-4-bit widths apply to *weights* — "
            "see quantize_weights_planes)")
    qmax = 2 ** (bits - 1) - 1
    amax = torch.amax(torch.abs(x2), dim=1, keepdim=True)
    a_scale = _divide(torch.clamp_min(amax, 1e-8), qmax)
    return _quantize_with_scale(x2, a_scale, qmax), a_scale


def quantize_weights(wf: torch.Tensor, bits: int, pack: bool = False):
    """Per-output-channel symmetric quant: [..., K, N] f32 -> (codes,
    [..., 1, N] scale); ``pack`` nibble-packs 4-bit codes along K.  Every
    weight quantization of the port (serving leaves included) is a call of
    this function, so it alone bumps ``WEIGHT_QUANT_COUNT``."""
    if bits not in (4, 8):
        raise ValueError(
            f"unsupported weight bit width {bits!r} for the nibble/int8 "
            "format: use 4 or 8, or quantize_weights_planes for the tmac "
            "bitplane family (1, 2, 3, 4, 'ternary')")
    if pack and bits != 4:
        raise ValueError("nibble packing (pack=True) is a 4-bit format; "
                         f"got bits={bits}")
    global WEIGHT_QUANT_COUNT
    WEIGHT_QUANT_COUNT += 1
    qmax = 2 ** (bits - 1) - 1
    w_scale = _divide(torch.amax(torch.abs(wf), dim=-2, keepdim=True), qmax)
    w_scale = torch.clamp_min(w_scale, 1e-8)
    w_q = torch.clamp(torch.round(wf / w_scale), -qmax - 1,
                      qmax).to(torch.int8)
    if pack:
        if wf.shape[-2] % 2:
            raise ValueError(
                f"nibble packing needs even K, got K={wf.shape[-2]}")
        w_q = pack_int4(w_q.transpose(-1, -2)).transpose(-1, -2) \
            .contiguous()
    return w_q, w_scale


def quantize_weights_planes(wf: torch.Tensor, wbits):
    """Per-output-channel quant to the tmac bitplane format: [..., K, N] f32
    -> ([..., P, K//8, N] uint8 packed bitplanes, [..., 1, N] f32 scale).

    Integer widths use :func:`quantize_weights`' absmax/round/clip formula
    (so w4 planes decode to exactly the w4 nibble codes); ternary and w1
    follow BitNet-b1.58: per-channel mean-|w| scale, codes in {-1, 0, +1}
    (ternary) / sign in {-1, +1} (w1).  Counted by ``WEIGHT_QUANT_COUNT``.
    """
    validate_weight_bits(wbits)
    if wf.shape[-2] % 8:
        raise ValueError(
            f"tmac bitplane packing needs K % 8 == 0, got K={wf.shape[-2]}; "
            "pad the contraction dim before quantizing")
    global WEIGHT_QUANT_COUNT
    WEIGHT_QUANT_COUNT += 1
    wf = wf.to(torch.float32)
    if wbits in ("ternary", 1):
        # the mean over K is taken in float64 and rounded once, so every
        # device gets the same scale (a float32 mean's value depends on its
        # summation order: XLA's and ATen's differ by a few ulp)
        w_scale = torch.clamp_min(
            torch.mean(torch.abs(wf), dim=-2, keepdim=True,
                       dtype=torch.float64).to(torch.float32), 1e-8)
        if wbits == "ternary":
            codes = torch.clamp(torch.round(wf / w_scale), -1, 1)
        else:
            codes = torch.where(wf >= 0, 1, -1)
    else:
        qmax = 2 ** (int(wbits) - 1) - 1
        w_scale = torch.clamp_min(
            _divide(torch.amax(torch.abs(wf), dim=-2, keepdim=True), qmax),
            1e-8)
        codes = torch.clamp(torch.round(wf / w_scale), -qmax - 1, qmax)
    planes = planes_from_codes(codes.to(torch.int32), wbits)
    return pack_bitplanes(planes), w_scale


# ---------------------------------------------------------------------------
# formulation selection: tmac vs one-hot per (bits, shape)
# ---------------------------------------------------------------------------

_FORMULATION_CACHE: dict[tuple, str] = {}
FORMULATION_TIMES: dict[tuple, dict] = {}   # the timed keys' ms, by kernel
PROBE_M = 256          # the rows the timed formulation choice runs at


def pick_formulation(wbits, abits: int, K: int, N: int,
                     backend: Optional[str] = None) -> str:
    """"tmac" | "onehot" for a [K, N] leaf, cached per (wbits, abits, K, N,
    backend).  The default is the reference's: tmac for every a8 mode (the
    one-hot product table is 4-bit x 4-bit) and below 4 weight bits (its
    work is linear in the plane count), one-hot at w4a4.  With autotuning
    on, on ``cuda``, the first call of a key times both kernels (unfused,
    CUDA events, one warm-up then the median of 3) at ``PROBE_M`` rows on
    seeded synthetic codes, caches the faster and keeps both times in
    ``FORMULATION_TIMES``; sub-4-bit codes are valid 4-bit codes, so
    one-hot runs them as decoded nibbles."""
    validate_weight_bits(wbits)
    be = backend or get_backend()
    key = (wbits, abits, K, N, be)
    hit = _FORMULATION_CACHE.get(key)
    if hit is not None:
        return hit
    if abits >= 8:
        _FORMULATION_CACHE[key] = "tmac"
        return "tmac"
    default = "tmac" if weight_bits(wbits) < 4 else "onehot"
    if be == "ref" or not autotune_enabled():
        _FORMULATION_CACHE[key] = default
        return default
    times = FORMULATION_TIMES[key] = time_formulations(wbits, K, N)
    best = min(times, key=times.get)
    _FORMULATION_CACHE[key] = best
    return best


def time_formulations(wbits, K: int, N: int, M: int = PROBE_M) -> dict:
    """{"tmac": ms, "onehot": ms} of the two kernels on the card for an a4
    [M, K] x [K, N] product of ``wbits`` codes (numpy seed 0): the tmac
    kernel on the packed planes, the one-hot LUT kernel on the decoded
    codes as nibbles."""
    import numpy as np
    from repro_torch.core.lut import decode_planes, unpack_bitplanes
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    a_q = torch.from_numpy(rng.integers(-8, 8, size=(M, K)).astype(
        np.int8)).to(dev)
    n_planes = plane_decomposition(wbits)[0]
    planes = torch.from_numpy(rng.integers(0, 256, size=(
        n_planes, K // 8, N)).astype(np.uint8)).to(dev)
    codes = decode_planes(unpack_bitplanes(planes), wbits).to(torch.int8)
    nib = pack_int4(codes.T).T.contiguous()
    a_nib = a_q.to(torch.uint8) & 0xF
    runs = {"tmac": lambda: lutmul_tmac(a_q, planes, wbits, abits=4,
                                        backend="cuda"),
            "onehot": lambda: lutmul(a_nib, nib, a_signed=True,
                                     backend="cuda")}
    times = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        times[name] = sorted(_event_ms(fn) for _ in range(3))[1]
    return times


# ---------------------------------------------------------------------------
# pre-quantized (serving) matmul: weights are integer codes on the device
# ---------------------------------------------------------------------------

def _unpack_w(w_q: torch.Tensor) -> torch.Tensor:
    """Packed-int4 uint8 [..., K//2, N] -> int8 [..., K, N]."""
    return unpack_int4(w_q.transpose(-1, -2), signed=True) \
        .transpose(-1, -2).contiguous()


def lut_leaf(mode: str) -> bool:
    """Whether a nibble leaf served under ``mode`` takes the LUT kernel:
    under ``w4a4_lut``, and under a suffix-free mode ("w2a4"), whose nibble
    leaf is :func:`pick_formulation`'s one-hot choice (the reference runs
    the int8 kernel on the unpacked nibbles there: the same integer sums,
    the same epilogue).  Elsewhere the int8 kernel takes the nibbles."""
    m = _TMAC_MODE.match(mode)
    return mode == "w4a4_lut" or (m is not None and not m.group(4))


def _dispatch(a_q, a_scale, w_q, ws_row, mode: str, be: str, lead,
              compute_dtype) -> torch.Tensor:
    """Fused or unfused kernel call on quantized activations."""
    M, K = a_q.shape
    N = w_q.shape[-1]
    packed = w_q.dtype == torch.uint8
    lut = packed and lut_leaf(mode)
    if pick_variant("lutmul" if lut else "int_matmul", M, K, N,
                    be) == "fused":
        if lut:
            y = _fused_lut(a_q.to(torch.uint8) & 0xF, w_q, a_scale, ws_row,
                           a_signed=True, out_dtype=compute_dtype)
        else:
            y = _fused_int(a_q, _unpack_w(w_q) if packed else w_q, a_scale,
                           ws_row, out_dtype=compute_dtype)
        return y.reshape(*lead, N)
    if lut:
        acc = lutmul(a_q.to(torch.uint8) & 0xF, w_q, a_signed=True,
                     backend=be)
    else:
        acc = int_matmul(a_q, _unpack_w(w_q) if packed else w_q, backend=be)
    return ref.dequant_epilogue(acc, a_scale, ws_row,
                                compute_dtype).reshape(*lead, N)


def _dispatch_tmac(a_q, a_scale, w_planes, ws_row, wspec, abits: int,
                   be: str, lead, compute_dtype) -> torch.Tensor:
    """Fused or unfused tmac kernel call on quantized activations."""
    M, K = a_q.shape
    N = w_planes.shape[-1]
    if pick_variant(f"lutmul_tmac{tmac_group_size(abits)}", M, K, N,
                    be) == "fused":
        y = _fused_tmac(a_q, w_planes, a_scale, ws_row, wbits=wspec,
                        g=tmac_group_size(abits), out_dtype=compute_dtype)
        return y.reshape(*lead, N)
    acc = lutmul_tmac(a_q, w_planes, wspec, abits=abits, backend=be)
    return ref.dequant_epilogue(acc, a_scale, ws_row,
                                compute_dtype).reshape(*lead, N)


def _row_parallel_prequant(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor, mode: str, compute_dtype,
                           be: str, axis) -> torch.Tensor:
    """Row-parallel (K-split) pre-quantized matmul, as the reference's
    ``_row_parallel_prequant``.

    ``w_q`` is this rank's K slice of the codes.  ``x`` is either the full
    replicated activation or, when attention runs head-sharded, already
    this rank's K slice (the head-local attention output feeding ``wo``),
    told apart by its K extent.  Either way the activation scale is the
    full-K per-token scale, the unsharded one: taken on the replicated
    input, or recovered from the local slice as the max of the per-rank
    maxima (max is exact).  Each rank contracts its slice into int32
    through the UNFUSED kernel, the int32 sums are all-reduced (exact), and
    the epilogue ``(acc.f32 * a_scale) * w_scale`` runs once on the full
    sums: a fused epilogue would rescale partial sums and break exactness.
    """
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w_q.shape[-1]
    tmac = w_q.dim() == 3
    packed = w_q.dtype == torch.uint8 and not tmac
    if tmac:
        _, wspec, bits = parse_mode(mode)
        Kl = 8 * w_q.shape[-2]
    else:
        bits = 4 if packed else 8
        Kl = 2 * w_q.shape[-2] if packed else w_q.shape[-2]
    qmax = 2 ** (bits - 1) - 1
    x2 = x.reshape(-1, K).to(torch.float32)
    if K == Kl * axis.size:
        # replicated input: quantize over the full K, contract the local
        # slice
        a_q, a_scale = quantize_activations(x2, bits)
        a_l = a_q[:, axis.index * Kl:(axis.index + 1) * Kl].contiguous()
    elif K == Kl:
        # head-sharded input: x IS the local K slice
        local_max = torch.amax(torch.abs(x2), dim=1, keepdim=True)
        a_scale = _divide(torch.clamp_min(
            tp_lib.all_reduce_max(local_max, axis), 1e-8), qmax)
        a_l = _quantize_with_scale(x2, a_scale, qmax)
    else:
        raise ValueError(
            f"row-parallel activation K ({K}) matches neither the full "
            f"extent ({Kl * axis.size}) nor this rank's slice ({Kl})")
    if tmac:
        acc = lutmul_tmac(a_l, w_q, wspec, abits=bits, backend=be)
    elif packed and lut_leaf(mode):
        acc = lutmul(a_l.to(torch.uint8) & 0xF, w_q, a_signed=True,
                     backend=be)
    else:
        acc = int_matmul(a_l, _unpack_w(w_q) if packed else w_q,
                         backend=be)
    acc = tp_lib.all_reduce_sum(acc, axis)
    return ref.dequant_epilogue(acc, a_scale, w_scale.reshape(1, N),
                                compute_dtype).reshape(*lead, N)


def prequant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor, mode: str = "",
                    compute_dtype=torch.bfloat16,
                    backend: Optional[str] = None,
                    tp: Optional[str] = None) -> torch.Tensor:
    """x [..., K] float; w_q packed-int4 uint8 [K//2, N], int8 [K, N] or
    packed bitplanes uint8 [P, K//8, N].

    The weights live on the device as integer codes; the int8 ``[K, N]``
    leaf (the w8a8 head) takes the int8 kernel, the packed leaf the LUT
    kernel where :func:`lut_leaf` says (the int8 kernel on unpacked nibbles
    otherwise), the bitplane leaf the T-MAC kernel with the weight spec and
    activation bits of ``mode`` (``models.layers.linear`` derives it from
    the leaf).

    ``tp`` ("col" | "head" | "row" | None) is the tensor-parallel layout of
    ``w_q`` inside an active ``dist.tp.tp_context`` (the sharded engine):
    column-parallel computes the local N columns with the unsharded math
    and all-gathers them; head-parallel is column-parallel without the
    gather (the caller keeps working on local heads); row-parallel
    contracts a K slice and all-reduces the exact int32 sums
    (:func:`_row_parallel_prequant`).  Outside the context ``tp`` is
    ignored.
    """
    axis = tp_lib.model_axis() if tp else None
    be = backend or get_backend()
    if axis is not None and tp == "row":
        return _row_parallel_prequant(x, w_q, w_scale, mode, compute_dtype,
                                      be, axis)
    y = _prequant_local(x, w_q, w_scale, mode, compute_dtype, be)
    if axis is not None and tp == "col":     # column-parallel: N is local
        y = tp_lib.all_gather(y, axis, dim=-1)
    return y                                 # "head": stays head-local


def _prequant_local(x, w_q, w_scale, mode: str, compute_dtype,
                    be: str) -> torch.Tensor:
    """The unsharded prequant matmul on this device's codes."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w_q.shape[-1]
    x2 = x.reshape(-1, K).to(torch.float32)
    if w_q.dim() == 3:                       # bitplane leaf -> tmac kernel
        _, wspec, bits = parse_mode(mode)
        _check_tmac_shapes(x2, w_q, wspec)
        a_q, a_scale = quantize_activations(x2, bits)
        return _dispatch_tmac(a_q, a_scale, w_q, w_scale.reshape(1, N),
                              wspec, bits, be, lead, compute_dtype)
    packed = w_q.dtype == torch.uint8
    if packed:
        _check_lut_shapes(x2, w_q)
    a_q, a_scale = quantize_activations(x2, 4 if packed else 8)
    return _dispatch(a_q, a_scale, w_q, w_scale.reshape(1, N), mode, be,
                     lead, compute_dtype)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     mode: str = "w4a4_mxu", compute_dtype=torch.bfloat16,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Dynamic-quant matmul on a float weight ``w [K, N]``: re-quantizes
    the weight on every call (serving quantizes once, see serve.quantize)."""
    form, wspec, abits = parse_mode(mode)
    if form in ("tmac", "auto") and weight_bits(wspec) < 4:
        form = "tmac"          # sub-4-bit auto: tmac is the only exact fit
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K).to(torch.float32)
    be = backend or get_backend()
    if form == "tmac":
        w_planes, w_scale = quantize_weights_planes(w.to(torch.float32),
                                                    wspec)
        a_q, a_scale = quantize_activations(x2, abits)
        return _dispatch_tmac(a_q, a_scale, w_planes, w_scale, wspec, abits,
                              be, lead, compute_dtype)
    bits = 4 if mode.startswith("w4") else 8
    a_q, a_scale = quantize_activations(x2, bits)
    w_q, w_scale = quantize_weights(w.to(torch.float32), bits,
                                    pack=(mode == "w4a4_lut"))
    return _dispatch(a_q, a_scale, w_q, w_scale, mode, be, lead,
                     compute_dtype)
