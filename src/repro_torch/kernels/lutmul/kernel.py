"""Wrappers of the CUDA LUT, int8 and T-MAC kernels (``csrc/lutmul.cu``,
``csrc/lutmul_gather.cu``, ``csrc/int_matmul.cu``, ``csrc/lutmul_tmac.cu``).

Seven entry points, each with a plain launch counter in ``LAUNCHES``:

* ``lutmul`` / ``lutmul_fused`` replace ``lutmul_pallas(impl="onehot")``
  and ``lutmul_fused_pallas`` (``repro/kernels/lutmul/kernel.py:178`` and
  ``:380``): ``acc[m,n] = sum_k T[w[k,n], a[m,k]]`` as the TPU kernel's
  two-stage contraction, on the int8 tensor cores: each weight code selects
  its word of the 16 in :func:`product_words` (``T[w, 2^b]``, b = 0..3, as
  int8 bytes), contracted with the activation codes' 0/1 bitplanes
  (``ref.lutmul_bitplane_ref`` is the plain form); int32 out or the fused
  ``(acc.f32 * a_scale) * w_scale`` epilogue.
* ``lutmul_gather`` replaces ``lutmul_pallas(impl="gather")``: the same
  int32 sums, one read of the table in shared memory per product (the A/B
  baseline), from the product table or any [16, 16] int32 ``table``
  (``ref.gather_layout`` is its conflict-free staging, the sums wrap as
  int32 adds do).
* ``int_matmul`` / ``int_matmul_fused`` replace ``int_matmul_pallas`` and
  ``int_matmul_fused_pallas`` (``:332`` and ``:483``): int8 x int8 -> int32
  on the int8 tensor cores, one block over up to 32 rows (each weight byte
  read once at decode and verify), with the same optional epilogue and the
  LUT kernel's one-launch K split.
* ``lutmul_tmac`` / ``lutmul_tmac_fused`` replace ``lutmul_tmac_pallas``
  and ``lutmul_tmac_fused_pallas`` (``:289`` and ``:430``): int8 activation
  codes against packed weight bitplanes ``[P, K//8, N]``,
  ``sum_b coeff_b * (a . plane_b) + const * sum_k a``: each block decodes
  the planes into the int8 weight codes in registers (``ref.tmac_words``
  is that decode on the CPU) and contracts them once on the int8 tensor
  cores, one block over up to 32 rows (each plane byte read once at decode
  and verify).  ``g`` (2 for a4, 1 for a8: the reference's table width) is
  validated and leaves the sums unchanged.

Bound on the H100 at decode (M = 8): the weight bytes over 3.35 TB/s (the
545 MB qwen2-7b int8 head: 0.16 ms; a LUT projection's K*N/2 bytes); at the
CNN stages the LUT kernel's M*N*4 output bytes (the source notes in
``csrc/`` say what each design does about its bound).

``lutmul_experts`` and ``int_matmul_experts`` launch the LUT and int8
kernels once per expert of a MoE bank (``models.moe.expert_matmul``): a
stack of E operands, expert e's addresses offsets into the stacks, so the
checks and the output allocation run once for the E launches; each launch
counts under its entry point's name.

A tensor on the CPU takes the plain version from ``ref.py``; a CUDA tensor
launches the kernel on the current stream or raises — there is no fallback.
The wrappers check device, dtype, shape and contiguity, allocate the output
with ``torch.empty`` and raise when the launch reports a CUDA error.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.core.lut import (contraction_table, contraction_words,
                                  plane_decomposition)
from repro_torch.kernels import build
from repro_torch.kernels.lutmul import ref

LAUNCHES = {"lutmul": 0, "lutmul_fused": 0, "lutmul_gather": 0,
            "int_matmul": 0, "int_matmul_fused": 0, "lutmul_tmac": 0,
            "lutmul_tmac_fused": 0}

_EPILOGUE = {torch.int32: 0, torch.bfloat16: 1, torch.float32: 2}
_TABLES: dict[tuple, torch.Tensor] = {}
_WORKSPACES: dict[tuple, torch.Tensor] = {}
_ENTRIES: dict[str, object] = {}
_GRAPH_WORKSPACES: dict | None = None   # see graph_workspaces


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _table(make, a_signed: bool, device) -> torch.Tensor:
    """``make(a_signed=...)`` as an int32 tensor on ``device``, cached."""
    key = (make.__name__, a_signed, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.as_tensor(make(a_signed=a_signed), dtype=torch.int32,
                            device=device).contiguous()
        _TABLES[key] = t
    return t


def product_table(a_signed: bool, device) -> torch.Tensor:
    """[16, 16] int32 product table on ``device`` (cached): what
    ``csrc/lutmul_gather.cu`` looks up."""
    return _table(contraction_table, a_signed, device)


def product_words(a_signed: bool, device) -> torch.Tensor:
    """int32 [16] selection words of the bitplane contraction on ``device``
    (cached): what ``csrc/lutmul.cu`` takes in place of the table."""
    return _table(contraction_words, a_signed, device)


def _entry(lib_name: str, fn_name: str, argtypes: list,
           restype=ctypes.c_int):
    fn = _ENTRIES.get(fn_name)
    if fn is None:
        fn = getattr(build.load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
        _ENTRIES[fn_name] = fn
    return fn


def _launch_args(n_ptr: int) -> list:
    """ctypes signature of a launch entry: pointers, M K N epilogue, stream."""
    return [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _workspace_words(lib: str, M: int, N: int) -> int:
    return _entry(lib, f"{lib}_workspace_words",
                  [ctypes.c_int, ctypes.c_int], ctypes.c_longlong)(M, N)


def _workspace(lib: str, M: int, N: int, device, stream: int) -> torch.Tensor:
    """A K-split kernel's int32 scratch (split sums + per-tile arrival
    counters), one per (kernel, device, stream).  Allocated zeroed and
    grown, never cleared: every launch leaves it zero again.  Inside
    :func:`graph_workspaces` a launch takes the graph's workspace instead,
    which never moves (captured graphs hold its address): one too small
    raises, as does a launch under capture outside it."""
    words = _workspace_words(lib, M, N)
    if _GRAPH_WORKSPACES is not None:
        ws = _GRAPH_WORKSPACES.get(lib)
        if ws is None or ws.numel() < words or ws.device != device:
            have = 0 if ws is None else ws.numel()
            raise RuntimeError(
                f"{lib} at M={M}, N={N} needs a {words}-word workspace on "
                f"{device}; the graphs' workspace holds {have}: "
                "reserve_workspaces must cover every shape they capture")
        return ws
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{lib}: a launch under graph capture takes its "
                           "workspace from graph_workspaces")
    key = (lib, device, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < words:
        ws = torch.zeros((words,), dtype=torch.int32, device=device)
        _WORKSPACES[key] = ws
    return ws


def reserve_workspaces(shapes, device) -> dict:
    """Zeroed workspaces of the three K-split kernels at the largest of
    ``shapes`` ((M, N) pairs), for :func:`graph_workspaces`."""
    return {lib: torch.zeros(
        (max(_workspace_words(lib, M, N) for M, N in shapes),),
        dtype=torch.int32, device=device)
        for lib in ("lutmul", "int_matmul", "lutmul_tmac")}


@contextlib.contextmanager
def graph_workspaces(workspaces: dict):
    """Launches inside take their K-split workspaces from ``workspaces``
    (:func:`reserve_workspaces`) and never allocate one: graphs captured
    inside record these addresses.  Graphs may share them, since replays
    run in order on one stream and every launch leaves them zero."""
    global _GRAPH_WORKSPACES
    prev, _GRAPH_WORKSPACES = _GRAPH_WORKSPACES, workspaces
    try:
        yield
    finally:
        _GRAPH_WORKSPACES = prev


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} is on {device}: the kernels run on cuda "
                         "(CPU tensors take the plain version)")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_scales(a_scale, w_scale, M: int, N: int, device) -> None:
    _check("a_scale", a_scale, torch.float32, 2, device)
    _check("w_scale", w_scale, torch.float32, 2, device)
    if tuple(a_scale.shape) != (M, 1) or tuple(w_scale.shape) != (1, N):
        raise ValueError(
            f"scales must be a_scale [M, 1] = [{M}, 1] and w_scale [1, N] = "
            f"[1, {N}], got {tuple(a_scale.shape)} and "
            f"{tuple(w_scale.shape)}")


def _out_dtype(dtype) -> int:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused epilogue writes bfloat16 or float32, got "
                        f"{dtype}")
    return _EPILOGUE[dtype]


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{code}")


def _lut_shapes(a_codes, w_packed) -> tuple[int, int, int]:
    """(M, K, N) of a_codes [.., M, K] and w_packed [.., K//2, N]."""
    M, K = a_codes.shape[-2:]
    if K % 2 or w_packed.shape[-2] * 2 != K:
        raise ValueError(
            f"w_packed [K//2, N] = {tuple(w_packed.shape)} does not match "
            f"activation K = {K} (K must be even)")
    return M, K, w_packed.shape[-1]


def _launch(name: str, lib: str, operands: list, M: int, K: int, N: int,
            epi: int) -> None:
    """``lib``'s launch entry on ``operands`` (tensors or None), the
    workspace after them, once for each expert of a stacked call: where
    the first operand is [E, M, K], launch e takes every 3D operand's
    e-th slice (its pointer plus e times its leading stride) and every
    other operand whole.  A 2D call is one launch.  Each launch counts."""
    dev = operands[0].device
    E = operands[0].shape[0] if operands[0].dim() == 3 else 1
    if E == 0 or M == 0 or N == 0:
        return
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = _workspace(lib, M, N, dev, stream).data_ptr()
    fn = _entry(lib, f"{lib}_launch", _launch_args(len(operands) + 1))
    bases = [None if t is None else t.data_ptr() for t in operands]
    steps = [t.stride(0) * t.element_size() if t is not None and t.dim() == 3
             else 0 for t in operands]
    for e in range(E):
        ptrs = [None if b is None else b + e * st
                for b, st in zip(bases, steps)]
        _raise_on(fn(*ptrs, work, M, K, N, epi, stream), name)
        LAUNCHES[name] += 1


def _lut_launch(a_codes, w_packed, a_scale, w_scale, out, epi: int,
                a_signed: bool, name: str) -> None:
    M, K, N = _lut_shapes(a_codes, w_packed)
    _launch(name, "lutmul",
            [a_codes, w_packed, product_words(a_signed, a_codes.device),
             a_scale, w_scale, out], M, K, N, epi)


def _int_launch(a, w, a_scale, w_scale, out, epi: int, name: str) -> None:
    M, K = a.shape[-2:]
    if w.shape[-2] != K:
        raise ValueError(f"w [K, N] = {tuple(w.shape)} does not match "
                         f"activation K = {K}")
    _launch(name, "int_matmul", [a, w, a_scale, w_scale, out], M, K,
            w.shape[-1], epi)


def _tmac_shapes(a_q, w_planes) -> tuple[int, int, int, int]:
    M, K = a_q.shape
    P, rows, N = w_planes.shape
    if K % 8 or rows * 8 != K:
        raise ValueError(
            f"w_planes [P, K//8, N] = {tuple(w_planes.shape)} does not match "
            f"activation K = {K} (K must be a multiple of 8)")
    return M, K, N, P


def _tmac_launch(a_q, w_planes, wbits, g: int, a_scale, w_scale, out,
                 epi: int, name: str) -> None:
    M, K, N, P = _tmac_shapes(a_q, w_planes)
    n_planes, coeffs, const = plane_decomposition(wbits)
    if P != n_planes:
        raise ValueError(f"w_planes has {P} planes, wbits={wbits!r} has "
                         f"{n_planes}")
    if g not in (1, 2):
        raise ValueError(f"tmac group size g must be 1 or 2, got {g}")
    if M == 0 or N == 0:
        return
    stream = torch.cuda.current_stream(a_q.device).cuda_stream
    work = _workspace("lutmul_tmac", M, N, a_q.device, stream)
    fn = _entry("lutmul_tmac", "lutmul_tmac_launch",
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                + [ctypes.c_void_p])
    co = list(coeffs) + [0] * (4 - len(coeffs))
    code = fn(a_q.data_ptr(), w_planes.data_ptr(),
              a_scale.data_ptr() if a_scale is not None else None,
              w_scale.data_ptr() if w_scale is not None else None,
              out.data_ptr(), work.data_ptr(), M, K, N, P, g, *co, const,
              epi, stream)
    _raise_on(code, name)
    LAUNCHES[name] += 1


def lutmul_tmac(a_q: torch.Tensor, w_planes: torch.Tensor, wbits, *,
                g: int = 2) -> torch.Tensor:
    """a_q [M, K] int8 signed codes, w_planes [P, K//8, N] uint8 packed
    bitplanes of spec ``wbits`` -> int32 [M, N].  ``g`` (1 or 2) is the
    reference's table width: the kernel checks it, the sums do not depend
    on it (``ops.lutmul_tmac`` keeps the reference's a4-only rule for
    g = 2)."""
    if a_q.device.type == "cpu":
        return ref.tmac_ref(a_q, w_planes, wbits)
    dev = a_q.device
    _check("a_q", a_q, torch.int8, 2, dev)
    _check("w_planes", w_planes, torch.uint8, 3, dev)
    M, _, N, _ = _tmac_shapes(a_q, w_planes)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    _tmac_launch(a_q, w_planes, wbits, g, None, None, out, 0, "lutmul_tmac")
    return out


def lutmul_tmac_fused(a_q: torch.Tensor, w_planes: torch.Tensor, wbits,
                      a_scale: torch.Tensor, w_scale: torch.Tensor, *,
                      g: int = 2, out_dtype=torch.bfloat16) -> torch.Tensor:
    """T-MAC multiply + dequant: a_scale [M, 1], w_scale [1, N] float32 ->
    [M, N] ``out_dtype``."""
    if a_q.device.type == "cpu":
        return ref.scaled_tmac_ref(a_q, w_planes, wbits, a_scale, w_scale,
                                   out_dtype)
    dev = a_q.device
    _check("a_q", a_q, torch.int8, 2, dev)
    _check("w_planes", w_planes, torch.uint8, 3, dev)
    M, _, N, _ = _tmac_shapes(a_q, w_planes)
    _check_scales(a_scale, w_scale, M, N, dev)
    epi = _out_dtype(out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    _tmac_launch(a_q, w_planes, wbits, g, a_scale, w_scale, out, epi,
                 "lutmul_tmac_fused")
    return out


def lutmul(a_codes: torch.Tensor, w_packed: torch.Tensor, *,
           a_signed: bool = True) -> torch.Tensor:
    """a_codes [M, K] uint8 4-bit codes, w_packed [K//2, N] uint8 ->
    int32 [M, N]."""
    if a_codes.device.type == "cpu":
        return ref.lutmul_ref(a_codes, w_packed, a_signed)
    dev = a_codes.device
    _check("a_codes", a_codes, torch.uint8, 2, dev)
    _check("w_packed", w_packed, torch.uint8, 2, dev)
    M, _, N = _lut_shapes(a_codes, w_packed)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    _lut_launch(a_codes, w_packed, None, None, out, 0, a_signed, "lutmul")
    return out


def lutmul_gather(a_codes: torch.Tensor, w_packed: torch.Tensor, *,
                  a_signed: bool = True,
                  table: torch.Tensor | None = None) -> torch.Tensor:
    """The gather baseline: int32 [M, N] ``sum_k table[w[k, n], a[m, k]]``
    (wrapping as int32 adds do), one table read per product.  ``table``
    (int32 [16, 16], row = weight code) defaults to the product table of
    ``a_signed``, whose sums are :func:`lutmul`'s."""
    if a_codes.device.type == "cpu":
        if table is None:
            return ref.lutmul_ref(a_codes, w_packed, a_signed)
        return ref.lutmul_gather_ref(a_codes, w_packed, table)
    dev = a_codes.device
    _check("a_codes", a_codes, torch.uint8, 2, dev)
    _check("w_packed", w_packed, torch.uint8, 2, dev)
    if table is None:
        table = product_table(a_signed, dev)
    _check("table", table, torch.int32, 2, dev)
    if tuple(table.shape) != (16, 16):
        raise ValueError(f"table must be [16, 16], got {tuple(table.shape)}")
    M, K, N = _lut_shapes(a_codes, w_packed)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M == 0 or N == 0:
        return out
    fn = _entry("lutmul_gather", "lutmul_gather_launch",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
    code = fn(a_codes.data_ptr(), w_packed.data_ptr(), table.data_ptr(),
              out.data_ptr(), M, K, N,
              torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "lutmul_gather")
    LAUNCHES["lutmul_gather"] += 1
    return out


def lutmul_fused(a_codes: torch.Tensor, w_packed: torch.Tensor,
                 a_scale: torch.Tensor, w_scale: torch.Tensor, *,
                 a_signed: bool = True,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """LUT multiply + dequant: a_scale [M, 1], w_scale [1, N] float32 ->
    [M, N] ``out_dtype``."""
    if a_codes.device.type == "cpu":
        return ref.scaled_lutmul_ref(a_codes, w_packed, a_scale, w_scale,
                                     a_signed, out_dtype)
    dev = a_codes.device
    _check("a_codes", a_codes, torch.uint8, 2, dev)
    _check("w_packed", w_packed, torch.uint8, 2, dev)
    M, _, N = _lut_shapes(a_codes, w_packed)
    _check_scales(a_scale, w_scale, M, N, dev)
    epi = _out_dtype(out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    _lut_launch(a_codes, w_packed, a_scale, w_scale, out, epi, a_signed,
                "lutmul_fused")
    return out


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N]."""
    if a.device.type == "cpu":
        return ref.int_matmul_ref(a, w)
    dev = a.device
    _check("a", a, torch.int8, 2, dev)
    _check("w", w, torch.int8, 2, dev)
    out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.int32,
                      device=dev)
    _int_launch(a, w, None, None, out, 0, "int_matmul")
    return out


def int_matmul_fused(a: torch.Tensor, w: torch.Tensor,
                     a_scale: torch.Tensor, w_scale: torch.Tensor, *,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 matmul + dequant -> [M, N] ``out_dtype``."""
    if a.device.type == "cpu":
        return ref.scaled_int_matmul_ref(a, w, a_scale, w_scale, out_dtype)
    dev = a.device
    _check("a", a, torch.int8, 2, dev)
    _check("w", w, torch.int8, 2, dev)
    M, N = a.shape[0], w.shape[1]
    _check_scales(a_scale, w_scale, M, N, dev)
    epi = _out_dtype(out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    _int_launch(a, w, a_scale, w_scale, out, epi, "int_matmul_fused")
    return out


# ---------------------------------------------------------------------------
# one launch per expert of a MoE bank
# ---------------------------------------------------------------------------

def _expert_stacks(a, w, a_scale, w_scale, kind: str, w_rows: int):
    """Checks of an expert launch's stacks: a [E, M, K], w [E, w_rows, N],
    the optional scales [E, M, 1] and [E, 1, N] float32; (E, M, K, N)."""
    dev = a.device
    adt = torch.uint8 if kind == "lut" else torch.int8
    _check("a", a, adt, 3, dev)
    _check("w", w, adt, 3, dev)
    E, M, K = a.shape
    if w.shape[0] != E or w.shape[1] != w_rows:
        raise ValueError(f"w {tuple(w.shape)} does not match a "
                         f"{tuple(a.shape)}: expected [{E}, {w_rows}, N]")
    N = w.shape[2]
    if a_scale is not None:
        _check("a_scale", a_scale, torch.float32, 3, dev)
        _check("w_scale", w_scale, torch.float32, 3, dev)
        if tuple(a_scale.shape) != (E, M, 1) or \
                tuple(w_scale.shape) != (E, 1, N):
            raise ValueError(
                f"scales must be a_scale [E, M, 1] = [{E}, {M}, 1] and "
                f"w_scale [E, 1, N] = [{E}, 1, {N}], got "
                f"{tuple(a_scale.shape)} and {tuple(w_scale.shape)}")
    return E, M, K, N


def _expert_out(a_scale, out_dtype, E, M, N, device):
    """(output [E, M, N], epilogue code): int32 without scales."""
    epi = 0 if a_scale is None else _out_dtype(out_dtype)
    dtype = torch.int32 if a_scale is None else out_dtype
    return torch.empty((E, M, N), dtype=dtype, device=device), epi


def lutmul_experts(a_codes: torch.Tensor, w_packed: torch.Tensor,
                   a_scale: torch.Tensor | None = None,
                   w_scale: torch.Tensor | None = None, *,
                   a_signed: bool = True,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """The LUT kernel once per expert: a_codes [E, M, K] uint8 4-bit codes,
    w_packed [E, K//2, N] uint8 -> int32 [E, M, N] (``lutmul``), or with
    a_scale [E, M, 1] and w_scale [E, 1, N] float32 the fused epilogue in
    ``out_dtype`` (``lutmul_fused``)."""
    fused = a_scale is not None
    if a_codes.device.type == "cpu":
        return torch.stack([
            lutmul_fused(a_codes[e], w_packed[e], a_scale[e], w_scale[e],
                         a_signed=a_signed, out_dtype=out_dtype) if fused
            else lutmul(a_codes[e], w_packed[e], a_signed=a_signed)
            for e in range(a_codes.shape[0])])
    dev = a_codes.device
    E, M, K, N = _expert_stacks(a_codes, w_packed, a_scale, w_scale, "lut",
                                a_codes.shape[2] // 2)
    out, epi = _expert_out(a_scale, out_dtype, E, M, N, dev)
    _lut_launch(a_codes, w_packed, a_scale, w_scale, out, epi, a_signed,
                "lutmul_fused" if fused else "lutmul")
    return out


def int_matmul_experts(a: torch.Tensor, w: torch.Tensor,
                       a_scale: torch.Tensor | None = None,
                       w_scale: torch.Tensor | None = None, *,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 kernel once per expert: a [E, M, K] int8, w [E, K, N] int8
    -> int32 [E, M, N] (``int_matmul``), or with the scales the fused
    epilogue in ``out_dtype`` (``int_matmul_fused``)."""
    fused = a_scale is not None
    if a.device.type == "cpu":
        return torch.stack([
            int_matmul_fused(a[e], w[e], a_scale[e], w_scale[e],
                             out_dtype=out_dtype) if fused
            else int_matmul(a[e], w[e]) for e in range(a.shape[0])])
    dev = a.device
    E, M, K, N = _expert_stacks(a, w, a_scale, w_scale, "int", a.shape[2])
    out, epi = _expert_out(a_scale, out_dtype, E, M, N, dev)
    _int_launch(a, w, a_scale, w_scale, out, epi,
                "int_matmul_fused" if fused else "int_matmul")
    return out
