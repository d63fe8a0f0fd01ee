"""Product tables, int4 packing and the sub-4-bit bitplane format (port of
``repro.core.lut``'s tensor part).

``product_table`` is the paper's LUT multiply as a ``[2^w, 2^a]`` table:
``T[w_code, a_code] == w * a`` for the two's-complement weight code and the
(un)signed activation code.  ``contraction_words`` is its selection stage as
the CUDA lutmul kernel takes it: per weight code the four power-of-two
partial products ``T[w, 1], T[w, 2], T[w, 4], T[w, 8]`` packed as int8 bytes
of one word, so activation signedness lives in the table alone.  Packing is
k-major: byte ``i`` holds element ``2i`` in its low nibble and ``2i+1`` in
its high one.

The T-MAC formulation stores a weight as ``P`` binary planes with integer
coefficients, ``w[k, n] = sum_b coeff_b * plane_b[k, n] + const``, packed
k-major eight rows to a byte (bit ``i`` of byte ``j`` is plane row
``8j + i``).  A weight-bits *spec* is an int in {1, 2, 3, 4} or
``"ternary"`` (BitNet b1.58's {-1, 0, +1}).
"""
from __future__ import annotations

import numpy as np
import torch


def product_table(w_bits: int = 4, a_bits: int = 4, w_signed: bool = True,
                  a_signed: bool = False) -> np.ndarray:
    """Dense ``T[w_code, a_code] -> int32 product`` table."""
    ws = np.arange(2 ** w_bits)
    wvals = np.where(ws >= 2 ** (w_bits - 1), ws - 2 ** w_bits, ws) \
        if w_signed else ws
    As = np.arange(2 ** a_bits)
    avals = np.where(As >= 2 ** (a_bits - 1), As - 2 ** a_bits, As) \
        if a_signed else As
    return (wvals[:, None] * avals[None, :]).astype(np.int32)


def contraction_table(a_signed: bool = False) -> np.ndarray:
    """[16, 16] w4a4 table (row = weight code, column = activation code)."""
    t = product_table(w_signed=True, a_signed=a_signed)
    assert t.min() >= -128 and t.max() <= 127, "table must fit int8"
    return t


BITPLANE_COLUMNS = (1, 2, 4, 8)     # activation codes 2^b, b = 0..3


def contraction_words(a_signed: bool = False) -> np.ndarray:
    """The selection stage as 16 words (int32 [16]): byte ``b`` of word
    ``w`` (bits ``8b .. 8b+7``) is ``T[w, 2^b]`` as int8.  ``T[w, 8]``
    carries the sign of the activation's top bit (``-8w`` signed, ``+8w``
    unsigned).  Contracting these bytes with the activation's 0/1 bitplanes
    gives ``T[w, a]`` for every table linear in the activation bits, which
    :func:`contraction_table` is."""
    cols = contraction_table(a_signed)[:, BITPLANE_COLUMNS]
    u = cols.astype(np.int64) & 0xFF
    words = sum(u[:, b] << (8 * b) for b in range(4))
    return words.astype(np.uint32).view(np.int32)


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """Pack int4 values along the last (even) axis into uint8 nibble pairs:
    ``out[..., i] = (x[..., 2i+1] & 0xF) << 4 | (x[..., 2i] & 0xF)``."""
    if x.shape[-1] % 2:
        raise ValueError("last axis must be even to pack nibbles")
    lo = x[..., 0::2].to(torch.uint8) & 0xF
    hi = x[..., 1::2].to(torch.uint8) & 0xF
    return (hi << 4) | lo


def unpack_int4(packed: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; int8 out, sign-extended if ``signed``."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    x = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    if signed:
        x = torch.where(x >= 8, x - 16, x)
    return x


# ---------------------------------------------------------------------------
# sub-4-bit weight specs + bitplane decomposition (the T-MAC formulation)
# ---------------------------------------------------------------------------

WEIGHT_BITS_SPECS = (1, "ternary", 2, 3, 4)


def validate_weight_bits(spec) -> None:
    """Raise an actionable error for anything outside the supported family."""
    if spec not in WEIGHT_BITS_SPECS:
        raise ValueError(
            f"unsupported weight bit width {spec!r}: the tmac formulation "
            f"supports {WEIGHT_BITS_SPECS} (ints are two's-complement widths;"
            " 'ternary' is the BitNet-b1.58 {-1,0,+1} coding at ~1.58 bits)")


def weight_bits(spec) -> float:
    """Effective bits for cost/memory accounting (ternary ~= log2(3))."""
    validate_weight_bits(spec)
    return 1.58 if spec == "ternary" else float(spec)


def plane_decomposition(spec) -> tuple[int, tuple[int, ...], int]:
    """(n_planes, per-plane coeffs, additive const) for a weight-bits spec:
    two's-complement planes ``(1, 2, .., -2^(B-1))`` for ints B >= 2,
    ``(1, -1)`` for ternary, and one plane with coeff 2, const -1 for w1
    (``w = 2p - 1``)."""
    validate_weight_bits(spec)
    if spec == "ternary":
        return 2, (1, -1), 0
    if spec == 1:
        return 1, (2,), -1
    b = int(spec)
    return b, tuple([1 << i for i in range(b - 1)] + [-(1 << (b - 1))]), 0


def truncate_plane_spec(spec, keep: int) -> tuple[int, int]:
    """``(kept_spec, scale_mult)`` of the top-``keep``-plane drafter of an
    int spec ``B``: the suffix ``planes[B-keep:]`` has coefficients
    ``2^(B-keep) * plane_decomposition(keep)[1]``, so it is a valid
    ``keep``-bit stack once the scale absorbs ``2^(B-keep)``.  Only int
    specs with ``2 <= keep < B`` truncate."""
    validate_weight_bits(spec)
    if spec in ("ternary", 1):
        raise ValueError(
            f"weight spec {spec!r} has no truncatable plane prefix: its "
            "planes are not positional powers of two")
    b = int(spec)
    if not 2 <= keep < b:
        raise ValueError(
            f"draft plane count must satisfy 2 <= keep < {b} for a w{b} "
            f"weight, got keep={keep}")
    _, coeffs, const = plane_decomposition(b)
    _, kcoeffs, kconst = plane_decomposition(keep)
    mult = 1 << (b - keep)
    assert coeffs[b - keep:] == tuple(c * mult for c in kcoeffs)
    assert not const and not kconst
    return keep, mult


def planes_from_codes(codes: torch.Tensor, spec) -> torch.Tensor:
    """Integer weight codes [..., K, N] -> {0, 1} uint8 planes
    [..., P, K, N] (inverse of :func:`decode_planes` on the spec's range)."""
    n_planes, _, _ = plane_decomposition(spec)
    c = codes.to(torch.int32)
    if spec == "ternary":
        planes = [c == 1, c == -1]
    elif spec == 1:
        planes = [c > 0]
    else:
        u = c & ((1 << int(spec)) - 1)
        planes = [((u >> b) & 1).bool() for b in range(n_planes)]
    return torch.stack([p.to(torch.uint8) for p in planes], dim=-3)


def decode_planes(planes: torch.Tensor, spec) -> torch.Tensor:
    """{0, 1} planes [..., P, K, N] -> int32 weight codes [..., K, N]."""
    _, coeffs, const = plane_decomposition(spec)
    co = torch.tensor(coeffs, dtype=torch.int32,
                      device=planes.device).reshape(-1, 1, 1)
    return torch.sum(planes.to(torch.int32) * co, dim=-3,
                     dtype=torch.int32) + const


def pack_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """{0, 1} planes [..., K, N] (K % 8 == 0) -> uint8 [..., K//8, N]; bit
    ``i`` of byte ``j`` is plane row ``8j + i``."""
    K = planes.shape[-2]
    if K % 8:
        raise ValueError(
            f"bitplane packing needs K % 8 == 0, got K={K}; pad the "
            "contraction dim to a multiple of 8 before packing")
    x = planes.to(torch.uint8).reshape(*planes.shape[:-2], K // 8, 8,
                                       planes.shape[-1])
    shifts = torch.arange(8, dtype=torch.uint8,
                          device=planes.device).reshape(8, 1)
    return torch.sum(x << shifts, dim=-2, dtype=torch.int32).to(torch.uint8)


def unpack_bitplanes(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K//8, N] -> {0, 1} uint8 planes [..., K, N]."""
    shifts = torch.arange(8, dtype=torch.uint8,
                          device=packed.device).reshape(8, 1)
    bits = (packed[..., :, None, :] >> shifts) & 1
    return bits.reshape(*packed.shape[:-2], packed.shape[-2] * 8,
                        packed.shape[-1])
