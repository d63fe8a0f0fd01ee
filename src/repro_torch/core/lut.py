"""The paper's LUT multiply: the FPGA's LUT6_2 INIT words, the Eq. 3 cost
model, product tables, int4 packing and the sub-4-bit bitplane format
(port of ``repro.core.lut``).

``lut6_2_init_words`` gives the 64-bit INIT words of the Xilinx LUT6_2
primitives that embed two int4 weights as constant multipliers, as the
paper's Fig. 5 prints them.  Input wiring (MSB to LSB) is ``{I5=1, I4=WS
(weight select), I3..I0=uint4 activation}``; LUT ``j`` (j = 0 the most
significant) emits product bit ``7-2j`` on O6 (``INIT[32 + 16*WS + a]``)
and bit ``6-2j`` on O5 (``INIT[16*WS + a]``).  ``multiply_via_lut6`` reads
the bank as the FPGA would; ``luts_per_multiply`` is Eq. 3.  These are
plain Python integers: no device is involved.

``product_table`` is the same multiply as a ``[2^w, 2^a]`` table:
``T[w_code, a_code] == w * a`` for the two's-complement weight code and the
(un)signed activation code; both it and the INIT words derive from
:func:`_int_product`.  ``contraction_words`` is its selection stage as
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


# ---------------------------------------------------------------------------
# the shared integer product and the FPGA's LUT6_2 INIT words (Fig. 5)
# ---------------------------------------------------------------------------

def _int_product(weight: int, activation: int, out_bits: int = 8) -> int:
    """Two's-complement ``weight * activation`` truncated to ``out_bits``."""
    return (int(weight) * int(activation)) & ((1 << out_bits) - 1)


def lut6_2_init_words(w0: int, w1: int, act_bits: int = 4,
                      out_bits: int = 8) -> list[int]:
    """The 64-bit INIT words of the ``out_bits // 2`` LUT6_2 embedding
    weights ``(w0, w1)`` (``w0`` selected by WS=0, ``w1`` by WS=1), most
    significant bit pair first, in the order the paper lists them."""
    if act_bits != 4:
        raise ValueError("LUT6_2 packing is defined for 4-bit activations")
    words = []
    for j in range(out_bits // 2):
        hi_bit = out_bits - 1 - 2 * j    # on O6 (upper 32 INIT bits)
        lo_bit = out_bits - 2 - 2 * j    # on O5 (lower 32 INIT bits)
        init = 0
        for ws, w in ((0, w0), (1, w1)):
            for a in range(2 ** act_bits):
                p = _int_product(w, a, out_bits)
                if (p >> hi_bit) & 1:
                    init |= 1 << (32 + 16 * ws + a)
                if (p >> lo_bit) & 1:
                    init |= 1 << (16 * ws + a)
        words.append(init)
    return words


# the paper's published INIT words for weights (+1, -3)
PAPER_FIG5_INIT_WORDS = (
    0xFFFE_0000_FFFE_0000,
    0x07FE_0000_F83E_0000,
    0x39C6_FF00_5A5A_F0F0,
    0xCCCC_CCCC_AAAA_AAAA,
)


def lut6_read(init: int, i5: int, i4: int, a: int) -> tuple[int, int]:
    """(O6, O5) of a LUT6_2 at input ``{i5, i4, a[3:0]}``."""
    idx6 = (i5 << 5) | (i4 << 4) | a
    idx5 = (i4 << 4) | a
    return (init >> idx6) & 1, (init >> idx5) & 1


def multiply_via_lut6(w0: int, w1: int, ws: int, a: int,
                      out_bits: int = 8) -> int:
    """The signed product the LUT6_2 bank of ``(w0, w1)`` emits for weight
    select ``ws`` and activation ``a``, read as the FPGA would."""
    words = lut6_2_init_words(w0, w1, out_bits=out_bits)
    p = 0
    for j, init in enumerate(words):
        o6, o5 = lut6_read(init, 1, ws, a)
        p |= o6 << (out_bits - 1 - 2 * j)
        p |= o5 << (out_bits - 2 - 2 * j)
    if p >= 1 << (out_bits - 1):          # two's complement decode
        p -= 1 << out_bits
    return p


# ---------------------------------------------------------------------------
# Eq. (3): the LUT cost model
# ---------------------------------------------------------------------------

def luts_per_multiply(n_bits: int) -> float:
    """Paper Eq. (3): #LUT6 = (2n * 2^n) / (1 * 2^6) for an n:2n LUT
    multiply."""
    return (2 * n_bits * 2 ** n_bits) / 64.0


def luts_per_multiply_general(n_bits: int) -> tuple[int, int]:
    """(min, max) LUT6 count of a general n-bit multiplier (the paper: 13-28
    at 4 bits; Fig. 5's caption: 6-14x LUTMUL's 2)."""
    if n_bits <= 4:
        return 13, 28
    scale = (n_bits // 4) ** 2
    return 13 * scale, 28 * scale


# ---------------------------------------------------------------------------
# product tables (consumed by the LUT kernels)
# ---------------------------------------------------------------------------

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


def flat_product_table(w_bits: int = 4, a_bits: int = 4, **kw) -> np.ndarray:
    """:func:`product_table` flattened, addressed by ``(w_code << a_bits) |
    a_code``."""
    return product_table(w_bits, a_bits, **kw).reshape(-1)


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
