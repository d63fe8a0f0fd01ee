"""Plain PyTorch versions of the LUT-multiplication kernels.

They define what the CUDA kernels must reproduce exactly.  CUDA has no
int32 matmul, so the integer products are taken in float64 and cast back:
exact while ``|acc| < 2^53`` (float32 is not: the int8 head reaches
``128 * 128 * 3584 > 2^24``).

The T-MAC bitplane product has three plain forms: ``lutmul_tmac_ref``, the
faithful group-table gather (the paper's and T-MAC's lookup, as the
reference's oracle builds it); ``tmac_ref``, the decoded-plane
contraction (the reference's ``ref`` backend), which the kernel wrappers
and the serving path use; and ``tmac_words_ref``, the CUDA kernel's own
word-level decode (``tmac_words``) and contraction, step by step.  They
give the same integers.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import (decode_planes, plane_decomposition,
                                  unpack_bitplanes, unpack_int4)

_U32 = 0xFFFFFFFF


def decode_codes(codes: torch.Tensor, bits: int = 4,
                 signed: bool = True) -> torch.Tensor:
    """Two's-complement decode of n-bit codes held in uint8/int8 -> int32."""
    c = codes.to(torch.int32) & ((1 << bits) - 1)
    if signed:
        c = torch.where(c >= (1 << (bits - 1)), c - (1 << bits), c)
    return c


def _exact_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def lutmul_ref(a_codes: torch.Tensor, w_packed: torch.Tensor,
               a_signed: bool = True) -> torch.Tensor:
    """a_codes [M, K] uint8 4-bit codes; w_packed [K//2, N] uint8 (byte k2
    holds w[2*k2] in the low nibble).  Returns int32 [M, N]."""
    a = decode_codes(a_codes, 4, a_signed)
    w = unpack_int4(w_packed.T, signed=True).T
    return _exact_matmul(a, w)


GATHER_COLS = 8       # columns a half-warp of csrc/lutmul_gather.cu holds


def gather_layout(table: torch.Tensor) -> torch.Tensor:
    """The [16, 16] int32 table (row = weight code) as the CUDA gather
    kernel stages it in shared memory: int32 [1024] with ``T[w, a]`` at
    word ``(w << 6) | (g << 4) | a`` for both halves g = 0, 1 of a warp.
    A half-warp's 16 lanes share w and differ in a, so its reads fall in
    banks ``16 g + a`` (word mod 32): one wavefront per warp-wide read.
    The words with bit 5 set are never written nor read (0 here)."""
    t = table.to(torch.int32).reshape(16, 1, 16)
    lay = torch.zeros((16, 4, 16), dtype=torch.int32, device=table.device)
    lay[:, :2] = t
    return lay.reshape(-1)


def lutmul_gather_ref(a_codes: torch.Tensor, w_packed: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """The gather kernel's sums, step by step: for every k, each product
    is one read of :func:`gather_layout` at ``(w << 6) | (g << 4) | a``
    (a the low nibble of the activation byte, w the weight nibble, g the
    half-warp of column n: ``(n // 8) % 2``), added up modulo 2^32 as
    int32 adds wrap.  a_codes [M, K] uint8, w_packed [K//2, N] uint8, any
    [16, 16] int32 table -> int32 [M, N]."""
    lay = gather_layout(table).to(torch.int64)
    a = a_codes.to(torch.int64) & 0xF                             # [M, K]
    w = unpack_int4(w_packed.T, signed=False).T.to(torch.int64)   # [K, N]
    M, K = a.shape
    N = w.shape[1]
    half = (torch.arange(N, device=a.device) // GATHER_COLS) % 2
    acc = torch.zeros((M, N), dtype=torch.int64, device=a.device)
    for k in range(K):
        acc += lay[(w[k] << 6 | half << 4)[None, :] | a[:, k, None]]
    acc &= _U32
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def lutmul_bitplane_ref(a_codes: torch.Tensor, w_packed: torch.Tensor,
                        words: torch.Tensor) -> torch.Tensor:
    """The CUDA LUT kernel's two stages, step by step.  Selection: each
    weight nibble looks up its word in ``words`` (int32 [16],
    ``core.lut.contraction_words``), unpacked into four int8 partial
    products ``T[w, 2^b]``.  Contraction: the 0/1 bitplanes of the
    activation codes against them over ``(k, b)``, in float64 (exact).
    Returns int32 [M, N], equal to :func:`lutmul_ref` for the tables the
    kernel is given."""
    codes = unpack_int4(w_packed.T, signed=False).T.to(torch.int64)
    sel = words.to(torch.int64)[codes] & 0xFFFFFFFF            # [K, N]
    shifts = 8 * torch.arange(4, device=sel.device)
    u8 = (sel[..., None] >> shifts) & 0xFF                     # [K, N, 4]
    tw = u8 - ((u8 >= 128).to(torch.int64) << 8)               # int8 bytes
    K, N = codes.shape
    bits = (a_codes.to(torch.int64)[..., None]
            >> torch.arange(4, device=sel.device)) & 1         # [M, K, 4]
    return _exact_matmul(bits.reshape(-1, K * 4),
                         tw.permute(0, 2, 1).reshape(K * 4, N))


def lutmul_tmac_ref(a_q: torch.Tensor, w_planes: torch.Tensor, wbits,
                    g: int = 2) -> torch.Tensor:
    """The faithful T-MAC group-table semantics: a_q [M, K] int8, w_planes
    [P, K//8, N] packed bitplanes.  Builds ``T[m, kg, c] = sum_i bit_i(c) *
    a[m, kg*g + i]`` and gathers it with each plane's g-bit group codes,
    ``acc = sum_b coeff_b * sum_kg T[m, kg, gcode_b(kg, n)] + const *
    sum_k a[m, k]``.  Returns int32 [M, N]."""
    n_planes, coeffs, const = plane_decomposition(wbits)
    a = a_q.to(torch.int32)
    w = unpack_bitplanes(w_planes).to(torch.int32)               # [P, K, N]
    M, K = a.shape
    if K % g:
        raise ValueError(f"tmac ref needs K % g == 0, got K={K} g={g}")
    kg, c = K // g, 1 << g
    dev = a.device
    bitsel = (torch.arange(c, device=dev)[None, :]
              >> torch.arange(g, device=dev)[:, None]) & 1      # [g, c]
    table = torch.sum(a.reshape(M, kg, g, 1) * bitsel.to(torch.int32),
                      dim=2, dtype=torch.int32)                 # [M, kg, c]
    gsh = torch.arange(g, dtype=torch.int32, device=dev).reshape(1, 1, g, 1)
    gcodes = torch.sum(w.reshape(n_planes, kg, g, -1) << gsh, dim=2,
                       dtype=torch.int32)                       # [P, kg, N]
    N = w.shape[-1]
    acc = torch.zeros((M, N), dtype=torch.int32, device=dev)
    for p in range(n_planes):
        looked = torch.gather(table, 2, gcodes[p][None].expand(M, kg, N)
                              .to(torch.int64))                 # [M, kg, N]
        acc = acc + coeffs[p] * torch.sum(looked, dim=1, dtype=torch.int32)
    if const:
        acc = acc + const * torch.sum(a, dim=1, keepdim=True,
                                      dtype=torch.int32)
    return acc


def tmac_ref(a_q: torch.Tensor, w_planes: torch.Tensor,
             wbits) -> torch.Tensor:
    """Decoded-plane contraction: ``a_q @ decode_planes(planes)``, int32
    [M, N] — the same integers as :func:`lutmul_tmac_ref` for any g."""
    return _exact_matmul(a_q, decode_planes(unpack_bitplanes(w_planes),
                                            wbits))


def _byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's ``__byte_perm`` on uint32 words: byte i of the result is byte
    ``(sel >> 4i) & 7`` of the 8 bytes (x low, y high)."""
    v = x | (y << 32)
    out = torch.zeros_like(x)
    for i in range(4):
        out |= ((v >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
    return out


def _swap_bits(x: torch.Tensor, y: torch.Tensor, d: int, mask: int):
    """Swap the bits of x under ``mask`` with those of y under ``mask >> d``."""
    t = (x ^ ((y << d) & _U32)) & mask
    return x ^ t, y ^ (t >> d)


def tmac_shift(wbits) -> int:
    """How far the tmac kernel's A bytes shift each weight code up: 8 less
    its two's-complement bit slots (P for the int widths, 2 for ternary
    and w1), so the top slot is the byte's sign bit."""
    n_planes, _, _ = plane_decomposition(wbits)
    return 8 - (n_planes if wbits not in ("ternary", 1) else 2)


def tmac_words(w_planes: torch.Tensor, wbits) -> torch.Tensor:
    """The CUDA tmac kernel's in-register decode (``csrc/lutmul_tmac.cu``
    ``decode``), word for word: packed planes [P, K//8, N] -> int32 A words
    [K//8, N, 2].  Word (j, n, h) is the A register of column n that lane
    ``tig = j % 4`` feeds the 32-deep step ``j // 4`` in its k slots
    ``16h + 4*tig .. +3``: byte i is the weight code at k = 8j + 4h + i,
    shifted up by :func:`tmac_shift` (an int8 byte).

    Each lane takes 4 adjacent columns: one uint32 word per plane (byte c =
    column c's plane byte).  The spec's map makes two's-complement bit
    slots, top-aligned in each nibble (ternary ``p0 - p1`` is the code
    ``(p1 & ~p0, p0 ^ p1)``, w1's ``2p - 1`` the code ``(~p, 1)``); two
    delta-swap rounds transpose (slot, k) inside every nibble; a 4 x 4 byte
    transpose gives each column one word; its high nibbles and its low
    nibbles shifted up are the two A registers.  The uint32 words are held
    in int64 tensors so that right shifts are logical, as in CUDA."""
    n_planes, _, _ = plane_decomposition(wbits)
    P, KB, N = w_planes.shape
    if P != n_planes:
        raise ValueError(f"w_planes has {P} planes, wbits={wbits!r} has "
                         f"{n_planes}")
    n4 = -(-N // 4)
    w = torch.zeros((P, KB, 4 * n4), dtype=torch.int64,
                    device=w_planes.device)
    w[..., :N] = w_planes.to(torch.int64)
    w = w.reshape(P, KB, n4, 4)
    words = sum(w[..., c] << (8 * c) for c in range(4))      # [P, KB, n4]
    zero = torch.zeros_like(words[0])
    s = [zero] * 4
    if wbits == "ternary":
        s[2] = words[0] ^ words[1]
        s[3] = words[1] & ~words[0] & _U32
    elif wbits == 1:
        s[2] = zero | _U32
        s[3] = ~words[0] & _U32
    else:
        for p in range(P):
            s[4 - P + p] = words[p]
    s[0], s[2] = _swap_bits(s[0], s[2], 2, 0xCCCCCCCC)
    s[1], s[3] = _swap_bits(s[1], s[3], 2, 0xCCCCCCCC)
    s[0], s[1] = _swap_bits(s[0], s[1], 1, 0xAAAAAAAA)
    s[2], s[3] = _swap_bits(s[2], s[3], 1, 0xAAAAAAAA)
    lo01 = _byte_perm(s[0], s[1], 0x5140)
    lo23 = _byte_perm(s[2], s[3], 0x5140)
    hi01 = _byte_perm(s[0], s[1], 0x7362)
    hi23 = _byte_perm(s[2], s[3], 0x7362)
    t = [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
         _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
    q = torch.stack([torch.stack([(tc << 4) & 0xF0F0F0F0, tc & 0xF0F0F0F0],
                                 dim=-1) for tc in t], dim=2)  # [KB,n4,4,2]
    q = q.reshape(KB, 4 * n4, 2)[:, :N]
    return torch.where(q >= 1 << 31, q - (1 << 32), q).to(torch.int32)


def tmac_words_ref(a_q: torch.Tensor, w_planes: torch.Tensor,
                   wbits) -> torch.Tensor:
    """The contraction the CUDA tmac kernel runs on :func:`tmac_words`:
    int8 A bytes (codes shifted up) against the activation codes, exact,
    then shifted back down.  int32 [M, N], equal to :func:`tmac_ref`."""
    q = tmac_words(w_planes, wbits).to(torch.int64) & _U32     # [KB, N, 2]
    KB, N, _ = q.shape
    u8 = (q[..., None] >> (8 * torch.arange(4, device=q.device))) & 0xFF
    w = u8 - ((u8 >= 128).to(torch.int64) << 8)               # [KB,N,2,4]
    w = w.permute(0, 2, 3, 1).reshape(8 * KB, N)      # k = 8j + 4h + i
    acc = (a_q.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)
    return (acc >> tmac_shift(wbits)).to(torch.int32)


def int_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N]."""
    return _exact_matmul(a, w)


def dequant_epilogue(acc: torch.Tensor, a_scale: torch.Tensor,
                     w_scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """``(acc.f32 * a_scale[M, 1]) * w_scale[1, N]`` rounded to
    ``out_dtype`` — the order the fused kernels apply."""
    return (acc.to(torch.float32) * a_scale.to(torch.float32)
            * w_scale.to(torch.float32)).to(out_dtype)


def scaled_lutmul_ref(a_codes: torch.Tensor, w_packed: torch.Tensor,
                      a_scale: torch.Tensor, w_scale: torch.Tensor,
                      a_signed: bool = True,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the fused LUT kernel."""
    return dequant_epilogue(lutmul_ref(a_codes, w_packed, a_signed),
                            a_scale, w_scale, out_dtype)


def scaled_int_matmul_ref(a: torch.Tensor, w: torch.Tensor,
                          a_scale: torch.Tensor, w_scale: torch.Tensor,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the fused int8 kernel."""
    return dequant_epilogue(int_matmul_ref(a, w), a_scale, w_scale,
                            out_dtype)


def scaled_tmac_ref(a_q: torch.Tensor, w_planes: torch.Tensor, wbits,
                    a_scale: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the fused tmac kernel."""
    return dequant_epilogue(tmac_ref(a_q, w_planes, wbits), a_scale,
                            w_scale, out_dtype)
