"""Plain PyTorch versions of the LUT-multiplication kernels.

They define what the CUDA kernels must reproduce exactly.  CUDA has no
int32 matmul, so the integer products are taken in float64 and cast back:
exact while ``|acc| < 2^53`` (float32 is not: the int8 head reaches
``128 * 128 * 3584 > 2^24``).

The T-MAC bitplane product has two plain forms: ``lutmul_tmac_ref``, the
faithful group-table gather (the paper's and T-MAC's lookup, as the
reference's oracle builds it), and ``tmac_ref``, the decoded-plane
contraction (the reference's ``ref`` backend), which the kernel wrappers
and the serving path use.  They give the same integers.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import (decode_planes, plane_decomposition,
                                  unpack_bitplanes, unpack_int4)


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
