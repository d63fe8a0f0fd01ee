"""Plain PyTorch versions of the LUT-multiplication kernels.

They define what the CUDA kernels must reproduce exactly.  CUDA has no
int32 matmul, so the integer products are taken in float64 and cast back:
exact while ``|acc| < 2^53`` (float32 is not: the int8 head reaches
``128 * 128 * 3584 > 2^24``).
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import unpack_int4


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
