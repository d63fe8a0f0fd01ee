"""Product tables and int4 packing (port of ``repro.core.lut``'s tensor
part).

``product_table`` is the paper's LUT multiply as a ``[2^w, 2^a]`` table:
``T[w_code, a_code] == w * a`` for the two's-complement weight code and the
(un)signed activation code.  The CUDA lutmul kernel takes it as an argument,
so activation signedness lives in the table alone.  Packing is k-major: byte
``i`` holds element ``2i`` in its low nibble and ``2i+1`` in its high one.
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
