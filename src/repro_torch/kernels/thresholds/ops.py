"""Dispatch around the multi-threshold kernel, and the paper's integer
stage: LUT multiply-accumulate, then the threshold unit (port of
``repro.kernels.thresholds.ops``).

Backends are ``repro_torch.kernels.lutmul.ops``'s: ``"ref"`` takes the plain
version; ``"cuda"`` takes the kernel wrapper, which itself takes the plain
version for a tensor on the CPU.  The kernel needs no padding: it masks the
ragged edge.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.lutmul.ops import get_backend, lutmul
from repro_torch.kernels.thresholds import kernel, ref


def threshold(acc: torch.Tensor, thresholds: torch.Tensor,
              sign: torch.Tensor, backend: Optional[str] = None
              ) -> torch.Tensor:
    """acc [M, N] int32; thresholds [N, L]; sign [N] -> int32 codes."""
    if (backend or get_backend()) == "ref":
        return ref.threshold_ref(acc, thresholds, sign)
    return kernel.threshold(acc.contiguous(),
                            thresholds.to(torch.float32).contiguous(),
                            sign.to(torch.float32).contiguous())


def lutmul_threshold_stage(a_codes: torch.Tensor, w_packed: torch.Tensor,
                           thresholds: torch.Tensor, sign: torch.Tensor,
                           a_signed: bool = False,
                           backend: Optional[str] = None) -> torch.Tensor:
    """The paper's integer stage: the LUT multiply-accumulate, then the
    threshold unit, end to end in integer arithmetic."""
    acc = lutmul(a_codes, w_packed, a_signed=a_signed, backend=backend)
    return threshold(acc, thresholds, sign, backend=backend)
