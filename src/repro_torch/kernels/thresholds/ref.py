"""Plain PyTorch version of the multi-threshold kernel: the count of
``acc >= T[c, l]`` (paper Sec. 3.2's threshold unit), which
``csrc/thresholds.cu`` must reproduce exactly."""
from __future__ import annotations

import torch


def threshold_ref(acc: torch.Tensor, thresholds: torch.Tensor,
                  sign: torch.Tensor) -> torch.Tensor:
    """acc [M, N] int32; thresholds [N, L] f32; sign [N] f32 (+-1).

    Returns uint codes [M, N] int32 in [0, L]."""
    a = acc.to(torch.float32) * sign[None, :]
    return torch.sum(a[:, :, None] >= thresholds[None, :, :],
                     dim=-1).to(torch.int32)
