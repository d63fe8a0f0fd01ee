"""Wrapper of the CUDA multi-threshold kernel (``csrc/thresholds.cu``),
which replaces ``threshold_pallas``
(``repro/kernels/thresholds/kernel.py:31``):
``codes[m, n] = sum_l [f32(acc[m, n]) * sign[n] >= thr[n, l]]``.

A tensor on the CPU takes the plain version (``ref.threshold_ref``); a CUDA
tensor launches the kernel on the current stream or raises.  ``LAUNCHES``
counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.lutmul.kernel import _check, _entry, _raise_on
from repro_torch.kernels.thresholds import ref

LAUNCHES = {"threshold": 0}

_MAX_SMEM = 48 * 1024          # shared memory a launch gets without opt-in


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def threshold(acc: torch.Tensor, thresholds: torch.Tensor,
              sign: torch.Tensor) -> torch.Tensor:
    """acc [M, N] int32, thresholds [N, L] float32, sign [N] float32 ->
    int32 codes [M, N] in [0, L]."""
    if acc.device.type == "cpu":
        return ref.threshold_ref(acc, thresholds, sign)
    dev = acc.device
    _check("acc", acc, torch.int32, 2, dev)
    _check("thresholds", thresholds, torch.float32, 2, dev)
    _check("sign", sign, torch.float32, 1, dev)
    M, N = acc.shape
    L = thresholds.shape[1]
    if thresholds.shape[0] != N or sign.shape[0] != N:
        raise ValueError(
            f"thresholds [N, L] = {tuple(thresholds.shape)} and sign [N] = "
            f"{tuple(sign.shape)} must have acc's N = {N}")
    smem = _entry("thresholds", "threshold_smem_bytes", [ctypes.c_int],
                  ctypes.c_longlong)(L)
    if smem > _MAX_SMEM:
        raise ValueError(f"{L} threshold levels need {smem} bytes of shared "
                         f"memory, more than the {_MAX_SMEM} a launch gets")
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M == 0 or N == 0:
        return out
    fn = _entry("thresholds", "threshold_launch",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
    code = fn(acc.data_ptr(), thresholds.data_ptr(), sign.data_ptr(),
              out.data_ptr(), M, N, L,
              torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "threshold")
    LAUNCHES["threshold"] += 1
    return out
