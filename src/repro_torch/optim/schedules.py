"""LR schedules (port of ``repro.optim.schedules``): cosine, and WSD
(Warmup-Stable-Decay) from MiniCPM [arXiv:2404.06395] — the schedule the
minicpm-2b config trains with.

A schedule maps an integer step tensor to a float32 0-d tensor on its
device, computed in float32 in the reference's order of operations: the
step cast to float32, Python constants folded in float64 and rounded to
float32 where the reference's are (JAX's weakly typed scalars), and every
division an IEEE division by a tensor (CUDA turns a division by a Python
number into a reciprocal multiply).  ``cos`` and ``pow`` are the C
library's ``cosf`` and ``powf``, evaluated on the host: they are what the
reference's XLA CPU backend calls, and ATen's float32 ``cos`` and ``pow``
differ from them in the last bit at some steps (ATen's ``cos`` at 497 of
10,000 cosine steps, measured on the CPU).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

_LIBM: dict = {}


def libm_f32(name: str, *args: torch.Tensor) -> torch.Tensor:
    """The C library's float32 ``name`` elementwise over float32 tensors
    (broadcast), on the host, returned on the first argument's device."""
    if name not in _LIBM:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * len(args)
        _LIBM[name] = np.vectorize(fn, otypes=[np.float32])
    host = [a.detach().to("cpu", torch.float32).numpy() for a in args]
    out = np.asarray(_LIBM[name](*host), dtype=np.float32)
    return torch.from_numpy(out).to(args[0].device)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1) -> torch.Tensor:
    s = _step(step)
    warm = _f32(peak_lr, s) * s / _f32(max(warmup, 1), s)
    prog = torch.clamp((s - _f32(warmup, s))
                       / _f32(max(total - warmup, 1), s), 0.0, 1.0)
    cos = _f32(final_frac * peak_lr, s) \
        + _f32((1 - final_frac) * peak_lr * 0.5, s) \
        * (_f32(1.0, s) + libm_f32("cosf", _f32(math.pi, s) * prog))
    return torch.where(s < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.1) -> torch.Tensor:
    """Warmup -> constant ("stable") -> short exponential-ish decay tail.

    MiniCPM: decay over the last ~10% of tokens; the decay branch is the
    paper's f(s) = peak * final_frac ** ((s - w - st)/decay).
    """
    s = _step(step)
    warm = _f32(peak_lr, s) * s / _f32(max(warmup, 1), s)
    dec_prog = torch.clamp((s - _f32(warmup, s) - _f32(stable, s))
                           / _f32(max(decay, 1), s), 0.0, 1.0)
    dec = _f32(peak_lr, s) * libm_f32("powf", _f32(final_frac, s).expand_as(dec_prog),
                                        dec_prog)
    return torch.where(s < warmup, warm,
                       torch.where(s < warmup + stable, _f32(peak_lr, s),
                                   dec))


def make(name: str, **kw):
    fn = {"cosine": cosine, "wsd": wsd}[name]
    return lambda step: fn(step, **kw)
