"""Quantization primitives — paper Eq. (4)/(5) — plus QAT fake-quant with a
straight-through estimator (port of ``repro.core.quantization``).

Weights quantize to signed int4 (symmetric, per channel), activations to
unsigned uint4 (the threshold units emit unsigned codes), first/last layers
to 8 bits.  ``quantize``/``dequantize`` are Eq. (4)/(5); ``fake_quant`` is the
straight-through estimator of QAT; ``project_params`` snaps weights onto the
grid after an update (Sec. 3.6).

Held bitwise to the reference on every device: divisions are IEEE divisions
by tensors (CUDA PyTorch turns ``x / 7`` by a Python number into a
reciprocal multiply), ``torch.round`` rounds half to even like ``jnp.round``,
and the cast to the code dtype saturates as XLA's does (an A8 code of 255
becomes int8 127 there; PyTorch's own cast would wrap it to -1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static description of one quantizer (weights or activations)."""

    bits: int = 4
    signed: bool = True            # weights: int4; activations: uint4
    per_channel: bool = True
    channel_axis: int = -1         # axis that keeps its own scale
    narrow_range: bool = False     # use [-(2^{b-1}-1), 2^{b-1}-1] when True

    @property
    def qmin(self) -> int:
        if not self.signed:
            return 0
        return -(2 ** (self.bits - 1)) + (1 if self.narrow_range else 0)

    @property
    def qmax(self) -> int:
        return (2 ** (self.bits - 1) - 1) if self.signed \
            else (2 ** self.bits - 1)

    @property
    def n_levels(self) -> int:
        return self.qmax - self.qmin + 1


W4 = QuantConfig(bits=4, signed=True)
A4 = QuantConfig(bits=4, signed=False)
W8 = QuantConfig(bits=8, signed=True)
A8 = QuantConfig(bits=8, signed=False)


def as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 tensor on ``like``'s device (a Python number
    becomes a 0-d tensor, so dividing by it is an IEEE division)."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def compute_scale(x: torch.Tensor, cfg: QuantConfig,
                  eps: float = 1e-8) -> torch.Tensor:
    """Max-abs (symmetric) scale; per channel when configured, keeping the
    reduced dims so the scale broadcasts against ``x``."""
    if cfg.per_channel and x.dim() > 1:
        axis = cfg.channel_axis % x.dim()
        dims = tuple(a for a in range(x.dim()) if a != axis)
        amax = torch.amax(torch.abs(x), dim=dims, keepdim=True)
    else:
        amax = torch.amax(torch.abs(x))
    # unsigned quantizers map [0, amax] onto [0, qmax]; signed [-amax, amax]
    denom = cfg.qmax if not cfg.signed else (2 ** (cfg.bits - 1) - 1)
    return torch.clamp_min(amax, eps) / as_tensor(float(denom), amax)


def quantize(x: torch.Tensor, scale, zero_point, cfg: QuantConfig
             ) -> torch.Tensor:
    """Paper Eq. (4): clamp(round(x / s + z), qmin, qmax), half to even.
    A tensor scale keeps its dtype (a bf16 weight divides by its bf16
    scale in bf16, as the reference's)."""
    if not isinstance(scale, torch.Tensor):
        scale = as_tensor(scale, x)
    q = torch.round(x / scale.to(x.device) + zero_point)
    q = torch.clamp(q, cfg.qmin, cfg.qmax)
    dtype = torch.int8 if cfg.bits <= 8 else torch.int32
    info = torch.iinfo(dtype)
    return torch.clamp(q, info.min, info.max).to(dtype)


def dequantize(q: torch.Tensor, scale, zero_point=0) -> torch.Tensor:
    """Paper Eq. (5): s * (y - z)."""
    if not isinstance(scale, torch.Tensor):
        scale = as_tensor(scale, q)
    return (q.to(scale.dtype) - zero_point) * scale


def fake_quant(x: torch.Tensor, cfg: QuantConfig,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Straight-through fake quantization: forward ``x + (xq - x)`` (the
    reference's value, which is not bitwise ``xq``), gradient identity."""
    if scale is None:
        scale = compute_scale(x, cfg)
    xq = dequantize(quantize(x, scale, 0, cfg), scale, 0)
    return x + (xq - x).detach()


def shared_scale(leaves: list, cfg: QuantConfig,
                 eps: float = 1e-8) -> torch.Tensor:
    """The per-channel (last axis) scale of the leaves stacked along a new
    leading axis, without stacking them: the max-abs of each column over
    every leaf and every other axis.  The reference stacks a pattern
    position's layers into one ``[G, ...]`` leaf, so its per-channel scale
    is shared by those layers; this gives the port's per-layer leaves the
    same scale, bit for bit (a max is exact in any order)."""
    amax = None
    for leaf in leaves:
        a = torch.abs(leaf)
        if leaf.dim() > 1:
            a = torch.amax(a, dim=tuple(range(leaf.dim() - 1)), keepdim=True)
        amax = a if amax is None else torch.maximum(amax, a)
    denom = cfg.qmax if not cfg.signed else (2 ** (cfg.bits - 1) - 1)
    return torch.clamp_min(amax, eps) / as_tensor(float(denom), amax)


def quantize_pair(x: torch.Tensor, cfg: QuantConfig):
    """Returns (q, scale) with a freshly computed scale."""
    scale = compute_scale(x, cfg)
    return quantize(x, scale, 0, cfg), scale


def project_params(params, spec):
    """Post-update projection of weights onto the quantization grid.

    ``spec`` has the structure of ``params`` (dicts and lists) with a
    ``QuantConfig`` at each leaf to project and ``None`` at each leaf to
    keep."""
    if spec is None:
        return params
    if isinstance(params, dict):
        return {k: project_params(v, spec[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(project_params(v, s)
                            for v, s in zip(params, spec, strict=True))
    return fake_quant(params, spec)


def quant_error(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Mean-squared quantization error (the Fig. 2 style sweep)."""
    scale = compute_scale(x, cfg)
    xq = dequantize(quantize(x, scale, 0, cfg), scale, 0)
    return torch.mean((x - xq) ** 2)
