"""Multi-threshold activation units + FINN-style streamlining (paper Sec.
3.2/3.6; port of ``repro.core.thresholds``).

The paper absorbs per-channel scales and batch norm into the activation,
turning ``dequant -> BN -> act -> requant`` into a bank of comparisons:

    q_out = sum_k [ acc >= T[c, k] ],    k = 1 .. 2^bits - 1

on the int32 accumulator of the LUT multiply.  ``make_thresholds`` derives
the bank; ``apply_thresholds`` evaluates it; ``float_reference`` is the float
path it must match code for code.  The operation order is the reference's,
and every division is by a tensor (an IEEE division on every device).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quantization import QuantConfig, as_tensor


@dataclasses.dataclass(frozen=True)
class BNParams:
    """Inference-time batch norm: y = gamma * (x - mean) / sqrt(var+eps) +
    beta."""
    gamma: torch.Tensor
    beta: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    eps: float = 1e-5

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (A, B) with y = A*x + B."""
        inv = self.gamma / sqrt_rn(self.var + self.eps)
        return inv, self.beta - self.mean * inv


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device.  ATen's vectorized
    float32 ``sqrt`` on the CPU can be 1 ulp off; the float64 root rounded
    to float32 is the correctly rounded float32 root (53 >= 2*24 + 2 bits),
    as XLA's and CUDA's ``sqrtf`` are."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _sign(a: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, +1, and ``a`` itself for +-0 and NaN
    (``torch.sign`` maps NaN to 0)."""
    return torch.where(a > 0, 1.0, torch.where(a < 0, -1.0, a)).to(a.dtype)


def make_thresholds(acc_scale: torch.Tensor, bn: Optional[BNParams],
                    out_cfg: QuantConfig, out_scale: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer thresholds ``T[c, k]`` (float32 ``[C, levels-1]``) and the
    per-channel slope sign ``[C]`` such that

        popcount(sign*acc >= T) == quantize(relu_clip(BN(acc*acc_scale)))

    with round-half-up semantics; a negative slope flips the comparison,
    encoded by negating both the accumulator and the thresholds."""
    n_steps = out_cfg.qmax - out_cfg.qmin
    if bn is not None:
        A, B = bn.affine()
    else:
        A = torch.ones_like(out_scale)
        B = torch.zeros_like(out_scale)
    A = A * acc_scale                  # y = A * acc + B in float
    # q steps at y = out_scale * (k - 0.5), k = qmin+1 .. qmax
    ks = torch.arange(1, n_steps + 1, dtype=torch.float32,
                      device=A.device) + float(out_cfg.qmin)
    y_t = out_scale[..., None] * (ks - 0.5)              # [C, K]
    # A*acc + B >= y_t  <=>  acc >= (y_t - B)/A (A > 0), <= (A < 0)
    t = (y_t - B[..., None]) / A[..., None]
    sign = _sign(A)
    t = t * sign[..., None]
    t_int = torch.ceil(t)        # acc' >= ceil(t) <=> acc' >= t, integer acc'
    return t_int.to(torch.float32), sign


def apply_thresholds(acc: torch.Tensor, thresholds: torch.Tensor,
                     sign: torch.Tensor, out_cfg: QuantConfig
                     ) -> torch.Tensor:
    """acc [..., C] int32; thresholds [C, K] -> int32 codes in [qmin,
    qmax]."""
    acc_f = acc.to(torch.float32) * sign
    q = torch.sum(acc_f[..., None] >= thresholds, dim=-1).to(torch.int32)
    return q + out_cfg.qmin


def float_reference(acc: torch.Tensor, acc_scale: torch.Tensor,
                    bn: Optional[BNParams], out_cfg: QuantConfig,
                    out_scale) -> torch.Tensor:
    """The float path the threshold unit must match exactly on integer
    accumulators."""
    x = acc.to(torch.float32) * acc_scale
    if bn is not None:
        A, B = bn.affine()
        x = A * x + B
    q = torch.floor(x / as_tensor(out_scale, x) + 0.5)   # round half up
    return torch.clamp(q, out_cfg.qmin, out_cfg.qmax).to(torch.int32)
