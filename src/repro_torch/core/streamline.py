"""Streamlining (paper Sec. 3.2 / FINN): turn a float ``conv -> BN ->
ReLU6 -> quantize`` stage into the integer-only ``LUT multiply ->
multi-threshold`` stage (port of ``repro.core.streamline``).

The stage consumes uint4 activation codes and int4 weight codes and emits
uint4 codes for the next layer, with every scale and the BN folded into
per-channel integer thresholds.  ``integer_stage_forward`` is held code for
code to ``float_stage_reference``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.lut import pack_int4
from repro_torch.core.quantization import (A4, W4, QuantConfig, as_tensor,
                                           compute_scale, dequantize,
                                           quantize)
from repro_torch.core.thresholds import BNParams, make_thresholds
from repro_torch.kernels.thresholds.ops import lutmul_threshold_stage


@dataclasses.dataclass
class StreamlinedStage:
    """Integer-only stage: weights as int4 codes + threshold bank."""
    w_codes: torch.Tensor         # [K, N] int8 (int4 codes)
    thresholds: torch.Tensor      # [N, levels-1] float32
    sign: torch.Tensor            # [N] BN-slope sign
    act_scale_out: torch.Tensor   # [N] output activation scale
    relu6_cap_code: torch.Tensor  # [N] int32 code of the clip at 6.0


def streamline_stage(w: torch.Tensor, bn: BNParams, act_scale_in,
                     out_cfg: QuantConfig = A4) -> StreamlinedStage:
    """w [K, N] float weights; act_scale_in the scalar input activation
    scale.  acc = sum_k w_q[k, n] * a_q[k] carries the float pre-activation
    (w_scale[n] * act_scale_in) * acc; BN, the ReLU6 clip and rounding to
    the output scale are monotone per channel, hence a threshold bank."""
    w_scale = compute_scale(w, W4)                        # [1, N]
    w_codes = quantize(w, w_scale, 0, W4)
    acc_scale = w_scale[0] * as_tensor(act_scale_in, w)   # [N]
    # the output scale maps the ReLU6 cap 6.0 onto qmax
    out_scale = torch.full(acc_scale.shape, 6.0 / out_cfg.qmax,
                           dtype=torch.float32, device=w.device)
    thresholds, sign = make_thresholds(acc_scale, bn, out_cfg, out_scale)
    cap = torch.full(acc_scale.shape, out_cfg.qmax, dtype=torch.int32,
                     device=w.device)
    return StreamlinedStage(w_codes=w_codes, thresholds=thresholds,
                            sign=sign, act_scale_out=out_scale,
                            relu6_cap_code=cap)


def integer_stage_forward(stage: StreamlinedStage, a_codes: torch.Tensor,
                          out_cfg: QuantConfig = A4,
                          backend: Optional[str] = None) -> torch.Tensor:
    """a_codes [M, K] uint4 codes -> [M, N] uint4 codes, integer only.

    The matmul runs through the LUT kernel (unsigned activations) and the
    activation through the threshold kernel: one launch of each on a CUDA
    tensor (``thresholds.ops.lutmul_threshold_stage``).  The reference
    applies ``apply_thresholds``, the same count plus ``qmin``."""
    w_packed = pack_int4(stage.w_codes.T).T
    q = lutmul_threshold_stage(a_codes.to(torch.uint8) & 0xF, w_packed,
                               stage.thresholds, stage.sign, a_signed=False,
                               backend=backend) + out_cfg.qmin
    return torch.minimum(torch.clamp_min(q, 0), stage.relu6_cap_code[None, :])


def float_stage_reference(w: torch.Tensor, bn: BNParams, act_scale_in,
                          a_codes: torch.Tensor,
                          out_cfg: QuantConfig = A4) -> torch.Tensor:
    """The float path the integer stage must match code for code."""
    w_scale = compute_scale(w, W4)
    w_q = dequantize(quantize(w, w_scale, 0, W4), w_scale)
    x = (a_codes.to(torch.float32) * as_tensor(act_scale_in, w)) @ w_q
    A, B = bn.affine()
    y = A * x + B
    act = torch.clamp(y, 0.0, 6.0)
    out_scale = as_tensor(6.0 / out_cfg.qmax, w)
    return torch.floor(act / out_scale + 0.5).to(torch.int32)
