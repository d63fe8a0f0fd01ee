"""MobileNetV2 — the paper's evaluation network — in PyTorch, float or QAT
(port of ``repro.models.mobilenet``).

The public layouts are the reference's: NHWC activations, HWIO conv
weights (``[k, k, cin, cout]``; depthwise ``[k, k, 1, C]``), ``fc.w`` of
``[head, n_classes]``.  Inside, a convolution runs as ``F.conv2d`` on the
NCHW view of the NHWC data (channels-last memory, no copy), padded
explicitly like XLA's ``"SAME"``: at stride 2 on an even size the padding is
``(0, 1)``, where ``conv2d(padding=1)`` would pad ``(1, 1)`` and shift every
strided layer by a pixel.  Activation quantizers keep a scale per channel
over (B, H, W), so the QAT forward of a batch depends on the whole batch.

``_conv_shapes`` lists the 52 convolutions; ``chip_smoke.py`` streamlines
its 34 pointwise ones into integer stages (``core.streamline``), and
``fpga_layer_table`` gives them to the paper's analytic FPGA model
(``core.fpga_model``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.core.fpga_model import ConvLayer
from repro_torch.core.quantization import A4, A8, W4, W8, fake_quant
from repro_torch.core.thresholds import sqrt_rn
from repro_torch.models.layers import nll

# (expansion t, out channels c, repeats n, stride s) — Sandler et al. Table 2
INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


@dataclasses.dataclass(frozen=True)
class MobileNetConfig:
    name: str = "mobilenetv2"
    width: float = 1.0
    resolution: int = 224
    n_classes: int = 1000
    quant: str = "none"              # none | qat
    first_last_bits: int = 8         # paper: 8-bit first/last layers
    inner_bits: int = 4


def _c(ch: float, width: float) -> int:
    return max(8, int(ch * width + 4) // 8 * 8)


def _conv_shapes(cfg: MobileNetConfig):
    """([(name, cin, cout, k, stride, depthwise, h_in)], final res, head
    channels)."""
    layers = []
    res = cfg.resolution
    cin = 3
    cout = _c(32, cfg.width)
    layers.append(("stem", cin, cout, 3, 2, False, res))
    res //= 2
    cin = cout
    for bi, (t, c, n, s) in enumerate(INVERTED_RESIDUAL_CFG):
        cout = _c(c, cfg.width)
        for i in range(n):
            stride = s if i == 0 else 1
            exp = cin * t
            if t != 1:
                layers.append((f"b{bi}_{i}_expand", cin, exp, 1, 1, False,
                               res))
            layers.append((f"b{bi}_{i}_dw", exp, exp, 3, stride, True, res))
            res = res // stride
            layers.append((f"b{bi}_{i}_project", exp, cout, 1, 1, False,
                           res))
            cin = cout
    head = max(_c(1280, cfg.width),
               1280 if cfg.width >= 1.0 else _c(1280, cfg.width))
    layers.append(("head", cin, head, 1, 1, False, res))
    return layers, res, head


def fpga_layer_table(cfg: MobileNetConfig) -> list[ConvLayer]:
    """The 52 convolutions as ``core.fpga_model``'s dataflow layers (the
    paper's Table 2 model): 8 bits for ``stem`` and ``head``, 4 for every
    other layer, as the reference."""
    out = []
    for name, cin, cout, k, s, dw, h_in in _conv_shapes(cfg)[0]:
        h_out = h_in // s
        out.append(ConvLayer(name=name, cin=cin, cout=cout, k=k, h_out=h_out,
                             w_out=h_out, stride=s, depthwise=dw,
                             bits=8 if name in ("stem", "head") else 4))
    return out


def init_params(cfg: MobileNetConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights drawn from ``generator`` (on its own device), then
    moved to ``device`` (the GPU unless the caller names one)."""
    dev = resolve_device(device)
    gdev = generator.device
    layers, _, head = _conv_shapes(cfg)

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=gdev)

    params = {}
    for name, cin, cout, k, _, dw, _ in layers:
        fan_in = k * k * (1 if dw else cin)
        w = normal((k, k, 1 if dw else cin, cout)) / torch.tensor(
            math.sqrt(fan_in), device=gdev)
        params[name] = {
            "w": w.to(dev),
            "bn_gamma": torch.ones((cout,), device=dev),
            "bn_beta": torch.zeros((cout,), device=dev),
            "bn_mean": torch.zeros((cout,), device=dev),
            "bn_var": torch.ones((cout,), device=dev)}
    params["fc"] = {
        "w": (normal((head, cfg.n_classes))
              * torch.tensor(0.01, device=gdev)).to(dev),
        "b": torch.zeros((cfg.n_classes,), device=dev)}
    return params


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding (lo, hi) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p, x, k, stride, depthwise, quant_bits: Optional[int],
          train_qat: bool):
    w = p["w"]
    if train_qat and quant_bits:
        wcfg = W4 if quant_bits == 4 else W8
        w = fake_quant(w, dataclasses.replace(wcfg, channel_axis=-1))
    xc = x.permute(0, 3, 1, 2)               # NCHW view, channels-last data
    hlo, hhi = same_padding(xc.shape[2], k, stride)
    wlo, whi = same_padding(xc.shape[3], k, stride)
    if hlo or hhi or wlo or whi:
        xc = F.pad(xc, (wlo, whi, hlo, hhi))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
                 groups=x.shape[-1] if depthwise else 1)
    return y.permute(0, 2, 3, 1)


def _bn_relu6(p, x, quant_bits: Optional[int], train_qat: bool):
    inv = p["bn_gamma"] / sqrt_rn(p["bn_var"] + 1e-5)
    y = x * inv + (p["bn_beta"] - p["bn_mean"] * inv)
    # max then min, as ``jnp.clip``: a value exactly at 0 or 6 (a window
    # of zeros after a ReLU) takes half the gradient there, as XLA's
    y = torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_full((), 6.0))
    if train_qat and quant_bits:
        y = fake_quant(y, A4 if quant_bits == 4 else A8)
    return y


def _bn_only(p, x):
    inv = p["bn_gamma"] / sqrt_rn(p["bn_var"] + 1e-5)
    return x * inv + (p["bn_beta"] - p["bn_mean"] * inv)


def forward(params: dict, cfg: MobileNetConfig, x: torch.Tensor,
            train_qat: Optional[bool] = None) -> torch.Tensor:
    """x [B, H, W, 3] -> logits [B, n_classes]."""
    train_qat = cfg.quant == "qat" if train_qat is None else train_qat
    fb, ib = cfg.first_last_bits, cfg.inner_bits
    x = _conv(params["stem"], x, 3, 2, False, fb, train_qat)
    x = _bn_relu6(params["stem"], x, fb, train_qat)
    for bi, (t, _, n, s) in enumerate(INVERTED_RESIDUAL_CFG):
        for i in range(n):
            stride = s if i == 0 else 1
            inp = x
            h = x
            if t != 1:
                name = f"b{bi}_{i}_expand"
                h = _bn_relu6(params[name],
                              _conv(params[name], h, 1, 1, False, ib,
                                    train_qat), ib, train_qat)
            name = f"b{bi}_{i}_dw"
            h = _bn_relu6(params[name],
                          _conv(params[name], h, 3, stride, True, ib,
                                train_qat), ib, train_qat)
            name = f"b{bi}_{i}_project"
            h = _bn_only(params[name],
                         _conv(params[name], h, 1, 1, False, ib, train_qat))
            if stride == 1 and inp.shape == h.shape:   # inverted residual
                h = h + inp
            x = h
    x = _bn_relu6(params["head"], _conv(params["head"], x, 1, 1, False, fb,
                                        train_qat), fb, train_qat)
    x = torch.mean(x, dim=(1, 2))
    return x @ params["fc"]["w"] + params["fc"]["b"]


def loss_fn(params: dict, cfg: MobileNetConfig, batch: dict) -> torch.Tensor:
    """Mean cross-entropy of ``batch["images"]`` against
    ``batch["labels"]`` (QAT when ``cfg.quant == "qat"``), the loss that
    ``train.step`` differentiates."""
    return nll(forward(params, cfg, batch["images"]), batch["labels"])
