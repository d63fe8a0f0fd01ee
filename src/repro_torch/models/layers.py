"""Layer primitives (port of ``repro.models.layers``): quantizable linears,
RMS norm (plain or gemma's zero-centered scale), layer norm, rotary
embeddings (standard and Qwen2-VL's M-RoPE), the SwiGLU, GeGLU and plain
GELU MLPs, gemma-2's logit soft-cap and the weight-code cache.

Parameters are plain dicts of tensors in the reference layout: a linear is
``{"w": [d_in, d_out]}`` (``x @ w``) with an optional ``"b"``, or its
serving form ``{"w_q", "w_scale"[, "w_tmac", "w_tern"][, "b"]}`` produced
by ``serve.quantize``; ``linear`` dispatches on the presence of ``w_q``.
Initializers take an explicit ``torch.Generator`` and device.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantization import A4, W4, fake_quant

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, dtype=torch.float32,
                device=None) -> Params:
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=device)
    p = {"w": w.mul_(1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_norm(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device=None) -> Params:
    emb = torch.randn((vocab, d), generator=gen, dtype=dtype, device=device)
    return {"emb": emb.mul_(0.02)}


# ---------------------------------------------------------------------------
# quantizable linear
# ---------------------------------------------------------------------------

def linear(p: Params, x: torch.Tensor, quant: str = "none",
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense projection with a selectable quantization mode: ``"none"``
    (the float matmul in ``compute_dtype``), ``"qat"`` (W4A4 fake
    quantization in float32, the training path) or a kernel mode
    (``ops.quantized_matmul`` re-quantizes ``w`` every call).

    A leaf carrying serving codes (``w_q`` + ``w_scale``) always takes the
    integer path — weights are read from device memory as codes.  A tmac
    bitplane leaf (``w_tmac`` marker) takes its weight spec from itself —
    its plane count, or ternary when it carries ``w_tern`` — and only the
    activation bits from ``quant``, so a drafter's truncated view of a
    ``w4a4_tmac`` leaf runs as ``w2a4_tmac``.  A leaf marked by
    ``dist.tp.mark_tp_params`` passes its layout on (inert outside the
    sharded engine's context); its bias is added after the gather or the
    reduce, or to the local columns of a head-parallel leaf.
    """
    from repro_torch.dist.tp import leaf_tp_mode
    from repro_torch.kernels.lutmul import ops as lut_ops
    if "w_q" in p:
        mode = quant
        if "w_tmac" in p:
            try:
                abits = lut_ops.parse_mode(quant)[2]
            except ValueError:
                abits = 4
            mode = (f"ternary_a{abits}_tmac" if "w_tern" in p
                    else f"w{p['w_q'].shape[0]}a{abits}_tmac")
        y = lut_ops.prequant_matmul(x, p["w_q"], p["w_scale"], mode=mode,
                                    compute_dtype=compute_dtype,
                                    tp=leaf_tp_mode(p))
    elif quant == "none":
        y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    elif quant == "qat":
        # W4A4 fake quantization, straight through (paper Sec. 3.6): the
        # weight per output channel; the activation's positive part as
        # uint4 codes (threshold units emit unsigned codes), its negative
        # part passed on for the gradient of pre-activation values
        xf = x.to(torch.float32)
        pos = torch.relu(xf)
        wq = fake_quant(p["w"].to(torch.float32), W4)
        xq = fake_quant(pos, A4) + (xf - pos)
        y = (xq @ wq).to(compute_dtype)
    else:
        lut_ops.parse_mode(quant)   # raises with the mode grammar on typos
        y = lut_ops.quantized_matmul(x, p["w"], mode=quant,
                                     compute_dtype=compute_dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[label]`` over every position,
    in float32 (every model's training loss)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# norm + rotary embeddings
# ---------------------------------------------------------------------------

# ATen's CUDA reduction lays its threads out by how many outputs a call
# has, up to 16 (fewer outputs, more threads on each), so a norm's sum over
# d takes other bits in a call of fewer than 16 rows than in a larger one
# (seen on the card: a data shard's rows of a split-head model parted from
# the whole batch's; ``scripts/sharded_costs.py norm``).  On the card the
# norms reduce over at least ``_MIN_ROWS`` rows, zero rows padded in.
_MIN_ROWS = 16


def _rows_padded(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` of a reduction over the last axis (keepdim), with at least
    ``_MIN_ROWS`` rows in the call on the card."""
    rows = x.numel() // x.shape[-1]
    if not x.is_cuda or rows >= _MIN_ROWS:
        return fn(x)
    x2 = x.reshape(rows, x.shape[-1])
    x2 = torch.cat([x2, x2.new_zeros((_MIN_ROWS - rows, x2.shape[1]))])
    return fn(x2)[:rows].reshape(x.shape[:-1] + (1,))


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x, -1, keepdim=True)``, each row's bits independent of
    the call's rows on the card."""
    return _rows_padded(lambda t: torch.mean(t, dim=-1, keepdim=True), x)


def row_var(x: torch.Tensor) -> torch.Tensor:
    """The population variance over the last axis (keepdim), each row's
    bits independent of the call's rows on the card."""
    return _rows_padded(lambda t: torch.var(t, dim=-1, keepdim=True,
                                            unbiased=False), x)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = row_mean(xf * xf)
    xf = xf * torch.rsqrt(var + eps)
    scale = p["scale"].to(torch.float32)
    if zero_centered:          # gemma-style (1 + scale)
        scale = 1.0 + scale
    return (xf * scale).to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with the population variance, times ``scale``
    plus the optional ``bias``, in x's dtype."""
    xf = x.to(torch.float32)
    mu = row_mean(xf)
    var = row_var(xf)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    if "bias" in p:
        out = out + p["bias"].to(torch.float32)
    return out.to(x.dtype)


_FREQS: dict[tuple, torch.Tensor] = {}


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """[head_dim/2] float32 inverse frequencies (computed on the CPU, so
    every device sees the same values)."""
    key = (head_dim, float(theta), str(device))
    f = _FREQS.get(key)
    if f is None:
        f = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                          dtype=torch.float32) / head_dim))
        f = f.to(device) if device is not None else f
        _FREQS[key] = f
    return f


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S] int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs     # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_MROPE_IDS: dict[tuple, torch.Tensor] = {}


def _mrope_ids(sections: tuple, half: int, device) -> torch.Tensor:
    """[half] component (0, 1, 2) of each frequency channel, made on the
    CPU once per device (a round's capture copies nothing from the host)."""
    key = (sections, half, str(device))
    ids = _MROPE_IDS.get(key)
    if ids is None:
        ids = torch.repeat_interleave(torch.arange(len(sections)),
                                      torch.tensor(sections))[:half]
        if ids.numel() < half:
            ids = torch.cat([ids, ids[-1:].expand(half - ids.numel())])
        ids = _MROPE_IDS[key] = (ids % 3).to(device)
    return ids


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple, theta: float = 1_000_000.0) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x [B, S, H, D]; positions [B, S, 3]
    (temporal, height, width ids).  ``sections`` splits the D/2 frequency
    channels among the three components in order (the last one repeated
    to fill D/2, or cut, as ``jnp.repeat(..., total_repeat_length=)``),
    channel j takes component ``id % 3`` of its position as float32, then
    the rotation is :func:`apply_rope`'s.  With equal t/h/w ids every
    channel's angle is ``apply_rope``'s, bit for bit."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ids = _mrope_ids(tuple(sections), x.shape[-1] // 2, x.device)
    pos = positions.to(torch.float32).index_select(-1, ids)   # [B, S, D/2]
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rotate(x: torch.Tensor, positions: torch.Tensor, rope_mode: str,
           theta: float, sections: tuple = (),
           mrope_positions=None) -> torch.Tensor:
    """The rotation of ``rope_mode``: ``"rope"`` at ``positions`` [B, S],
    ``"mrope"`` at ``mrope_positions`` [B, S, 3] (``positions`` in all
    three components when None), ``"none"`` leaves x as it is."""
    if rope_mode == "mrope":
        if mrope_positions is None:
            mrope_positions = positions[..., None].expand(
                tuple(positions.shape) + (3,))
        return apply_mrope(x, mrope_positions, sections, theta)
    if rope_mode == "rope":
        return apply_rope(x, positions, theta)
    return x


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32,
             device=None, kind: str = "swiglu") -> Params:
    """MLP weights: ``wi``, ``wg`` and ``wo`` for the gated kinds (SwiGLU,
    GeGLU), ``wi`` and ``wo`` for the plain GELU MLP."""
    kw = dict(dtype=dtype, device=device)
    if kind == "gelu":
        return {"wi": init_linear(gen, d, d_ff, **kw),
                "wo": init_linear(gen, d_ff, d, **kw)}
    return {"wi": init_linear(gen, d, d_ff, **kw),
            "wg": init_linear(gen, d, d_ff, **kw),
            "wo": init_linear(gen, d_ff, d, **kw)}


_SQRT_2_OVER_PI = float(np.float32(math.sqrt(2.0 / math.pi)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in its own op order, in x's
    dtype.  Not ``F.gelu``: ATen's CPU kernel rounds the elements of a
    tensor's scalar tail differently from its vectorized body, so the same
    value gets other bits in a prefill and a decode tensor; ``tanh``,
    products and sums give every element the same bits whatever the
    shape."""
    inner = _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp(p: Params, x: torch.Tensor, quant: str = "none",
        compute_dtype=torch.bfloat16, kind: str = "swiglu") -> torch.Tensor:
    """``wo(act(wg x) * wi x)``: SwiGLU (``silu``) or GeGLU (tanh GeLU);
    ``kind="gelu"`` is the plain ``wo(gelu_tanh(wi x))`` (whisper)."""
    if kind == "gelu":
        h = gelu_tanh(linear(p["wi"], x, quant, compute_dtype))
        return linear(p["wo"], h, quant, compute_dtype)
    g = linear(p["wg"], x, quant, compute_dtype)
    if kind == "swiglu":
        g = F.silu(g)
    elif kind == "geglu":
        g = gelu_tanh(g)
    else:
        raise ValueError(kind)
    h = g * linear(p["wi"], x, quant, compute_dtype)
    return linear(p["wo"], h, quant, compute_dtype)


def stable_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh through exp, as the reference's: ``sign(x) * (1 - e) / (1 +
    e)`` with ``e = exp(-2|x|)`` (the exponent is never positive).  The
    reference routes tanh this way because exp's bits do not depend on the
    tensor's shape, so prefill and decode agree."""
    e = torch.exp(-2.0 * torch.abs(x))
    return torch.sign(x) * (1.0 - e) / (1.0 + e)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping, ``cap * tanh(x / cap)`` in float32, in
    x's dtype.  The division is by a device scalar: CUDA turns a division
    by a Python number into a reciprocal multiply."""
    xf = x.to(torch.float32)
    c = torch.full((), cap, dtype=torch.float32, device=x.device)
    return (cap * stable_tanh(xf / c)).to(x.dtype)


# ---------------------------------------------------------------------------
# weight-code caching
# ---------------------------------------------------------------------------

class QuantizedLinear:
    """A linear layer that quantizes + packs its weight codes ONCE at
    construction; every call then takes ``prequant_matmul`` and performs no
    weight quantization (``ops.WEIGHT_QUANT_COUNT`` stays put)."""

    def __init__(self, p: Params, mode: str = "w4a4_mxu"):
        from repro_torch.kernels.lutmul import ops as lut_ops
        if mode in ("none", "qat"):
            raise ValueError(
                f"unsupported quant mode {mode!r}: QuantizedLinear caches "
                "integer serving codes; float/QAT paths use layers.linear")
        lut_ops.parse_mode(mode)             # raises on unknown modes
        self.mode = mode
        if "w_q" in p:                       # already serving codes
            self.p = dict(p)
        else:
            from repro_torch.serve.quantize import quantize_leaf_mode
            self.p = quantize_leaf_mode(p["w"], mode)
            if "b" in p:
                self.p["b"] = p["b"]

    @property
    def params(self) -> Params:
        return self.p

    def __call__(self, x: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
        return linear(self.p, x, quant=self.mode,
                      compute_dtype=compute_dtype)
