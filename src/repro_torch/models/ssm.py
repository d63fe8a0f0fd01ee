"""State-space and linear-recurrence blocks (port of ``repro.models.ssm``):
Mamba2 (SSD, chunked) and RWKV6 ("Finch"), full sequence and one token.

The full-sequence forms are the reference's chunked formulation: within a
chunk the interactions are dense products (``torch.einsum``), across
chunks a Python loop carries the state (the reference's ``lax.scan``).
The decode forms carry explicit recurrent state, O(1) a token.  Every
projection goes through ``layers.linear``, so under a serving mode the
LUT kernel runs them; the RWKV decay's low-rank ``w_lora_a/b`` products
stay float32 matrix products, as in the reference.

Float details kept from the reference: ``softplus`` is ``logaddexp(x,
0)`` (``jax.nn.softplus``), not ATen's thresholded ``log1p(exp(x))``; the
causal convolution accumulates its taps in float32 in tap order and rounds
once to the input dtype before the bias, as XLA's bf16 einsum does; the
group norms take the population variance.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, init_linear, linear

D_CONV = 4                # taps of Mamba2's causal convolution


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    (NaN stays NaN, +inf stays inf)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def init_mamba2(gen: torch.Generator, d_model: int, d_inner: int,
                d_state: int, n_heads: int, d_conv: int = D_CONV,
                dtype=torch.float32, device=None) -> Params:
    """``in_proj`` [d, 2 d_inner + 2 N + H] (order z, x, B, C, dt), the
    depthwise conv [d_conv, d_inner + 2 N] and its bias, ``A_log`` (log 1..H,
    float32), ``D``, ``dt_bias``, ``out_proj`` and the gated norm's scale."""
    kw = dict(dtype=dtype, device=device)
    conv_c = d_inner + 2 * d_state
    return {
        "in_proj": init_linear(gen, d_model,
                               2 * d_inner + 2 * d_state + n_heads, **kw),
        "conv_w": torch.randn((d_conv, conv_c), generator=gen,
                              **kw).mul_(0.1),
        "conv_b": torch.zeros((conv_c,), **kw),
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((n_heads,), **kw),
        "dt_bias": torch.zeros((n_heads,), **kw),
        "out_proj": init_linear(gen, d_inner, d_model, **kw),
        "norm_scale": torch.ones((d_inner,), **kw),
    }


def _pick_chunk(T: int, target: int) -> int:
    """Largest divisor of T not exceeding target."""
    c = min(target, T)
    while T % c:
        c -= 1
    return c


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x [B, T, C]; w [K, C]; ``state``
    [B, K - 1, C] (the previous inputs; zeros when None).  Returns (y
    [B, T, C] in x's dtype, the new state: the last K - 1 inputs)."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], 1)
    wf = _f32(w.to(x.dtype))
    acc = _f32(xp[:, 0:T]) * wf[0]
    for k in range(1, K):
        acc = acc + _f32(xp[:, k:k + T]) * wf[k]
    y = acc.to(x.dtype) + b.to(x.dtype)
    return y, (xp[:, -(K - 1):] if K > 1 else None)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor):
    """Mamba2's norm-before-gate: RMS norm (eps 1e-6) times ``scale``, then
    times ``silu(z)``, in float32."""
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * _f32(scale)
    return y * F.silu(_f32(z))


def _split_in_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int,
                   n_heads: int):
    return torch.split(zxbcdt, [d_inner, d_inner, d_state, d_state,
                                n_heads], dim=-1)


def mamba2(p: Params, x: torch.Tensor, *, d_inner: int, d_state: int,
           n_heads: int, chunk: int = 128, quant: str = "none",
           compute_dtype=torch.bfloat16, return_state: bool = False):
    """Full-sequence Mamba2 (prefill).  x [B, T, d_model]; with
    ``return_state`` also the final :class:`Mamba2State` (a prompt shorter
    than ``D_CONV - 1`` tokens leaves a shorter conv tail, as in the
    reference)."""
    B, T, _ = x.shape
    head_p = d_inner // n_heads
    z, xs, Bc, Cc, dt = _split_in_proj(
        linear(p["in_proj"], x, quant, compute_dtype), d_inner, d_state,
        n_heads)
    conv_in = torch.cat([xs, Bc, Cc], -1)
    conv_out, _ = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    conv_tail = conv_in[:, T - (p["conv_w"].shape[0] - 1):]
    xs, Bc, Cc = torch.split(F.silu(conv_out), [d_inner, d_state, d_state],
                             dim=-1)
    xs = xs.reshape(B, T, n_heads, head_p)
    dt = softplus(_f32(dt) + _f32(p["dt_bias"]))                  # [B,T,H]
    a = -torch.exp(_f32(p["A_log"]))                               # [H]
    y, h_final = _ssd_chunked(_f32(xs), dt, a, _f32(Bc), _f32(Cc),
                              chunk=_pick_chunk(T, chunk))
    y = y + _f32(xs) * _f32(p["D"])[None, None, :, None]
    y = _gated_norm(y.reshape(B, T, d_inner), z, p["norm_scale"])
    out = linear(p["out_proj"], y.to(compute_dtype), quant, compute_dtype)
    if return_state:
        return out, Mamba2State(h=h_final, conv=conv_tail)
    return out


def _ssd_chunked(xs, dt, a, Bc, Cc, chunk: int):
    """SSD: ``h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t .
    h_t``.  xs [B, T, H, P], dt [B, T, H], a [H], Bc / Cc [B, T, N], all
    float32.  Returns (y [B, T, H, P], the final state [B, H, N, P])."""
    B, T, H, P = xs.shape
    N = Bc.shape[-1]
    nc = T // chunk
    xs = xs.reshape(B, nc, chunk, H, P)
    dt = dt.reshape(B, nc, chunk, H)
    Bc = Bc.reshape(B, nc, chunk, N)
    Cc = Cc.reshape(B, nc, chunk, N)
    cum = torch.cumsum(a[None, None, None, :] * dt, dim=2)   # inclusive
    # intra-chunk: M[t, s] = exp(cum_t - cum_s) (C_t . B_s) dt_s, s <= t
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,nc,t,s,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xs.device))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bgtn,bgsn->bgts", Cc, Bc)
    M = cb[..., None] * decay * dt[:, :, None, :, :]
    y_intra = torch.einsum("bgtsh,bgshp->bgthp", M, xs)
    # each chunk's contribution to the state, and its decay
    last = cum[:, :, -1:, :]                                 # [B,nc,1,H]
    k_fac = torch.exp(last - cum) * dt                       # [B,nc,c,H]
    chunk_state = torch.einsum("bgcn,bgch,bgchp->bghnp", Bc, k_fac, xs)
    chunk_decay = torch.exp(last[:, :, 0, :])                # [B,nc,H]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=xs.device)
    h_prevs = []                                 # the state entering chunk g
    for g in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, g, :, None, None] + chunk_state[:, g]
    y_inter = torch.einsum("bgtn,bgth,bghnp->bgthp", Cc, torch.exp(cum),
                           torch.stack(h_prevs, 1))
    return (y_intra + y_inter).reshape(B, T, H, P), h


class Mamba2State(NamedTuple):
    h: torch.Tensor       # [B, H, N, P] float32 ssm state
    conv: torch.Tensor    # [B, D_CONV - 1, d_inner + 2N] conv tail


def mamba2_decode(p: Params, x: torch.Tensor, state: Mamba2State, *,
                  d_inner: int, d_state: int, n_heads: int,
                  quant: str = "none", compute_dtype=torch.bfloat16):
    """One token.  x [B, 1, d_model].  Returns (out, the new state)."""
    B = x.shape[0]
    head_p = d_inner // n_heads
    z, xs, Bc, Cc, dt = _split_in_proj(
        linear(p["in_proj"], x, quant, compute_dtype), d_inner, d_state,
        n_heads)
    conv_out, conv_state = _causal_conv(torch.cat([xs, Bc, Cc], -1),
                                        p["conv_w"], p["conv_b"], state.conv)
    xs, Bc, Cc = torch.split(F.silu(conv_out), [d_inner, d_state, d_state],
                             dim=-1)
    xs = _f32(xs.reshape(B, n_heads, head_p))
    Bc, Cc = _f32(Bc[:, 0]), _f32(Cc[:, 0])                        # [B, N]
    dt = softplus(_f32(dt[:, 0]) + _f32(p["dt_bias"]))             # [B, H]
    a = -torch.exp(_f32(p["A_log"]))
    decay = torch.exp(a[None] * dt)
    h = state.h * decay[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bc, dt, xs)
    y = torch.einsum("bn,bhnp->bhp", Cc, h)
    y = y + xs * _f32(p["D"])[None, :, None]
    y = _gated_norm(y.reshape(B, 1, d_inner), z, p["norm_scale"])
    out = linear(p["out_proj"], y.to(compute_dtype), quant, compute_dtype)
    return out, Mamba2State(h=h, conv=conv_state)


# ===========================================================================
# RWKV6 ("Finch"): data-dependent per-channel decay
# ===========================================================================

def init_rwkv6(gen: torch.Generator, d_model: int, n_heads: int,
               decay_lora: int = 64, dtype=torch.float32,
               device=None) -> Params:
    """The time mix: token-shift mixes ``mu`` [5, d] (r, k, v, g, w), the
    ``wr/wk/wv/wg/wo`` projections, the base decay ``w0``, its low-rank
    data-dependent part ``w_lora_a/b``, the bonus ``u`` [H, K] and the
    group norm's scale."""
    kw = dict(dtype=dtype, device=device)
    K = d_model // n_heads

    def normal(shape, s):
        return torch.randn(shape, generator=gen, **kw).mul_(s)
    return {
        "mu": torch.rand((5, d_model), generator=gen, **kw),
        "wr": init_linear(gen, d_model, d_model, **kw),
        "wk": init_linear(gen, d_model, d_model, **kw),
        "wv": init_linear(gen, d_model, d_model, **kw),
        "wg": init_linear(gen, d_model, d_model, **kw),
        "w0": torch.full((d_model,), -6.0, **kw),
        "w_lora_a": normal((d_model, decay_lora), 0.01),
        "w_lora_b": normal((decay_lora, d_model), 0.01),
        "u": normal((n_heads, K), 0.1),
        "wo": init_linear(gen, d_model, d_model, **kw),
        "ln_scale": torch.ones((d_model,), **kw),
    }


def _rwkv_projections(p: Params, x, x_prev, quant, compute_dtype):
    """Token-shifted projections.  x, x_prev [B, T, d] (x_prev: the
    previous token's input).  Returns r, k, v, g and the log decay
    (float32, < 0)."""
    mu = _f32(p["mu"])
    xf, xpf = _f32(x), _f32(x_prev)

    def mix(i):
        return (xf + (xpf - xf) * mu[i]).to(compute_dtype)
    r = linear(p["wr"], mix(0), quant, compute_dtype)
    k = linear(p["wk"], mix(1), quant, compute_dtype)
    v = linear(p["wv"], mix(2), quant, compute_dtype)
    g = linear(p["wg"], mix(3), quant, compute_dtype)
    dd = torch.tanh(_f32(mix(4)) @ _f32(p["w_lora_a"])) @ _f32(p["w_lora_b"])
    return r, k, v, g, -torch.exp(_f32(p["w0"]) + dd)


def _group_norm_gate(y: torch.Tensor, g: torch.Tensor, p: Params,
                     shape: tuple) -> torch.Tensor:
    """Per-head group norm (population variance, eps 64e-5) over y's last
    axis, reshaped to ``shape``, times ``ln_scale`` and ``silu(g)``."""
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(shape)
    return y * _f32(p["ln_scale"]) * F.silu(_f32(g))


def rwkv6_timemix(p: Params, x: torch.Tensor, *, n_heads: int,
                  chunk: int = 32, quant: str = "none",
                  compute_dtype=torch.bfloat16, return_state: bool = False):
    """Full-sequence WKV6 in chunks of ``_pick_chunk(T, chunk)``.  x [B, T,
    d]; with ``return_state`` also (S [B, H, K, K] float32, x[:, -1:])."""
    B, T, d = x.shape
    K = d // n_heads
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, logw = _rwkv_projections(p, x, x_prev, quant, compute_dtype)
    chunk = _pick_chunk(T, chunk)
    nc = T // chunk
    rh, kh, vh, wh = (_f32(t).reshape(B, nc, chunk, n_heads, K)
                      for t in (r, k, v, logw))
    u = _f32(p["u"])
    cum = torch.cumsum(wh, dim=2)                  # inclusive log-decay sums
    # intra-chunk pairs: A[t, s] = sum_k r_t k_s exp(cum_{t-1} - cum_s), s < t
    cprev = cum - wh                               # cum_{t-1} (exclusive)
    diff = cprev[:, :, :, None] - cum[:, :, None, :]    # [B,nc,t,s,H,K]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device), diagonal=-1)
    dec = torch.where(mask[None, None, :, :, None, None], torch.exp(diff),
                      0.0)
    A = torch.einsum("bgthk,bgtshk,bgshk->bgtsh", rh, dec, kh)
    diag = torch.einsum("bgthk,hk,bgthk->bgth", rh, u, kh)
    eye = torch.eye(chunk, dtype=torch.float32, device=x.device)
    A = A + eye[None, None, :, :, None] * diag[:, :, :, None, :]
    y_intra = torch.einsum("bgtsh,bgshv->bgthv", A, vh)
    # across chunks: each chunk's state contribution and decay
    kfac = torch.exp(cum[:, :, -1:] - cum) * 1.0   # exp(cum_L - cum_s) <= 1
    chunk_state = torch.einsum("bgshk,bgshv->bghkv", kh * kfac, vh)
    chunk_decay = torch.exp(cum[:, :, -1])         # [B, nc, H, K]
    S = torch.zeros((B, n_heads, K, K), dtype=torch.float32, device=x.device)
    S_prevs = []                                   # the state entering chunk g
    for gi in range(nc):
        S_prevs.append(S)
        S = S * chunk_decay[:, gi, ..., None] + chunk_state[:, gi]
    y_inter = torch.einsum("bgthk,bghkv->bgthv", rh * torch.exp(cprev),
                           torch.stack(S_prevs, 1))
    y = (y_intra + y_inter).reshape(B, T, n_heads, K)
    y = _group_norm_gate(y, g, p, (B, T, d))
    out = linear(p["wo"], y.to(compute_dtype), quant, compute_dtype)
    if return_state:
        return out, (S, x[:, -1:])
    return out


class RWKVState(NamedTuple):
    S: torch.Tensor         # [B, H, K, V] float32
    x_prev_t: torch.Tensor  # [B, 1, d] the last input (time-mix shift)
    x_prev_c: torch.Tensor  # [B, 1, d] the last input (channel-mix shift)


def rwkv6_timemix_decode(p: Params, x: torch.Tensor, state: RWKVState, *,
                         n_heads: int, quant: str = "none",
                         compute_dtype=torch.bfloat16):
    """One token.  x [B, 1, d].  Returns (out, the state with the new S
    and ``x_prev_t = x``)."""
    B, _, d = x.shape
    K = d // n_heads
    r, k, v, g, logw = _rwkv_projections(p, x, state.x_prev_t, quant,
                                         compute_dtype)
    rh, kh, vh = (_f32(t).reshape(B, n_heads, K) for t in (r, k, v))
    wh = torch.exp(logw.reshape(B, n_heads, K))
    u = _f32(p["u"])
    kv = kh[..., :, None] * vh[..., None, :]              # [B, H, K, V]
    y = torch.einsum("bhk,bhkv->bhv", rh, state.S + u[None, :, :, None] * kv)
    S_new = state.S * wh[..., None] + kv
    y = _group_norm_gate(y, g, p, (B, 1, d))
    out = linear(p["wo"], y.to(compute_dtype), quant, compute_dtype)
    return out, state._replace(S=S_new, x_prev_t=x)


def init_rwkv6_chanmix(gen: torch.Generator, d_model: int, d_ff: int,
                       dtype=torch.float32, device=None) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {"mu": torch.rand((2, d_model), generator=gen, **kw),
            "wk": init_linear(gen, d_model, d_ff, **kw),
            "wv": init_linear(gen, d_ff, d_model, **kw),
            "wr": init_linear(gen, d_model, d_model, **kw)}


def rwkv6_chanmix(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
                  quant: str = "none",
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """RWKV6's channel mix: ``sigmoid(wr xr) * wv(relu(wk xk)^2)`` over the
    token-shifted mixes of x and x_prev."""
    mu = _f32(p["mu"])
    xf, xpf = _f32(x), _f32(x_prev)
    xk = (xf + (xpf - xf) * mu[0]).to(compute_dtype)
    xr = (xf + (xpf - xf) * mu[1]).to(compute_dtype)
    k = torch.square(F.relu(linear(p["wk"], xk, quant, compute_dtype)))
    kv = linear(p["wv"], k, quant, compute_dtype)
    gate = torch.sigmoid(_f32(linear(p["wr"], xr, quant, compute_dtype)))
    return gate.to(kv.dtype) * kv
