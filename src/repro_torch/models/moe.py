"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing with
capacity-based dispatch into a fixed ``[E, C, d]`` buffer (routes past an
expert's capacity are dropped, GShard-style), the per-expert SwiGLU, a
gate-weighted combine, and the optional shared expert behind a sigmoid gate
(Qwen-MoE).

Everything is static shapes and device ops with no host read, so a decode
step that routes captures in a CUDA graph.  Two rules keep a replayed round
bitwise stable: no float atomics (the dispatch writes each kept (expert,
position) pair once with a plain ``index_put_``, the dropped routes land on
a scratch row that is sliced off, and the combine sums a token's k slots in
slot order), and ties in the top-k go to the lower expert index (a stable
descending sort, as ``jax.lax.top_k``).

Serving banks are ``{"w_q": [E, K//2, N] uint8 nibbles | [E, K, N] int8,
"w_scale": [E, 1, N] float32}`` (``serve.quantize``'s ``_MOE_W``).
:func:`expert_matmul` quantizes the whole dispatch buffer once with the
reference's own activation quantizer and, on the kernel backend, launches
one kernel per expert on that expert's codes where they lie: the LUT kernel
(``csrc/lutmul.cu``) for nibble banks, the int8 kernel
(``csrc/int_matmul.cu``) for int8 banks, fused or unfused as
``ops.pick_variant`` says.  The plain version (:func:`expert_matmul_ref`,
the ``ref`` backend) takes the same int32 products in float64.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import tp as tp_lib
from repro_torch.dist.sharding import constrain
from repro_torch.models.layers import (Params, init_linear, init_mlp, linear,
                                       mlp)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert ff
    capacity_factor: float = 1.25
    shared_ff: int = 0             # 0 = no shared expert branch
    norm_topk: bool = True
    router_aux_weight: float = 0.01
    dispatch: str = "global"       # global (one buffer over every token) |
                                   # grouped (each batch row its own group)


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32, device=None) -> Params:
    """Router [d, E], expert banks ``wi``/``wg`` [E, d, F] and ``wo`` [E,
    F, d], and with ``shared_ff`` the shared SwiGLU and its gate [d, 1]."""
    E, F_ = cfg.n_experts, cfg.d_ff
    kw = dict(dtype=dtype, device=device)

    def bank(shape, s):
        return torch.randn(shape, generator=gen, **kw).mul_(s)

    p = {"router": init_linear(gen, d_model, E, **kw),
         "wi": bank((E, d_model, F_), 1.0 / math.sqrt(d_model)),
         "wg": bank((E, d_model, F_), 1.0 / math.sqrt(d_model)),
         "wo": bank((E, F_, d_model), 1.0 / math.sqrt(F_))}
    if cfg.shared_ff:
        p["shared"] = init_mlp(gen, d_model, cfg.shared_ff, **kw)
        p["shared_gate"] = init_linear(gen, d_model, 1, **kw)
    return p


# ---------------------------------------------------------------------------
# the expert product
# ---------------------------------------------------------------------------

def quantize_experts(a: torch.Tensor, qmax: int):
    """The reference's expert activation quantizer (``_expert_einsum``),
    per row of a [E, C, d] buffer: ``a_scale = max(max|a.f32|, 1e-8) /
    qmax`` in float32, codes ``clip(round(a / a_scale.astype(a.dtype)),
    -qmax - 1, qmax)`` with the division in a's dtype (bf16 when serving).
    Both divisions are by device tensors (CUDA turns a division by a Python
    number into a reciprocal multiply).  Returns (int8 codes, float32
    [E, C, 1] scales)."""
    amax = torch.amax(torch.abs(a.to(torch.float32)), dim=-1, keepdim=True)
    a_scale = torch.clamp_min(amax, 1e-8) / torch.full(
        (), float(qmax), dtype=torch.float32, device=a.device)
    a_q = torch.clamp(torch.round(a / a_scale.to(a.dtype)), -qmax - 1,
                      qmax).to(torch.int8)
    return a_q, a_scale


def _bank_codes(w: dict) -> torch.Tensor:
    """The int8 codes [E, K, N] of a serving bank (nibbles unpacked)."""
    from repro_torch.kernels.lutmul.ops import _unpack_w
    if w["w_q"].dtype == torch.uint8:            # packed int4
        return _unpack_w(w["w_q"])
    return w["w_q"]


def expert_matmul_ref(a_q: torch.Tensor, a_scale: torch.Tensor, w: dict,
                      compute_dtype) -> torch.Tensor:
    """Plain version of :func:`expert_matmul` after the quantizer: the
    int32 products ``einsum('ecd,edf->ecf')`` of the codes, exact in
    float64, then ``(acc.f32 * a_scale) * w_scale`` in ``compute_dtype``."""
    from repro_torch.kernels.lutmul import ref
    w_int = _bank_codes(w)
    acc = (a_q.to(torch.float64) @ w_int.to(torch.float64)).to(torch.int32)
    return ref.dequant_epilogue(acc, a_scale, w["w_scale"], compute_dtype)


def _expert_kernels(a_q: torch.Tensor, a_scale: torch.Tensor, w: dict,
                    compute_dtype, fused: bool) -> torch.Tensor:
    """One kernel launch per expert on its own codes: the LUT kernel on a
    nibble bank, the int8 kernel on an int8 bank."""
    from repro_torch.kernels.lutmul import kernel, ref
    w_q, w_scale = w["w_q"], w["w_scale"]
    if w_q.dtype == torch.uint8:
        launch = kernel.lutmul_experts
        a_q = a_q.view(torch.uint8) & 0xF        # 4-bit two's complement
    else:
        launch = kernel.int_matmul_experts
    if fused:
        return launch(a_q, w_q, a_scale, w_scale, out_dtype=compute_dtype)
    return ref.dequant_epilogue(launch(a_q, w_q), a_scale, w_scale,
                                compute_dtype)


def expert_matmul(a: torch.Tensor, w, compute_dtype,
                  backend: Optional[str] = None) -> torch.Tensor:
    """``einsum('ecd,edf->ecf')`` of the dispatch buffer a [E, C, d] with a
    float bank [E, d, F] (in ``compute_dtype``) or a serving bank (the
    port of ``_expert_einsum``): the buffer quantized once
    (:func:`quantize_experts`, qmax 7 for nibbles, 127 for int8), then the
    kernels (``cuda`` backend) or the plain version (``ref``).  The kernels
    never give way to the plain version: one that fails raises."""
    if not isinstance(w, dict):
        return torch.matmul(a, w.to(compute_dtype))
    from repro_torch.kernels.lutmul import ops
    qmax = 7 if w["w_q"].dtype == torch.uint8 else 127
    a_q, a_scale = quantize_experts(a, qmax)
    be = backend or ops.get_backend()
    if be == "ref":
        return expert_matmul_ref(a_q, a_scale, w, compute_dtype)
    op = ("lutmul_experts" if w["w_q"].dtype == torch.uint8
          else "int_matmul_experts")
    fused = ops.pick_variant(op, a_q.shape[-2], a_q.shape[-1],
                             w["w_q"].shape[-1], be) == "fused"
    return _expert_kernels(a_q.contiguous(), a_scale, w, compute_dtype,
                           fused)


# ---------------------------------------------------------------------------
# routing, dispatch, combine
# ---------------------------------------------------------------------------

def route(p: Params, xf: torch.Tensor, cfg: MoEConfig, C: int):
    """Routing of G groups of T tokens, xf [G, T, d]: float32 router
    logits, softmax, the top k (ties to the lower index), optionally
    renormalized.  Returns (gates [G, T*k] float32, expert ids [G, T*k],
    positions within the expert [G, T*k] (an exclusive count in
    token-major order), keep = position < C, aux [G]: the Switch
    load-balancing loss ``w * E * sum_e f_e * P_e``)."""
    E, k = cfg.n_experts, cfg.top_k
    G, T, _ = xf.shape
    logits = linear(p["router"], xf.to(torch.float32), "none", torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # [G, T, E]
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[..., :k], ids[..., :k]
    if cfg.norm_topk:
        gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    experts = torch.arange(E, device=xf.device)
    me = torch.mean(probs, dim=1)
    ce = torch.mean((ids[..., :1] == experts).to(torch.float32), dim=1)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce, dim=-1)
    flat_e = ids.reshape(G, T * k)
    onehot = (flat_e[..., None] == experts).to(torch.int32)   # [G, T*k, E]
    pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2,
                       flat_e[..., None])[..., 0]
    return gates.reshape(G, T * k), flat_e, pos, pos < C, aux


def _dispatch_groups(p: Params, xf: torch.Tensor, cfg: MoEConfig, *,
                     quant: str, compute_dtype, C: int):
    """Capacity dispatch of G independent groups xf [G, T, d] (one for
    global dispatch, a batch row each for grouped): (y [G, T, d], aux [G]).
    The groups share each expert's launch: its rows are the G buffers'."""
    G, T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    cd = compute_dtype
    gates, flat_e, pos, keep, aux = route(p, xf, cfg, C)
    token_of = torch.arange(T * k, device=xf.device) // k
    grp = torch.arange(G, device=xf.device)[:, None].expand(G, T * k)
    # kept (group, expert, position) triples are unique; the dropped routes
    # all land on the scratch row C, sliced off below
    buf = torch.zeros((G, E, C + 1, d), dtype=cd, device=xf.device)
    buf.index_put_((grp, flat_e, torch.where(keep, pos, C)),
                   xf[:, token_of].to(cd))
    a = buf[:, :, :C].transpose(0, 1).reshape(E, G * C, d)
    # the reference constrains the flat (global) dispatch's buffers only
    flat = cfg.dispatch != "grouped"
    if flat:
        a = constrain(a, "expert", "moe_capacity", None)
    # expert-parallel banks (``tp_exp``, inside the sharded engine's
    # context) hold this rank's E/tp experts: only they run, on their rows
    # of the buffer, and an all_gather over the expert axis rebuilds the
    # output buffer, every element computed by one rank with the unsharded
    # per-expert math; the routing above ran on the replicated router
    exp_axis = (tp_lib.model_axis() if isinstance(p["wi"], dict)
                and "tp_exp" in p["wi"] else None)
    if exp_axis is not None:
        E_local = p["wi"]["w_q"].shape[0]
        a = a[exp_axis.index * E_local:(exp_axis.index + 1) * E_local]
    h = expert_matmul(a, p["wi"], cd)
    g = expert_matmul(a, p["wg"], cd)
    h = F.silu(g.to(torch.float32)).to(cd) * h
    if exp_axis is None and flat:
        h = constrain(h, "expert", "moe_capacity", "expert_mlp")
    out = expert_matmul(h, p["wo"], cd)                        # [E, G*C, d]
    if exp_axis is not None:
        out = tp_lib.all_gather(out, exp_axis, dim=0)
    elif flat:
        out = constrain(out, "expert", "moe_capacity", None)
    out = out.reshape(E, G, C, d).transpose(0, 1)              # [G, E, C, d]
    safe = torch.where(keep, pos, C - 1)
    gathered = torch.where(keep[..., None], out[grp, flat_e, safe], 0)
    contrib = (gathered.to(torch.float32)
               * gates[..., None]).reshape(G, T, k, d)
    yf = contrib[:, :, 0]
    for j in range(1, k):                       # the k slots in slot order
        yf = yf + contrib[:, :, j]
    y = yf.to(cd)
    if "shared" in p:
        sg = torch.sigmoid(linear(p["shared_gate"], xf.to(torch.float32),
                                  "none", torch.float32))
        y = y + (sg * mlp(p["shared"], xf, quant, cd).to(torch.float32)
                 ).to(cd)
    return y, aux


def capacity(cfg: MoEConfig, tokens: int, fixed: Optional[int] = None
             ) -> int:
    """An expert's rows in one routing group of ``tokens`` tokens:
    ``fixed`` when given, else ``max(1, int(T * k / E * cf))`` (global) or
    ``max(k, int(S * k / E * cf))`` (grouped), in the reference's Python
    arithmetic and order."""
    if fixed:
        return fixed
    k = cfg.top_k
    c = int(tokens * k / cfg.n_experts * cfg.capacity_factor)
    return max(k, c) if cfg.dispatch == "grouped" else max(1, c)


def expert_rows(cfg: MoEConfig, B: int, S: int,
                fixed: Optional[int] = None) -> int:
    """Rows M of each expert's launch in a forward over [B, S] tokens: the
    capacities of its routing groups (one of B*S tokens, or B of S)."""
    G, T = (B, S) if cfg.dispatch == "grouped" else (1, B * S)
    return G * capacity(cfg, T, fixed)


def decode_capacity(cfg: MoEConfig, batch: int) -> Optional[int]:
    """The reference's deterministic capacity of a decode step over
    ``batch`` rows (``det_cap``): ``max(1, int(B * k / E * cf) + 1)``
    under global dispatch (1 at qwen2-moe-a2.7b's 8 slots); None under
    grouped dispatch, whose rows each take :func:`capacity` of 1 token."""
    if cfg.dispatch != "global":
        return None
    return max(1, int(batch * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor) + 1)


def decode_rows(cfg: MoEConfig, batch: int) -> int:
    """Rows M of each expert's launch in a decode step over ``batch``
    rows."""
    return expert_rows(cfg, batch, 1, decode_capacity(cfg, batch))


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig, *,
            quant: str = "none", compute_dtype=torch.bfloat16,
            deterministic_capacity: Optional[int] = None):
    """x [B, S, d] -> (y [B, S, d], aux float32 scalar).

    ``dispatch="global"``: one routing group over all B*S tokens;
    ``"grouped"``: each batch row its own group (the reference's vmap).
    Capacity: :func:`capacity`, where ``deterministic_capacity`` is
    ``fixed``; aux the mean over the groups."""
    B, S, d = x.shape
    groups = x if cfg.dispatch == "grouped" else x.reshape(1, B * S, d)
    y, aux = _dispatch_groups(
        p, groups, cfg, quant=quant, compute_dtype=compute_dtype,
        C=capacity(cfg, groups.shape[1], deterministic_capacity))
    if cfg.dispatch == "grouped":
        y = constrain(y, "batch", None, None)
    return y.reshape(B, S, d), torch.mean(aux)
