"""Decoder LM (port of ``repro.models.transformer``): ``embed -> layers
-> final_norm -> lm_head``.

Layers are a per-layer list (``params["blocks"][i]``), not the reference's
``[G, ...]`` stacks; layer ``i`` takes the block spec ``cfg.pattern[i %
len(cfg.pattern)]``, so layer ``g * len(pattern) + j`` is group ``g``'s
pattern position ``j`` (``convert.params_from_jax`` unstacks in that
order).  Gemma-2's features are here: local (sliding-window) layers beside
global ones, attention and final logit soft-caps, zero-centered norms with
post-attention and post-MLP norms, the embedding scaled by
``sqrt(d_model)`` and the GeGLU MLP.  A ``mlp="moe"`` block takes the
Mixture-of-Experts FFN (``models.moe``): ``forward`` sums its aux loss over
the layers, prefill routes with the capacity of all its tokens, and
``decode_step`` under global dispatch with the reference's deterministic
capacity ``max(1, int(B * k / E * cf) + 1)``, so every slot's row, a free
one's too, routes and competes for it.  The recurrent families
(``models.ssm``): a ``kind="mamba2"`` layer mixes with Mamba2's SSD, a
``kind="rwkv6"`` layer with RWKV6's time mix, ``mlp="rwkv_cm"`` is RWKV6's
channel mix and ``mlp="none"`` leaves the FFN out; ``norm="layernorm"``
takes the layer norm; a ``shared_attn`` layer first runs the one shared
block (zamba2: attention and a SwiGLU, ``params["shared_attn"]``).
``rope_mode="mrope"`` is Qwen2-VL's M-RoPE: ``forward`` and ``prefill``
take the stub vision frontend's ``embeddings`` [B, S, d] in place of the
token embedding and its 3-D ``mrope_positions`` [B, S, 3]; without them
every position rotates at its index in all three components, which is
RoPE bit for bit.  Whisper's encoder-decoder is ``models.encdec``.

The decode cache is a list of per-layer ``{"k", "v"}`` buffers ``[B, T,
n_kv, head_dim]`` that ``decode_step`` and ``verify_step`` update in
place, ``T = max_len`` for a global layer and the ring ``min(max_len,
window)`` for a local one, which decode addresses at ``pos % T``.  The
paged cache (``init_paged_cache``) is per-layer page pools ``[num_pages,
page_size, n_kv, head_dim]`` addressed through the ``(full, ring)`` page
tables those two take: global layers read the full table, local layers
their ring table.  ``prefill`` returns every layer's K/V at full length;
serving arranges the rings from them as it stitches (``generate`` through
:func:`_roll_local`).  With ``cfg.kv_quant == "int8"`` a global
attention layer's decode cache holds int8 ``k``/``v`` codes with float32
per-token-per-head ``k_scale``/``v_scale`` leaves (dense rows or page pools
alike), which ``decode_step`` reads through
``attention.decode_attention_int8``; a local layer's ring, the shared
block's K/V and recurrent state stay float, as the reference's; prefill
still returns the float K/V, which serving quantizes as it stitches them
into the live cache.  A recurrent layer's entry is its state
(``STATE_KEYS``: Mamba2's ``h`` and ``conv``, RWKV6's ``S``, ``xt`` and
``xc``), [B, ...] with no sequence axis, dense per slot even in a paged
cache, overwritten in place at every decode step; a ``shared_attn``
layer adds the shared block's ``shared_k``/``shared_v``, full length (or
pages of the full table).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import BlockSpec, ModelConfig
from repro_torch.core.device import resolve_device, seeded_generator
from repro_torch.dist.sharding import constrain
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (init_embedding, init_linear, init_mlp,
                                       init_norm, layer_norm, mlp, nll,
                                       rms_norm, softcap)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration features the port does not serve yet."""
    bad = []
    for spec in cfg.pattern:
        if spec.kind not in ("attn", "mamba2", "rwkv6"):
            bad.append(f"block kind {spec.kind!r}")
        if spec.mlp not in ("swiglu", "geglu", "gelu", "moe", "rwkv_cm",
                            "none"):
            bad.append(f"mlp {spec.mlp!r}")
        if spec.mlp == "moe" and (cfg.moe is None or cfg.moe.dispatch
                                  not in ("global", "grouped")):
            bad.append("mlp 'moe' without a global or grouped MoEConfig")
    for name, ok in (("rope_mode", cfg.rope_mode in ("rope", "mrope", "none")),
                     ("norm", cfg.norm in ("rmsnorm", "layernorm")),
                     ("enc_dec", not cfg.enc_dec),
                     ("kv_quant", cfg.kv_quant in ("none", "int8"))):
        if not ok:
            bad.append(name)
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(sorted(set(bad)))}")


def layer_spec(cfg: ModelConfig, i: int) -> BlockSpec:
    """Layer ``i``'s block spec: the pattern repeats over the layers."""
    return cfg.pattern[i % len(cfg.pattern)]


def is_local(cfg: ModelConfig, spec: BlockSpec) -> bool:
    """A sliding-window layer (its cache is a ring)."""
    return spec.attn_type == "local" and bool(cfg.window)


def cache_len(cfg: ModelConfig, spec: BlockSpec, max_len: int) -> int:
    """Positions a layer's dense cache holds: the ring ``min(max_len,
    window)`` of a local layer, else ``max_len``."""
    return min(max_len, cfg.window) if is_local(cfg, spec) else max_len


def _window(cfg: ModelConfig, spec: BlockSpec):
    return cfg.window if spec.attn_type == "local" else None


def _norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(p, x)
    return rms_norm(p, x, zero_centered=cfg.gemma_norms)


def _final_softcap(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return softcap(logits, cfg.final_softcap) if cfg.final_softcap \
        else logits


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               device) -> dict:
    """One layer's random parameters (the reference's ``_init_block``):
    norms, the attention, Mamba2 or RWKV6 time mix, and the MLP, MoE FFN or
    RWKV6 channel mix (none with ``mlp="none"``)."""
    kw = dict(dtype=cfg.pdtype, device=device)
    bp = {"ln1": init_norm(cfg.d_model, **kw)}
    if spec.kind == "attn":
        bp["attn"] = attn_lib.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
            cfg.qkv_bias, split_heads=cfg.split_head_params, **kw)
        if cfg.gemma_norms:
            bp["post_attn_ln"] = init_norm(cfg.d_model, **kw)
    elif spec.kind == "mamba2":
        bp["mamba"] = ssm_lib.init_mamba2(gen, cfg.d_model, cfg.d_inner,
                                          cfg.d_state, cfg.ssm_heads, **kw)
    else:
        bp["tmix"] = ssm_lib.init_rwkv6(gen, cfg.d_model, cfg.rwkv_heads,
                                        **kw)
    if spec.mlp == "none":
        return bp
    bp["ln2"] = init_norm(cfg.d_model, **kw)
    if spec.mlp == "moe":
        bp["moe"] = moe_lib.init_moe(gen, cfg.d_model, cfg.moe, **kw)
    elif spec.mlp == "rwkv_cm":
        bp["cmix"] = ssm_lib.init_rwkv6_chanmix(gen, cfg.d_model, cfg.d_ff,
                                                **kw)
    else:
        bp["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, kind=spec.mlp,
                             **kw)
        if cfg.gemma_norms:
            bp["post_mlp_ln"] = init_norm(cfg.d_model, **kw)
    return bp


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                block_hook=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (``"meta"``: the shapes alone, which is what
    ``roofline.analysis.plan_mixed_bits`` reads to plan a full-width model).
    ``block_hook(i, block)`` replaces layer ``i``'s parameters as soon as
    they are made (``serve.quantize.init_served_params`` quantizes them
    there, so the float tree is never whole).  A pattern with
    ``shared_attn`` adds the one shared block (zamba2: attention and a
    SwiGLU MLP, each behind its own norm)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = seeded_generator(dev, seed)
    kw = dict(dtype=cfg.pdtype, device=dev)
    blocks = []
    for i in range(cfg.n_layers):
        bp = init_block(gen, cfg, layer_spec(cfg, i), dev)
        blocks.append(bp if block_hook is None else block_hook(i, bp))
    params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, **kw),
              "blocks": blocks,
              "final_norm": init_norm(cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab, **kw)
    if any(spec.shared_attn for spec in cfg.pattern):
        params["shared_attn"] = {
            "ln": init_norm(cfg.d_model, **kw),
            "attn": attn_lib.init_attention(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                cfg.qkv_bias, **kw),
            "mlp_ln": init_norm(cfg.d_model, **kw),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)}
    return params


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------

def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           embeddings=None):
    """The token embedding of ``tokens`` or, when given, the frontend's
    ``embeddings`` [B, S, d] in the compute dtype; times sqrt(d_model)
    under ``embed_scale`` either way, as the reference's."""
    if embeddings is not None:
        x = embeddings.to(cfg.cdtype)
    elif torch.is_grad_enabled():
        # cast, then gather, as the reference: the table's gradient is
        # scatter-added in the compute dtype, then cast to the table's
        x = params["embed"]["emb"].to(cfg.cdtype)[tokens.long()]
    else:
        # gather, then cast: the reference's cast-then-gather's values
        # without converting the whole table every call
        x = params["embed"]["emb"][tokens.long()].to(cfg.cdtype)
    if cfg.embed_scale:         # gemma: times sqrt(d_model) in the dtype
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cfg.cdtype,
                           device=x.device)
    return x


def _lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final projection; tied embeddings or the (pre-quantized) head,
    vocab-column-parallel when the sharded engine marked it."""
    if cfg.tie_embeddings:
        return x @ params["embed"]["emb"].T.to(x.dtype)
    lh = params["lm_head"]
    if "w_q" in lh:
        from repro_torch.dist.tp import leaf_tp_mode
        from repro_torch.kernels.lutmul import ops as lut_ops
        return lut_ops.prequant_matmul(x, lh["w_q"], lh["w_scale"],
                                       mode=cfg.quant, compute_dtype=x.dtype,
                                       tp=leaf_tp_mode(lh))
    return x @ lh["w"].to(x.dtype)


def _mlp_tail(bp: dict, spec: BlockSpec, cfg: ModelConfig, x: torch.Tensor,
              norm=None, capacity=None):
    """(``x`` plus the block's MLP (and gemma's post-MLP norm) or MoE FFN,
    the MoE aux loss or None); ``norm`` normalizes (``_norm`` unless
    given), ``capacity`` is the MoE's deterministic capacity.  A block with
    ``mlp="none"`` adds nothing."""
    if spec.mlp == "none":
        return x, None
    norm = norm or (lambda p, v: _norm(p, v, cfg))
    h = norm(bp["ln2"], x)
    if spec.mlp == "moe":
        y, aux = moe_lib.moe_ffn(bp["moe"], h, cfg.moe, quant=cfg.quant,
                                 compute_dtype=cfg.cdtype,
                                 deterministic_capacity=capacity)
        return x + y, aux
    y = mlp(bp["mlp"], h, quant=cfg.quant, compute_dtype=cfg.cdtype,
            kind=spec.mlp)
    if cfg.gemma_norms:
        y = norm(bp["post_mlp_ln"], y)
    return x + y, None


def _shared_mlp(shared: dict, cfg: ModelConfig, x: torch.Tensor):
    """The shared block's tail: ``x`` plus its SwiGLU behind ``mlp_ln``."""
    h = _norm(shared["mlp_ln"], x, cfg)
    return x + mlp(shared["mlp"], h, quant=cfg.quant,
                   compute_dtype=cfg.cdtype)


def _block(bp: dict, spec: BlockSpec, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, shared=None, mrope_positions=None):
    """One layer over a full sequence: (x, the layer's decode-cache entry,
    the MoE aux or None).  The entry holds the attention K/V of the S
    positions, or the recurrent state after them (Mamba2 ``h`` and
    ``conv``; RWKV6 ``S``, ``xt`` and with the channel mix ``xc``), and on
    a ``shared_attn`` layer the shared block's ``shared_k``/``shared_v``
    (the shared block runs first, as the reference's).  ``mrope_positions``
    [B, S, 3] rotate the layer's attention under ``rope_mode="mrope"``."""
    cd = cfg.cdtype
    kw = dict(quant=cfg.quant, compute_dtype=cd)
    cache = {}
    if spec.shared_attn and shared is not None:
        h = _norm(shared["ln"], x, cfg)
        y, (sk, sv) = attn_lib.attention(
            shared["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            rope_mode=cfg.rope_mode, kv_block=cfg.kv_block, return_kv=True,
            **kw)
        x = _shared_mlp(shared, cfg, x + y)
        cache["shared_k"], cache["shared_v"] = sk.to(cd), sv.to(cd)
    h = _norm(bp["ln1"], x, cfg)
    if spec.kind == "attn":
        y, (k, v) = attn_lib.attention(
            bp["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.head_dim, window=_window(cfg, spec),
            logit_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
            rope_mode=cfg.rope_mode, mrope_sections=cfg.mrope_sections,
            mrope_positions=mrope_positions, kv_block=cfg.kv_block,
            return_kv=True, **kw)
        if cfg.gemma_norms:
            y = _norm(bp["post_attn_ln"], y, cfg)
        cache["k"], cache["v"] = k.to(cd), v.to(cd)
    elif spec.kind == "mamba2":
        y, st = ssm_lib.mamba2(bp["mamba"], h, d_inner=cfg.d_inner,
                               d_state=cfg.d_state, n_heads=cfg.ssm_heads,
                               return_state=True, **kw)
        cache["h"], cache["conv"] = st.h, st.conv.to(cd)
    else:
        y, (S, xlast) = ssm_lib.rwkv6_timemix(
            bp["tmix"], h, n_heads=cfg.rwkv_heads, chunk=cfg.rwkv_chunk,
            return_state=True, **kw)
        cache["S"], cache["xt"] = S, xlast.to(cd)
    x = x + y
    if spec.mlp == "rwkv_cm":
        h = _norm(bp["ln2"], x, cfg)
        h_prev = F.pad(h, (0, 0, 1, 0))[:, :-1]
        cache["xc"] = h[:, -1:].to(cd)
        x = x + ssm_lib.rwkv6_chanmix(bp["cmix"], h, h_prev, **kw)
        return constrain(x, "batch", "seq", None), cache, None
    x, aux = _mlp_tail(bp, spec, cfg, x)
    return constrain(x, "batch", "seq", None), cache, aux


def _remat_context(cfg: ModelConfig):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat == "dots"``: keep
    the outputs of the 2-D matrix products (the reference's
    ``dots_with_no_batch_dims_saveable``), recompute everything else."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _layers(params: dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor, mrope_positions=None):
    """Every layer over the full sequence: (x, the MoE aux losses summed
    in layer order).  Under autograd each pattern group (the reference's
    scan step) is rematerialized as ``cfg.remat`` says: ``"full"`` keeps
    only the group's input, ``"dots"`` also its matrix products,
    ``"none"`` everything; the values and gradients are the same bits."""
    from torch.utils.checkpoint import checkpoint
    P = len(cfg.pattern)
    blocks = params["blocks"]
    shared = params.get("shared_attn")

    def group(g: int, x: torch.Tensor, total: torch.Tensor):
        for i in range(g * P, min((g + 1) * P, len(blocks))):
            x, _, aux = _block(blocks[i], layer_spec(cfg, i), cfg, x,
                               positions, shared, mrope_positions)
            if aux is not None:
                total = total + aux
        return x, total

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    for g in range(-(-len(blocks) // P)):
        if remat == "none":
            x, total = group(g, x, total)
        elif remat == "full":
            x, total = checkpoint(group, g, x, total, use_reentrant=False)
        elif remat == "dots":
            x, total = checkpoint(group, g, x, total, use_reentrant=False,
                                  context_fn=lambda: _remat_context(cfg))
        else:
            raise ValueError(f"unknown remat {cfg.remat!r}: expected "
                             "'full', 'dots' or 'none'")
    return x, total


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor = None,
            embeddings: torch.Tensor = None, mrope_positions=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B, S, V] compute dtype, aux float32:
    the MoE layers' aux losses summed, 0.0 without any).  ``embeddings``
    [B, S, d] (the stub modality frontend's output) replace the token
    embedding; ``mrope_positions`` [B, S, 3] rotate under M-RoPE.  Under
    autograd the layers are rematerialized per ``cfg.remat``."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens, embeddings)
    B, S = x.shape[:2]
    positions = attn_lib.arange_positions(B, S, x.device)
    x = constrain(x, "batch", "seq", None)
    x, total = _layers(params, cfg, x, positions, mrope_positions)
    x = _norm(params["final_norm"], x, cfg)
    logits = constrain(_lm_head(params, cfg, x.to(cfg.cdtype)), "batch",
                       "seq", "vocab")
    return _final_softcap(logits, cfg), total


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Causal LM loss: the mean NLL of ``batch["labels"]`` [B, S] under
    the logits of ``batch["tokens"]`` [B, S] (or of the frontend's
    ``batch["embeddings"]``, rotated by ``batch["mrope_positions"]``), in
    float32, plus the MoE aux loss."""
    logits, aux = forward(params, cfg, batch.get("tokens"),
                          embeddings=batch.get("embeddings"),
                          mrope_positions=batch.get("mrope_positions"))
    return nll(logits, batch["labels"]) + aux


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor = None,
            length=None, embeddings: torch.Tensor = None,
            mrope_positions=None):
    """Forward that also returns the decode cache: (logits [B, V] float32
    at the last position, per-layer entries of :func:`_block`: float K/V of
    length S, or the recurrent state after the S tokens).  Local layers'
    K/V are full length too, as the reference's ``full_kv=True``:
    serving arranges the ring from the true prompt length
    (``engine._ring_from_full``), the static-batch oracle with
    :func:`_roll_local`.

    ``length`` ([B] or scalar int) takes each row's logits at ``length -
    1`` (clipped into [0, S - 1]) instead: right-padded rows and the dummy
    rows of a batched admission (pad tokens sit after the prompt, so the
    causal mask keeps them out of every real token).  A recurrent state
    integrates every token it is given, pads too: serving prefills those
    models at the prompts' exact length.  ``embeddings`` and
    ``mrope_positions``: as in :func:`forward`."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens, embeddings)
    B, S = x.shape[:2]
    positions = attn_lib.arange_positions(B, S, x.device)
    x = constrain(x, "batch", "seq", None)
    cache = []
    shared = params.get("shared_attn")
    for i, bp in enumerate(params["blocks"]):
        x, c, _ = _block(bp, layer_spec(cfg, i), cfg, x, positions, shared,
                         mrope_positions)
        cache.append(c)
    x = _norm(params["final_norm"], x, cfg)
    if length is None:
        xl = x[:, -1]
    else:
        last = torch.as_tensor(length, dtype=torch.int64, device=x.device)
        last = torch.clamp(last.reshape(-1).expand(B) - 1, 0, S - 1)
        xl = x.gather(1, last[:, None, None].expand(B, 1, x.shape[-1]))[:, 0]
    logits = _lm_head(params, cfg, xl.to(cfg.cdtype)).to(torch.float32)
    return _final_softcap(logits, cfg), cache


def _roll_local(k: torch.Tensor, S: int, W: int) -> torch.Tensor:
    """A prefill's full-length K or V [B, S, ...] as a W-slot ring where
    slot i holds the token whose position is i mod W (decode's rolling
    addressing): the last W tokens rolled by S mod W, or, when S < W, the S
    tokens zero-padded to W."""
    tail = k[:, max(0, S - W):]
    if S < W:
        pad = torch.zeros((k.shape[0], W - S) + tuple(k.shape[2:]),
                          dtype=k.dtype, device=k.device)
        return torch.cat([tail, pad], 1)
    return torch.roll(tail, S % W, dims=1)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

STATE_KEYS = ("h", "conv", "S", "xt", "xc")     # recurrent leaves
SHARED_KEYS = ("shared_k", "shared_v")


def _kv_leaves(cfg: ModelConfig, spec: BlockSpec, rows: tuple) -> dict:
    """An attention layer's decode-cache leaves over the leading shape
    ``rows``: (shape tail, dtype) by name — float ``k``/``v``, or on a
    global layer under ``kv_quant == "int8"`` int8 codes and float32
    per-head scales (a local layer's ring stays float, as the
    reference's)."""
    kv = (cfg.n_kv, cfg.head_dim)
    if cfg.kv_quant == "int8" and not is_local(cfg, spec):
        return {"k": (rows + kv, torch.int8), "v": (rows + kv, torch.int8),
                "k_scale": (rows + kv[:1], torch.float32),
                "v_scale": (rows + kv[:1], torch.float32)}
    return {"k": (rows + kv, cfg.cdtype), "v": (rows + kv, cfg.cdtype)}


def _state_leaves(cfg: ModelConfig, spec: BlockSpec, batch: int) -> dict:
    """A recurrent layer's state leaves (no sequence axis): Mamba2's ``h``
    [B, H, N, P] float32 and conv tail ``conv`` [B, 3, d_inner + 2N];
    RWKV6's ``S`` [B, H, K, K] float32 and the time- and channel-mix
    shifts ``xt``, ``xc`` [B, 1, d] (the reference keeps ``xc`` on every
    rwkv6 layer)."""
    cd = cfg.cdtype
    if spec.kind == "mamba2":
        P = cfg.d_inner // cfg.ssm_heads
        return {"h": ((batch, cfg.ssm_heads, cfg.d_state, P), torch.float32),
                "conv": ((batch, ssm_lib.D_CONV - 1,
                          cfg.d_inner + 2 * cfg.d_state), cd)}
    if spec.kind == "rwkv6":
        K = cfg.d_model // cfg.rwkv_heads
        return {"S": ((batch, cfg.rwkv_heads, K, K), torch.float32),
                "xt": ((batch, 1, cfg.d_model), cd),
                "xc": ((batch, 1, cfg.d_model), cd)}
    return {}


def _layer_leaves(cfg: ModelConfig, spec: BlockSpec, rows: tuple,
                  shared_rows: tuple, batch: int) -> dict:
    """Every decode-cache leaf of a layer: the attention leaves over
    ``rows`` or the recurrent state of ``batch`` slots, then on a
    ``shared_attn`` layer the shared block's float K/V over
    ``shared_rows``."""
    out = (_kv_leaves(cfg, spec, rows) if spec.kind == "attn"
           else _state_leaves(cfg, spec, batch))
    if spec.shared_attn:
        kv = (cfg.n_kv, cfg.head_dim)
        out.update({k: (shared_rows + kv, cfg.cdtype) for k in SHARED_KEYS})
    return out


def _nbytes(shape: tuple, dt: torch.dtype) -> int:
    bits = torch.finfo(dt).bits if dt.is_floating_point \
        else torch.iinfo(dt).bits
    return math.prod(shape) * bits // 8


def kv_bytes_per_position(cfg: ModelConfig) -> int:
    """Bytes one cache position (a dense row's slot or a page's token)
    holds summed over every layer's sequence leaves: K/V and int8 scales,
    and the shared block's K/V (recurrent state is per slot:
    :func:`state_bytes`)."""
    return sum(_nbytes(shape, dt)
               for i in range(cfg.n_layers)
               for k, (shape, dt) in _layer_leaves(
                   cfg, layer_spec(cfg, i), (), (), 0).items()
               if k not in STATE_KEYS)


def dense_cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Bytes of :func:`init_cache`'s sequence leaves: every layer's K/V
    (and int8 scales) over its own length, the ring of a local layer
    included, and the shared block's K/V at ``max_len``."""
    total = 0
    for i in range(cfg.n_layers):
        spec = layer_spec(cfg, i)
        T = cache_len(cfg, spec, max_len)
        for k, (shape, dt) in _layer_leaves(cfg, spec, (), (), 0).items():
            if k in SHARED_KEYS:
                total += batch * max_len * _nbytes(shape, dt)
            elif k not in STATE_KEYS:
                total += batch * T * _nbytes(shape, dt)
    return total


def state_bytes(cfg: ModelConfig, batch: int) -> int:
    """Bytes of the recurrent state of ``batch`` slots over every layer
    (dense per slot, paged engine or not)."""
    return sum(_nbytes(shape, dt) for i in range(cfg.n_layers)
               for shape, dt in _state_leaves(cfg, layer_spec(cfg, i),
                                              batch).values())


def _zero_cache(cfg: ModelConfig, rows_of, shared_rows: tuple, batch: int,
                device) -> list:
    """Zero leaves for every layer; ``rows_of(spec)`` is an attention
    layer's leading shape, ``shared_rows`` the shared block's."""
    dev = resolve_device(device)
    out = []
    for i in range(cfg.n_layers):
        spec = layer_spec(cfg, i)
        out.append({k: torch.zeros(shape, dtype=dt, device=dev)
                    for k, (shape, dt) in _layer_leaves(
                        cfg, spec, rows_of(spec), shared_rows,
                        batch).items()})
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list:
    """Zero per-layer dense decode buffers: an attention layer's K/V
    [batch, T, n_kv, head_dim], T = :func:`cache_len` (int8 KV: int8 codes
    and float32 scales [batch, T, n_kv]); a recurrent layer's state
    (:func:`_state_leaves`); the shared block's K/V [batch, max_len, n_kv,
    head_dim] on a ``shared_attn`` layer."""
    check_supported(cfg)
    return _zero_cache(
        cfg, lambda spec: (batch, cache_len(cfg, spec, max_len)),
        (batch, max_len), batch, device)


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_pages: int, page_size: int, device=None) -> list:
    """Paged form of :func:`init_cache`: per layer, every sequence leaf as
    a shared zero page pool ``[num_pages, page_size, ...]`` (int8 KV: the
    scales page with their codes; the shared block's K/V page through the
    full table), local layers' too (their rings are pages of the ring
    table); the per-slot addressing lives in the scheduler's page tables.
    Recurrent state has no sequence axis and stays dense, ``batch`` rows."""
    check_supported(cfg)
    rows = (num_pages, page_size)
    return _zero_cache(cfg, lambda spec: rows, rows, batch, device)


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: list, pos, tables=None) -> tuple[torch.Tensor, list]:
    """One token for the whole batch.  token [B] int; pos scalar or [B]
    int32 (each slot at its own depth; negative = free slot).  Returns
    (logits [B, V] float32, cache) with the cache updated in place: K/V
    written at each row's position, a recurrent state copied into its
    leaves (every row's, a free row's too, as in the reference).  A local
    layer's dense cache shorter than the window is a ring written at ``pos
    % T``.

    ``tables`` (paged serving): the ``(full_table [B, E], ring_table [B,
    Er])`` int32 pair; the cache is then :func:`init_paged_cache`'s page
    pools, global layers and the shared block addressed through the full
    table and local layers, always rolling, through the ring table.  A
    cache with ``k_scale`` leaves (int8 KV) takes
    ``attention.decode_attention_int8``."""
    cd = cfg.cdtype
    x = _embed(params, cfg, token)[:, None, :]                   # [B, 1, d]
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, rope_mode=cfg.rope_mode,
              mrope_sections=cfg.mrope_sections, quant=cfg.quant,
              compute_dtype=cd)
    qkw = dict(quant=cfg.quant, compute_dtype=cd)
    cap = (None if cfg.moe is None
           else moe_lib.decode_capacity(cfg.moe, x.shape[0]))
    shared = params.get("shared_attn")
    full = None if tables is None else tables[0]
    for i, (bp, c) in enumerate(zip(params["blocks"], cache)):
        spec = layer_spec(cfg, i)
        if spec.shared_attn and shared is not None:
            y, _, _ = attn_lib.decode_attention(
                shared["attn"], _norm(shared["ln"], x, cfg), c["shared_k"],
                c["shared_v"], pos, table=full, **kw)
            x = _shared_mlp(shared, cfg, x + y)
        h = _norm(bp["ln1"], x, cfg)
        if spec.kind == "mamba2":
            y, st = ssm_lib.mamba2_decode(
                bp["mamba"], h, ssm_lib.Mamba2State(c["h"], c["conv"]),
                d_inner=cfg.d_inner, d_state=cfg.d_state,
                n_heads=cfg.ssm_heads, **qkw)
            c["h"].copy_(st.h)
            c["conv"].copy_(st.conv)
        elif spec.kind == "rwkv6":
            y, st = ssm_lib.rwkv6_timemix_decode(
                bp["tmix"], h, ssm_lib.RWKVState(c["S"], c["xt"], c["xc"]),
                n_heads=cfg.rwkv_heads, **qkw)
            c["S"].copy_(st.S)
            c["xt"].copy_(st.x_prev_t)
        else:
            local = is_local(cfg, spec)
            if tables is not None:
                rolling, table = local, tables[1 if local else 0]
            else:
                rolling, table = local and c["k"].shape[1] <= cfg.window, None
            if "k_scale" in c:            # the int8 cache, as the reference
                y, _ = attn_lib.decode_attention_int8(
                    bp["attn"], h, c, pos, window=_window(cfg, spec),
                    logit_softcap=cfg.attn_softcap, table=table, **kw)
            else:
                y, _, _ = attn_lib.decode_attention(
                    bp["attn"], h, c["k"], c["v"], pos,
                    window=_window(cfg, spec),
                    logit_softcap=cfg.attn_softcap, rolling=rolling,
                    table=table, **kw)
            if cfg.gemma_norms:
                y = _norm(bp["post_attn_ln"], y, cfg)
        x = x + y
        if spec.mlp == "rwkv_cm":
            h = _norm(bp["ln2"], x, cfg)
            x = x + ssm_lib.rwkv6_chanmix(bp["cmix"], h, c["xc"], **qkw)
            c["xc"].copy_(h)
        else:
            x, _ = _mlp_tail(bp, spec, cfg, x, capacity=cap)
    x = _norm(params["final_norm"], x, cfg)
    logits = _lm_head(params, cfg, x[:, 0].to(cd)).to(torch.float32)
    return _final_softcap(logits, cfg), cache


def _norm_rows(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The norm of each position of x [B, S, d] on its own [B, 1, d] slice,
    the shape ``decode_step`` normalizes (the reduction strategy of a CUDA
    kernel depends on the shape, and verify must reproduce decode's bits)."""
    return torch.cat([_norm(p, x[:, i:i + 1].contiguous(), cfg)
                      for i in range(x.shape[1])], dim=1)


def verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: list, pos, tables=None) -> tuple[torch.Tensor, list]:
    """S tokens for the whole batch in one forward (speculative verify).

    tokens [B, S] int, token i of a row at ``pos + i``; pos [B] int32 start
    positions (negative = free slot; live rows need ``pos <= max_len -
    S``).  Returns (logits [B, S, V] float32, cache) with every K/V write
    landed in place: ``logits[:, i]`` has the bits of the i-th of S
    sequential :func:`decode_step` calls.  The projections and the head run
    once at M = B*S; norms, rope and attention run per position.
    ``tables``: as in :func:`decode_step`.  An int8 cache or a local
    (sliding-window) layer raises, as the reference's does: speculation
    needs full-length caches built a token at a time (MoE blocks raise too:
    routing couples the tokens of a forward; so do recurrent and
    shared-attention blocks)."""
    check_supported(cfg)
    for spec, c in zip(cfg.pattern, cache):
        if (spec.kind != "attn" or spec.shared_attn or is_local(cfg, spec)
                or "k_scale" in c or spec.mlp in ("moe", "rwkv_cm")):
            raise ValueError(
                f"verify_step cannot run block spec {spec} (kv_quant="
                f"{cfg.kv_quant!r}): speculative decoding supports plain "
                "full-length attention blocks only")
    cd = cfg.cdtype
    table = None if tables is None else tables[0]
    x = _embed(params, cfg, tokens)                              # [B, S, d]
    rows = lambda p, v: _norm_rows(p, v, cfg)                    # noqa: E731
    for i, (bp, c) in enumerate(zip(params["blocks"], cache)):
        y, _, _ = attn_lib.decode_attention_multi(
            bp["attn"], rows(bp["ln1"], x), c["k"], c["v"], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            logit_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
            rope_mode=cfg.rope_mode, mrope_sections=cfg.mrope_sections,
            quant=cfg.quant, compute_dtype=cd, table=table)
        if cfg.gemma_norms:
            y = rows(bp["post_attn_ln"], y)
        x, _ = _mlp_tail(bp, layer_spec(cfg, i), cfg, x + y, norm=rows)
    x = rows(params["final_norm"], x)
    logits = _lm_head(params, cfg, x.to(cd)).to(torch.float32)
    return _final_softcap(logits, cfg), cache
