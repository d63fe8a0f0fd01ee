"""Dense decoder LM (port of ``repro.models.transformer``, attention-only
patterns): ``embed -> layers -> final_norm -> lm_head``.

Layers are a per-layer list (``params["blocks"][i]``), not the reference's
``[G, ...]`` stacks; layer ``g * len(pattern) + j`` is group ``g``'s pattern
position ``j`` (``convert.params_from_jax`` unstacks in that order).  The
decode cache is a list of per-layer ``{"k", "v"}`` buffers
``[B, max_len, n_kv, head_dim]`` that ``decode_step`` and ``verify_step``
update in place; the paged cache (``init_paged_cache``) is per-layer page
pools ``[num_pages, page_size, n_kv, head_dim]`` addressed through the
``tables`` those two take.  With ``cfg.kv_quant == "int8"`` the decode
cache holds int8 ``k``/``v`` codes with float32 per-token-per-head
``k_scale``/``v_scale`` leaves (dense rows or page pools alike), which
``decode_step`` reads through ``attention.decode_attention_int8``; prefill
still returns the float K/V, which serving quantizes as it stitches them
into the live cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (init_embedding, init_linear, init_mlp,
                                       init_norm, mlp, rms_norm)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration features this slice does not port."""
    bad = []
    for spec in cfg.pattern:
        if spec.kind != "attn" or spec.shared_attn:
            bad.append(f"block kind {spec.kind!r}")
        if spec.attn_type != "global" or cfg.window:
            bad.append("sliding-window attention")
        if spec.mlp != "swiglu":
            bad.append(f"mlp {spec.mlp!r}")
    for name, ok in (("attn_softcap", cfg.attn_softcap is None),
                     ("final_softcap", cfg.final_softcap is None),
                     ("rope_mode", cfg.rope_mode == "rope"),
                     ("norm", cfg.norm == "rmsnorm"),
                     ("gemma_norms", not cfg.gemma_norms),
                     ("embed_scale", not cfg.embed_scale),
                     ("moe", cfg.moe is None),
                     ("enc_dec", not cfg.enc_dec),
                     ("kv_quant", cfg.kv_quant in ("none", "int8")),
                     ("split_head_params", not cfg.split_head_params)):
        if not ok:
            bad.append(name)
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(sorted(set(bad)))}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.pdtype
    kw = dict(dtype=dt, device=dev)
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            "ln1": init_norm(cfg.d_model, **kw),
            "attn": attn_lib.init_attention(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                cfg.qkv_bias, **kw),
            "ln2": init_norm(cfg.d_model, **kw),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, **kw),
        })
    params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, **kw),
              "blocks": blocks,
              "final_norm": init_norm(cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab, **kw)
    return params


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------

def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    # gather, then cast: the same values as the reference's cast-then-gather
    # without converting the whole table every call
    return params["embed"]["emb"][tokens.long()].to(cfg.cdtype)


def _lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final projection; tied embeddings or the (pre-quantized) head."""
    if cfg.tie_embeddings:
        return x @ params["embed"]["emb"].T.to(x.dtype)
    lh = params["lm_head"]
    if "w_q" in lh:
        from repro_torch.kernels.lutmul import ops as lut_ops
        return lut_ops.prequant_matmul(x, lh["w_q"], lh["w_scale"],
                                       mode=cfg.quant, compute_dtype=x.dtype)
    return x @ lh["w"].to(x.dtype)


def _block(bp: dict, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor):
    cd = cfg.cdtype
    h = rms_norm(bp["ln1"], x)
    y, (k, v) = attn_lib.attention(
        bp["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        quant=cfg.quant, compute_dtype=cd, return_kv=True)
    x = x + y
    h = rms_norm(bp["ln2"], x)
    x = x + mlp(bp["mlp"], h, quant=cfg.quant, compute_dtype=cd)
    return x, {"k": k.to(cd), "v": v.to(cd)}


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


def forward(params: dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B, S, V] compute dtype, aux 0.0)."""
    check_supported(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(B, S, x.device)
    for bp in params["blocks"]:
        x, _ = _block(bp, cfg, x, positions)
    x = rms_norm(params["final_norm"], x)
    logits = _lm_head(params, cfg, x.to(cfg.cdtype))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            length=None):
    """Forward that also returns the decode cache: (logits [B, V] float32
    at the last position, per-layer float {"k", "v"} of length S).

    ``length`` ([B] or scalar int) takes each row's logits at ``length -
    1`` (clipped into [0, S - 1]) instead: right-padded rows and the dummy
    rows of a batched admission (pad tokens sit after the prompt, so the
    causal mask keeps them out of every real token)."""
    check_supported(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(B, S, x.device)
    cache = []
    for bp in params["blocks"]:
        x, c = _block(bp, cfg, x, positions)
        cache.append(c)
    x = rms_norm(params["final_norm"], x)
    if length is None:
        xl = x[:, -1]
    else:
        last = torch.as_tensor(length, dtype=torch.int64, device=x.device)
        last = torch.clamp(last.reshape(-1).expand(B) - 1, 0, S - 1)
        xl = x.gather(1, last[:, None, None].expand(B, 1, x.shape[-1]))[:, 0]
    logits = _lm_head(params, cfg, xl.to(cfg.cdtype)).to(torch.float32)
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _kv_leaves(cfg: ModelConfig, rows: tuple) -> dict:
    """One layer's decode-cache leaves over the leading shape ``rows``:
    (shape tail, dtype) by name — float ``k``/``v``, or int8 codes and
    float32 per-head scales under ``kv_quant == "int8"``."""
    kv = (cfg.n_kv, cfg.head_dim)
    if cfg.kv_quant == "int8":
        return {"k": (rows + kv, torch.int8), "v": (rows + kv, torch.int8),
                "k_scale": (rows + kv[:1], torch.float32),
                "v_scale": (rows + kv[:1], torch.float32)}
    return {"k": (rows + kv, cfg.cdtype), "v": (rows + kv, cfg.cdtype)}


def kv_bytes_per_position(cfg: ModelConfig) -> int:
    """Bytes one cache position (a dense row's slot or a page's token)
    holds summed over every layer's leaves, scales included."""
    return cfg.n_layers * sum(
        math.prod(shape) * (torch.finfo(dt).bits if dt.is_floating_point
                            else torch.iinfo(dt).bits) // 8
        for shape, dt in _kv_leaves(cfg, ()).values())


def _zero_cache(cfg: ModelConfig, rows: tuple, device) -> list:
    dev = resolve_device(device)
    return [{k: torch.zeros(shape, dtype=dt, device=dev)
             for k, (shape, dt) in _kv_leaves(cfg, rows).items()}
            for _ in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list:
    """Zero per-layer dense K/V buffers [batch, max_len, n_kv, head_dim]
    (int8 KV: int8 codes and float32 scales [batch, max_len, n_kv])."""
    check_supported(cfg)
    return _zero_cache(cfg, (batch, max_len), device)


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_pages: int, page_size: int, device=None) -> list:
    """Paged form of :func:`init_cache`: per layer, every leaf as a shared
    zero page pool ``[num_pages, page_size, ...]`` (int8 KV: the scales
    page with their codes); the per-slot addressing lives in the
    scheduler's page tables (``batch`` and ``max_len`` size the tables,
    not the pools)."""
    check_supported(cfg)
    return _zero_cache(cfg, (num_pages, page_size), device)


def _full_table(tables):
    """The full-length layers' page table of a ``tables`` pair (the ring
    table is unused: the port refuses sliding windows)."""
    return None if tables is None else tables[0]


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: list, pos, tables=None) -> tuple[torch.Tensor, list]:
    """One token for the whole batch.  token [B] int; pos scalar or [B]
    int32 (each slot at its own depth; negative = free slot).  Returns
    (logits [B, V] float32, cache) with the cache updated in place.

    ``tables`` (paged serving): ``(full_table [B, E], ...)`` int32, the
    reference's pair whose ring table the port leaves unused; the cache is
    then :func:`init_paged_cache`'s page pools.  A cache with ``k_scale``
    leaves (int8 KV) takes ``attention.decode_attention_int8``."""
    cd = cfg.cdtype
    table = _full_table(tables)
    x = _embed(params, cfg, token)[:, None, :]                   # [B, 1, d]
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, quant=cfg.quant, compute_dtype=cd,
              table=table)
    for bp, c in zip(params["blocks"], cache):
        h = rms_norm(bp["ln1"], x)
        if "k_scale" in c:            # the int8 cache, as the reference
            y, _ = attn_lib.decode_attention_int8(bp["attn"], h, c, pos, **kw)
        else:
            y, _, _ = attn_lib.decode_attention(bp["attn"], h, c["k"],
                                                c["v"], pos, **kw)
        x = x + y
        h = rms_norm(bp["ln2"], x)
        x = x + mlp(bp["mlp"], h, quant=cfg.quant, compute_dtype=cd)
    x = rms_norm(params["final_norm"], x)
    logits = _lm_head(params, cfg, x[:, 0].to(cd)).to(torch.float32)
    return logits, cache


def _norm_rows(p: dict, x: torch.Tensor) -> torch.Tensor:
    """rms_norm of each position of x [B, S, d] on its own [B, 1, d] slice,
    the shape ``decode_step`` normalizes (the reduction strategy of a CUDA
    kernel depends on the shape, and verify must reproduce decode's bits)."""
    return torch.cat([rms_norm(p, x[:, i:i + 1].contiguous())
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
    ``tables``: as in :func:`decode_step`.  An int8 cache raises, as the
    reference's does: speculation needs a cache built a token at a time."""
    check_supported(cfg)
    if any("k_scale" in c for c in cache):
        raise ValueError(
            f"verify_step cannot run block spec {cfg.pattern[0]} (kv_quant="
            f"{cfg.kv_quant!r}): speculative decoding supports plain "
            "full-length attention blocks only")
    cd = cfg.cdtype
    table = _full_table(tables)
    x = _embed(params, cfg, tokens)                              # [B, S, d]
    for bp, c in zip(params["blocks"], cache):
        h = _norm_rows(bp["ln1"], x)
        y, _, _ = attn_lib.decode_attention_multi(
            bp["attn"], h, c["k"], c["v"], pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv, head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            quant=cfg.quant, compute_dtype=cd, table=table)
        x = x + y
        h = _norm_rows(bp["ln2"], x)
        x = x + mlp(bp["mlp"], h, quant=cfg.quant, compute_dtype=cd)
    x = _norm_rows(params["final_norm"], x)
    logits = _lm_head(params, cfg, x.to(cd)).to(torch.float32)
    return logits, cache
