"""Whisper-style encoder-decoder (port of ``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the caller gives
frame embeddings [B, enc_seq, d_model].  The encoder is ``n_enc_layers``
layers of bidirectional attention and a GELU MLP behind layer norms, with
sinusoidal positions added to the frames; the decoder is causal
self-attention, cross-attention to the encoder output and a GELU MLP, with
sinusoidal positions added to the token embedding; the head is the tied
float embedding (``x @ emb.T`` in the compute dtype, the whole table cast
every call as the reference's).

Layers are per-layer lists, ``params["enc_blocks"][i]`` and
``params["dec_blocks"][i]`` (the reference's ``[L, ...]`` stacks,
unstacked by ``convert.params_from_jax``).  The decode cache is a list of
per-layer ``{"k", "v", "xk", "xv"}``: the decoder's self-attention K/V
[B, T, n_kv, head_dim] (``T = max_len``), written in place a token at a
time, and the cross-attention K/V [B, enc_seq, n_kv, head_dim], projected
once from the encoder output by :func:`precompute_cross_kv`.  The paged
cache (:func:`init_paged_cache`) makes the self-attention K/V page pools
read through the full page table; the cross K/V stay dense.

As the reference, :func:`prefill` projects the cross K/V twice: once
inside the decoder forward (``attention.cross_attention``, per layer) and
once more for the cache.  :func:`loss_fn` is the training loss.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.device import resolve_device, seeded_generator
from repro_torch.dist.sharding import constrain
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (init_embedding, init_mlp, layer_norm,
                                       linear, mlp, nll)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this module does not run: it serves
    encoder-decoder configs only (decoder LMs are ``models.transformer``)."""
    if not cfg.enc_dec:
        raise ValueError(f"{cfg.name}: models.encdec runs enc_dec configs; "
                         "decoder LMs are models.transformer")


_SINUSOIDS: dict[tuple, torch.Tensor] = {}


def sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    """[length, d] float32 positions, the reference's op order: the float32
    scalar ``log(10000) / (d // 2 - 1)`` times ``arange(d // 2)``, then
    ``exp``; the angles ``arange(length) * inv``; then ``sin`` and ``cos``
    side by side.  Every op is elementwise, so row p has the same bits in
    a table of any length (prefill's rows and decode's ``[pos]`` agree).
    Made once per (length, d, device)."""
    key = (length, d, str(device))
    t = _SINUSOIDS.get(key)
    if t is None:
        scale = torch.tensor(np.float32(math.log(10000.0) / (d // 2 - 1)),
                             device=device)
        inv = torch.exp(-scale * torch.arange(d // 2, dtype=torch.float32,
                                              device=device))
        ang = torch.arange(length, dtype=torch.float32,
                           device=device)[:, None] * inv[None, :]
        t = _SINUSOIDS[key] = torch.cat([torch.sin(ang), torch.cos(ang)], 1)
    return t


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ln(cfg: ModelConfig, device) -> dict:
    return {"scale": torch.ones((cfg.d_model,), dtype=cfg.pdtype,
                                device=device),
            "bias": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                device=device)}


def _init_attn(gen, cfg: ModelConfig, device) -> dict:
    return attn_lib.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                   cfg.head_dim, True, cfg.pdtype, device)


def _init_mlp(gen, cfg: ModelConfig, device) -> dict:
    return init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device,
                    kind="gelu")


def init_enc_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """An encoder layer: ``ln1``, ``attn`` (q/k/v biases), ``ln2``, ``mlp``
    (GELU: ``wi``, ``wo``)."""
    return {"ln1": _ln(cfg, device), "attn": _init_attn(gen, cfg, device),
            "ln2": _ln(cfg, device), "mlp": _init_mlp(gen, cfg, device)}


def init_dec_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """A decoder layer: ``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``,
    ``ln2``, ``mlp``."""
    return {"ln1": _ln(cfg, device),
            "self_attn": _init_attn(gen, cfg, device),
            "ln_x": _ln(cfg, device),
            "cross_attn": _init_attn(gen, cfg, device),
            "ln2": _ln(cfg, device), "mlp": _init_mlp(gen, cfg, device)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                block_hook=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.
    ``block_hook(stack, i, block)`` (``stack`` is ``"enc_blocks"`` or
    ``"dec_blocks"``) replaces a layer's parameters as soon as they are
    made (``serve.quantize.init_served_params`` quantizes them there)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = seeded_generator(dev, seed)
    out = {}
    for stack, n, make in (("enc_blocks", cfg.n_enc_layers, init_enc_block),
                           ("dec_blocks", cfg.n_layers, init_dec_block)):
        blocks = []
        for i in range(n):
            bp = make(gen, cfg, dev)
            blocks.append(bp if block_hook is None
                          else block_hook(stack, i, bp))
        out[stack] = blocks
    out["enc_ln"] = _ln(cfg, dev)
    out["dec_ln"] = _ln(cfg, dev)
    out["embed"] = init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype,
                                  dev)
    return out


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------

def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                quant=cfg.quant, compute_dtype=cfg.cdtype)


def encode(params: dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames [B, T, d_model] (the stub frontend's output) -> the encoder
    output [B, T, d_model] in the compute dtype: sinusoids added in the
    compute dtype, then every layer's bidirectional attention and GELU
    MLP, then ``enc_ln``."""
    cd = cfg.cdtype
    B, T, _ = frames.shape
    x = frames.to(cd) + sinusoids(T, cfg.d_model, frames.device).to(cd)[None]
    pos = attn_lib.arange_positions(B, T, x.device)
    for bp in params["enc_blocks"]:
        h = layer_norm(bp["ln1"], x)
        x = x + attn_lib.attention(bp["attn"], h, pos, causal=False,
                                   rope_mode="none", kv_block=cfg.kv_block,
                                   **_attn_kw(cfg))
        h = layer_norm(bp["ln2"], x)
        x = x + mlp(bp["mlp"], h, cfg.quant, cd, kind="gelu")
        x = constrain(x, "batch", "seq", None)
    return layer_norm(params["enc_ln"], x)


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The tied head, ``x @ emb.astype(cd).T`` as the reference's."""
    return x @ params["embed"]["emb"].to(cfg.cdtype).T


def dec_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                enc_out: torch.Tensor, return_cache: bool = False):
    """The decoder over tokens [B, S] attending to ``enc_out``: logits
    [B, S, V] in the compute dtype, and with ``return_cache`` the per-layer
    self-attention ``{"k", "v"}`` [B, S, n_kv, head_dim]."""
    cd = cfg.cdtype
    B, S = tokens.shape
    emb = params["embed"]["emb"]
    # under autograd cast, then gather, as the reference (the table's
    # gradient is scatter-added in the compute dtype)
    x = emb.to(cd)[tokens.long()] if torch.is_grad_enabled() \
        else emb[tokens.long()].to(cd)
    x = x + sinusoids(S, cfg.d_model, x.device).to(cd)[None]
    pos = attn_lib.arange_positions(B, S, x.device)
    kw = _attn_kw(cfg)
    cache = []
    for bp in params["dec_blocks"]:
        h = layer_norm(bp["ln1"], x)
        y, (k, v) = attn_lib.attention(bp["self_attn"], h, pos,
                                       rope_mode="none", kv_block=cfg.kv_block,
                                       return_kv=True, **kw)
        x = x + y
        h = layer_norm(bp["ln_x"], x)
        x = x + attn_lib.cross_attention(bp["cross_attn"], h, enc_out, **kw)
        h = layer_norm(bp["ln2"], x)
        x = x + mlp(bp["mlp"], h, cfg.quant, cd, kind="gelu")
        x = constrain(x, "batch", "seq", None)
        cache.append({"k": k.to(cd), "v": v.to(cd)})
    logits = constrain(_head(params, cfg, layer_norm(params["dec_ln"], x)),
                       "batch", "seq", "vocab")
    return (logits, cache) if return_cache else logits


def forward(params: dict, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Logits [B, S, V] (compute dtype) of the decoder over ``tokens``
    given the encoded ``frames``."""
    check_supported(cfg)
    return dec_forward(params, cfg, tokens, encode(params, cfg, frames))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The decoder's mean NLL of ``batch["labels"]`` [B, S] given
    ``batch["frames"]`` and ``batch["tokens"]``, in float32."""
    return nll(forward(params, cfg, batch["frames"], batch["tokens"]),
               batch["labels"])


def precompute_cross_kv(params: dict, cfg: ModelConfig,
                        enc_out: torch.Tensor, cache: list) -> list:
    """Every decoder layer's cross-attention K/V [B, T, n_kv, head_dim]
    projected from ``enc_out`` into ``cache[i]["xk"]`` / ``["xv"]`` (the
    dicts are updated and returned)."""
    cd = cfg.cdtype
    B, T, _ = enc_out.shape
    for bp, c in zip(params["dec_blocks"], cache):
        ca = bp["cross_attn"]
        c["xk"] = linear(ca["wk"], enc_out, cfg.quant, cd).reshape(
            B, T, -1, cfg.head_dim).to(cd)
        c["xv"] = linear(ca["wv"], enc_out, cfg.quant, cd).reshape(
            B, T, -1, cfg.head_dim).to(cd)
    return cache


def prefill(params: dict, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor):
    """Encode, run the decoder over the prompt, and build the decode cache:
    (last-position logits [B, V] float32, per-layer ``{"k", "v", "xk",
    "xv"}`` with K/V of length S)."""
    check_supported(cfg)
    enc_out = encode(params, cfg, frames)
    logits, cache = dec_forward(params, cfg, tokens, enc_out,
                                return_cache=True)
    cache = precompute_cross_kv(params, cfg, enc_out, cache)
    return logits[:, -1].to(torch.float32), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _zeros(shape: tuple, cfg: ModelConfig, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=cfg.cdtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list:
    """Zero per-layer decode buffers: self-attention ``k``/``v`` [batch,
    max_len, n_kv, head_dim] and cross-attention ``xk``/``xv`` [batch,
    enc_seq, n_kv, head_dim], in the compute dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    kv, x = (batch, max_len, cfg.n_kv, cfg.head_dim), \
        (batch, cfg.enc_seq, cfg.n_kv, cfg.head_dim)
    return [{"k": _zeros(kv, cfg, dev), "v": _zeros(kv, cfg, dev),
             "xk": _zeros(x, cfg, dev), "xv": _zeros(x, cfg, dev)}
            for _ in range(cfg.n_layers)]


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Bytes of :func:`init_cache`'s leaves: the self-attention K/V at
    ``max_len`` and the cross K/V at ``enc_seq``, every layer (the
    reference's KV figure counts ``xk`` / ``xv`` too)."""
    row = cfg.n_kv * cfg.head_dim * torch.finfo(cfg.cdtype).bits // 8
    return cfg.n_layers * 2 * batch * (max_len + cfg.enc_seq) * row


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_pages: int, page_size: int, device=None) -> list:
    """Paged form of :func:`init_cache`: the self-attention K/V become
    shared ``[num_pages, page_size, n_kv, head_dim]`` pools addressed
    through a per-slot page table; the cross-attention K/V stay dense (one
    per slot, at the encoder's length, never grown)."""
    check_supported(cfg)
    if max_len % page_size:
        raise ValueError(f"page_size ({page_size}) must divide max_len "
                         f"({max_len})")
    dev = resolve_device(device)
    kv = (num_pages, page_size, cfg.n_kv, cfg.head_dim)
    x = (batch, cfg.enc_seq, cfg.n_kv, cfg.head_dim)
    return [{"k": _zeros(kv, cfg, dev), "v": _zeros(kv, cfg, dev),
             "xk": _zeros(x, cfg, dev), "xv": _zeros(x, cfg, dev)}
            for _ in range(cfg.n_layers)]


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: list, pos, tables=None) -> tuple[torch.Tensor, list]:
    """One token for the whole batch: token [B] int; pos scalar or [B]
    int32 (negative = free slot).  Returns (logits [B, V] float32, cache)
    with each layer's self-attention K/V written in place.  The position
    embedding is row ``clip(pos, 0, T - 1)`` of ``sinusoids(T)``, T the
    cache's length; cross-attention reads the precomputed ``xk``/``xv``
    with every key visible.

    ``tables`` (paged): ``(full_table [B, E], _)``; the self-attention
    leaves are then :func:`init_paged_cache`'s pools, written and read
    through the table (T = E * page_size)."""
    cd = cfg.cdtype
    B = token.shape[0]
    x = params["embed"]["emb"][token.long()].to(cd)[:, None, :]
    full = None if tables is None else tables[0]
    T = (full.shape[1] * cache[0]["k"].shape[1] if full is not None
         else cache[0]["k"].shape[1])
    posv = attn_lib._pos_vec(pos, B, x.device)
    pe = sinusoids(T, cfg.d_model, x.device).to(cd).index_select(
        0, torch.clamp(posv, 0, T - 1))                      # [B, d]
    x = x + pe[:, None, :]
    kw = _attn_kw(cfg)
    for bp, c in zip(params["dec_blocks"], cache):
        h = layer_norm(bp["ln1"], x)
        y, _, _ = attn_lib.decode_attention(
            bp["self_attn"], h, c["k"], c["v"], posv, rope_mode="none",
            table=full, **kw)
        x = x + y
        h = layer_norm(bp["ln_x"], x)
        ca = bp["cross_attn"]
        qh = linear(ca["wq"], h, cfg.quant, cd).reshape(B, 1, -1,
                                                         cfg.head_dim)
        Te = c["xk"].shape[1]
        o = attn_lib.full_attention(
            qh, c["xk"], c["xv"],
            torch.zeros((B, 1), dtype=torch.int32, device=x.device),
            attn_lib.arange_positions(B, Te, x.device), causal=False)
        x = x + linear(ca["wo"], o.reshape(B, 1, -1).to(cd), cfg.quant, cd)
        h = layer_norm(bp["ln2"], x)
        x = x + mlp(bp["mlp"], h, cfg.quant, cd, kind="gelu")
    x = layer_norm(params["dec_ln"], x)
    return _head(params, cfg, x[:, 0]).to(torch.float32), cache
