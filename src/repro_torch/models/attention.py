"""Attention (port of ``repro.models.attention``): GQA with the
reference's boolean position mask (causal or, for whisper's encoder,
bidirectional, and a sliding window on local layers), gemma-2's logit
soft-cap before the mask and the ``NEG_INF`` fill; RoPE, Qwen2-VL's M-RoPE
or no rotation (``rope_mode``); full-sequence prefill and training
(``attention``: one score tensor up to 2 x ``kv_block`` tokens, past that
the reference's online softmax over K/V blocks, ``blocked_attention``,
with the reference's sharding constraint points), single-token decode
(over a full-length cache or a rolling ring of a local layer) and the
S-token speculative-verify block over a dense per-slot KV cache or, with a
page ``table``, over shared page pools (``paged_gather`` /
``paged_write``); single-token decode over an int8 KV cache
(``quantize_kv``, ``int8_kv_attention``, ``decode_attention_int8``); and
whisper's encoder-decoder ``cross_attention``.

Head counts come from the projections' outputs (``_proj_qkv`` reshapes to
``[B, S, -1, head_dim]``), never from the ``n_heads`` / ``n_kv``
arguments, so a head-parallel rank of ``serve.sharded.ShardedEngine``
runs its ``n_heads / tp`` local heads through the same code, its cache
holding ``n_kv / tp`` heads (the reference's ``_proj_qkv`` rule).

Plain PyTorch ops throughout (the reference has no Pallas kernel here).
Scores and the probability-value product accumulate in float32 on float32
copies of K/V (a block at a time in ``blocked_attention``), the analogue
of the reference's ``preferred_element_type=float32``.  Decode writes the
new K/V row into the cache IN PLACE (the reference returns an updated
copy; the engine donates it, so the two are the same data flow) and
returns the same tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain
from repro_torch.models.layers import (Params, init_linear, linear, rotate,
                                       stable_tanh)

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qkv_bias: bool = False,
                   dtype=torch.float32, device=None,
                   split_heads: bool = False) -> Params:
    """``split_heads=True`` stores the projections as 3D float leaves
    (``split_head_params``), as the reference does: ``wq3``/``wk3``/``wv3``
    [d, H, dh] with [H, dh] biases under ``qkv_bias``, and ``wo3`` [H, dh,
    d].  Serving quantization leaves them float."""
    kw = dict(dtype=dtype, device=device)
    if not split_heads:
        return {
            "wq": init_linear(gen, d_model, n_heads * head_dim,
                              bias=qkv_bias, **kw),
            "wk": init_linear(gen, d_model, n_kv * head_dim, bias=qkv_bias,
                              **kw),
            "wv": init_linear(gen, d_model, n_kv * head_dim, bias=qkv_bias,
                              **kw),
            "wo": init_linear(gen, n_heads * head_dim, d_model, **kw),
        }
    s = 1.0 / math.sqrt(d_model)
    p = {name: {"w": torch.randn((d_model, h, head_dim), generator=gen,
                                 **kw).mul_(s)}
         for name, h in (("wq3", n_heads), ("wk3", n_kv), ("wv3", n_kv))}
    p["wo3"] = {"w": torch.randn((n_heads, head_dim, d_model), generator=gen,
                                 **kw).mul_(1.0 / math.sqrt(n_heads
                                                            * head_dim))}
    if qkv_bias:
        for name, h in (("wq3", n_heads), ("wk3", n_kv), ("wv3", n_kv)):
            p[name]["b"] = torch.zeros((h, head_dim), **kw)
    return p


def _proj_qkv(p: Params, name: str, x: torch.Tensor, B: int, S: int,
              D: int, quant: str, cd) -> torch.Tensor:
    """Project to [B, S, h, D] through the 2D leaf (codes or float) or the
    3D split-head leaf (a float product).  ``h`` comes from the
    projection's output: a head-parallel rank's leaves give its local
    heads."""
    if name + "3" in p:
        leaf = p[name + "3"]
        x, w = x.to(cd), leaf["w"].to(cd)
        y = proj_stable(x, w) if x.is_cuda else torch.einsum(
            "bsd,dhk->bshk", x, w)
        if "b" in leaf:
            y = y + leaf["b"].to(cd)
        return y
    return linear(p[name], x, quant, cd).reshape(B, S, -1, D)


def _proj_out(p: Params, out: torch.Tensor, B: int, S: int, quant: str,
              cd) -> torch.Tensor:
    """The output projection.  The 2D ``wo`` is row-parallel under tensor
    parallelism (its K rows are head-major, so the local heads are its K
    slice); the float ``wo3`` [H, dh, d] stays replicated, so head-local
    outputs are all-gathered over the model axis in front of it (a float
    partial-sum reduction would reorder the sum)."""
    if "wo3" in p:
        w = p["wo3"]["w"]
        if out.shape[2] != w.shape[0]:        # head-sharded input
            from repro_torch.dist import tp as tp_lib
            out = tp_lib.all_gather(out, tp_lib.model_axis(), dim=2)
        out, w = out.to(cd), w.to(cd)
        return out_stable(out, w) if out.is_cuda else torch.einsum(
            "bshk,hkd->bsd", out, w)
    return linear(p["wo"], out.reshape(B, S, -1).to(cd), quant, cd)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: Optional[int] = None, causal: bool = True) -> torch.Tensor:
    """[..., q, k] boolean keep-mask from absolute positions; negative key
    positions (padding / unwritten cache slots) are always masked; with
    ``causal`` so is every key past its query, and with ``window`` every
    key ``window`` or more positions back."""
    m = (k_pos >= 0)[..., None, :]
    d = q_pos[..., :, None] - k_pos[..., None, :]
    if causal:
        m = m & (d >= 0)
    if window is not None:
        m = m & (d < window)
    return m


def _softcap_scores(s: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(s / cap)`` on float32 scores, the reference's order
    (the division by a device scalar: CUDA turns a division by a Python
    number into a reciprocal multiply)."""
    return cap * stable_tanh(_div(s, cap))


# On the card the two attention products must not depend on how many rows
# and heads a call holds: cuBLAS picks a batched GEMM's algorithm (split-K
# included) by the batch count, so the same (row, head) pair got other bits
# at 4 rows than at 8, or at 14 heads than at 28, which a sharded engine
# (local rows, local heads) must not see.  A decode call (one query
# position) therefore takes each product as an elementwise product summed
# over its contiguous last axis (ATen's reduction keeps one order per
# output once a call has 16 outputs or more), in blocks of ``_SUM_BLOCK``
# terms where the axis is longer; a prefill call takes batched GEMMs of a
# fixed batch of (row, kv head) pairs.  The CPU keeps the batched einsums:
# ATen's CPU GEMM computes each batch entry on its own.
_SUM_BLOCK = 256
_PAIR_BATCH = 16


def _blocked_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, whose length is at most ``_SUM_BLOCK`` or a
    multiple of it: block sums first, then their sum."""
    n = x.shape[-1]
    if n <= _SUM_BLOCK:
        return x.sum(-1)
    return x.reshape(x.shape[:-1] + (n // _SUM_BLOCK, _SUM_BLOCK)) \
        .sum(-1).sum(-1)


def _pad_last(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to a multiple of ``_SUM_BLOCK`` when
    longer than one block (the zeros add exact zeros to every sum)."""
    n = x.shape[dim]
    pad = (-n) % _SUM_BLOCK if n > _SUM_BLOCK else 0
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def _per_pair(a: torch.Tensor, b: torch.Tensor, transpose: bool
              ) -> torch.Tensor:
    """a [B, S, H, G, X] and b [B, T, H, Y] -> [B, S, H, G, Z]: for each
    (row, kv head) pair ``a_bh [S*G, X] @ b_bh`` (``b_bh.T`` with
    ``transpose``), as batched GEMMs of ``_PAIR_BATCH`` pairs each (the
    pair count zero-padded to a multiple), every operand a fresh
    allocation: each GEMM call has one shape and alignment whatever the
    call's rows and heads."""
    B, S, H, G, X = a.shape
    P = B * H
    ah = a.permute(0, 2, 1, 3, 4).reshape(P, S * G, X)
    bh = b.permute(0, 2, 1, 3).reshape(P, b.shape[1], b.shape[3])
    pad = (-P) % _PAIR_BATCH
    if pad:
        ah = torch.cat([ah, ah.new_zeros((pad,) + tuple(ah.shape[1:]))])
        bh = torch.cat([bh, bh.new_zeros((pad,) + tuple(bh.shape[1:]))])
    outs = []
    for i in range(0, P + pad, _PAIR_BATCH):
        x = ah[i:i + _PAIR_BATCH].clone()
        y = bh[i:i + _PAIR_BATCH].clone()
        outs.append(torch.bmm(x, y.transpose(1, 2) if transpose else y))
    out = torch.cat(outs)[:P]
    return out.reshape(B, H, S, G, -1).permute(0, 2, 1, 3, 4)


def scores_stable(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum("bshgd,bkhd->bshgk")`` of float32 qg [B, S, H, G, D] and k
    [B, T, H, D], each (row, head) with bits that do not depend on B or H
    on the card."""
    if qg.shape[1] == 1:
        return _blocked_sum(_pad_last(qg, -1)[..., None, :] * _pad_last(
            k, -1).permute(0, 2, 1, 3)[:, None, :, None])
    return _per_pair(qg, k, transpose=True)


def weighted_stable(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("bshgk,bkhd->bshgd")`` of float32 p [B, S, H, G, T] and v
    [B, T, H, D], each (row, head) with bits that do not depend on B or H
    on the card."""
    if p.shape[1] == 1:
        p, v = _pad_last(p, -1), _pad_last(v, 1)
        return _blocked_sum(p[..., None, :]
                            * v.permute(0, 2, 3, 1)[:, None, :, None])
    return _per_pair(p, v, transpose=False)


# The split-head projections are float GEMMs whose bits must not depend on
# the call's rows (a data shard's) or heads (a model rank's), for the same
# reason as attention's products: on the card each takes GEMMs of one
# shape, rows in zero-padded blocks of ``_ROW_BLOCK``, heads one at a time
# in batches of ``_PAIR_BATCH`` (zero-padded), every operand a fresh
# allocation.  ``wo3`` contracts over every head (gathered first under
# tensor parallelism), so only its rows are blocked.
_ROW_BLOCK = 16


def _row_blocks(x2: torch.Tensor) -> torch.Tensor:
    """[R, K] -> [ceil(R / _ROW_BLOCK), _ROW_BLOCK, K], zero-padded."""
    pad = (-x2.shape[0]) % _ROW_BLOCK
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, x2.shape[1]))])
    return x2.reshape(-1, _ROW_BLOCK, x2.shape[1])


def proj_stable(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` of x [B, S, d] and w [d, H, dh], each
    (row, head) with bits that do not depend on B, S or H on the card:
    batched GEMMs [_PAIR_BATCH, _ROW_BLOCK, d] @ [_PAIR_BATCH, d, dh]."""
    B, S, d = x.shape
    H, dh = w.shape[1], w.shape[2]
    pad = (-H) % _PAIR_BATCH
    wh = w.permute(1, 0, 2)
    if pad:
        wh = torch.cat([wh, wh.new_zeros((pad, d, dh))])
    heads = [wh[i:i + _PAIR_BATCH].clone()
             for i in range(0, H + pad, _PAIR_BATCH)]
    outs = []
    for blk in _row_blocks(x.reshape(B * S, d)):
        a = blk.expand(_PAIR_BATCH, _ROW_BLOCK, d).clone()
        outs.append(torch.cat([torch.bmm(a, b) for b in heads])[:H])
    y = torch.cat(outs, 1)[:, :B * S]                     # [H, R, dh]
    return y.permute(1, 0, 2).reshape(B, S, H, dh)


def out_stable(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` of out [B, S, H, dh] and w [H, dh, d],
    each row with bits that do not depend on B or S on the card: GEMMs
    [_ROW_BLOCK, H * dh] @ [H * dh, d]."""
    B, S, H, dh = out.shape
    w2 = w.reshape(H * dh, w.shape[2]).clone()
    blocks = _row_blocks(out.reshape(B * S, H * dh))
    y = torch.cat([blk.clone() @ w2 for blk in blocks])[:B * S]
    return y.reshape(B, S, -1)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: Optional[int] = None,
                   logit_softcap: Optional[float] = None,
                   causal: bool = True) -> torch.Tensor:
    """Attention: q [B, S, Hq, D], k/v [B, T, Hkv, D] -> float32 [B, S, Hq,
    D]; causal unless ``causal`` is False, ``window`` masks keys that far
    back, ``logit_softcap`` caps the scores before the mask.  On the card
    every (row, head) gets the same bits whatever the call's rows and heads
    (:func:`scores_stable`, :func:`weighted_stable`): the rows may be one
    data shard's, the heads one model rank's."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)
    qg = q.reshape(B, S, Hkv, G, D) * scale
    qg, k = qg.to(torch.float32), k.to(torch.float32)
    s = (scores_stable(qg, k) if qg.is_cuda
         else torch.einsum("bshgd,bkhd->bshgk", qg, k))
    if logit_softcap is not None:
        s = _softcap_scores(s, logit_softcap)
    keep = _mask(q_pos, k_pos, window, causal)
    s = s.masked_fill(~keep[:, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    p, v = p.to(v.dtype).to(torch.float32), v.to(torch.float32)
    out = (weighted_stable(p, v) if p.is_cuda
           else torch.einsum("bshgk,bkhd->bshgd", p, v))
    return out.reshape(B, S, Hq, D)


# Blocked attention is an online softmax over K/V blocks of ``kv_block``
# keys, as the reference's scan, with the query positions in tiles of
# ``_TILE_ROWS // G`` (G query heads a KV head): a unit is one (row, kv
# head, query tile), ``_TILE_ROWS`` query-head rows.  Units go in groups
# of ``_UNIT_BATCH`` (the last zero-padded), each group stepping through
# its units' blocks as batched GEMMs of one shape ([_UNIT_BATCH, rows, D]
# @ [_UNIT_BATCH, D, kv_block]), so a (row, head)'s bits do not depend on
# the call's rows, heads or length on the card (the reason
# ``scores_stable`` exists), and no (row, kv head) pair count is padded.
# A block no query of a tile can see (above the causal diagonal, or
# behind every query's window) is skipped for that tile; a unit whose
# blocks run out before its group's keeps its state through
# ``torch.where``.
_TILE_ROWS = 2048
_UNIT_BATCH = 16
_FAR = 2 ** 30            # beyond any position, for the tiles' ranges


def _q_block(G: int) -> int:
    """Query positions a tile: ``_TILE_ROWS`` rows over G heads."""
    return max(1, _TILE_ROWS // G)


def _live_blocks(q_pos: torch.Tensor, k_pos: torch.Tensor, qb: int,
                 kv_block: int, causal: bool, window: Optional[int]) -> list:
    """Per row and query tile (``qb`` positions): the K/V blocks the tile
    must visit, in order, each as (block, whether its mask can drop a key:
    else every key of the block is visible to every query of the tile).
    q_pos [B, S] the queries' positions, k_pos [B, nblk * kv_block] with
    the reference's ``-10**9`` on padded keys.  One host read."""
    B, S = q_pos.shape
    nq = -(-S // qb)
    spad = nq * qb - S
    qmin = F.pad(q_pos, (0, spad), value=_FAR).reshape(B, nq, qb).amin(-1)
    qmax = F.pad(q_pos, (0, spad), value=-_FAR).reshape(B, nq, qb).amax(-1)
    kt = k_pos.reshape(B, -1, kv_block)
    valid = kt >= 0
    kstats = torch.stack([torch.where(valid, kt, _FAR).amin(-1),
                          torch.where(valid, kt, -_FAR).amax(-1),
                          valid.all(-1).to(kt.dtype)], -1)
    flat = torch.cat([torch.stack([qmin, qmax], -1).flatten(),
                      kstats.flatten()]).tolist()
    qs = [[flat[(b * nq + i) * 2:(b * nq + i) * 2 + 2] for i in range(nq)]
          for b in range(B)]
    off, nblk = B * nq * 2, kt.shape[1]
    ks = [[flat[off + (b * nblk + j) * 3:off + (b * nblk + j) * 3 + 3]
           for j in range(nblk)] for b in range(B)]
    out = []
    for b in range(B):
        row = []
        for qlo, qhi in qs[b]:
            blocks = []
            for j, (kmin, kmax, full) in enumerate(ks[b]):
                if (kmin == _FAR or (causal and kmin > qhi)
                        or (window is not None and kmax <= qlo - window)):
                    continue                 # no query of the tile sees it
                open_ = (full and (not causal or kmax <= qlo)
                         and (window is None or kmin > qhi - window))
                blocks.append((j, not open_))
            row.append(blocks)
        out.append(row)
    return out


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      logit_softcap: Optional[float] = None,
                      kv_block: int = 1024) -> torch.Tensor:
    """q [B, S, Hq, D], k/v [B, T, Hkv, D] -> float32 [B, S, Hq, D]: GQA
    by head grouping (no K/V repeat), an online softmax over K/V blocks of
    ``kv_block`` keys (the last padded with key position ``-10**9``), the
    running max, sum and accumulator in float32, the output ``acc /
    max(l, 1e-30)``; the mask and ``NEG_INF`` as :func:`full_attention`'s.
    K and V stay in their storage dtype: each block is cast to float32 as
    it is read, never the whole sequence.  The scale is applied to q in
    q's dtype, as the reference's.

    Skipping a block that no query of a tile can see keeps every row that
    sees at least one key bit for bit: before the row's first visible key
    such a block would add p = 1 a key (``NEG_INF`` is finite), wiped by
    the next ``corr = exp(-1e30 - m) = 0``; after it, it adds exact zeros
    (up to the sign of an exact zero).  A row that sees no key at all
    (never one of :func:`attention`'s) gets 0 where the reference gets
    the mean of V."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kb, qb, dev = kv_block, _q_block(G), q.device
    nblk, nq = -(-T // kb), -(-S // qb)
    R = qb * G                                 # query-head rows a unit
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)
    qg = (q.reshape(B, S, Hkv, G, D) * scale).to(torch.float32)
    spad, tpad = nq * qb - S, nblk * kb - T
    # units u = (b * Hkv + h) * nq + i; index U is a zero dummy unit
    U = B * Hkv * nq
    qu = torch.cat([F.pad(qg, (0, 0, 0, 0, 0, 0, 0, spad))
                    .permute(0, 2, 1, 3, 4).reshape(U, R, D),
                    qg.new_zeros((1, R, D))])

    def blocks_of(x):              # [B, T, Hkv, D] -> [B*Hkv*nblk + 1, kb, D]
        xb = F.pad(x, (0, 0, 0, 0, 0, tpad)).reshape(
            B, nblk, kb, Hkv, D).permute(0, 3, 1, 2, 4).reshape(-1, kb, D)
        return torch.cat([xb, xb.new_zeros((1, kb, D))])
    kblk, vblk = blocks_of(k), blocks_of(v)
    qp = F.pad(q_pos.to(torch.int32), (0, spad), value=-_FAR)
    kp = F.pad(k_pos.to(torch.int32), (0, tpad), value=-(10 ** 9))
    live = _live_blocks(q_pos.to(torch.int32), kp, qb, kb, causal, window)
    qpu = torch.cat([qp.reshape(B * nq, qb), qp.new_full((1, qb), -_FAR)])
    kpu = torch.cat([kp.reshape(B * nblk, kb),
                     kp.new_full((1, kb), -(10 ** 9))])
    plan = [live[u // (Hkv * nq)][u % nq] for u in range(U)]
    # groups of units with as many blocks as each other as can be: the
    # units in the order of their block counts, _UNIT_BATCH at a time;
    # each group's unit, K/V block, query-row and key-position indices go
    # to the device in one copy
    order = sorted(range(U), key=lambda u: (-len(plan[u]), u))
    groups, index = [], []
    for c in range(0, U, _UNIT_BATCH):
        units = order[c:c + _UNIT_BATCH]
        units = units + [U] * (_UNIT_BATCH - len(units))
        steps = []
        for t in range(max(len(plan[u]) for u in units if u < U)):
            on = [u < U and len(plan[u]) > t for u in units]
            js = [plan[u][t][0] if o else None for u, o in zip(units, on)]
            steps.append((all(on), any(o and plan[u][t][1]
                                       for u, o in zip(units, on))))
            index.append([
                [(u // nq) * nblk + j if o else B * Hkv * nblk
                 for u, j, o in zip(units, js, on)],
                [(u // (Hkv * nq)) * nblk + j if o else B * nblk
                 for u, j, o in zip(units, js, on)],
                [int(o) for o in on]])
        groups.append((units, steps))
    index = torch.tensor(index, dtype=torch.int64).reshape(-1, 3,
                                                           _UNIT_BATCH)
    index = index.to(dev)
    rows = torch.tensor([[u if u < U else U for u in units]
                         + [(u // (Hkv * nq)) * nq + u % nq if u < U
                            else B * nq for u in units]
                         for units, _ in groups],
                        dtype=torch.int64).to(dev)
    outs, n_step = [], 0
    for g, (units, steps) in enumerate(groups):
        qx = qu.index_select(0, rows[g, :_UNIT_BATCH])
        qrow = qpu.index_select(0, rows[g, _UNIT_BATCH:])
        m_run = qx.new_full((_UNIT_BATCH, R), NEG_INF)
        l_run = qx.new_zeros((_UNIT_BATCH, R))
        acc = qx.new_zeros((_UNIT_BATCH, R, D))
        for every_on, masked in steps:
            kidx, krow, on = index[n_step]
            n_step += 1
            s = torch.bmm(qx, kblk.index_select(0, kidx).to(torch.float32)
                          .transpose(1, 2))      # [UB, R, kb]
            if logit_softcap is not None:
                s = _softcap_scores(s, logit_softcap)
            if masked:
                keep = _mask(qrow, kpu.index_select(0, krow), window,
                             causal)             # [UB, qb, kb]
                s = s.view(_UNIT_BATCH, qb, G, kb).masked_fill(
                    ~keep[:, :, None], NEG_INF).view(_UNIT_BATCH, R, kb)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_new = l_run * corr + p.sum(-1)
            pv = torch.bmm(p.to(v.dtype).to(torch.float32),
                           vblk.index_select(0, kidx).to(torch.float32))
            a_new = acc * corr[..., None] + pv
            if not every_on:       # units out of blocks keep their state
                live_u = on.bool()[:, None]
                m_new = torch.where(live_u, m_new, m_run)
                l_new = torch.where(live_u, l_new, l_run)
                a_new = torch.where(live_u[..., None], a_new, acc)
            m_run, l_run, acc = m_new, l_new, a_new
        outs.append(acc / torch.clamp_min(l_run[..., None], 1e-30))
    inverse = torch.empty(U, dtype=torch.int64)
    inverse[torch.tensor(order)] = torch.arange(U)
    out = torch.cat(outs).index_select(0, inverse.to(dev))
    out = out.reshape(B, Hkv, nq * qb, G, D)[:, :, :S]
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)


def attention(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
              n_heads: int, n_kv: int, head_dim: int, causal: bool = True,
              window: Optional[int] = None,
              logit_softcap: Optional[float] = None,
              rope_theta: float = 10000.0, rope_mode: str = "rope",
              mrope_sections: tuple = (), mrope_positions=None,
              kv_block: int = 1024, quant: str = "none",
              compute_dtype=torch.bfloat16, return_kv: bool = False):
    """Self-attention over a full sequence (train / prefill;
    ``causal=False`` for whisper's encoder).  ``rope_mode`` "rope",
    "mrope" (at ``mrope_positions`` [B, S, 3], ``positions`` in all three
    components when None) or "none".  Up to ``2 * kv_block`` tokens the
    scores are one [B, S, H, S] tensor (:func:`full_attention`); past
    that the blocked online softmax (:func:`blocked_attention`), as the
    reference switches."""
    B, S, _ = x.shape
    q = _proj_qkv(p, "wq", x, B, S, head_dim, quant, compute_dtype)
    k = _proj_qkv(p, "wk", x, B, S, head_dim, quant, compute_dtype)
    v = _proj_qkv(p, "wv", x, B, S, head_dim, quant, compute_dtype)
    rot = dict(rope_mode=rope_mode, theta=rope_theta,
               sections=mrope_sections, mrope_positions=mrope_positions)
    q = rotate(q, positions, **rot)
    k = rotate(k, positions, **rot)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    if S <= 2 * kv_block:
        out = full_attention(q, k, v, positions, positions, window,
                             logit_softcap, causal)
    else:
        out = blocked_attention(q, k, v, positions, positions,
                                causal=causal, window=window,
                                logit_softcap=logit_softcap,
                                kv_block=kv_block)
    out = constrain(out.to(compute_dtype), "batch", None, "heads", None)
    y = _proj_out(p, out, B, S, quant, compute_dtype)
    if return_kv:
        return y, (k, v)
    return y


def arange_positions(B: int, S: int, device) -> torch.Tensor:
    """[B, S] int32 positions 0..S-1 in every row."""
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def _pos_vec(pos, B: int, device) -> torch.Tensor:
    """Decode positions as per-sequence [B] int32 (a scalar broadcasts;
    negative = free-slot sentinel, its keys never unmask)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(B) if pos.numel() == 1 else pos


def _write_kv_slot(cache: torch.Tensor, new: torch.Tensor,
                   slot: torch.Tensor) -> torch.Tensor:
    """Per-sequence in-place write: cache [B, T, ...], new [B, 1, ...],
    slot [B] — row b's token lands at ``cache[b, slot[b]]`` only."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache


def decode_kv_positions(pos: torch.Tensor, T: int,
                        rolling: bool = False) -> torch.Tensor:
    """[B, T] absolute position of each cache slot (negative sentinel on
    unwritten slots) for per-sequence decode at ``pos``.  ``rolling``: the
    cache is a T-slot ring, slot i holding the largest position ``p <=
    pos`` with ``p % T == i`` (a free row's negative ``pos`` leaves every
    slot negative)."""
    idx = torch.arange(T, dtype=torch.int32, device=pos.device)[None]
    posb = pos[:, None]
    if rolling:
        k_pos = posb - torch.remainder(posb - idx, T)
        return torch.where(k_pos < 0, -(10 ** 9), k_pos)
    return torch.where((idx <= posb) & (posb >= 0), idx, -(10 ** 9))


# ---------------------------------------------------------------------------
# paged KV cache: ordered gather / per-row page-table writes.  The pool is a
# shared [num_pages, page_size, ...] block store; each batch row owns a
# fixed-shape [E] int32 page-table row.  Gathering the pages in table order
# rebuilds the row's dense [T = E * page_size, ...] buffer, equal to the
# dense cache at every position the mask keeps (unmapped entries read the
# reserved null page 0, whose junk stays behind the position mask), and of
# the dense buffer's shape, so the attention after it is the dense path's.
# Plain indexing, no host read: both run inside a captured round.
# ---------------------------------------------------------------------------

def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool [P, ps, ...], table [B, E] int32 -> dense [B, E * ps, ...] in
    logical order (page j's rows land at positions [j * ps, (j + 1) * ps))."""
    B, E = table.shape
    g = pool.index_select(0, table.reshape(-1))          # [B * E, ps, ...]
    return g.reshape((B, E * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_write(pool: torch.Tensor, table: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> torch.Tensor:
    """One token a row written in place through the page table.

    pool [P, ps, ...]; table [B, E]; slot [B] int32 (the token's position in
    the row's logical buffer); new [B, 1, ...].  A free row's table row is
    all zeros, so its write lands in the null page, where several rows may
    write at once: only values the position mask hides (no ``accumulate``).
    Live rows own their current page, so their writes never collide."""
    ps = pool.shape[1]
    page = table.gather(1, (slot // ps).long()[:, None])[:, 0]
    pool[page.long(), (slot % ps).long()] = new[:, 0].to(pool.dtype)
    return pool


def decode_attention(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *, n_heads: int, n_kv: int,
                     head_dim: int, window: Optional[int] = None,
                     logit_softcap: Optional[float] = None,
                     rope_theta: float = 10000.0, rope_mode: str = "rope",
                     mrope_sections: tuple = (), rolling: bool = False,
                     quant: str = "none", compute_dtype=torch.bfloat16,
                     table: Optional[torch.Tensor] = None):
    """One decode step.  x [B, 1, d]; cache [B, T, Hkv, D]; pos scalar or
    [B] int32.  Returns (y, cache_k, cache_v) with the caches updated in
    place.  A negative ``pos[b]`` marks a free slot: its write lands inside
    its own row and every key of that row stays masked.  With ``rolling``
    the cache is a T-slot ring (a local layer's): the token lands at ``pos
    % T`` and each slot holds the latest position that maps there.
    ``rope_mode="mrope"`` rotates at ``pos`` in all three components, as
    the reference does (not at a vision prompt's max + 1).

    ``table`` ([B, E] int32) makes the caches page pools ([P, page_size,
    Hkv, D]): the token is written through the row's page table (a ring's
    table on a rolling layer) and the attention runs over the ordered page
    gather, the dense path's buffer at every unmasked position, so the
    output is the dense path's."""
    B = x.shape[0]
    paged = table is not None
    T = table.shape[1] * cache_k.shape[1] if paged else cache_k.shape[1]
    q = _proj_qkv(p, "wq", x, B, 1, head_dim, quant, compute_dtype)
    k = _proj_qkv(p, "wk", x, B, 1, head_dim, quant, compute_dtype)
    v = _proj_qkv(p, "wv", x, B, 1, head_dim, quant, compute_dtype)
    posv = _pos_vec(pos, B, x.device)
    posb = posv[:, None]
    q = rotate(q, posb, rope_mode, rope_theta, mrope_sections)
    k = rotate(k, posb, rope_mode, rope_theta, mrope_sections)
    slot = torch.remainder(posv, T) if rolling else torch.clamp(posv, 0,
                                                                 T - 1)
    if paged:
        paged_write(cache_k, table, slot, k)
        paged_write(cache_v, table, slot, v)
        dense_k = paged_gather(cache_k, table)
        dense_v = paged_gather(cache_v, table)
    else:
        dense_k = _write_kv_slot(cache_k, k, slot)
        dense_v = _write_kv_slot(cache_v, v, slot)
    k_pos = decode_kv_positions(posv, T, rolling)
    out = full_attention(q, dense_k, dense_v, posb, k_pos, window,
                         logit_softcap)
    y = _proj_out(p, out.to(compute_dtype), B, 1, quant, compute_dtype)
    return y, cache_k, cache_v


def _write_kv_block(cache: torch.Tensor, new: torch.Tensor,
                    start: torch.Tensor) -> torch.Tensor:
    """Contiguous in-place S-token write: cache [B, T, ...], new [B, S, ...],
    row b's tokens land at ``cache[b, start[b] : start[b] + S]``."""
    B, S = new.shape[:2]
    rows = torch.arange(B, device=cache.device)[:, None]
    idx = start.long()[:, None] + torch.arange(S, device=cache.device)[None]
    cache[rows, idx] = new.to(cache.dtype)
    return cache


def decode_attention_multi(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos, *, n_heads: int,
                           n_kv: int, head_dim: int,
                           logit_softcap: Optional[float] = None,
                           rope_theta: float = 10000.0,
                           rope_mode: str = "rope",
                           mrope_sections: tuple = (), quant: str = "none",
                           compute_dtype=torch.bfloat16,
                           table: Optional[torch.Tensor] = None):
    """A contiguous S-token decode block (speculative verify) over a
    full-length cache (a ring would wrap under the block: the engine
    refuses speculation on sliding windows).  x [B, S, d]; pos [B] int32
    start positions, token i of a row at ``pos + i``.

    The projections run once at M = B*S (the integer kernels are exact per
    row).  Rope and attention run per position i on [B, 1, ...] slices,
    with the shapes :func:`decode_attention` gives them, after all S K/V
    rows are written: query i masks every key past ``pos + i``, and a
    masked key adds an exact zero, so position i gets the bits S sequential
    decode calls would give it (CUDA picks reduction strategies by shape).
    Block starts clamp into [0, T - S] like the reference's
    ``dynamic_update_slice``: live rows need ``pos <= T - S`` (the
    scheduler's headroom guard); a free row (negative ``pos``) writes the
    tail of its own row and keeps every key masked.

    With ``table`` (page pools, as in :func:`decode_attention`) the block
    is S sequential per-token writes at ``clip(pos + i, 0, T - 1)``
    through the table, the reference's paged rule (not the dense block
    start): a free row's writes land in the null page.
    """
    B, S = x.shape[:2]
    paged = table is not None
    T = table.shape[1] * cache_k.shape[1] if paged else cache_k.shape[1]
    q = _proj_qkv(p, "wq", x, B, S, head_dim, quant, compute_dtype)
    k = _proj_qkv(p, "wk", x, B, S, head_dim, quant, compute_dtype)
    v = _proj_qkv(p, "wv", x, B, S, head_dim, quant, compute_dtype)
    posv = _pos_vec(pos, B, x.device)
    q_pos = posv[:, None] + torch.arange(S, dtype=torch.int32,
                                         device=x.device)[None]   # [B, S]
    rot = dict(rope_mode=rope_mode, theta=rope_theta,
               sections=mrope_sections)
    qs = [rotate(q[:, i:i + 1].contiguous(), q_pos[:, i:i + 1], **rot)
          for i in range(S)]
    k = torch.cat([rotate(k[:, i:i + 1].contiguous(), q_pos[:, i:i + 1],
                          **rot) for i in range(S)], dim=1)
    if paged:
        for i in range(S):
            slot = torch.clamp(posv + i, 0, T - 1)
            paged_write(cache_k, table, slot, k[:, i:i + 1])
            paged_write(cache_v, table, slot, v[:, i:i + 1])
        dense_k = paged_gather(cache_k, table)
        dense_v = paged_gather(cache_v, table)
    else:
        # the reference's dynamic_update_slice: a negative start wraps
        # (+T), then every start clamps into [0, T - S]
        start = torch.clamp(torch.where(posv < 0, posv + T, posv), 0, T - S)
        dense_k = _write_kv_block(cache_k, k, start)
        dense_v = _write_kv_block(cache_v, v, start)
    outs = []
    for i in range(S):
        # free rows stay negative: every key of theirs stays masked
        pos_i = torch.where(posv >= 0, posv + i, posv)
        outs.append(full_attention(qs[i], dense_k, dense_v,
                                   q_pos[:, i:i + 1],
                                   decode_kv_positions(pos_i, T),
                                   logit_softcap=logit_softcap))
    out = torch.cat(outs, dim=1)
    y = _proj_out(p, out.to(compute_dtype), B, S, quant, compute_dtype)
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# int8-quantized KV cache decode: int8 codes with per-token-per-head float32
# scales; QK^T and PV as integer products with float32 rescales.  CUDA has
# no int8 or int32 matmul, so both integer products run on the codes as
# float32, which is exact: every partial sum is an integer below 2^24 (a
# block of at most ``_EXACT_TERMS`` products of magnitude <= 127 * 127), and
# longer contractions add their block sums in float64 and round once, as
# the reference's int32 result rounds when cast to float32.  Codes of at
# most 127 are exact in TF32 too.  Every division by a constant divides by
# a device tensor (CUDA turns ``x / 127.0`` into a reciprocal multiply).
# ---------------------------------------------------------------------------

_EXACT_TERMS = 1024        # 1024 * 127 * 127 < 2^24


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _code_scale(xf: torch.Tensor, eps: float) -> torch.Tensor:
    """``max(max |x|, eps) / 127`` over the last axis of float32 ``xf``."""
    return _div(torch.clamp_min(torch.amax(torch.abs(xf), dim=-1), eps),
                127.0)


def quantize_kv(x: torch.Tensor):
    """x [B, T, H, D] -> (int8 codes [B, T, H, D], float32 scales
    [B, T, H]): ``scale = max(max |x|, 1e-8) / 127``, codes
    ``clip(round(x / scale), -127, 127)`` (half to even)."""
    xf = x.to(torch.float32)
    scale = _code_scale(xf, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def int_product(eq: str, a: torch.Tensor, b: torch.Tensor, a_dim: int,
                b_dim: int) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of integer-valued float32 operands of
    magnitude <= 127 contracting ``a``'s axis ``a_dim`` with ``b``'s
    ``b_dim``, equal to the int32 einsum cast to float32: blocks of at
    most ``_EXACT_TERMS`` terms are exact in float32; more add their block
    sums in float64 and round once."""
    n = a.shape[a_dim]
    if n <= _EXACT_TERMS:
        return torch.einsum(eq, a, b)
    acc = None
    for i in range(0, n, _EXACT_TERMS):
        w = min(_EXACT_TERMS, n - i)
        part = torch.einsum(eq, a.narrow(a_dim, i, w),
                            b.narrow(b_dim, i, w)).to(torch.float64)
        acc = part if acc is None else acc + part
    return acc.to(torch.float32)


def int8_kv_probs(q: torch.Tensor, k_q: torch.Tensor,
                  k_scale: torch.Tensor, v_scale: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  window: Optional[int] = None,
                  logit_softcap: Optional[float] = None):
    """The probabilities :func:`int8_kv_attention` quantizes: (``p_eff``
    [B, S, Hkv, G, T], the softmax with ``v_scale`` folded in, and its
    per-row scale ``p_scale`` [B, S, Hkv, G]).  q [B, S, Hq, D] float is
    quantized per (b, s, kv-head, group) row; the integer QK^T is rescaled
    as ``(s_int * (q_scale * k_scale)) / sqrt(D)``, then soft-capped
    (``logit_softcap``) and masked (causal, and ``window`` back), in the
    reference's order."""
    B, S, Hq, D = q.shape
    Hkv = k_q.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D).to(torch.float32)
    q_scale = _code_scale(qg, 1e-8)
    q_int = torch.clamp(torch.round(qg / q_scale[..., None]), -127, 127)
    s_int = int_product("bshgd,bkhd->bshgk", q_int, k_q.to(torch.float32),
                        4, 3)
    # scale[b, s, h, g, t] = q_scale[b, s, h, g] * k_scale[b, t, h]
    scale = q_scale[..., None] * k_scale.permute(0, 2, 1)[:, None, :, None]
    s = _div(s_int * scale, math.sqrt(D))
    if logit_softcap is not None:
        s = _softcap_scores(s, logit_softcap)
    keep = _mask(q_pos, k_pos, window)
    s = s.masked_fill(~keep[:, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    p_eff = p * v_scale.permute(0, 2, 1)[:, None, :, None]   # [B,S,Hkv,G,T]
    return p_eff, _code_scale(p_eff, 1e-12)


def int8_kv_attention(q: torch.Tensor, k_q: torch.Tensor,
                      k_scale: torch.Tensor, v_q: torch.Tensor,
                      v_scale: torch.Tensor, q_pos: torch.Tensor,
                      k_pos: torch.Tensor, window: Optional[int] = None,
                      logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Attention over an int8 cache, as the reference's: the probabilities
    of :func:`int8_kv_probs` (``window`` and ``logit_softcap`` as there)
    quantized per row (codes in [0, 127], since p and the scales are >=
    0), the integer PV rescaled by their scale.  q [B, S, Hq, D] float;
    k_q/v_q [B, T, Hkv, D] int8, scales [B, T, Hkv] float32 -> float32 [B,
    S, Hq, D]."""
    p_eff, p_scale = int8_kv_probs(q, k_q, k_scale, v_scale, q_pos, k_pos,
                                   window, logit_softcap)
    p_int = torch.round(p_eff / p_scale[..., None])
    o_int = int_product("bshgk,bkhd->bshgd", p_int, v_q.to(torch.float32),
                        4, 1)
    return (o_int * p_scale[..., None]).reshape(q.shape)


KV_INT8_LEAVES = ("k", "v", "k_scale", "v_scale")


def decode_attention_int8(p: Params, x: torch.Tensor, cache: dict, pos, *,
                          n_heads: int, n_kv: int, head_dim: int,
                          window: Optional[int] = None,
                          logit_softcap: Optional[float] = None,
                          rope_theta: float = 10000.0,
                          rope_mode: str = "rope", mrope_sections: tuple = (),
                          quant: str = "none", compute_dtype=torch.bfloat16,
                          table: Optional[torch.Tensor] = None):
    """One decode step over an int8 cache: ``cache`` {"k", "v": int8 [B, T,
    Hkv, D], "k_scale", "v_scale": float32 [B, T, Hkv]}, written in place.  The
    new K/V row is quantized per head, written at ``clip(pos, 0, T - 1)``,
    then attention reads the whole cache (:func:`int8_kv_attention`, with
    ``window`` and ``logit_softcap``).  With ``table`` the four leaves are page
    pools ([P, page_size, ...]: codes and scales page together, so every page
    carries its own scales).  Returns (y, cache)."""
    B = x.shape[0]
    paged = table is not None
    T = table.shape[1] * cache["k"].shape[1] if paged else cache["k"].shape[1]
    q = _proj_qkv(p, "wq", x, B, 1, head_dim, quant, compute_dtype)
    k = _proj_qkv(p, "wk", x, B, 1, head_dim, quant, compute_dtype)
    v = _proj_qkv(p, "wv", x, B, 1, head_dim, quant, compute_dtype)
    posv = _pos_vec(pos, B, x.device)
    posb = posv[:, None]
    q = rotate(q, posb, rope_mode, rope_theta, mrope_sections)
    k = rotate(k, posb, rope_mode, rope_theta, mrope_sections)
    k_new, ks_new = quantize_kv(k)
    v_new, vs_new = quantize_kv(v)
    slot = torch.clamp(posv, 0, T - 1)
    dense = {}
    for name, new in zip(KV_INT8_LEAVES, (k_new, v_new, ks_new, vs_new)):
        if paged:
            paged_write(cache[name], table, slot, new)
            dense[name] = paged_gather(cache[name], table)
        else:
            dense[name] = _write_kv_slot(cache[name], new, slot)
    out = int8_kv_attention(q, dense["k"], dense["k_scale"], dense["v"],
                            dense["v_scale"], posb,
                            decode_kv_positions(posv, T), window,
                            logit_softcap)
    y = _proj_out(p, out.to(compute_dtype), B, 1, quant, compute_dtype)
    return y, cache


def cross_attention(p: Params, x: torch.Tensor, enc: torch.Tensor, *,
                    n_heads: int, n_kv: int, head_dim: int,
                    quant: str = "none", compute_dtype=torch.bfloat16):
    """Encoder-decoder cross attention (whisper's decoder): queries from x
    [B, S, d], keys and values projected from the encoder output ``enc``
    [B, T, d], every key visible (no rotation, no causal mask)."""
    B, S, _ = x.shape
    T = enc.shape[1]
    q = _proj_qkv(p, "wq", x, B, S, head_dim, quant, compute_dtype)
    k = _proj_qkv(p, "wk", enc, B, T, head_dim, quant, compute_dtype)
    v = _proj_qkv(p, "wv", enc, B, T, head_dim, quant, compute_dtype)
    out = full_attention(q, k, v, arange_positions(B, S, x.device),
                         arange_positions(B, T, x.device), causal=False)
    return _proj_out(p, out.to(compute_dtype), B, S, quant, compute_dtype)
