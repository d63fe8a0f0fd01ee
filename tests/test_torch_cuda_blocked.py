"""Blocked attention on the card (marker ``gpu``; skips without a GPU;
imports no JAX):

* ``attention.blocked_attention`` gives every (row, head) the same bits
  whatever rows and heads the call holds (a data shard's rows, a model
  rank's heads), at qwen2-7b's, gemma2-2b's (window and soft-cap) and
  minicpm-2b's prefill shapes past 2 x kv_block;
* just past 2 x kv_block, blocked equals ``full_attention`` within the
  stated tolerance: float32 K/V at the reference's own 2e-5 (sums in
  another order); bf16 K/V each within (2^-8 + 2^-12) x sum_k p_k |v_k,d|
  of a float64 softmax, element by element (each path rounds its
  probabilities to bf16 before the value product, the full path's
  normalized and the blocked path's not, each within 2^-8 relative, bf16's
  unit roundoff; 2^-12 for the float32 scores, exponentials and sums), so
  the two within twice that;
* skipping the blocks no query of a tile sees keeps the bits of visiting
  every block.

    python -m pytest -q -m gpu tests/test_torch_cuda_blocked.py
"""
import math

import pytest
import torch

from repro_torch.models import attention as A

pytestmark = [pytest.mark.gpu, pytest.mark.skipif(
    not torch.cuda.is_available(), reason="needs a CUDA GPU")]


def _inputs(B, S, Hq, Hkv, D, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    return q, k, v, A.arange_positions(B, S, "cuda")


@pytest.mark.parametrize("B,S,Hq,Hkv,D,kv_block,window,cap", [
    (4, 2100, 28, 4, 128, 1024, None, None),     # qwen2-7b
    (2, 4152, 8, 4, 256, 1024, 4096, 50.0),      # gemma2-2b, local layer
    (2, 4104, 8, 4, 256, 1024, None, 50.0),      # gemma2-2b, global layer
    (2, 2500, 36, 36, 64, 1024, None, None),     # minicpm-2b
    (3, 700, 12, 4, 128, 64, 100, None)])
def test_cuda_blocked_bits_ignore_rows_and_heads(B, S, Hq, Hkv, D, kv_block,
                                                 window, cap):
    q, k, v, pos = _inputs(B, S, Hq, Hkv, D)
    kw = dict(window=window, logit_softcap=cap, kv_block=kv_block)
    full = A.blocked_attention(q, k, v, pos, pos, **kw)
    G = Hq // Hkv
    r, hk = max(1, B // 2), max(1, Hkv // 2)
    for rows, k0, nk in ((slice(r, None), hk, Hkv - hk),
                         (slice(None, r), 0, hk),
                         (slice(r - 1, r), Hkv - 1, 1),
                         (slice(None), hk, Hkv - hk)):
        part = A.blocked_attention(q[rows, :, k0 * G:(k0 + nk) * G],
                                   k[rows, :, k0:k0 + nk],
                                   v[rows, :, k0:k0 + nk], pos[rows],
                                   pos[rows], **kw)
        assert torch.equal(full[rows, :, k0 * G:(k0 + nk) * G], part), (
            rows, k0, nk)


P_REL, F32_REL = 2.0 ** -8, 2.0 ** -12


def _f64(q, k, v, window, cap):
    """Causal attention of q [S, Hq, D] over k/v [S, Hkv, D] in float64
    (q scaled in its dtype first, as the model does), with the window and
    soft-cap: the output and sum_k p_k |v_k,d|, both [S, Hq, D]."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)
    qg = (q * scale).double().reshape(S, Hkv, Hq // Hkv, D)
    kd, vd = k.double(), v.double()
    pos = torch.arange(S, device=q.device)
    out, mass = [], []
    for i in range(0, S, 256):
        s = torch.einsum("rhgd,khd->rhgk", qg[i:i + 256], kd)
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        d = pos[i:i + 256, None] - pos[None]
        keep = d >= 0
        if window is not None:
            keep = keep & (d < window)
        p = torch.softmax(s.masked_fill(~keep[:, None, None], -math.inf), -1)
        out.append(torch.einsum("rhgk,khd->rhgd", p, vd).reshape(-1, Hq, D))
        mass.append(torch.einsum("rhgk,khd->rhgd", p, vd.abs())
                    .reshape(-1, Hq, D))
    return torch.cat(out), torch.cat(mass)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,window,cap", [
    (28, 4, 128, None, None), (8, 4, 256, 1500, 50.0),
    (36, 36, 64, None, None)])
def test_cuda_blocked_equals_full_just_past_two_blocks(dtype, Hq, Hkv, D,
                                                       window, cap):
    kv_block = 1024
    q, k, v, pos = _inputs(1, 2 * kv_block + 1, Hq, Hkv, D, dtype, seed=1)
    blk = A.blocked_attention(q, k, v, pos, pos, window=window,
                              logit_softcap=cap, kv_block=kv_block)
    full = A.full_attention(q, k, v, pos, pos, window, cap)
    err = float((blk - full).abs().max())
    if dtype == torch.float32:
        assert torch.allclose(blk, full, rtol=2e-5, atol=2e-5), err
    else:
        exact, mass = _f64(q[0], k[0], v[0], window, cap)
        lim = (P_REL + F32_REL) * mass
        for got in (blk, full):
            e = (got[0].double() - exact).abs()
            assert bool((e <= lim).all()), float((e / mass).max())
        assert bool(((blk - full)[0].double().abs() <= 2 * lim).all()), err


def test_cuda_skipping_keeps_the_bits(monkeypatch):
    q, k, v, pos = _inputs(2, 3000, 28, 4, 128, seed=2)
    kw = dict(window=1100, logit_softcap=50.0, kv_block=512)
    skipped = A.blocked_attention(q, k, v, pos, pos, **kw)
    real = A._live_blocks

    def every(q_pos, k_pos, qb, kv_block, causal, window):
        plan = real(q_pos, k_pos, qb, kv_block, causal, window)
        nblk = k_pos.shape[1] // kv_block
        return [[[(j, True) for j in range(nblk)] for _ in row]
                for row in plan]
    monkeypatch.setattr(A, "_live_blocks", every)
    assert torch.equal(A.blocked_attention(q, k, v, pos, pos, **kw), skipped)
