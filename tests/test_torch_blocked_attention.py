"""Port vs reference, blocked attention: ``attention.blocked_attention``
against the reference's, ``attention()``'s switch at 2 * kv_block, the
skipped blocks, and the paths that take it (prefill of qwen2-7b, gemma2-2b
with its window and soft-cap, whisper's bidirectional encoder, and the
training gradient of minicpm-2b), on the CPU at smoke sizes with
``kv_block = 8`` and 40 tokens (float32 compute).

Tolerances and why:

* ``blocked_attention`` against the reference's: rtol = atol = 2e-5, the
  reference's own (``tests/test_attention.py``): float32 sums over a block
  in another order (XLA's dot against ATen's GEMM); with bf16 q, K and V
  too (the probabilities cast to bf16 before the value product, as the
  reference casts them; measured up to 8.3e-7 on these inputs).
* skipping blocks no query of a tile sees: bitwise against visiting every
  block.
* prefill logits and K/V, the encoder output: 1e-5, as the models' other
  tests (``test_torch_gemma2.py``, ``test_torch_encdec.py``).
* loss rtol 2e-6 and gradients each leaf within 1e-4 of its own max |g|
  plus 1e-3 of the tree's, as ``test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import flatten
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 2e-5
MODEL_ATOL = 1e-5
LOSS_RTOL = 2e-6
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-3
KV_BLOCK = 8
S_LONG = 40


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _qkv(seed, B=2, S=64, Hq=4, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return q, k, v, pos


def _both(x, dtype):
    j = jnp.asarray(x).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _np(x):
    return x.detach().to(torch.float32).numpy()


def _run_both(q, k, v, pos, kv_dtype=jnp.float32, causal=True, **kw):
    jq, tq = _both(q, jnp.float32 if kv_dtype == jnp.float32 else kv_dtype)
    jk, tk = _both(k, kv_dtype)
    jv, tv = _both(v, kv_dtype)
    jp, tp = jnp.asarray(pos), torch.from_numpy(np.ascontiguousarray(pos))
    want = JA.blocked_attention(jq, jk, jv, jp, jp, causal=causal, **kw)
    got = TA.blocked_attention(tq, tk, tv, tp, tp, causal=causal, **kw)
    assert got.dtype == torch.float32
    return np.asarray(want), _np(got)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_blocked_matches_reference(window, softcap):
    q, k, v, pos = _qkv(0)
    want, got = _run_both(q, k, v, pos, window=window, logit_softcap=softcap,
                          kv_block=16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S,kv_block,tile_rows", [
    (50, 16, 2048), (300, 64, 2048), (300, 64, 64), (37, 8, 16)])
def test_blocked_nondivisible_length_matches_reference(monkeypatch, S,
                                                       kv_block, tile_rows):
    """A last block padded with key position -10**9, a last query tile
    padded, and (tile_rows < 2 S) several query tiles."""
    monkeypatch.setattr(TA, "_TILE_ROWS", tile_rows)
    q, k, v, pos = _qkv(1, S=S)
    want, got = _run_both(q, k, v, pos, kv_block=kv_block)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (6, 1), (4, 4)])
def test_blocked_gqa_matches_reference(Hq, Hkv):
    q, k, v, pos = _qkv(2, S=48, Hq=Hq, Hkv=Hkv)
    want, got = _run_both(q, k, v, pos, window=20, kv_block=16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (16, 20.0)])
def test_blocked_bf16_kv_matches_reference(window, softcap):
    """bf16 K/V (and q), each block cast to float32 as it is read."""
    q, k, v, pos = _qkv(3, S=56)
    want, got = _run_both(q, k, v, pos, kv_dtype=jnp.bfloat16, window=window,
                          logit_softcap=softcap, kv_block=16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [None, 12])
def test_blocked_bidirectional_matches_reference(window):
    """``causal=False`` (whisper's encoder), with and without a window."""
    q, k, v, pos = _qkv(4, S=45)
    want, got = _run_both(q, k, v, pos, causal=False, window=window,
                          kv_block=8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _visit_every_block(monkeypatch):
    """Make the port visit every block with its mask (the reference's
    scan) and count the blocks the real planner skips."""
    real = TA._live_blocks
    counts = {"kept": 0, "all": 0}

    def every(q_pos, k_pos, qb, kv_block, causal, window):
        plan = real(q_pos, k_pos, qb, kv_block, causal, window)
        nblk = k_pos.shape[1] // kv_block
        counts["kept"] += sum(len(t) for row in plan for t in row)
        counts["all"] += sum(nblk for row in plan for _ in row)
        return [[[(j, True) for j in range(nblk)] for _ in row]
                for row in plan]
    monkeypatch.setattr(TA, "_live_blocks", every)
    return counts


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 24, 20.0), (False, 10, None)])
def test_skipping_masked_blocks_keeps_the_result(monkeypatch, causal,
                                                 window, softcap):
    """Blocks that no query of a tile sees (above the causal diagonal,
    behind every window) are skipped: the output is bitwise the one that
    visits every block, and within the reference's tolerance.  Tiles of 64
    query rows (32 positions) over blocks of 32 keys, so tiles see few
    blocks."""
    monkeypatch.setattr(TA, "_TILE_ROWS", 64)
    q, k, v, pos = _qkv(5, B=2, S=600, Hq=4, Hkv=2, D=8)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    tp = torch.from_numpy(np.ascontiguousarray(pos))
    kw = dict(causal=causal, window=window, logit_softcap=softcap,
              kv_block=32)
    skipped = TA.blocked_attention(*t, tp, tp, **kw)
    with monkeypatch.context() as m:
        counts = _visit_every_block(m)
        every = TA.blocked_attention(*t, tp, tp, **kw)
    assert counts["kept"] < counts["all"]      # blocks were skipped
    assert torch.equal(skipped, every)
    jp = jnp.asarray(pos)
    want = JA.blocked_attention(*(jnp.asarray(x) for x in (q, k, v)), jp, jp,
                                **kw)
    np.testing.assert_allclose(_np(skipped), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_blocked_equals_full_attention_of_the_port():
    q, k, v, pos = _qkv(6, S=70)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    tp = torch.from_numpy(np.ascontiguousarray(pos))
    full = TA.full_attention(*t, tp, tp, 16, 20.0)
    blk = TA.blocked_attention(*t, tp, tp, window=16, logit_softcap=20.0,
                               kv_block=16)
    np.testing.assert_allclose(_np(blk), _np(full), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# attention()'s switch
# ---------------------------------------------------------------------------

def _attn_params(seed, d=32, H=4, Hkv=2, D=8):
    rng = np.random.default_rng(seed)
    w = {n: (rng.standard_normal((d, h * D)) / np.sqrt(d)).astype(np.float32)
         for n, h in (("wq", H), ("wk", Hkv), ("wv", Hkv))}
    w["wo"] = (rng.standard_normal((H * D, d)) / np.sqrt(H * D)).astype(
        np.float32)
    jp = {n: {"w": jnp.asarray(x)} for n, x in w.items()}
    tp = {n: {"w": torch.from_numpy(x)} for n, x in w.items()}
    return jp, tp


@pytest.mark.parametrize("S,blocked", [(2 * KV_BLOCK, False),
                                       (2 * KV_BLOCK + 1, True)])
def test_attention_switches_as_the_reference(monkeypatch, S, blocked):
    """``attention`` runs full up to 2 * kv_block tokens and blocked past
    it, and matches the reference's at both lengths."""
    jp, tp = _attn_params(7)
    x = np.random.default_rng(8).standard_normal((2, S, 32)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S))
    calls = []
    real = TA.blocked_attention
    monkeypatch.setattr(TA, "blocked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(n_heads=4, n_kv=2, head_dim=8, kv_block=KV_BLOCK,
              compute_dtype=torch.float32)
    got, (k, v) = TA.attention(tp, torch.from_numpy(x),
                               torch.from_numpy(np.ascontiguousarray(pos)),
                               return_kv=True, **kw)
    assert bool(calls) == blocked
    want, (jk, jv) = JA.attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                  n_heads=4, n_kv=2, head_dim=8,
                                  kv_block=KV_BLOCK,
                                  compute_dtype=jnp.float32, return_kv=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_np(k), np.asarray(jk), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the models' paths past 2 * kv_block
# ---------------------------------------------------------------------------

def _cfgs(arch):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                            compute_dtype="float32", kv_block=KV_BLOCK)
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                            compute_dtype="float32", kv_block=KV_BLOCK)
    return j, t


_P = {}


def _params(arch):
    if arch not in _P:
        jc, tc = _cfgs(arch)
        init = JE.init_params if jc.enc_dec else JT.init_params
        jp = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(0), jc)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                             device="cpu")
        _P[arch] = (jp, tp)
    return _P[arch]


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b"])
def test_prefill_past_two_blocks_matches_reference(monkeypatch, arch):
    """Prefill at 40 tokens with kv_block 8 (the blocked path in both
    packages; gemma2's smoke window of 8 and soft-cap of 50 on its local
    layers): last-token logits and every layer's full-length K/V."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    calls = []
    real = TA.blocked_attention
    monkeypatch.setattr(TA, "blocked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = np.random.default_rng(10).integers(0, jc.vocab, (2, S_LONG))
    jl, jcache = JT.prefill(jp, jc, jnp.asarray(toks), full_kv=True)
    tl, tcache = TT.prefill(tp, tc, torch.from_numpy(toks))
    assert len(calls) == tc.n_layers
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                               atol=MODEL_ATOL)
    P = len(tc.pattern)
    for i, c in enumerate(tcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                _np(c[key]), np.asarray(jcache[i % P][key][i // P]), rtol=0,
                atol=MODEL_ATOL, err_msg=f"layer {i} {key}")


def test_whisper_encoder_past_two_blocks_matches_reference(monkeypatch):
    """whisper's bidirectional encoder over 40 frames with kv_block 8."""
    jc, tc = _cfgs("whisper-large-v3")
    jp, tp = _params("whisper-large-v3")
    calls = []
    real = TA.blocked_attention
    monkeypatch.setattr(TA, "blocked_attention",
                        lambda *a, **k: calls.append(k["causal"])
                        or real(*a, **k))
    frames = np.random.default_rng(11).standard_normal(
        (2, S_LONG, jc.d_model)).astype(np.float32)
    want = JE.encode(jp, jc, jnp.asarray(frames))
    got = TE.encode(tp, tc, torch.from_numpy(frames))
    assert calls == [False] * tc.n_enc_layers
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=MODEL_ATOL)


def test_training_gradient_past_two_blocks_matches_reference():
    """minicpm-2b's loss and gradients at 40 tokens with kv_block 8: the
    backward runs through the block loop (under remat as configured)."""
    jc, tc = _cfgs("minicpm-2b")
    jp, tp = _params("minicpm-2b")
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, jc.vocab, (2, S_LONG)).astype(np.int32),
             "labels": rng.integers(0, jc.vocab, (2, S_LONG)).astype(
                 np.int32)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jc, b)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = TS.value_and_grad(TS.loss_for(tc), tp,
                               TS.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), tc,
                           device="cpu")
    paths, wl = flatten(want)
    gl = flatten(tg)[1]
    gmax = max(float(w.abs().max()) for w in wl if w.numel())
    for p, w, g in zip(paths, wl, gl, strict=True):
        err = float((w - g).abs().max())
        lim = GRAD_RTOL * (float(w.abs().max()) + GRAD_FLOOR * gmax)
        assert err <= lim, (p, err, lim)
