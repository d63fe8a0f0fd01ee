"""Port vs reference: split-head attention leaves (``split_head_params``)
on the qwen2-7b smoke config, float32 compute.

The 3D leaves (``wq3``/``wk3``/``wv3`` [d, H, dh], ``wo3`` [H, dh, d],
[H, dh] biases) are float products in both packages, so the float
comparisons use ``atol=rtol=1e-5`` as ``tests/test_torch_model.py`` states
(XLA and ATen order float sums differently); structure, markers, split
axes, serving codes and temperature-0 transcripts are compared exactly.

* ``init_params`` gives the reference's tree structure and shapes, and
  ``params_from_jax`` carries its stacked ``[G, d, H, dh]`` leaves into
  per-layer ones;
* ``forward`` / ``prefill`` logits and caches, four ``decode_step`` calls
  with a free slot, and a ``verify_step`` after history (also bitwise
  against the port's sequential decode steps);
* ``loss_fn``'s gradients against ``jax.grad``, every leaf;
* ``quantize_params_for_serving("w4a4_lut")`` leaves the 3D leaves float
  and codes the rest as the reference does;
* ``tp.mark_tp_params`` at n_model 2: the reference's markers and split
  axes, ``shard_params``' slices, and markers inert on one device;
* the port's ``Engine`` + ``Scheduler`` transcripts against the
  reference's (w4a4_lut, 3 slots, staggered lengths);
* the card's shape-stable products (``attention.proj_stable`` /
  ``out_stable``) against the einsums they replace, on the CPU
  (``test_torch_cuda_sharded.py`` holds their bits across rows and heads
  on the card).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.dist import tp as jtp
from repro.models import transformer as JT
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import flatten
from repro_torch.dist import tp
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve.quantize import quantize_params_for_serving
from repro_torch.train import step as TS

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 32
LEAVES_3D = ("wq3", "wk3", "wv3", "wo3")


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _cfgs(quant="none", bias=False):
    over = dict(compute_dtype="float32", split_head_params=True,
                qkv_bias=bias)
    j = dataclasses.replace(jconfigs.get_config("qwen2-7b", smoke=True,
                                                quant=quant), **over)
    t = dataclasses.replace(tconfigs.get_config("qwen2-7b", smoke=True,
                                                quant=quant), **over)
    return j, t


_PARAMS = {}


def _params(quant="none"):
    """The reference's split-head params (quantized for a serving mode)
    and their conversion."""
    if quant not in _PARAMS:
        jcfg, tcfg = _cfgs(quant)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if quant != "none":
            jp = jquantize(jp, mode=quant)
        _PARAMS[quant] = jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return _PARAMS[quant]


def _cache_to_torch(jcache, n_layers):
    (c,) = jcache
    return [{k: torch.from_numpy(np.array(v[g])) for k, v in c.items()}
            for g in range(n_layers)]


@pytest.mark.parametrize("bias", [False, True])
def test_init_and_conversion_match_reference_structure(bias):
    jcfg, tcfg = _cfgs(bias=bias)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp_ = TT.init_params(tcfg, seed=0, device="cpu")
    attn = tp_["blocks"][0]["attn"]
    assert sorted(attn) == sorted(LEAVES_3D)
    H, K, D, d = tcfg.n_heads, tcfg.n_kv, tcfg.head_dim, tcfg.d_model
    assert attn["wq3"]["w"].shape == (d, H, D)
    assert attn["wk3"]["w"].shape == attn["wv3"]["w"].shape == (d, K, D)
    assert attn["wo3"]["w"].shape == (H, D, d)
    assert ("b" in attn["wq3"]) == bias and "b" not in attn["wo3"]
    if bias:
        assert attn["wk3"]["b"].shape == (K, D)
    jattn = jp["blocks"][0]["attn"]
    for k in LEAVES_3D:
        assert sorted(jattn[k]) == sorted(attn[k]), k
        for n, v in jattn[k].items():
            assert tuple(v.shape[1:]) == tuple(attn[k][n].shape), (k, n)
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    for g in range(tcfg.n_layers):
        for k in LEAVES_3D:
            assert np.array_equal(
                conv["blocks"][g]["attn"][k]["w"].numpy(),
                np.asarray(jp["blocks"][0]["attn"][k]["w"][g]))


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_forward_and_prefill_match(quant):
    jcfg, tcfg = _cfgs(quant)
    jp, tp_ = _params(quant)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 9))
    want, _ = JT.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = TT.forward(tp_, tcfg, torch.from_numpy(toks))
    _close(got, want)
    wl, wc = JT.prefill(jp, jcfg, jnp.asarray(toks))
    gl, gc = TT.prefill(tp_, tcfg, torch.from_numpy(toks))
    _close(gl, wl)
    for g, c in zip(gc, _cache_to_torch(wc, tcfg.n_layers)):
        _close(g["k"], c["k"])
        _close(g["v"], c["v"])


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_decode_steps_match(quant):
    jcfg, tcfg = _cfgs(quant)
    jp, tp_ = _params(quant)
    B, T = 3, 12
    rng = np.random.default_rng(8)
    jc = JT.init_cache(jcfg, B, T)
    tc = TT.init_cache(tcfg, B, T, device="cpu")
    pos = np.array([0, 3, -1], np.int32)
    for _ in range(4):
        tok = rng.integers(0, jcfg.vocab, B).astype(np.int32)
        wl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                jnp.asarray(pos))
        gl, tc = TT.decode_step(tp_, tcfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos.copy()))
        _close(gl[:2], wl[:2])                  # row 2 is a free slot
        assert torch.isfinite(gl).all()
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    for g, c in zip(tc, _cache_to_torch(jc, tcfg.n_layers)):
        _close(g["k"][:2], c["k"][:2])
        _close(g["v"][:2], c["v"][:2])


def test_verify_step_matches_reference_and_sequential_decode():
    jcfg, tcfg = _cfgs("w4a4_tmac")
    jq, tq = _params("w4a4_tmac")
    B, S, T = 3, 4, 16
    rng = np.random.default_rng(3)
    hist = rng.integers(0, jcfg.vocab, (B, 3)).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    pos = np.array([0, 2, -1], np.int32)
    jc = JT.init_cache(jcfg, B, T)
    tc = TT.init_cache(tcfg, B, T, device="cpu")
    for j in range(hist.shape[1]):
        _, jc = JT.decode_step(jq, jcfg, jnp.asarray(hist[:, j]), jc,
                               jnp.asarray(pos))
        _, tc = TT.decode_step(tq, tcfg, torch.from_numpy(hist[:, j]), tc,
                               torch.from_numpy(pos.copy()))
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    want, jc = JT.verify_step(jq, jcfg, jnp.asarray(toks), jc,
                              jnp.asarray(pos))
    seq = [{k: v.clone() for k, v in c.items()} for c in tc]
    got, tc = TT.verify_step(tq, tcfg, torch.from_numpy(toks), tc,
                             torch.from_numpy(pos.copy()))
    live = pos >= 0
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], **TOL)
    for g, c in zip(tc, _cache_to_torch(jc, tcfg.n_layers)):
        _close(g["k"], c["k"])
    p = torch.from_numpy(pos.copy())
    for i in range(S):
        li, seq = TT.decode_step(tq, tcfg, torch.from_numpy(toks[:, i]),
                                 seq, torch.where(p >= 0, p + i, p))
        assert torch.equal(got[:2, i], li[:2]), i


def test_loss_gradients_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp_ = _params()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jl, jg = jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, {
        k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tl, tg = TS.value_and_grad(TS.loss_for(tcfg), tp_,
                               TS.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), tcfg,
                           device="cpu")
    paths, wl = flatten(want)
    _, gl = flatten(tg)
    n3 = 0
    for p, w, g in zip(paths, wl, gl, strict=True):
        assert g.shape == w.shape, p
        _close(g, w)
        n3 += any(f"['{k}']" in p for k in LEAVES_3D)
    assert n3 == 4 * tcfg.n_layers


def test_serving_quantization_leaves_3d_float():
    jq, tq = _params("w4a4_lut")
    _, tcfg = _cfgs("w4a4_lut")
    _, tf = _params()
    mine = quantize_params_for_serving(tf, mode="w4a4_lut")
    for g in range(tcfg.n_layers):
        attn = mine["blocks"][g]["attn"]
        for k in LEAVES_3D:
            assert set(attn[k]) == {"w"}, k
            assert attn[k]["w"].is_floating_point()
            assert torch.equal(attn[k]["w"], tf["blocks"][g]["attn"][k]["w"])
        assert "w_q" in mine["blocks"][g]["mlp"]["wi"]
    paths, got = flatten(mine)
    wpaths, want = flatten(tq)
    assert paths == wpaths
    for p, a, b in zip(paths, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def _modes(tree, dims, path=()):
    out = {}
    if isinstance(tree, dict):
        mode = tp.leaf_tp_mode(tree)
        if mode is not None:
            return {path: (mode, dims)}
        for k, v in tree.items():
            out.update(_modes(v, dims[k], path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_modes(v, dims[i], path + (i,)))
    return out


def _ref_split(spec):
    entries = tuple(spec)
    return (entries.index("model") - len(entries) if "model" in entries
            else None)


def test_marking_matches_reference_and_markers_are_inert():
    jcfg, tcfg = _cfgs("w4a4_lut")
    jq, tq = _params("w4a4_lut")
    jm, jspecs, jn = jtp.mark_tp_params(jq, 2, head_dim=jcfg.head_dim)
    marked, dims, n = tp.mark_tp_params(tq, 2, head_dim=tcfg.head_dim)
    ref = {p: (m, {k: _ref_split(s) for k, s in d.items()})
           for p, (m, d) in _modes(jm, jspecs).items()}
    got = _modes(marked, dims)
    folded = set()
    for path, val in got.items():
        key = ("blocks", 0) + path[2:] if path[0] == "blocks" else path
        assert ref.get(key) == val, (path, ref.get(key), val)
        folded.add(key)
    assert folded == set(ref)
    attn = marked["blocks"][0]["attn"]
    for k in ("wq3", "wk3", "wv3"):
        assert tp.leaf_tp_mode(attn[k]) == "head", k
    assert tp.leaf_tp_mode(attn["wo3"]) is None
    assert dims["blocks"][0]["attn"]["wq3"] == dict(w=-2, tp_head=None)
    # the reference counts a stacked leaf once, the port a layer's
    assert tp.attn_group_counts(marked) == (tcfg.n_layers,) * 2
    assert jtp.attn_group_counts(jm) == (1, 1)
    assert n - 1 == (jn - 1) * tcfg.n_layers       # the head: once each
    # each rank's slice holds whole heads; the slices make the leaf again
    parts = [tp.shard_params(marked, SimpleNamespace(model_index=i,
                                                     n_model=2))
             for i in range(2)]
    for k in ("wq3", "wk3", "wv3"):
        full = attn[k]["w"]
        got_parts = [p["blocks"][0]["attn"][k]["w"] for p in parts]
        assert got_parts[0].shape[-2] == full.shape[-2] // 2
        assert torch.equal(torch.cat(got_parts, -2), full)
    assert all(p["blocks"][0]["attn"]["wo3"]["w"] is attn["wo3"]["w"]
               for p in parts)
    toks = torch.arange(6, dtype=torch.int64)[None] % tcfg.vocab
    a, _ = TT.prefill(tq, tcfg, toks)
    b, _ = TT.prefill(marked, tcfg, toks)
    assert torch.equal(a, b)


def test_biased_heads_split_with_their_bias():
    _, tcfg = _cfgs("w4a4_lut", bias=True)
    q = quantize_params_for_serving(
        TT.init_params(tcfg, seed=0, device="cpu"), mode="w4a4_lut")
    marked, dims, _ = tp.mark_tp_params(q, 2, head_dim=tcfg.head_dim)
    assert dims["blocks"][0]["attn"]["wk3"] == dict(w=-2, b=-2,
                                                    tp_head=None)
    part = tp.shard_params(marked, SimpleNamespace(model_index=1, n_model=2))
    b = marked["blocks"][0]["attn"]["wk3"]["b"]
    assert torch.equal(part["blocks"][0]["attn"]["wk3"]["b"],
                       b[tcfg.n_kv // 2:])


def _requests(make, vocab):
    rng = np.random.default_rng(1)
    return [make(prompt=rng.integers(0, vocab, L).tolist(),
                 max_new_tokens=b)
            for L, b in zip([3, 9, 5, 12, 1], [5, 4, 7, 3, 6])]


def test_scheduler_transcripts_match_reference():
    jcfg, tcfg = _cfgs("w4a4_lut")
    jp, tp_ = _params()
    jeng = jserve.make_engine(jp, jcfg, jserve.ServeConfig(
        quant="w4a4_lut", max_len=MAX_LEN))
    jreqs = _requests(jserve.Request, jcfg.vocab)
    jserve.Scheduler(jeng, slots=3, chunk=3).run(jreqs)
    teng = tserve.make_engine(tp_, tcfg, tserve.ServeConfig(
        quant="w4a4_lut", max_len=MAX_LEN), device="cpu")
    treqs = _requests(tserve.Request, tcfg.vocab)
    tserve.Scheduler(teng, slots=3, chunk=3).run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.tokens == j.tokens
        assert t.finish_reason == j.finish_reason
    assert teng.kv_cache_bytes(3) == jeng.kv_cache_bytes(3)


@pytest.mark.parametrize("B,S,H", [(3, 1, 4), (2, 5, 2), (17, 2, 5),
                                   (1, 1, 1)])
def test_stable_split_head_products_match_einsum(B, S, H):
    g = torch.Generator().manual_seed(B * 7 + S)
    d, dh = 24, 8
    x = torch.randn((B, S, d), generator=g)
    w = torch.randn((d, H, dh), generator=g)
    _close(TA.proj_stable(x, w), torch.einsum("bsd,dhk->bshk", x, w))
    o = torch.randn((B, S, H, dh), generator=g)
    wo = torch.randn((H, dh, d), generator=g)
    _close(TA.out_stable(o, wo), torch.einsum("bshk,hkd->bsd", o, wo))
