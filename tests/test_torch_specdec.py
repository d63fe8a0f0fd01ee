"""Port vs reference, the speculative slice: the S-token verify forward
(``decode_attention_multi``, ``verify_step``), the truncated-plane drafter
(``draft_params_view``), bitplane leaves through ``params_from_jax``, and
``make_engine`` + ``Scheduler`` serving qwen2-7b-smoke in w4a4_tmac (with
and without ``spec_decode``) and bitnet-3b-smoke in ternary_a8_tmac.

Transcripts are compared exactly.  Float results against the reference
agree at ``atol=rtol=1e-5`` (float32 compute: XLA and ATen order the float
reductions differently).  The verify forward against S sequential port
``decode_step`` calls is compared bitwise: the tmac projections are exact
per row, and the float ops run per position at decode's shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serve import quantize as jquant
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.core.lut import decode_planes, unpack_bitplanes
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve import quantize as tquant

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 40


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _cfgs(arch="qwen2-7b", quant="w4a4_tmac"):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    return j, t


_TREES = {}


def _trees(arch="qwen2-7b", quant="w4a4_tmac"):
    """(JAX float params, JAX quantized params, the port's float params,
    the JAX quantized tree converted) for a smoke config."""
    key = (arch, quant)
    if key not in _TREES:
        jcfg, tcfg = _cfgs(arch, quant)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        jq = jquant.quantize_params_for_serving(jp, mode=quant)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
        tq = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), tcfg,
                             device="cpu")
        _TREES[key] = (jp, jq, tp, tq)
    return _TREES[key]


@pytest.fixture(autouse=True)
def _reset_dispatch():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)
    ops.set_variant(None)


def _cache_to_torch(jcache, n_layers):
    (c,) = jcache
    return [{k: torch.from_numpy(np.array(v[g])) for k, v in c.items()}
            for g in range(n_layers)]


# ---------------------------------------------------------------------------
# params_from_jax on quantized trees; the port's quantizer on the same tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,quant", [("qwen2-7b", "w4a4_tmac"),
                                        ("bitnet-3b", "ternary_a8_tmac")])
def test_params_from_jax_takes_quantized_trees(arch, quant):
    jcfg, tcfg = _cfgs(arch, quant)
    _, jq, tp, tq = _trees(arch, quant)
    leaf = tq["blocks"][1]["mlp"]["wi"]
    P = 2 if quant.startswith("ternary") else 4
    assert leaf["w_q"].shape == (P, tcfg.d_model // 8, tcfg.d_ff)
    assert leaf["w_q"].dtype == torch.uint8
    assert leaf["w_tmac"].shape == (0,)
    assert ("w_tern" in leaf) == (P == 2)
    np.testing.assert_array_equal(
        leaf["w_q"].numpy(),
        np.asarray(jq["blocks"][0]["mlp"]["wi"]["w_q"][1]))
    assert tq["lm_head"]["w_q"].dtype == torch.int8
    # the port's own quantizer on the same float tree: the same structure,
    # int codes bitwise.  Ternary scales are mean-|w| (test_torch_tmac's
    # docstring: within 4 ulp), so a code whose |w| / scale sits on the .5
    # rounding boundary may round the other way; every other code is equal
    mine = tquant.quantize_params_for_serving(tp, mode=quant)
    jl = jax.tree_util.tree_flatten_with_path(tq)[0]
    tl = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    flips = 0
    for (path, a), (_, b) in zip(jl, tl):
        key = jax.tree_util.keystr(path)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if P == 4 or "lm_head" in key or torch.equal(a, b):
            assert torch.equal(a, b), key
        elif key.endswith("['w_scale']"):
            np.testing.assert_array_max_ulp(b.numpy(), a.numpy(), maxulp=4)
        else:
            assert key.endswith("['w_q']"), key
            leaf = eval("tp" + key[:-len("['w_q']")])   # noqa: S307
            ratio = (leaf["w"].abs() / eval("tq" + key[:-len("['w_q']")])[
                "w_scale"]).numpy()
            ca, cb = (decode_planes(unpack_bitplanes(t), "ternary")
                      for t in (a, b))
            where = (ca != cb).numpy()
            np.testing.assert_allclose(ratio[where], 0.5, rtol=1e-6)
            flips += int(where.sum())
    assert flips <= 2


# ---------------------------------------------------------------------------
# the drafter view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft_planes", [2, 3])
def test_draft_params_view_matches_reference(draft_planes):
    jcfg, tcfg = _cfgs()
    _, jq, _, tq = _trees()
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jquant.draft_params_view(jq, draft_planes)), tcfg,
        device="cpu")
    got = tquant.draft_params_view(tq, draft_planes)
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert torch.equal(a, b), path
    # the reference counts its [G, ...] stacks, the port its layers
    assert tquant.count_draftable_leaves(tq, draft_planes) == \
        7 * tcfg.n_layers
    assert jquant.count_draftable_leaves(jq, draft_planes) == 7
    # views of the target's bytes; the head and norms are the same objects
    wq = tq["blocks"][0]["attn"]["wq"]["w_q"]
    assert got["blocks"][0]["attn"]["wq"]["w_q"].data_ptr() == \
        wq[4 - draft_planes].data_ptr()
    assert got["lm_head"]["w_q"] is tq["lm_head"]["w_q"]
    _, _, _, bq = _trees("bitnet-3b", "ternary_a8_tmac")
    assert tquant.count_draftable_leaves(bq, 2) == 0


# ---------------------------------------------------------------------------
# the verify forward
# ---------------------------------------------------------------------------

def _attn_case(quant, seed=4, B=3, T=12, H=4, Hkv=2, D=16, S=4):
    rng = np.random.default_rng(seed)
    d = H * D
    jp = JA.init_attention(jax.random.PRNGKey(seed), d, H, Hkv, D,
                           qkv_bias=True)
    jp = jax.tree_util.tree_map(lambda a: a + 0.01, jp)   # nonzero biases
    if quant != "none":
        jp = jquant.quantize_params_for_serving({"attn": jp},
                                                mode=quant)["attn"]
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    ck = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    cv = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return jp, tp, x, ck, cv, dict(n_heads=H, n_kv=Hkv, head_dim=D,
                                   quant=quant)


@pytest.mark.parametrize("quant", ["none", "w4a4_tmac"])
@pytest.mark.parametrize("pos", [[4, 0, 8], [2, -1, 5]])
def test_decode_attention_multi_matches(quant, pos):
    jp, tp, x, ck, cv, kw = _attn_case(quant)
    pos = np.asarray(pos, np.int32)
    want = JA.decode_attention_multi(jp, jnp.asarray(x), jnp.asarray(ck),
                                     jnp.asarray(cv), jnp.asarray(pos),
                                     compute_dtype=jnp.float32, **kw)
    got = TA.decode_attention_multi(tp, torch.from_numpy(x),
                                    torch.from_numpy(ck.copy()),
                                    torch.from_numpy(cv.copy()),
                                    torch.from_numpy(pos.copy()),
                                    compute_dtype=torch.float32, **kw)
    live = pos >= 0                      # free rows' outputs are unused
    np.testing.assert_allclose(_np(got[0])[live], _np(want[0])[live], **TOL)
    for g, w in zip(got[1:], want[1:]):  # every row's cache, free included
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_decode_attention_multi_equals_sequential_decode():
    """Bitwise: S sequential decode_attention calls give the same outputs
    and caches (integer projections; the float ops per position)."""
    _, tp, x, ck, cv, kw = _attn_case("w4a4_tmac", seed=5)
    pos = torch.tensor([3, 0, 7], dtype=torch.int32)
    xt = torch.from_numpy(x)
    y, k1, v1 = TA.decode_attention_multi(
        tp, xt, torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        pos, compute_dtype=torch.float32, **kw)
    k2, v2 = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    for i in range(x.shape[1]):
        yi, k2, v2 = TA.decode_attention(tp, xt[:, i:i + 1], k2, v2,
                                         pos + i,
                                         compute_dtype=torch.float32, **kw)
        assert torch.equal(y[:, i:i + 1], yi), i
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def _verify_case(arch, quant, B=3, S=4, T=16, seed=7):
    jcfg, tcfg = _cfgs(arch, quant)
    _, jq, _, tq = _trees(arch, quant)
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, jcfg.vocab, (B, 6)).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tcfg, jq, tq, hist, toks, T


@pytest.mark.parametrize("arch,quant", [("qwen2-7b", "w4a4_tmac"),
                                        ("bitnet-3b", "ternary_a8_tmac")])
def test_verify_step_matches_reference_and_sequential_decode(arch, quant):
    """After a few decode steps of history, one verify over S tokens:
    against the reference's verify_step (tolerance), and bitwise against S
    sequential port decode_steps, logits and caches."""
    jcfg, tcfg, jq, tq, hist, toks, T = _verify_case(arch, quant)
    B, S = toks.shape
    pos0 = np.array([0, 2, -1], np.int32)      # row 2 is a free slot
    jc = JT.init_cache(jcfg, B, T)
    tc = TT.init_cache(tcfg, B, T, device="cpu")
    pos = pos0.copy()
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
    assert got.shape == (B, S, jcfg.vocab) and got.dtype == torch.float32
    live = pos >= 0
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], **TOL)
    for g, c in zip(tc, _cache_to_torch(jc, tcfg.n_layers)):
        np.testing.assert_allclose(_np(g["k"]), _np(c["k"]), **TOL)
    p = torch.from_numpy(pos.copy())
    for i in range(S):
        li, seq = TT.decode_step(tq, tcfg, torch.from_numpy(toks[:, i]),
                                 seq, torch.where(p >= 0, p + i, p))
        assert torch.equal(got[:2, i], li[:2]), i
    for a, b in zip(tc, seq):
        assert torch.equal(a["k"][:2], b["k"][:2])
        assert torch.equal(a["v"][:2], b["v"][:2])


# ---------------------------------------------------------------------------
# serving: the port against the reference engine, and spec == non-spec
# ---------------------------------------------------------------------------

def _requests(make, vocab, seed=1, eos_id=None):
    rng = np.random.default_rng(seed)
    lens, budgets = [3, 9, 5, 12, 1], [5, 4, 7, 3, 6]
    return [make(prompt=rng.integers(0, vocab, L).tolist(),
                 max_new_tokens=b, eos_id=eos_id)
            for L, b in zip(lens, budgets)]


_JAX_RUNS = {}


def _jax_transcripts(arch, quant):
    if (arch, quant) not in _JAX_RUNS:
        jcfg, _ = _cfgs(arch, quant)
        jp, _, _, _ = _trees(arch, quant)
        eng = jserve.make_engine(jp, jcfg, jserve.ServeConfig(
            quant=quant, max_len=MAX_LEN))
        reqs = _requests(jserve.Request, jcfg.vocab)
        jserve.Scheduler(eng, slots=3, chunk=3).run(reqs)
        _JAX_RUNS[(arch, quant)] = [(r.tokens, r.finish_reason)
                                    for r in reqs]
    return _JAX_RUNS[(arch, quant)]


def _serve(params, tcfg, max_len=MAX_LEN, eos_id=None, slots=3, chunk=3,
           **scfg):
    eng = tserve.make_engine(params, tcfg, tserve.ServeConfig(
        max_len=max_len, **scfg), device="cpu")
    reqs = _requests(tserve.Request, tcfg.vocab, eos_id=eos_id)
    sched = tserve.Scheduler(eng, slots=slots, chunk=chunk)
    sched.run(reqs)
    return [(r.tokens, r.finish_reason) for r in reqs], sched, eng


@pytest.mark.parametrize("backend,variant", [("ref", None), ("cuda", None),
                                             ("cuda", "unfused")])
def test_tmac_transcripts_match_reference(backend, variant):
    """qwen2-7b-smoke quantized at load to w4a4_tmac by the port: the
    reference engine's transcripts, through each dispatch."""
    want = _jax_transcripts("qwen2-7b", "w4a4_tmac")
    _, tcfg = _cfgs()
    _, _, tp, _ = _trees()
    ops.set_backend(backend)
    ops.set_variant(variant)
    got, _, _ = _serve(tp, tcfg, quant="w4a4_tmac")
    assert got == want


def test_tmac_transcripts_equal_lut_transcripts():
    """w4 bitplanes decode to the nibble codes: w4a4_tmac serves exactly
    what w4a4_lut serves from the same float weights."""
    _, tcfg = _cfgs()
    _, _, tp, _ = _trees()
    lut = dataclasses.replace(tcfg, quant="w4a4_lut")
    got, _, _ = _serve(tp, tcfg, quant="w4a4_tmac")
    want, _, _ = _serve(tp, lut, quant="w4a4_lut")
    assert got == want


@pytest.mark.parametrize("draft_k,draft_planes", [(3, 2), (2, 3), (1, 2)])
def test_spec_transcripts_equal_plain(draft_k, draft_planes):
    want = _jax_transcripts("qwen2-7b", "w4a4_tmac")
    _, tcfg = _cfgs()
    _, _, _, tq = _trees()
    got, sched, eng = _serve(tq, tcfg, spec_decode=True, draft_k=draft_k,
                             draft_planes=draft_planes)
    assert got == want
    st = sched.stats
    assert st["spec_rounds"] == sched.stats["rounds"] > 0
    assert st["spec_drafted"] > 0 and 0 <= st["spec_accepted"] <= \
        st["spec_drafted"]
    assert eng.lane_steps["draft"] == draft_k * st["spec_rounds"]
    assert eng.lane_steps["verify"] == st["spec_rounds"]
    assert eng.lane_steps["decode"] == 0


def _zero_low_planes(tree, draft_planes=2):
    if isinstance(tree, dict):
        if tquant._draftable(tree, draft_planes):
            out = dict(tree)
            out["w_q"] = tree["w_q"].clone()
            out["w_q"][:tree["w_q"].shape[0] - draft_planes] = 0
            return out
        return {k: _zero_low_planes(v, draft_planes) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zero_low_planes(v, draft_planes) for v in tree)
    return tree


@pytest.mark.parametrize("draft_planes", [2, 3])
def test_spec_low_planes_zeroed_accepts_every_draft(draft_planes):
    """With the low planes zero the drafter's logits are the target's, so
    every draft is accepted — only if the verify forward's float ops give
    each row decode's bits."""
    _, tcfg = _cfgs()
    _, _, _, tq = _trees()
    zq = _zero_low_planes(tq, draft_planes)
    want, _, _ = _serve(zq, tcfg)
    got, sched, _ = _serve(zq, tcfg, spec_decode=True,
                           draft_planes=draft_planes)
    assert got == want
    st = sched.stats
    assert st["spec_drafted"] > 0
    assert st["spec_accepted"] == st["spec_drafted"]
    assert sched.stats["emitted_tokens"] == sum(len(t) for t, _ in got)


def test_spec_near_max_len_falls_back_and_matches():
    """Rows within draft_k+1 of max_len take plain rounds (the headroom
    guard); transcripts still equal the non-speculative engine's."""
    _, tcfg = _cfgs()
    _, _, _, tq = _trees()
    max_len = 15                       # the 12-token prompt + 3 just fits
    want, _, _ = _serve(tq, tcfg, max_len=max_len)
    got, sched, eng = _serve(tq, tcfg, max_len=max_len, spec_decode=True)
    assert got == want
    assert sched.stats["spec_rounds"] > 0
    assert sched.stats["spec_rounds"] < sched.stats["rounds"]
    assert eng.lane_steps["decode"] > 0            # fallback plain rounds
    assert all(c["k"].shape[1] == max_len for c in sched.cache)


def test_spec_eos_inside_a_block():
    """EOS accepted inside a speculative block cuts the row there: on a
    zeroed lowest plane (a 3-plane drafter accepts every draft) pick an EOS
    that is the first occurrence of its token and not the last column of
    its block."""
    _, tcfg = _cfgs()
    _, _, _, tq = _trees()
    zq = _zero_low_planes(tq, 3)
    plain, _, _ = _serve(zq, tcfg)
    # the first token comes from the chunk lane, then blocks of 4
    r, i = next((r, i) for r, (toks, _) in enumerate(plain)
                for i in range(1, len(toks) - 1)
                if i % 4 and toks[i] not in toks[:i])
    toks = plain[r][0]
    want, _, _ = _serve(zq, tcfg, eos_id=toks[i])
    got, sched, _ = _serve(zq, tcfg, eos_id=toks[i], spec_decode=True,
                           draft_planes=3)
    assert got == want
    assert got[r] == (toks[:i + 1], "eos")
    assert sched.stats["spec_accepted"] < sched.stats["spec_drafted"]


def test_bitnet_transcripts_match_reference():
    """bitnet-3b-smoke in ternary_a8_tmac: the reference quantizer's codes
    through the port serve the reference's transcripts, through each
    dispatch.  (The port's own codes differ from the reference's at a .5
    rounding boundary here — test_params_from_jax_takes_quantized_trees —
    and a late token of one request follows that code.)"""
    want = _jax_transcripts("bitnet-3b", "ternary_a8_tmac")
    _, tcfg = _cfgs("bitnet-3b", "ternary_a8_tmac")
    _, _, _, tq = _trees("bitnet-3b", "ternary_a8_tmac")
    got, _, _ = _serve(tq, tcfg)
    assert got == want
    ops.set_backend("cuda")
    ops.set_variant("unfused")
    assert _serve(tq, tcfg)[0] == want


def test_spec_config_validation():
    _, tcfg = _cfgs()
    _, _, tp, tq = _trees()
    with pytest.raises(ValueError, match="draft_k"):
        tserve.ServeConfig(spec_decode=True, draft_k=0)
    with pytest.raises(ValueError, match="draft_planes"):
        tserve.ServeConfig(spec_decode=True, draft_planes=1)
    with pytest.raises(ValueError, match="max_len"):
        tserve.ServeConfig(spec_decode=True, draft_k=4, max_len=4)
    with pytest.raises(ValueError, match="no draftable"):
        tserve.make_engine(tp, dataclasses.replace(tcfg, quant="w4a4_lut"),
                           tserve.ServeConfig(quant="w4a4_lut",
                                              spec_decode=True),
                           device="cpu")
    with pytest.raises(ValueError, match="no draftable"):
        tserve.make_engine(tq, tcfg, tserve.ServeConfig(
            spec_decode=True, draft_planes=4), device="cpu")
    eng = tserve.make_engine(tq, tcfg, tserve.ServeConfig(), device="cpu")
    with pytest.raises(ValueError, match="spec_decode"):
        eng.step(eng.init_cache(1), None, torch.zeros(1, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.bool),
                 torch.full((1,), -1, dtype=torch.int32), 1, spec=True)


def test_leaf_width_rule():
    """A bitplane leaf takes its weight spec from itself: the drafter's
    2-plane view of a w4 leaf runs under the w4a4_tmac mode."""
    _, tcfg = _cfgs()
    _, _, _, tq = _trees()
    from repro_torch.models.layers import linear
    leaf = tq["blocks"][0]["attn"]["wq"]
    draft = tquant.draft_params_view({"l": leaf}, 2)["l"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, tcfg.d_model)).astype(np.float32))
    y = linear(draft, x, "w4a4_tmac", torch.float32)
    want = ops.prequant_matmul(x, draft["w_q"], draft["w_scale"],
                               mode="w2a4_tmac",
                               compute_dtype=torch.float32) + draft["b"]
    assert torch.equal(y, want)
    with pytest.raises(ValueError, match="bitplanes"):
        ops.prequant_matmul(x, draft["w_q"], draft["w_scale"],
                            mode="w4a4_tmac")
