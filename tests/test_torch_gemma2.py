"""Port vs reference, gemma2-2b's model code on the CPU: the zero-centered
``rms_norm``, ``stable_tanh``, ``softcap`` and the GeGLU ``mlp``; the
sliding-window ``_mask`` and the rolling ``decode_kv_positions``; the ring
arrangements ``_ring_positions`` / ``_ring_from_full`` (engine) and
``_roll_local`` (transformer); the smoke config's ``forward``,
``prefill`` and ``decode_step`` logits past the window; the weight
converter on gemma's two-position tree; and the refusals (speculative
decoding on sliding windows, the int8 KV cache with them, the verify
forward).

The same numpy-seeded inputs go through both packages.  Tolerances,
float32 throughout: the elementwise functions within 2 float32 ulp
(``rtol=2.4e-7``, ``atol=1e-7``: XLA's and ATen's ``exp``/``tanh`` are
different approximations); one MLP and one model forward within ``atol``
1e-5 of the reference (float32 sums in other orders); positions, masks and
ring arrangements exactly.
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE

from _torch_threads import one_torch_thread  # noqa: F401

ELEM = dict(rtol=2.4e-7, atol=1e-7)
MODEL_ATOL = 1e-5
W = 8                         # the smoke config's window
MAX_LEN = 32


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _cfgs(quant="none", **over):
    return [dataclasses.replace(mod.get_config("gemma2-2b", smoke=True,
                                               quant=quant),
                                compute_dtype="float32", **over)
            for mod in (jconfigs, tconfigs)]


_P = {}


def _params():
    """The reference's float tree (seed 0) and the port's conversion."""
    if not _P:
        jcfg, tcfg = _cfgs()
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        # gemma's zero-centered scales start at 0 in the real model; random
        # ones make the (1 + scale) path visible
        rng = np.random.default_rng(5)
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: (jnp.asarray(rng.normal(0, 0.3, a.shape),
                                         a.dtype)
                             if "scale" in jax.tree_util.keystr(path) else a),
            jp)
        _P["j"] = jp
        _P["t"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  tcfg, device="cpu")
    return _P["j"], _P["t"]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_matches_reference(zero_centered):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (3, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(0, 0.5, 64).astype(np.float32)}
    want = JL.rms_norm({"scale": jnp.asarray(p["scale"])}, jnp.asarray(x),
                       zero_centered=zero_centered)
    got = TL.rms_norm({"scale": torch.as_tensor(p["scale"])},
                      torch.as_tensor(x), zero_centered=zero_centered)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ELEM)


def _wide_values(n=4099, seed=1):
    """Values across tanh's range: tiny, moderate, saturating, both signs,
    and exact zeros."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, s, n // 4) for s in
                        (1e-3, 1.0, 5.0, 60.0)] + [np.zeros(n - n // 4 * 4)])
    return x.astype(np.float32)


def test_stable_tanh_matches_reference():
    x = _wide_values()
    np.testing.assert_allclose(_np(TL.stable_tanh(torch.as_tensor(x))),
                               np.asarray(JL.stable_tanh(jnp.asarray(x))),
                               **ELEM)


@pytest.mark.parametrize("cap", [30.0, 50.0])
def test_softcap_matches_reference(cap):
    x = _wide_values(seed=2) * 10
    got = _np(TL.softcap(torch.as_tensor(x), cap))
    want = np.asarray(JL.softcap(jnp.asarray(x), cap))
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=cap * 1e-7)
    assert np.abs(got).max() <= cap


def test_gelu_tanh_matches_jax_and_is_shape_stable():
    """Within ``2.4e-7 * |x| + 1e-7`` of ``jax.nn.gelu(approximate=True)``
    (XLA:CPU's ``tanh`` is up to 4 * 2^-24 from ATen's, and ``x * 0.5 * (1
    + tanh)`` scales that by |x| / 2), and the same bits for a value
    whatever the length of the tensor it sits in (ATen's ``F.gelu`` gives
    a tensor's scalar tail other bits)."""
    x = _wide_values(seed=3) / 10
    full = TL.gelu_tanh(torch.as_tensor(x))
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    assert (np.abs(_np(full) - want) <= 2.4e-7 * np.abs(x) + 1e-7).all()
    for n in (1, 3, 15, 17, 33, 100):
        for off in (0, 7, 1000):
            part = TL.gelu_tanh(torch.as_tensor(x[off:off + n]))
            assert torch.equal(part, full[off:off + n]), (n, off)


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_geglu_mlp_matches_reference(quant):
    jp, tp = _params()
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 3, 64)).astype(np.float32)
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0]["mlp"])
    want = JL.mlp(jm, jnp.asarray(x), "geglu", quant, jnp.float32)
    got = TL.mlp(tp["blocks"][0]["mlp"], torch.as_tensor(x), quant,
                 torch.float32, kind="geglu")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=MODEL_ATOL)


def test_mlp_refuses_an_unknown_kind():
    _, tp = _params()
    with pytest.raises(ValueError, match="relu_sq"):
        TL.mlp(tp["blocks"][0]["mlp"], torch.zeros(1, 1, 64),
               kind="relu_sq")


# ---------------------------------------------------------------------------
# masks, rolling positions, rings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 1, 3, W])
def test_window_mask_matches_reference(window):
    q = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    k = np.array([[-5, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11],
                  [11, 10, -1, 8, 7, 6, 5, 4, 3, 2, 1, 0]], np.int32)
    want = JA._mask(jnp.asarray(q), jnp.asarray(k), True, window)
    got = TA._mask(torch.as_tensor(q), torch.as_tensor(k), window)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("T", [1, 4, W])
def test_decode_kv_positions_match_reference(rolling, T):
    """Every position a slot can be at, free slots (negative) included: a
    free row keeps every key behind the sentinel under rolling addressing
    too."""
    pos = np.array([-7, -1, 0, 1, 3, 7, 8, 9, 15, 16, 31], np.int32)
    want = np.asarray(JA.decode_kv_positions(jnp.asarray(pos), T, rolling))
    got = _np(TA.decode_kv_positions(torch.as_tensor(pos), T, rolling))
    np.testing.assert_array_equal(got, want)
    assert (got[pos < 0] < 0).all()


LENGTHS = [1, 3, 7, 8, 9, 12, 16, 17]


@pytest.mark.parametrize("T", [4, W])
def test_ring_positions_and_ring_from_full_match_reference(T):
    P = max(LENGTHS)
    lengths = np.array(LENGTHS, np.int32)
    kv = np.random.default_rng(6).normal(
        0, 1, (1, len(LENGTHS), P, 2, 3)).astype(np.float32)
    want_p = JE._ring_positions(jnp.asarray(lengths), T)
    got_p = TE._ring_positions(torch.as_tensor(lengths), T)
    np.testing.assert_array_equal(_np(got_p), np.asarray(want_p))
    want = JE._ring_from_full(jnp.asarray(kv), jnp.asarray(lengths), T)
    got = TE._ring_from_full(torch.as_tensor(kv[0]),
                             torch.as_tensor(lengths), T)
    np.testing.assert_array_equal(_np(got), np.asarray(want)[0])


@pytest.mark.parametrize("S", [3, W, 11, 21])
def test_roll_local_matches_reference(S):
    k = np.random.default_rng(7).normal(0, 1, (2, S, 2, 3)).astype(
        np.float32)
    want = np.asarray(JT._roll_local(jnp.asarray(k), S, W))
    got = _np(TT._roll_local(torch.as_tensor(k), S, W))
    np.testing.assert_array_equal(got, want)
    # the oracle's ring is the stitch's ring
    ring = TE._ring_from_full(torch.as_tensor(k),
                              torch.full((2,), S, dtype=torch.int32), W)
    np.testing.assert_array_equal(got, _np(ring))


# ---------------------------------------------------------------------------
# the model: forward / prefill / decode past the window
# ---------------------------------------------------------------------------

def test_forward_matches_reference_past_the_window():
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    toks = np.random.default_rng(8).integers(0, 512, (2, 13))
    want, _ = JT.forward(jp, jcfg, jnp.asarray(toks))
    got, aux = TT.forward(tp, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=MODEL_ATOL)
    assert float(aux) == 0.0
    assert np.abs(_np(got)).max() <= 30.0          # the final soft-cap


@pytest.mark.parametrize("S", [5, 12])
def test_prefill_and_decode_match_reference(S):
    """prefill, then 10 decode steps over the dense rings (a prompt of 12
    rolls at once; one of 5 wraps during decode), logits within
    ``MODEL_ATOL`` of the reference's at every step; the port's K/V of a
    local layer equals its prefill's full-length K/V rolled."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    B = 2
    toks = np.random.default_rng(9).integers(0, 512, (B, S + 10))
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :S]))
    tl, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks[:, :S]))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                               atol=MODEL_ATOL)
    # the reference rolls its local layer's K/V past the window, the port
    # returns it full length (the reference's full_kv=True)
    for key in ("k", "v"):
        assert tc[0][key].shape[1] == S
        np.testing.assert_allclose(
            _np(TT._roll_local(tc[0][key], S, W)) if S > W
            else _np(tc[0][key]), np.asarray(jc[0][key][0]), rtol=0,
            atol=MODEL_ATOL)
    jeng = jserve.Engine(jcfg, jp, jserve.ServeConfig(max_len=MAX_LEN))
    teng = tserve.Engine(tcfg, tp, tserve.ServeConfig(max_len=MAX_LEN),
                         device="cpu")
    jcache = jeng._grow_cache(jc, S)
    tcache = teng._grow_cache(tc, S)
    assert [c["k"].shape[1] for c in tcache] == [W, MAX_LEN]
    jdecode = jax.jit(JT.decode_step, static_argnums=1)
    for i in range(10):
        pos = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i]
        jl, jcache = jdecode(jp, jcfg, jnp.asarray(tok), jcache,
                             jnp.asarray(pos))
        tl, tcache = TT.decode_step(tp, tcfg, torch.as_tensor(tok), tcache,
                                    torch.as_tensor(pos))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                                   atol=MODEL_ATOL, err_msg=f"step {i}")


def test_decode_free_slot_leaves_live_rows_alone():
    """A free row (negative position) beside a live one on the rings: the
    live row's logits and cache rows are the same whatever the free row's
    cache holds, and the free row writes only inside its own row."""
    _, tcfg = _cfgs()
    _, tp = _params()
    tok = torch.tensor([3, 5])
    pos = torch.tensor([11, -1], dtype=torch.int32)
    out = []
    for seed in (0, 1):
        torch.manual_seed(0)
        cache = TT.init_cache(tcfg, 2, MAX_LEN, device="cpu")
        for c in cache:
            for t in c.values():
                t[0].normal_()
        torch.manual_seed(seed + 1)
        for c in cache:
            for t in c.values():
                t[1].normal_()
        logits, cache = TT.decode_step(tp, tcfg, tok, cache, pos)
        out.append((logits[0], [t[0].clone() for c in cache
                                for t in c.values()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# weights, caches, refusals
# ---------------------------------------------------------------------------

def test_params_from_jax_converts_the_gemma_tree_leaf_for_leaf():
    """Two pattern positions unstacked in layer order, the post norms
    included and no lm_head (tied); the port's own init has the same
    structure."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    assert "lm_head" not in tp
    assert len(tp["blocks"]) == tcfg.n_layers
    for i, bp in enumerate(tp["blocks"]):
        g, j = divmod(i, len(tcfg.pattern))
        ref = jax.tree_util.tree_map(lambda a: np.asarray(a[g]),
                                     jp["blocks"][j])
        flat_t = jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(_np, bp))
        flat_j = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
        for (path, a), (_, b) in zip(flat_t, flat_j):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        assert {"post_attn_ln", "post_mlp_ln"} <= set(bp)
    np.testing.assert_array_equal(_np(tp["embed"]["emb"]),
                                  np.asarray(jp["embed"]["emb"]))
    own = TT.init_params(tcfg, seed=0, device="cpu")
    shape = lambda t: jax.tree_util.tree_structure(  # noqa: E731
        jax.tree_util.tree_map(lambda a: 0, t))
    assert shape(own) == shape(tp)


def test_cache_geometry_matches_reference():
    """Dense rings of min(max_len, window) on local layers, full-length
    global layers, and the engines' KV bytes (dense and paged) equal."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    for max_len in (4, MAX_LEN):
        dense = TT.init_cache(tcfg, 3, max_len, device="cpu")
        assert [c["k"].shape for c in dense] == [
            (3, min(max_len, W), 2, 16), (3, max_len, 2, 16)]
    for extra in ({}, {"paged": True, "page_size": 4}):
        je = jserve.Engine(jcfg, jp, jserve.ServeConfig(max_len=MAX_LEN,
                                                        **extra))
        te = tserve.Engine(tcfg, tp, tserve.ServeConfig(max_len=MAX_LEN,
                                                        **extra),
                           device="cpu")
        assert te._kv_leaf_bytes(3) == je._kv_leaf_bytes(3)
        assert te.chunk_window_limit == je.chunk_window_limit == W
        for L in (1, W, W + 1, MAX_LEN):
            assert te.chunk_eligible(L) == je.chunk_eligible(L)


@pytest.mark.parametrize("arch", ["gemma2-2b", "phi3-medium-14b",
                                  "minicpm-2b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_check_supported_accepts_the_dense_families(arch, smoke):
    TT.check_supported(tconfigs.get_config(arch, smoke=smoke))


def test_int8_kv_with_sliding_windows_is_refused():
    """Once refused, now served: an int8 KV cache beside sliding windows
    and the attention soft-cap (smoke and full configs) gives int8 codes
    to the global layers only, float rings to the local ones, as the
    reference's ``init_cache``; the verify forward still refuses it."""
    jcfg, tcfg = _cfgs(kv_quant="int8")
    TT.check_supported(tcfg)
    TT.check_supported(dataclasses.replace(
        tconfigs.get_config("gemma2-2b"), kv_quant="int8"))
    jc = JT.init_cache(jcfg, 2, 12)
    tc = TT.init_cache(tcfg, 2, 12, device="cpu")
    for i, c in enumerate(tc):
        local = TT.is_local(tcfg, TT.layer_spec(tcfg, i))
        assert set(c) == set(jc[i % len(tcfg.pattern)])
        assert set(c) == ({"k", "v"} if local
                          else {"k", "v", "k_scale", "v_scale"})
        assert c["k"].dtype == (torch.float32 if local else torch.int8)
        assert c["k"].shape[1] == (tcfg.window if local else 12)
    _, tp = _params()
    with pytest.raises(ValueError, match="speculative decoding supports"):
        TT.verify_step(tp, tcfg, torch.zeros((2, 2), dtype=torch.int32), tc,
                       torch.zeros((2,), dtype=torch.int32))


def test_spec_decode_on_sliding_windows_is_refused_as_the_reference():
    jcfg, tcfg = _cfgs("w4a4_tmac")
    jp, tp = _params()
    kw = dict(quant="w4a4_tmac", max_len=MAX_LEN, spec_decode=True)
    with pytest.raises(ValueError) as want:
        jserve.Engine(jcfg, jp, jserve.ServeConfig(**kw))
    with pytest.raises(ValueError) as got:
        tserve.Engine(tcfg, tp, tserve.ServeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
    assert "sliding-window" in str(got.value)


def test_verify_step_refuses_sliding_windows_as_the_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    toks = np.zeros((1, 2), np.int32)
    pos = np.zeros((1,), np.int32)
    with pytest.raises(ValueError) as want:
        JT.verify_step(jp, jcfg, jnp.asarray(toks),
                       JT.init_cache(jcfg, 1, MAX_LEN), jnp.asarray(pos))
    with pytest.raises(ValueError) as got:
        TT.verify_step(tp, tcfg, torch.as_tensor(toks),
                       TT.init_cache(tcfg, 1, MAX_LEN, device="cpu"),
                       torch.as_tensor(pos))
    assert str(got.value) == str(want.value)
