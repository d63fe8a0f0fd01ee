"""Port vs reference, the int8 KV cache below the scheduler
(``repro_torch.models.attention``: ``quantize_kv``, ``int_product``,
``int8_kv_attention``, ``decode_attention_int8``; the int8 leaves of
``models.transformer``; ``Engine``'s KV byte figures) on the qwen2-7b
smoke config, float32 compute.

``quantize_kv`` is compared bitwise (codes and scales).  The integer
products run on float32 copies of the codes and are compared bitwise with
the reference's int32 einsum cast to float32, past the 1,040 terms where an
unblocked float32 sum would stop being exact.  The attention's float ops
(scales, softmax) agree to a few ulps across XLA and ATen, so outputs are
compared at ``atol=rtol=1e-5``; where a probability code ``p_int`` rounds
the other way, the test shows that the port's ``p_eff / p_scale`` lies
within 1e-5 of a .5 boundary and that the code moved by one (the
reference's codes are read back by probing its attention with one-hot V
codes).
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
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# quantize_kv
# ---------------------------------------------------------------------------

def _kv_input(kind: str, rng) -> np.ndarray:
    """[B, T, H, D] float32 rows of one kind."""
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    if kind == "ties":
        # max |x| = 127 makes the scale exactly 1: every k + 0.5 is a tie
        halves = rng.integers(-126, 126, x.shape) + 0.5
        x = np.where(rng.random(x.shape) < 0.5, halves, x).astype(np.float32)
        x[..., 0] = 127.0
        x[..., 1] = -127.0
    elif kind == "zeros":
        x[:, 1] = 0.0
        x[0, 3, 2] = 0.0
    elif kind == "large":
        x = x * np.float32(1e37)
        x[1, 2, 0, 4] = np.float32(3.0e38)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "large"])
def test_quantize_kv_bitwise(kind, dtype):
    x = _kv_input(kind, np.random.default_rng(["random", "ties", "zeros",
                                               "large"].index(kind)))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if dtype == "bfloat16":
        # the same bf16 values in both packages
        np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)),
                                      _np(tx.to(torch.float32)))
    jq, js = JA.quantize_kv(jx)
    tq, ts = TA.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts).view(np.int32),
                                  np.asarray(js).view(np.int32))
    if kind == "ties":
        assert (np.abs(_np(tq)) == 127).any()
        assert np.isin(np.asarray(jq), [2, -2, 4, -4]).any()


# ---------------------------------------------------------------------------
# the integer products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1024, 1040, 2048])
@pytest.mark.parametrize("fill", ["plus", "signs"])
def test_int_product_equals_int32_einsum(T, fill):
    """All-127 probability codes against all +-127 value codes (and the
    QK^T form over a D of T terms): the float32 product equals the int32
    einsum cast to float32 bitwise, in one block (T = 1024) and blocked."""
    rng = np.random.default_rng(T)
    sign = (np.ones if fill == "plus" else
            lambda s: rng.choice([-1, 1], s))
    p = np.full((1, 1, 2, 2, T), 127, np.int8)
    v = (127 * sign((1, T, 2, 3))).astype(np.int8)
    want = jnp.einsum("bshgk,bkhd->bshgd", jnp.asarray(p), jnp.asarray(v),
                      preferred_element_type=jnp.int32).astype(jnp.float32)
    got = TA.int_product("bshgk,bkhd->bshgd",
                         torch.from_numpy(p).float(),
                         torch.from_numpy(v).float(), 4, 1)
    np.testing.assert_array_equal(_np(got).view(np.int32),
                                  np.asarray(want).view(np.int32))
    q = (127 * sign((1, 1, 2, 2, T))).astype(np.int8)
    k = np.full((1, 3, 2, T), -127, np.int8)
    want = jnp.einsum("bshgd,bkhd->bshgk", jnp.asarray(q), jnp.asarray(k),
                      preferred_element_type=jnp.int32).astype(jnp.float32)
    got = TA.int_product("bshgd,bkhd->bshgk", torch.from_numpy(q).float(),
                         torch.from_numpy(k).float(), 4, 3)
    np.testing.assert_array_equal(_np(got).view(np.int32),
                                  np.asarray(want).view(np.int32))


# ---------------------------------------------------------------------------
# int8_kv_attention, with the measured margin on p_int
# ---------------------------------------------------------------------------

def _ref_p_int(q, kq, ks, vs, q_pos, k_pos, p_scale):
    """The reference's p_int codes [B, S, Hkv, G, T]: its attention run
    with one-hot V codes (v[t, d] = 1 where t = d + off) gives o[d] =
    p_int[d + off] * p_scale; ``p_scale`` (the port's) is the reference's
    within ulps, and the quotient is rounded."""
    B, S, Hq, D = q.shape
    T, Hkv = kq.shape[1], kq.shape[2]
    G = Hq // Hkv
    out = np.zeros((B, S, Hkv, G, T), np.int64)
    for off in range(0, T, D):
        v1 = np.zeros((B, T, Hkv, D), np.int8)
        for d in range(D):
            if off + d < T:
                v1[:, off + d, :, d] = 1
        o = np.asarray(JA.int8_kv_attention(
            *map(jnp.asarray, (q, kq, ks, v1, vs, q_pos, k_pos))))
        o = o.reshape(B, S, Hkv, G, D) / p_scale[..., None]
        w = min(D, T - off)
        out[..., off:off + w] = np.rint(o[..., :w]).astype(np.int64)
    return out


def _attention_case(seed, B=3, S=1, Hq=4, Hkv=2, D=16, T=40):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = (2.0 * rng.standard_normal((B, T, Hkv, D))).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    kq, ks = (np.array(a) for a in JA.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in JA.quantize_kv(jnp.asarray(v)))
    pos = np.array([T - 1, 17, -1][:B], np.int32)
    q_pos = pos[:, None] + np.arange(S, dtype=np.int32)[None]
    k_pos = np.asarray(TA.decode_kv_positions(torch.from_numpy(pos), T))
    return q, kq, ks, vq, vs, q_pos, k_pos


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_kv_attention_matches_reference(seed):
    args = _attention_case(seed)
    q, kq, ks, vq, vs, q_pos, k_pos = args
    want = np.asarray(JA.int8_kv_attention(*map(jnp.asarray, args)))
    got = _np(TA.int8_kv_attention(*_t(*args)))
    p_eff, p_scale = TA.int8_kv_probs(*_t(q, kq, ks, vs, q_pos, k_pos))
    ratio = _np(p_eff / p_scale[..., None]).astype(np.float64)
    mine = np.rint(ratio).astype(np.int64)
    theirs = _ref_p_int(q, kq, ks, vs, q_pos, k_pos, _np(p_scale))
    moved = mine != theirs
    # a code that moved moved by one, from a ratio at a .5 boundary
    assert (np.abs(mine - theirs)[moved] == 1).all()
    assert (np.abs(ratio - np.floor(ratio) - 0.5)[moved] < MARGIN).all()
    B, S, Hkv, G, _ = moved.shape
    rows = ~moved.any(-1).reshape(B, S, Hkv * G)
    np.testing.assert_allclose(got[rows], want[rows], **TOL)
    assert rows.mean() > 0.9


def test_int8_kv_attention_free_row_is_finite_and_zero_scaled():
    """A free row (every key masked) and unwritten slots (scale 0) give
    finite output, as in the reference."""
    q, kq, ks, vq, vs, q_pos, k_pos = _attention_case(5)
    ks[2], vs[2] = 0.0, 0.0
    args = (q, kq, ks, vq, vs, q_pos, k_pos)
    got = _np(TA.int8_kv_attention(*_t(*args)))
    want = np.asarray(JA.int8_kv_attention(*map(jnp.asarray, args)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], 0.0)


# ---------------------------------------------------------------------------
# decode_attention_int8, dense and paged
# ---------------------------------------------------------------------------

def _int8_attn_case(quant, seed, B=3, T=16, H=4, Hkv=2, D=16, ps=4):
    """Attention params, x [B, 1, d], an int8 cache of quantized random rows
    [B, T] and the same rows scattered into shuffled page pools."""
    rng = np.random.default_rng(seed)
    d = H * D
    jp = JA.init_attention(jax.random.PRNGKey(seed), d, H, Hkv, D,
                           qkv_bias=True)
    jp = jax.tree_util.tree_map(lambda a: a + 0.01, jp)
    if quant != "none":
        jp = jquantize({"attn": jp}, mode=quant)["attn"]
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    dense = {}
    for name in ("k", "v"):
        codes, scales = JA.quantize_kv(jnp.asarray(
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32)))
        dense[name], dense[name + "_scale"] = (np.asarray(codes),
                                               np.asarray(scales))
    E = T // ps
    P = B * E + 1
    table = rng.permutation(np.arange(1, P)).reshape(B, E).astype(np.int32)
    pools = {}
    for name, rows in dense.items():
        pool = np.zeros((P, ps) + rows.shape[2:], rows.dtype)
        for b in range(B):
            for j in range(E):
                pool[table[b, j]] = rows[b, j * ps:(j + 1) * ps]
        pools[name] = pool
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=D, quant=quant)
    return jp, tp, x, dense, pools, table, kw


def _tcache(c):
    return {k: torch.from_numpy(np.array(v)) for k, v in c.items()}


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
@pytest.mark.parametrize("pos", [[4, 0, 15], [2, -1, 7]])
def test_decode_attention_int8_dense_paged_and_reference(quant, pos):
    jp, tp, x, dense, pools, table, kw = _int8_attn_case(quant, seed=3)
    pos = np.asarray(pos, np.int32)
    if pos[1] < 0:
        table[1] = 0                              # a free row
    live = pos >= 0
    td = _tcache(dense)
    yd, cd = TA.decode_attention_int8(tp, *_t(x), td, torch.from_numpy(pos),
                                      compute_dtype=torch.float32, **kw)
    assert cd is td and all(cd[k] is td[k] for k in td)       # in place
    tt = torch.from_numpy(table)
    yp, cp = TA.decode_attention_int8(tp, *_t(x), _tcache(pools),
                                      torch.from_numpy(pos),
                                      compute_dtype=torch.float32, table=tt,
                                      **kw)
    assert torch.equal(yp[live], yd[live])
    for name in cp:
        assert torch.equal(TA.paged_gather(cp[name], tt)[live],
                           cd[name][live])
    for jcache, table_j, got_y, got_c in (
            (dense, None, yd, cd), (pools, table, yp, cp)):
        wy, wc = JA.decode_attention_int8(
            jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                 jcache.items()},
            jnp.asarray(pos), compute_dtype=jnp.float32,
            table=None if table_j is None else jnp.asarray(table_j), **kw)
        np.testing.assert_allclose(_np(got_y)[live], np.asarray(wy)[live],
                                   **TOL)
        lo = 0 if table_j is None else 1          # pools: past the null page
        for name in ("k", "v"):
            np.testing.assert_array_equal(_np(got_c[name])[lo:],
                                          np.asarray(wc[name])[lo:])
            np.testing.assert_allclose(_np(got_c[name + "_scale"])[lo:],
                                       np.asarray(wc[name + "_scale"])[lo:],
                                       **TOL)


# ---------------------------------------------------------------------------
# the model: cache leaves, decode_step, verify_step, prefill(length=)
# ---------------------------------------------------------------------------

_TREES = {}


def _trees(quant, kv_quant="int8"):
    key = (quant, kv_quant)
    if key not in _TREES:
        jcfg = dataclasses.replace(jconfigs.get_config(
            "qwen2-7b", smoke=True, quant=quant), compute_dtype="float32",
            kv_quant=kv_quant)
        tcfg = dataclasses.replace(tconfigs.get_config(
            "qwen2-7b", smoke=True, quant=quant), compute_dtype="float32",
            kv_quant=kv_quant)
        jq = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if quant != "none":
            jq = jquantize(jq, mode=quant)
        tq = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), tcfg,
                             device="cpu")
        _TREES[key] = (jcfg, tcfg, jq, tq)
    return _TREES[key]


@pytest.mark.parametrize("paged", [False, True])
def test_init_cache_int8_leaves_match_reference(paged):
    jcfg, tcfg, _, _ = _trees("w4a4_lut")
    if paged:
        (jc,) = JT.init_paged_cache(jcfg, 3, 16, 13, 4)
        tc = TT.init_paged_cache(tcfg, 3, 16, 13, 4, device="cpu")
    else:
        (jc,) = JT.init_cache(jcfg, 3, 16)
        tc = TT.init_cache(tcfg, 3, 16, device="cpu")
    assert len(tc) == tcfg.n_layers
    for c in tc:
        assert set(c) == set(jc) == {"k", "v", "k_scale", "v_scale"}
        for key in c:
            assert tuple(c[key].shape) == jc[key].shape[1:]
            assert str(c[key].dtype)[6:] == str(jc[key].dtype)
            assert not c[key].any()


def test_verify_step_refuses_an_int8_cache():
    jcfg, tcfg, jq, tq = _trees("w4a4_tmac")
    toks = np.zeros((2, 3), np.int32)
    pos = np.zeros((2,), np.int32)
    with pytest.raises(ValueError, match="speculative decoding supports"):
        JT.verify_step(jq, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 2, 8),
                       jnp.asarray(pos))
    with pytest.raises(ValueError, match="speculative decoding supports"):
        TT.verify_step(tq, tcfg, *_t(toks), TT.init_cache(tcfg, 2, 8, "cpu"),
                       *_t(pos))


@pytest.mark.parametrize("quant", ["w4a4_lut", "w4a4_tmac"])
def test_decode_step_int8_twelve_steps_match_reference(quant):
    """12 decode steps over an int8 cache (row 1 joins late, row 2 free):
    logits within the tolerance of the reference's, codes equal, scales
    within it; the paged cache gives the dense path's bits."""
    jcfg, tcfg, jq, tq = _trees(quant)
    B, T, ps = 3, 16, 4
    rng = np.random.default_rng(12)
    toks = rng.integers(0, tcfg.vocab, (12, B)).astype(np.int32)
    E = T // ps
    table = rng.permutation(np.arange(1, B * E + 1)).reshape(B, E)
    table = table.astype(np.int32)
    table[2] = 0
    jc = JT.init_cache(jcfg, B, T)
    td = TT.init_cache(tcfg, B, T, device="cpu")
    tpg = TT.init_paged_cache(tcfg, B, T, B * E + 1, ps, device="cpu")
    tt = (torch.from_numpy(table),)
    live = np.array([True, True, False])
    for i in range(12):
        pos = np.array([i, i - 4 if i >= 4 else -1, -1], np.int32)
        want, jc = JT.decode_step(jq, jcfg, jnp.asarray(toks[i]), jc,
                                  jnp.asarray(pos))
        got, td = TT.decode_step(tq, tcfg, *_t(toks[i]), td, *_t(pos))
        gp, tpg = TT.decode_step(tq, tcfg, *_t(toks[i]), tpg, *_t(pos),
                                 tables=tt)
        rows = pos >= 0
        assert torch.equal(gp[rows], got[rows]), i
        np.testing.assert_allclose(_np(got)[rows], np.asarray(want)[rows],
                                   **TOL)
    (j,) = jc
    for g, c in enumerate(td):
        for name in ("k", "v"):
            np.testing.assert_array_equal(_np(c[name])[live],
                                          np.asarray(j[name][g])[live])
            np.testing.assert_allclose(_np(c[name + "_scale"])[live],
                                       np.asarray(j[name + "_scale"][g])[live],
                                       **TOL)


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
def test_prefill_length_takes_logits_at_length_minus_one(quant):
    """Right-padded rows, a dummy row of length 1 and a scalar length."""
    jcfg, tcfg, jq, tq = _trees(quant)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab, (3, 7)).astype(np.int32)
    for length in (np.array([7, 4, 1], np.int32), 5):
        want, jc = JT.prefill(jq, jcfg, jnp.asarray(toks),
                              length=jnp.asarray(length))
        got, tc = TT.prefill(tq, tcfg, *_t(toks), length=torch.as_tensor(
            length))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        assert set(tc[0]) == {"k", "v"}           # the float K/V
        for g, c in enumerate(tc):
            np.testing.assert_allclose(_np(c["k"]),
                                       np.asarray(jc[0]["k"][g]), **TOL)
    full, _ = TT.prefill(tq, tcfg, *_t(toks))
    last, _ = TT.prefill(tq, tcfg, *_t(toks), length=7)
    assert torch.equal(full, last)


# ---------------------------------------------------------------------------
# the engine's KV byte figures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_kv_bytes_match_reference(kv_quant, paged):
    """``_kv_leaf_bytes``, ``page_bytes`` and ``kv_cache_bytes`` count int8
    codes plus float32 scales as the reference's engine does
    (``KV_CACHE_LEAVES | KV_SCALE_LEAVES``), before and after traffic."""
    jcfg, tcfg, jq, tq = _trees("w4a4_lut", kv_quant)
    kw = dict(max_len=32, paged=paged, page_size=4)
    je = jserve.Engine(jcfg, jq, jserve.ServeConfig(**kw))
    te = tserve.Engine(tcfg, tq, tserve.ServeConfig(**kw), device="cpu")
    for batch in (1, 3):
        assert te._kv_leaf_bytes(batch) == je._kv_leaf_bytes(batch)
        if paged:
            assert te.page_bytes(batch) == je.page_bytes(batch)
        assert te.kv_cache_bytes(batch) == je.kv_cache_bytes(batch)
    if paged:
        for sched, make in ((jserve.Scheduler(je, slots=3), jserve.Request),
                            (tserve.Scheduler(te, slots=3), tserve.Request)):
            sched.run([make(prompt=list(range(1, 10)), max_new_tokens=3)])
        assert te.pool.peak_pages == je.pool.peak_pages > 0
        assert te.kv_cache_bytes(3) == je.kv_cache_bytes(3)
    if kv_quant == "int8":
        # the scales count: int8 codes are half of float32's bytes at most
        full = dataclasses.replace(tcfg, kv_quant="none")
        per = TT.kv_bytes_per_position(tcfg)
        assert per == 2 * tcfg.n_layers * tcfg.n_kv * (tcfg.head_dim + 4)
        assert per < TT.kv_bytes_per_position(full) / 2
