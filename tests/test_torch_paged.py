"""Port vs reference, the paged KV cache below the scheduler: the host-side
allocator (``serve/paged.py``) driven by the same seeded random sequences
of admit / ensure / mark_filled / trim / release as the reference's, the
ordered page gather and the per-token page write, ``decode_attention`` and
``decode_attention_multi`` with a page ``table``, and ``decode_step`` /
``verify_step`` with ``tables`` on qwen2-7b-smoke.

The allocator is integer bookkeeping: its state is compared exactly.  Paged
against dense inside the port is bitwise (the gathered buffer holds the
dense buffer's values at every unmasked position, in the dense buffer's
shape).  Against the reference the float outputs agree at
``atol=rtol=1e-5`` (float32 compute: XLA and ATen order the float
reductions differently); page ids, KV placement and the pools' rows are
compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serve import paged as jpaged
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve import paged as tpaged

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# the allocator, differentially
# ---------------------------------------------------------------------------

def _cfgs(window=None):
    """The qwen2-7b smoke config of both packages; with ``window`` a
    stand-in whose one pattern position is a local (ring) layer."""
    j = jconfigs.get_config("qwen2-7b", smoke=True)
    t = tconfigs.get_config("qwen2-7b", smoke=True)
    if window is not None:
        j = dataclasses.replace(j, window=window,
                                pattern=(JT.BlockSpec(attn_type="local"),))
        t = dataclasses.replace(t, window=window,
                                pattern=(tconfigs.BlockSpec(
                                    attn_type="local"),))
    return j, t


def _pools(slots, max_len, ps, window, pages, n_shards, reuse=True):
    jcfg, tcfg = _cfgs(window)
    jl = jpaged.PagedLayout.build(jcfg, max_len, ps)
    tl = tpaged.PagedLayout.build(tcfg, max_len, ps)
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
    return (jpaged.PagePool(slots, jl, pages_per_shard=pages,
                            n_shards=n_shards, prefix_reuse=reuse),
            tpaged.PagePool(slots, tl, pages_per_shard=pages,
                            n_shards=n_shards, prefix_reuse=reuse))


def _state(pool) -> dict:
    """Everything the allocator holds, in comparable form."""
    shards = [{"free": sorted(sh.free), "ref": sh.ref.tolist(),
               "hash2page": dict(sh.hash2page),
               "page_key": dict(sh.page_key), "ready": sorted(sh.ready)}
              for sh in pool._shards]
    return {"table": pool.table.tolist(), "ring": pool.ring.tolist(),
            "start": pool.start.tolist(), "n_full": list(pool.n_full),
            "n_ring": list(pool.n_ring), "shards": shards,
            "stats": (pool.allocated_pages, pool.peak_pages,
                      pool.prefix_hits, pool.prefix_fresh, pool.preemptions,
                      pool.peak_pages_per_shard, pool.prefix_hit_rate,
                      pool.usable_pages, pool.saturation),
            "free_pages": [pool.free_pages(s) for s in range(pool.n_shards)],
            "validate": pool.validate(), "leaked": pool.leaked_pages(),
            "state_dict": pool.state_dict()}


def _drive(jpool, tpool, seed: int, n_ops: int = 160):
    """The same seeded random op sequence on both pools; every return value
    and the whole state after each op must agree."""
    rng = np.random.default_rng(seed)
    lay = tpool.layout
    prefixes = [rng.integers(0, 6, lay.max_len).tolist() for _ in range(3)]
    mapped = {s for s in range(tpool.slots)
              if tpool.n_full[s] or tpool.n_ring[s]}
    counts: dict = {}
    for _ in range(n_ops):
        slot = int(rng.integers(0, tpool.slots))
        op = str(rng.choice(["admit", "ensure", "mark", "trim", "release"],
                            p=[0.35, 0.2, 0.15, 0.15, 0.15]))
        if slot not in mapped:
            op = "admit"
        if op == "admit":
            if slot in mapped:
                continue
            L = int(rng.integers(1, lay.max_len + 1))
            base = prefixes[int(rng.integers(0, len(prefixes)))]
            # shared-prefix length: often the whole prompt
            cut = L if rng.random() < 0.5 else int(rng.integers(0, L + 1))
            toks = base[:cut] + rng.integers(0, 6, L - cut).tolist()
            kw = dict(fills_now=bool(rng.integers(0, 2)),
                      share=bool(rng.random() < 0.85))
            got = (jpool.admit(slot, toks, **kw), tpool.admit(slot, toks,
                                                              **kw))
            if got[0] is not None:
                mapped.add(slot)
            else:
                counts["refused"] = counts.get("refused", 0) + 1
        elif op == "ensure":
            n = int(rng.integers(1, lay.max_len + 1))
            got = (jpool.ensure(slot, n), tpool.ensure(slot, n))
        elif op == "mark":
            n = int(rng.integers(0, lay.max_len + 1))
            got = (jpool.mark_filled(slot, n), tpool.mark_filled(slot, n))
        elif op == "trim":
            n = int(rng.integers(0, lay.max_len + 1))
            got = (jpool.trim(slot, n), tpool.trim(slot, n))
        else:
            got = (jpool.release(slot), tpool.release(slot))
            mapped.discard(slot)
        assert got[0] == got[1], op
        counts[op] = counts.get(op, 0) + 1
        assert _state(tpool) == _state(jpool), op
    return counts


ALLOC = [(4, 32, 4, None, 16, 1), (4, 32, 4, None, 9, 2),
         (3, 32, 4, 8, 24, 1), (4, 16, 2, 8, 12, 2), (2, 24, 3, None, 5, 1)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slots,max_len,ps,window,pages,n_shards", ALLOC,
                         ids=["full", "2-shards", "ring", "ring-2-shards",
                              "tight"])
def test_page_pool_matches_reference(slots, max_len, ps, window, pages,
                                     n_shards, seed):
    """Full tables, rings (a local-window stand-in) and 2 shards: the same
    ops give the same returns, tables, refcounts, free lists, registry,
    ready sets, stats, audit and snapshot, and both drain to nothing."""
    jpool, tpool = _pools(slots, max_len, ps, window, pages, n_shards)
    counts = _drive(jpool, tpool, seed)
    assert {"admit", "ensure", "mark", "trim", "release"} <= set(counts)
    assert tpool.validate() == []
    for s in range(slots):
        jpool.release(s)
        tpool.release(s)
    assert _state(tpool) == _state(jpool)
    assert tpool.allocated_pages == 0 and tpool.leaked_pages() == []


@pytest.mark.parametrize("slots,max_len,ps,window,pages,n_shards", ALLOC,
                         ids=["full", "2-shards", "ring", "ring-2-shards",
                              "tight"])
def test_page_pool_traffic_shares_and_refuses(slots, max_len, ps, window,
                                              pages, n_shards):
    """The differential's traffic reaches what it must: over its seeds each
    geometry shares prefix pages and refuses admissions."""
    hits = refused = 0
    for seed in range(3):
        jpool, tpool = _pools(slots, max_len, ps, window, pages, n_shards)
        refused += _drive(jpool, tpool, seed, n_ops=120).get("refused", 0)
        hits += tpool.prefix_hits
    assert hits > 0 and refused > 0


def test_page_pool_prefix_reuse_off_matches_reference():
    jpool, tpool = _pools(4, 32, 4, None, 40, 1, reuse=False)
    _drive(jpool, tpool, seed=5)
    assert tpool.prefix_hits == 0 and not tpool._shards[0].hash2page


@pytest.mark.parametrize("seed", [3, 4])
def test_page_pool_state_round_trips(seed):
    """A port pool loaded from the reference's snapshot (and from its own)
    continues as the reference does."""
    jpool, tpool = _pools(4, 32, 4, 8, 30, 2)
    _drive(jpool, tpool, seed, n_ops=60)
    fresh = _pools(4, 32, 4, 8, 30, 2)[1]
    fresh.load_state(jpool.state_dict())
    assert _state(fresh) == _state(jpool)
    again = _pools(4, 32, 4, 8, 30, 2)[1]
    again.load_state(tpool.state_dict())
    _drive(jpool, again, seed + 10, n_ops=60)


def test_page_pool_unit_cases_match_reference():
    """The reference's allocator unit cases, on both pools."""
    for mod, cfg in zip((jpaged, tpaged), _cfgs()):
        lay = mod.PagedLayout.build(cfg, 32, 4)
        pool = mod.PagePool(3, lay, pages_per_shard=32)
        base = list(range(100, 108))
        assert pool.admit(0, base + [1, 2]) == 0
        assert pool.admit(1, base + [3]) == 8
        assert pool.prefix_hits == 2
        assert (pool.table[0][:2] == pool.table[1][:2]).all()
        pool.release(0)
        assert pool.admit(2, base + [4]) == 8
        pool.release(1)
        pool.release(2)
        assert pool.allocated_pages == 0
        assert pool.admit(0, base + [5]) == 0
        # chunked admissions share only pages marked filled
        assert pool.admit(1, base + [6], fills_now=False) == 8
        pool.release(0)
        pool.release(1)
        assert pool.admit(0, base + [7], fills_now=False) == 0
        assert pool.admit(1, base + [8]) == 0
        pool.mark_filled(0, 8)
        assert pool.admit(2, base + [9]) == 8
        small = mod.PagePool(2, lay, pages_per_shard=4)
        assert small.admit(0, list(range(8))) == 0
        assert small.admit(1, list(range(50, 59))) is None
        assert not small.ensure(0, 32) and small.n_full[0] == 2
        with pytest.raises(ValueError, match="pages_per_shard"):
            mod.PagePool(2, lay, pages_per_shard=1)
        with pytest.raises(ValueError, match="divide"):
            mod.PagePool(3, lay, n_shards=2)


@pytest.mark.parametrize("max_len,ps,window", [(30, 4, None), (32, 16, 8),
                                               (32, 0, None), (32, 3, 9)])
def test_paged_layout_raises_where_the_reference_does(max_len, ps, window):
    jcfg, tcfg = _cfgs(window)
    with pytest.raises(ValueError) as want:
        jpaged.PagedLayout.build(jcfg, max_len, ps)
    with pytest.raises(ValueError) as got:
        tpaged.PagedLayout.build(tcfg, max_len, ps)
    assert str(got.value) == str(want.value)


def test_paged_layout_geometry_matches_reference():
    for window in (None, 8, 64):
        jcfg, tcfg = _cfgs(window)
        for max_len, ps in ((32, 4), (32, 8), (16, 2)):
            j = jpaged.PagedLayout.build(jcfg, max_len, ps)
            t = tpaged.PagedLayout.build(tcfg, max_len, ps)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.auto_pages_per_shard(3) == j.auto_pages_per_shard(3)


# ---------------------------------------------------------------------------
# paged_gather / paged_write
# ---------------------------------------------------------------------------

def _page_case(seed, B=4, E=5, ps=4, H=2, D=8, free=(2,)):
    """Pools of random rows, a table giving each live row its own pages (a
    few entries unmapped) and free rows all-zero tables."""
    rng = np.random.default_rng(seed)
    P = B * E + 1
    pool = rng.standard_normal((P, ps, H, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, P))[:B * E].reshape(B, E)
    table = ids.astype(np.int32)
    table[:, E - 1] = 0                          # last entry unmapped
    for b in free:
        table[b] = 0
    return rng, pool, table


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_gather_matches_reference(seed):
    _, pool, table = _page_case(seed)
    want = JA.paged_gather(jnp.asarray(pool), jnp.asarray(table))
    got = TA.paged_gather(torch.from_numpy(pool), torch.from_numpy(table))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert got.shape == (4, 20, 2, 8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_write_matches_reference(seed):
    """Live rows write their own pages; free rows (and positions past the
    mapping) land in the null page: the pools agree outside page 0."""
    rng, pool, table = _page_case(seed)
    B, E = table.shape
    ps = pool.shape[1]
    slot = rng.integers(0, E * ps, B).astype(np.int32)
    new = rng.standard_normal((B, 1) + pool.shape[2:]).astype(np.float32)
    want = np.asarray(JA.paged_write(jnp.asarray(pool), jnp.asarray(table),
                                     jnp.asarray(slot), jnp.asarray(new)))
    tp = torch.from_numpy(pool.copy())
    got = TA.paged_write(tp, torch.from_numpy(table),
                         torch.from_numpy(slot), torch.from_numpy(new))
    assert got is tp                              # in place
    np.testing.assert_array_equal(_np(got)[1:], want[1:])
    for b in range(B):
        page = table[b, slot[b] // ps]
        if page:
            np.testing.assert_array_equal(_np(got)[page, slot[b] % ps],
                                          new[b, 0])


# ---------------------------------------------------------------------------
# decode_attention / decode_attention_multi with a table
# ---------------------------------------------------------------------------

def _attn_case(quant, seed, B=3, T=12, H=4, Hkv=2, D=16, S=1, ps=4):
    """Attention params, x [B, S, d], a dense cache [B, T, Hkv, D] and the
    same rows scattered into a shuffled page pool through a full table
    (row 1 also as a free row: table all zero)."""
    rng = np.random.default_rng(seed)
    d = H * D
    jp = JA.init_attention(jax.random.PRNGKey(seed), d, H, Hkv, D,
                           qkv_bias=True)
    jp = jax.tree_util.tree_map(lambda a: a + 0.01, jp)   # nonzero biases
    if quant != "none":
        jp = jquantize({"attn": jp}, mode=quant)["attn"]
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    ck = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    cv = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    E = T // ps
    P = B * E + 1
    table = (rng.permutation(np.arange(1, P)).reshape(B, E)).astype(np.int32)
    pk = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pv = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    for b in range(B):
        for j in range(E):
            pk[table[b, j]] = ck[b, j * ps:(j + 1) * ps]
            pv[table[b, j]] = cv[b, j * ps:(j + 1) * ps]
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=D, quant=quant)
    return jp, tp, x, (ck, cv), (pk, pv), table, kw


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
@pytest.mark.parametrize("pos", [[4, 0, 11], [2, -1, 7]])
def test_paged_decode_attention_equals_dense_and_reference(quant, pos):
    jp, tp, x, (ck, cv), (pk, pv), table, kw = _attn_case(quant, seed=4)
    pos = np.asarray(pos, np.int32)
    if pos[1] < 0:
        table[1] = 0                              # a free row
    live = pos >= 0
    dense = TA.decode_attention(tp, *_t(x, ck, cv, pos),
                                compute_dtype=torch.float32, **kw)
    tt = torch.from_numpy(table)
    y, gk, gv = TA.decode_attention(tp, *_t(x, pk, pv, pos),
                                    compute_dtype=torch.float32, table=tt,
                                    **kw)
    assert torch.equal(y[live], dense[0][live])
    for g, d in ((gk, dense[1]), (gv, dense[2])):
        assert torch.equal(TA.paged_gather(g, tt)[live], d[live])
    want = JA.decode_attention(jp, *map(jnp.asarray, (x, pk, pv, pos)),
                               compute_dtype=jnp.float32,
                               table=jnp.asarray(table), **kw)
    np.testing.assert_allclose(_np(y)[live], np.asarray(want[0])[live],
                               **TOL)
    for g, w in zip((gk, gv), want[1:]):
        np.testing.assert_allclose(_np(g)[1:], np.asarray(w)[1:], **TOL)


@pytest.mark.parametrize("quant", ["none", "w4a4_tmac"])
@pytest.mark.parametrize("pos", [[4, 0, 8], [2, -1, 5], [0, 3, 8]])
def test_paged_decode_attention_multi_equals_dense_and_reference(quant, pos):
    """S = 4 per-token table writes: live rows equal the dense block's
    output and buffer bitwise; a free row's writes go to the null page."""
    jp, tp, x, (ck, cv), (pk, pv), table, kw = _attn_case(quant, seed=5,
                                                          S=4)
    pos = np.asarray(pos, np.int32)
    orphans = table[1].copy()
    if pos[1] < 0:
        table[1] = 0
    live = pos >= 0
    dense = TA.decode_attention_multi(tp, *_t(x, ck, cv, pos),
                                      compute_dtype=torch.float32, **kw)
    tt = torch.from_numpy(table)
    y, gk, gv = TA.decode_attention_multi(tp, *_t(x, pk, pv, pos),
                                          compute_dtype=torch.float32,
                                          table=tt, **kw)
    assert torch.equal(y[live], dense[0][live])
    for g, d in ((gk, dense[1]), (gv, dense[2])):
        assert torch.equal(TA.paged_gather(g, tt)[live], d[live])
    if not live.all():
        # the free row's writes went to the null page: the pages its table
        # no longer names are untouched
        assert torch.equal(gk[orphans], torch.from_numpy(pk)[orphans])
        assert torch.equal(gv[orphans], torch.from_numpy(pv)[orphans])
    want = JA.decode_attention_multi(jp, *map(jnp.asarray, (x, pk, pv, pos)),
                                     compute_dtype=jnp.float32,
                                     table=jnp.asarray(table), **kw)
    np.testing.assert_allclose(_np(y)[live], np.asarray(want[0])[live],
                               **TOL)
    for g, w in zip((gk, gv), want[1:]):
        np.testing.assert_allclose(_np(g)[1:], np.asarray(w)[1:], **TOL)


# ---------------------------------------------------------------------------
# decode_step / verify_step with tables
# ---------------------------------------------------------------------------

_TREES = {}


def _trees(quant):
    """qwen2-7b-smoke in float32 compute: the reference's quantized tree and
    its conversion."""
    if quant not in _TREES:
        jcfg = dataclasses.replace(jconfigs.get_config(
            "qwen2-7b", smoke=True, quant=quant), compute_dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_config(
            "qwen2-7b", smoke=True, quant=quant), compute_dtype="float32")
        jq = jquantize(JT.init_params(jax.random.PRNGKey(0), jcfg),
                       mode=quant)
        tq = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), tcfg,
                             device="cpu")
        _TREES[quant] = (jcfg, tcfg, jq, tq)
    return _TREES[quant]


def test_init_paged_cache_shapes_match_reference():
    jcfg, tcfg, _, _ = _trees("w4a4_lut")
    (jc,) = JT.init_paged_cache(jcfg, 3, 16, 13, 4)
    tc = TT.init_paged_cache(tcfg, 3, 16, 13, 4, device="cpu")
    assert len(tc) == tcfg.n_layers
    for c in tc:
        assert set(c) == set(jc) == {"k", "v"}
        for key in c:
            assert tuple(c[key].shape) == jc[key].shape[1:]
            assert c[key].dtype == torch.float32 and not c[key].any()


def _paged_run(quant, B=3, T=16, ps=4, seed=7):
    """Six decode steps of history, then (returned) the dense and paged
    caches of both packages and the tables: rows 0 and 2 live (their pages
    shuffled, the tail unmapped), row 1 free (table all zero)."""
    jcfg, tcfg, jq, tq = _trees(quant)
    rng = np.random.default_rng(seed)
    E = T // ps
    P = B * E + 1
    table = rng.permutation(np.arange(1, P)).reshape(B, E).astype(np.int32)
    table[1] = 0
    table[0, E - 1] = 0
    pos = np.array([0, -1, 2], np.int32)
    hist = rng.integers(0, tcfg.vocab, (B, 6)).astype(np.int32)
    jd, jpg = JT.init_cache(jcfg, B, T), JT.init_paged_cache(jcfg, B, T, P,
                                                             ps)
    td = TT.init_cache(tcfg, B, T, device="cpu")
    tpg = TT.init_paged_cache(tcfg, B, T, P, ps, device="cpu")
    jt = (jnp.asarray(table), jnp.zeros((B, 1), jnp.int32))
    tt = (torch.from_numpy(table),)
    for j in range(hist.shape[1]):
        tok, p = hist[:, j], pos.copy()
        _, jd = JT.decode_step(jq, jcfg, jnp.asarray(tok), jd, jnp.asarray(p))
        _, jpg = JT.decode_step(jq, jcfg, jnp.asarray(tok), jpg,
                                jnp.asarray(p), tables=jt)
        ld, td = TT.decode_step(tq, tcfg, torch.from_numpy(tok), td,
                                torch.from_numpy(p))
        lp, tpg = TT.decode_step(tq, tcfg, torch.from_numpy(tok), tpg,
                                 torch.from_numpy(p), tables=tt)
        assert torch.equal(lp[pos >= 0], ld[pos >= 0]), j
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    return jcfg, tcfg, jq, tq, (jd, jpg, td, tpg), (jt, tt), pos, rng


@pytest.mark.parametrize("quant", ["w4a4_lut", "w4a4_tmac"])
def test_paged_decode_step_equals_dense_and_reference(quant):
    jcfg, tcfg, jq, tq, (jd, jpg, td, tpg), (jt, tt), pos, rng = \
        _paged_run(quant)
    live = pos >= 0
    tok = rng.integers(0, tcfg.vocab, pos.shape[0]).astype(np.int32)
    ld, td = TT.decode_step(tq, tcfg, torch.from_numpy(tok), td,
                            torch.from_numpy(pos.copy()))
    lp, tpg = TT.decode_step(tq, tcfg, torch.from_numpy(tok), tpg,
                             torch.from_numpy(pos.copy()), tables=tt)
    assert torch.equal(lp[live], ld[live])
    for a, b in zip(tpg, td):
        for key in ("k", "v"):
            g = TA.paged_gather(a[key], tt[0])
            # live rows' mapped positions: row 0 maps 12 of 16
            assert torch.equal(g[0, :12], b[key][0, :12])
            assert torch.equal(g[2], b[key][2])
    want, jpg = JT.decode_step(jq, jcfg, jnp.asarray(tok), jpg,
                               jnp.asarray(pos), tables=jt)
    np.testing.assert_allclose(_np(lp)[live], np.asarray(want)[live], **TOL)
    (jc,) = jpg
    for g, c in enumerate(tpg):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(c[key])[1:],
                                       np.asarray(jc[key][g])[1:], **TOL)


def test_paged_verify_step_equals_dense_sequential_and_reference():
    """One verify over S = 4 tokens through the tables: bitwise the dense
    verify and four sequential paged decode steps on live rows, and the
    reference's paged verify within the tolerance."""
    jcfg, tcfg, jq, tq, (jd, jpg, td, tpg), (jt, tt), pos, rng = \
        _paged_run("w4a4_tmac", seed=8)
    live = pos >= 0
    S = 4
    toks = rng.integers(0, tcfg.vocab, (pos.shape[0], S)).astype(np.int32)
    seq = [{k: v.clone() for k, v in c.items()} for c in tpg]
    gd, td = TT.verify_step(tq, tcfg, torch.from_numpy(toks), td,
                            torch.from_numpy(pos.copy()))
    gp, tpg = TT.verify_step(tq, tcfg, torch.from_numpy(toks), tpg,
                             torch.from_numpy(pos.copy()), tables=tt)
    assert torch.equal(gp[live], gd[live])
    p = torch.from_numpy(pos.copy())
    for i in range(S):
        li, seq = TT.decode_step(tq, tcfg, torch.from_numpy(toks[:, i]), seq,
                                 torch.where(p >= 0, p + i, p), tables=tt)
        assert torch.equal(gp[live, i], li[live]), i
    for a, b in zip(tpg, seq):
        assert torch.equal(a["k"][1:], b["k"][1:])
        assert torch.equal(a["v"][1:], b["v"][1:])
    want, jpg = JT.verify_step(jq, jcfg, jnp.asarray(toks), jpg,
                               jnp.asarray(pos), tables=jt)
    np.testing.assert_allclose(_np(gp)[live], np.asarray(want)[live], **TOL)
    (jc,) = jpg
    for g, c in enumerate(tpg):
        np.testing.assert_allclose(_np(c["k"])[1:],
                                   np.asarray(jc["k"][g])[1:], **TOL)
