"""Port vs reference, monolithic admission (``Engine.admit_monolithic``,
``Engine._stitch``, ``Scheduler._admit``) on qwen2-7b-smoke with an int8
KV cache, the plain kernel versions and float32 compute.

The stitch is compared bitwise with the reference's ``_stitch_impl`` on the
same caches and prefill K/V (dense rows and page pools, prefix-shared pages
below ``start_tok`` included), and must write in place.  Scheduler
transcripts, the draw counter and the statistics are compared exactly with
the reference's int8 Scheduler (3 slots): lut and tmac, dense and paged,
equal and mixed prompt lengths, greedy and sampled requests, budget-1
requests, a contended pool.  Inside the port, paged == dense and lut ==
tmac exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops

from _torch_threads import one_torch_thread  # noqa: F401

MAX_LEN = 32
PS = 4
# per-request (temperature, top_k, top_p); None takes the engine default
KNOBS = [(0.0, 0, 1.0), (None, None, None), (1.0, 40, None),
         (0.8, None, 0.9), (1.0, 50, 0.95), (0.0, None, None),
         (1.2, 5, 0.8), (None, 3, None)]
SAMPLED = dict(temperature=0.9, seed=7)
MIXED = [6, 6, 3, 9, 1, 9, 9, 4]
EQUAL = [5] * 8
BUDGETS = [5, 1, 4, 7, 3, 1, 6, 4]


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _cfgs(quant, kv_quant="int8"):
    j = dataclasses.replace(jconfigs.get_config("qwen2-7b", smoke=True,
                                                quant=quant),
                            compute_dtype="float32", kv_quant=kv_quant)
    t = dataclasses.replace(tconfigs.get_config("qwen2-7b", smoke=True,
                                                quant=quant),
                            compute_dtype="float32", kv_quant=kv_quant)
    return j, t


_FLOAT = {}


def _float_params():
    if not _FLOAT:
        jcfg, tcfg = _cfgs("w4a4_lut")
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _FLOAT["j"] = jp
        _FLOAT["t"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      tcfg, device="cpu")
    return _FLOAT["j"], _FLOAT["t"]


def _engines(quant, **scfg):
    """(reference engine, port engine), each quantizing the float tree."""
    jcfg, tcfg = _cfgs(quant)
    jp, tp = _float_params()
    kw = dict(quant=quant, **{"max_len": MAX_LEN, **scfg})
    return (jserve.make_engine(jp, jcfg, jserve.ServeConfig(**kw)),
            tserve.make_engine(tp, tcfg, tserve.ServeConfig(**kw),
                               device="cpu"))


def _requests(make, lens, sampled=False, budgets=BUDGETS, seed=11):
    rng = np.random.default_rng(seed)
    knobs = KNOBS if sampled else [(None, None, None)] * len(lens)
    return [make(prompt=rng.integers(0, 512, L).tolist(), max_new_tokens=b,
                 temperature=t, top_k=k, top_p=p)
            for L, b, (t, k, p) in zip(lens, budgets, knobs)]


def _drive(sched, reqs):
    """Staggered: two requests, one round, then the rest, then drain."""
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    while sched.has_work:
        sched.step()
    sched.check_drained()
    return [(r.tokens, r.finish_reason) for r in reqs]


def _ptrs(cache) -> list:
    return [t.data_ptr() for c in cache for t in c.values()]


def _port_run(quant, lens, sampled=False, slots=3, chunk=2, **scfg):
    _, tp = _float_params()
    if sampled:
        scfg = {**SAMPLED, **scfg}
    eng = tserve.make_engine(tp, _cfgs(quant)[1], tserve.ServeConfig(
        quant=quant, **{"max_len": MAX_LEN, **scfg}), device="cpu")
    sched = tserve.Scheduler(eng, slots=slots, chunk=chunk)
    ptrs = _ptrs(sched.cache)
    got = _drive(sched, _requests(tserve.Request, lens, sampled))
    # every admission stitched into the live tensors in place
    assert _ptrs(sched.cache) == ptrs
    return got, sched


# ---------------------------------------------------------------------------
# engine flags and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_admission_kind_matches_reference(kv_quant):
    jcfg, tcfg = _cfgs("w4a4_lut", kv_quant)
    jp, tp = _float_params()
    je = jserve.Engine(jcfg, jp, jserve.ServeConfig(max_len=MAX_LEN))
    te = tserve.Engine(tcfg, tp, tserve.ServeConfig(max_len=MAX_LEN),
                       device="cpu")
    assert te.requires_monolithic_admission == \
        je.requires_monolithic_admission == (kv_quant == "int8")
    for L in (1, 9, MAX_LEN):
        assert te.chunk_eligible(L) == je.chunk_eligible(L)


def test_spec_decode_refuses_int8_kv_as_the_reference_does():
    with pytest.raises(ValueError) as jerr:
        _engines("w4a4_tmac", spec_decode=True)
    jcfg, tcfg = _cfgs("w4a4_tmac")
    _, tp = _float_params()
    with pytest.raises(ValueError) as terr:
        tserve.make_engine(tp, tcfg, tserve.ServeConfig(
            quant="w4a4_tmac", max_len=MAX_LEN, spec_decode=True),
            device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "int8-KV" in str(terr.value)


def test_generate_keeps_the_float_path_like_the_reference():
    """``generate`` on an int8 config prefills a float cache and decodes
    the float path, in both packages."""
    je, te = _engines("w4a4_lut")
    prompts = np.random.default_rng(2).integers(0, 512, (2, 6))
    want = np.asarray(je.generate(jnp.asarray(prompts, jnp.int32), 5,
                                  use_scan=False))
    got = _np(te.generate(torch.from_numpy(prompts), 5))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the stitch
# ---------------------------------------------------------------------------

def _stitch_case(paged: bool, kv_quant: str, seed: int = 0):
    """Live caches of random contents (both packages, the same bytes), the
    prefill K/V of 3 rows of width P = 7 (rows 0 and 2 admitted, lengths 7
    and 5) and, paged, a table whose rows own shuffled pages and start_tok
    (row 0's first 4 tokens live in a prefix-shared page)."""
    jcfg, tcfg = _cfgs("w4a4_lut", kv_quant)
    jp, tp = _float_params()
    kw = dict(max_len=16, paged=paged, page_size=PS)
    je = jserve.Engine(jcfg, jp, jserve.ServeConfig(**kw))
    te = tserve.Engine(tcfg, tp, tserve.ServeConfig(**kw), device="cpu")
    rng = np.random.default_rng(seed)
    B, P, L = 3, 7, tcfg.n_layers
    jcache = je.init_cache(B)
    tcache = te.init_cache(B)
    (jc,) = jcache
    for key, leaf in jc.items():
        shape = leaf.shape
        if leaf.dtype == jnp.int8:
            val = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            val = rng.standard_normal(shape).astype(np.float32)
        jc[key] = jnp.asarray(val)
        for g in range(L):
            tcache[g][key].copy_(torch.from_numpy(val[g]))
    part = {k: rng.standard_normal((L, B, P, tcfg.n_kv, tcfg.head_dim))
            .astype(np.float32) for k in ("k", "v")}
    jpart = ({k: jnp.asarray(v) for k, v in part.items()},)
    tpart = [{k: torch.from_numpy(v[g]) for k, v in part.items()}
             for g in range(L)]
    lengths = np.array([7, 1, 5], np.int32)
    mask = np.array([True, False, True])
    extra = None
    if paged:
        E = 16 // PS
        table = rng.permutation(np.arange(1, B * E + 1)).reshape(B, E)
        table = table.astype(np.int32)
        start = np.array([4, 0, 0], np.int32)
        extra = (table, start)
    return je, te, (jcache, jpart), (tcache, tpart), lengths, mask, extra


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_stitch_matches_reference_in_place(paged, kv_quant):
    je, te, (jcache, jpart), (tcache, tpart), lengths, mask, extra = \
        _stitch_case(paged, kv_quant)
    before = {k: _np(v).copy() for k, v in tcache[0].items()}
    ptrs = _ptrs(tcache)
    jextra = ()
    textra = None
    if paged:
        table, start = extra
        jextra = (jnp.asarray(table), jnp.zeros((3, 1), jnp.int32),
                  jnp.asarray(start))
        textra = (torch.from_numpy(table), None, torch.from_numpy(start))
    (want,) = je._stitch_impl(jcache, jpart, jnp.asarray(lengths),
                              jnp.asarray(mask), jextra)
    got = te._stitch(tcache, tpart, torch.from_numpy(lengths),
                     torch.from_numpy(mask), textra)
    assert got is tcache and _ptrs(got) == ptrs
    lo = 1 if paged else 0               # page 0: the null page's races
    for g, c in enumerate(got):
        for key in c:
            w = np.asarray(want[key][g])
            assert _np(c[key]).dtype == w.dtype, key
            np.testing.assert_array_equal(_np(c[key])[lo:], w[lo:])
    if paged:
        # the prefix-shared page (row 0's tokens 0..3) is untouched, and
        # the unadmitted row's pages too
        table, start = extra
        for key, old in before.items():
            np.testing.assert_array_equal(_np(got[0][key])[table[0, 0]],
                                          old[table[0, 0]])
            np.testing.assert_array_equal(_np(got[0][key])[table[1]],
                                          old[table[1]])
    else:
        for key, old in before.items():
            np.testing.assert_array_equal(_np(got[0][key])[1], old[1])


# ---------------------------------------------------------------------------
# admit_monolithic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_admit_monolithic_matches_reference(paged, sampled):
    """One admission of rows 0 and 2 (row 2 with a one-token budget) into 3
    slots where row 1 decodes: the first tokens, done flags, finite flags
    and the merged slot state equal the reference's, and the stitched
    cache its bytes (codes) and scales."""
    knobs = SAMPLED if sampled else {}
    je, te = _engines("w4a4_lut", paged=paged, page_size=PS, **knobs)
    jcache, tcache = je.init_cache(3), te.init_cache(3)
    rng = np.random.default_rng(4)
    prompts = np.zeros((3, 6), np.int32)
    prompts[[0, 2]] = rng.integers(0, 512, (2, 6))
    if paged:
        for pool in (je.pool, te.pool):
            assert pool.admit(0, prompts[0].tolist()) == 0
            assert pool.admit(2, prompts[2].tolist()) == 0
    lengths = np.array([6, 1, 6], np.int32)
    mask = np.array([True, False, True])
    b1 = np.array([False, False, True])
    tok, pos = np.array([0, 77, 0], np.int32), np.array([-1, 9, -1],
                                                        np.int32)
    done = np.array([True, False, True])
    eos = np.array([-1, -1, -1], np.int32)
    temp = np.array([0.9, 0.0, 1.1] if sampled else [0.0] * 3, np.float32)
    top_k = np.array([0, 0, 5], np.int32)
    top_p = np.array([1.0, 1.0, 0.9] if sampled else [1.0] * 3, np.float32)
    J = jnp.asarray
    (jcache, jtok, jpos, jdone, jtok0, jdone0, jok0) = je.admit_monolithic(
        jcache, prompts, lengths, mask, b1, J(eos), J(temp), J(top_k),
        J(top_p), J(tok), J(pos), J(done), 3)
    T = torch.from_numpy
    tcache, ttok, tpos, tdone, packed = te.admit_monolithic(
        tcache, prompts, lengths, mask, b1, T(eos), T(tok), T(pos), T(done),
        temperature=T(temp), top_k=T(top_k), top_p=T(top_p), step0=3,
        greedy=not sampled)
    assert te.prefill_steps == 1
    packed = _np(packed)
    np.testing.assert_array_equal(packed[:, 0][mask], np.asarray(jtok0)[mask])
    np.testing.assert_array_equal(packed[:, 1] != 0, np.asarray(jdone0))
    np.testing.assert_array_equal(packed[:, 2] != 0, np.asarray(jok0))
    for a, b in ((ttok, jtok), (tpos, jpos), (tdone, jdone)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert _np(tpos).tolist() == [6, 9, -1]           # row 2 done at once
    (jc,) = jcache
    for g, c in enumerate(tcache):
        for key in c:
            w, x = np.asarray(jc[key][g]), _np(c[key])
            if paged:
                w, x = w[1:], x[1:]
            if key in ("k", "v"):
                np.testing.assert_array_equal(x, w)
            else:
                np.testing.assert_allclose(x, w, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the Scheduler against the reference's
# ---------------------------------------------------------------------------

SCHED_CASES = [
    # (quant, paged, lens, sampled, extra ServeConfig)
    ("w4a4_lut", False, MIXED, False, {}),
    ("w4a4_lut", True, MIXED, True, {}),
    ("w4a4_lut", False, EQUAL, True, {}),
    ("w4a4_tmac", True, EQUAL, False, {}),
    ("w4a4_tmac", False, MIXED, True, {}),
    ("w4a4_lut", True, MIXED, False, {"num_pages": 5}),
]


@pytest.mark.parametrize("quant,paged,lens,sampled,extra", SCHED_CASES,
                         ids=["lut-dense-mixed-greedy",
                              "lut-paged-mixed-sampled",
                              "lut-dense-equal-sampled",
                              "tmac-paged-equal-greedy",
                              "tmac-dense-mixed-sampled",
                              "lut-paged-contended"])
def test_int8_scheduler_matches_reference(quant, paged, lens, sampled,
                                          extra):
    """Staggered traffic of 8 requests (budget-1 ones among them) into 3
    slots: transcripts, finish reasons, the draw counter, the statistics
    and (paged) the pool's figures equal the reference's int8 Scheduler's."""
    scfg = dict(extra, paged=paged, page_size=PS)
    if sampled:
        scfg.update(SAMPLED)
    je, _ = _engines(quant, **scfg)
    jsched = jserve.Scheduler(je, slots=3, chunk=2)
    want = _drive(jsched, _requests(jserve.Request, lens, sampled))
    got, tsched = _port_run(quant, lens, sampled, **scfg)
    assert got == want
    assert tsched._step == jsched._step
    assert tsched.stats == {k: jsched.stats[k] for k in tsched.stats}
    assert tsched.stats["admission_rounds"] > 0
    if lens is EQUAL:
        # equal-length runs: admissions of more than one request each
        assert tsched.stats["admitted_tokens"] > \
            EQUAL[0] * tsched.stats["admission_rounds"]
    if paged:
        tp, jp = tsched.engine.pool, jsched.engine.pool
        for attr in ("peak_pages", "prefix_hits", "prefix_fresh",
                     "preemptions", "allocated_pages"):
            assert getattr(tp, attr) == getattr(jp, attr), attr
        if "num_pages" in extra:
            assert tp.preemptions > 0


def test_whole_pool_refusal_matches_reference():
    """A request that needs more pages than the pool holds raises at
    admission, in both packages."""
    je, te = _engines("w4a4_lut", paged=True, page_size=PS, num_pages=3)
    for sched, make in ((jserve.Scheduler(je, slots=2), jserve.Request),
                        (tserve.Scheduler(te, slots=2), tserve.Request)):
        sched.submit(make(prompt=list(range(1, 14)), max_new_tokens=2))
        with pytest.raises(RuntimeError, match="whole pool"):
            sched.step()


# ---------------------------------------------------------------------------
# inside the port: paged == dense, lut == tmac
# ---------------------------------------------------------------------------

LONG = [6, 3, 9, 12, 1, 9, 7, 4, 7, 2, 11, 5]
LONG_BUDGETS = [5, 1, 4, 7, 3, 6, 2, 4, 8, 1, 5, 6]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_paged_equals_dense_and_tmac_equals_lut(sampled):
    """12 requests through 4 slots: the paged runs (auto pool and a
    contended one) and the tmac runs equal the dense lut run exactly."""
    def run(quant, **scfg):
        _, tp = _float_params()
        if sampled:
            scfg = {**SAMPLED, **scfg}
        eng = tserve.make_engine(tp, _cfgs(quant)[1], tserve.ServeConfig(
            quant=quant, max_len=MAX_LEN, **scfg), device="cpu")
        sched = tserve.Scheduler(eng, slots=4, chunk=3)
        reqs = _requests(tserve.Request, LONG, sampled, LONG_BUDGETS, seed=5)
        got = _drive(sched, reqs)
        return got, sched

    want, dense = run("w4a4_lut")
    for quant, scfg in (("w4a4_lut", dict(paged=True)),
                        ("w4a4_lut", dict(paged=True, num_pages=12)),
                        ("w4a4_tmac", {}),
                        ("w4a4_tmac", dict(paged=True))):
        got, sched = run(quant, **scfg)
        assert got == want, (quant, scfg)
        assert sched._step == dense._step or "num_pages" in scfg
    assert sched.engine.pool.allocated_pages == 0
