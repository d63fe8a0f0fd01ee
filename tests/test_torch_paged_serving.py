"""Port vs reference, paged serving: ``ServeConfig(paged=True)`` engines
driven by the ``Scheduler``'s block accounting on qwen2-7b-smoke in
``w4a4_lut`` and ``w4a4_tmac`` (plain kernel versions, float32 compute),
each package quantizing the same float tree itself.

Transcripts are compared exactly: against the reference's paged Scheduler
over the same traffic, and against the port's dense Scheduler.  The pool's
statistics (peak pages, prefix hits and fresh pages, preemptions) equal
the reference's, and every run drains with no page allocated and none
leaked (``Scheduler.run`` ends with ``check_drained``).
"""
import dataclasses
import math

import jax
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
LENS = [6, 5, 3, 9, 1, 2, 7, 4]
BUDGETS = [5, 6, 4, 7, 3, 5, 6, 4]
# per-request (temperature, top_k, top_p); None takes the engine default
KNOBS = [(0.0, 0, 1.0), (None, None, None), (1.0, 40, None),
         (0.8, None, 0.9), (1.0, 50, 0.95), (0.0, None, None),
         (1.2, 5, 0.8), (None, 3, None)]
SAMPLED = dict(temperature=0.9, seed=7)


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)
    ops.set_variant(None)


def _cfgs(quant):
    j = dataclasses.replace(jconfigs.get_config("qwen2-7b", smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    t = dataclasses.replace(tconfigs.get_config("qwen2-7b", smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
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
    """(reference engine, port engine) of one ServeConfig."""
    jcfg, tcfg = _cfgs(quant)
    jp, tp = _float_params()
    kw = dict(quant=quant, **{"max_len": MAX_LEN, **scfg})
    return (jserve.make_engine(jp, jcfg, jserve.ServeConfig(**kw)),
            tserve.make_engine(tp, tcfg, tserve.ServeConfig(**kw),
                               device="cpu"))


def _requests(make, sampled=False, lens=LENS, budgets=BUDGETS, seed=11):
    rng = np.random.default_rng(seed)
    knobs = KNOBS if sampled else [(None, None, None)] * len(lens)
    return [make(prompt=rng.integers(0, 512, L).tolist(), max_new_tokens=b,
                 temperature=t, top_k=k, top_p=p)
            for L, b, (t, k, p) in zip(lens, budgets, knobs)]


def _drive(sched, reqs, check=None):
    """Staggered admission: two requests, one round, then the rest; then
    drain (``check(sched)`` after every round)."""
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    while sched.has_work:
        sched.step()
        if check is not None:
            check(sched)
    sched.check_drained()
    return [(r.tokens, r.finish_reason) for r in reqs]


def _pool_stats(pool) -> dict:
    return {"peak_pages": pool.peak_pages, "prefix_hits": pool.prefix_hits,
            "prefix_fresh": pool.prefix_fresh,
            "preemptions": pool.preemptions,
            "allocated_pages": pool.allocated_pages}


def _drained(eng):
    assert eng.pool.allocated_pages == 0 and eng.pool.leaked_pages() == []
    assert eng.pool.validate() == [] and not eng.pool.table.any()


def _both(quant, sampled, slots=3, chunk=2, reqs=None, check=None, **scfg):
    """The same traffic through the reference's paged Scheduler and the
    port's: (reference transcripts, port transcripts, reference scheduler,
    port scheduler)."""
    if sampled:
        scfg = {**SAMPLED, **scfg}
    jeng, eng = _engines(quant, paged=True, page_size=PS, **scfg)
    make = reqs or (lambda m: _requests(m, sampled))
    jsched = jserve.Scheduler(jeng, slots=slots, chunk=chunk)
    tsched = tserve.Scheduler(eng, slots=slots, chunk=chunk)
    want = _drive(jsched, make(jserve.Request))
    got = _drive(tsched, make(tserve.Request), check)
    _drained(eng)
    return want, got, jsched, tsched


def _dense(quant, sampled, slots=3, chunk=2, reqs=None, **scfg):
    if sampled:
        scfg = {**SAMPLED, **scfg}
    _, tp = _float_params()
    eng = tserve.make_engine(tp, _cfgs(quant)[1], tserve.ServeConfig(
        quant=quant, **{"max_len": MAX_LEN, "prefill_chunk": 2 * PS,
                        **scfg}), device="cpu")
    make = reqs or (lambda m: _requests(m, sampled))
    return _drive(tserve.Scheduler(eng, slots=slots, chunk=chunk),
                  make(tserve.Request))


# ---------------------------------------------------------------------------
# transcripts: paged port == paged reference == dense port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["w4a4_lut", "w4a4_tmac"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_paged_scheduler_matches_reference_and_dense(quant, sampled):
    """Staggered admission of 8 requests into 3 slots (greedy, or the mix
    of greedy and sampled requests): transcripts, draw counter and pool
    statistics equal the reference's paged Scheduler's; transcripts equal
    the port's dense Scheduler's."""
    want, got, jsched, tsched = _both(quant, sampled)
    assert got == want
    assert tsched._step == jsched._step
    assert _pool_stats(tsched.engine.pool) == _pool_stats(jsched.engine.pool)
    assert tsched.stats["preemptions"] == jsched.stats["preemptions"] == 0
    assert got == _dense(quant, sampled)
    # every slot's KV lived in pages: fewer than the dense capacity
    assert 0 < tsched.engine.pool.peak_pages < 3 * MAX_LEN // PS


# the round shape of tests/test_torch_sampling.py's Scheduler test: 40
# positions, a 4-entry chunk lane, 3 decode tokens a round
SAMPLING_TRAFFIC = dict(max_len=40, prefill_chunk=4, chunk=3)


@pytest.mark.parametrize("sampled,traffic", [
    (False, {}), (True, SAMPLING_TRAFFIC), (True, None)],
    ids=["greedy", "sampled", "sampled-32"])
def test_paged_spec_scheduler_matches_reference(sampled, traffic):
    """Bitplane self-speculative rounds on a paged tmac engine: transcripts,
    spec statistics and pool statistics equal the reference's, and the
    dense speculative run's; after each speculative round no decoding slot
    maps a page past its committed sequence (the trim).

    ``sampled-32`` is the sampled mix on this file's 32-position round
    shape: there the port's DENSE transcripts already leave the
    reference's at one token (one layer-1 K row of a slot differs by 0.099
    after a round: a float32 sum ordered differently by XLA and ATen
    rounds an A4 activation code the other way, and a later draw reads
    it), so that case holds paged == dense within each package, and the
    sampled comparison with the reference runs on the sampling tests'
    round shape."""
    trims = []

    def committed(sched):
        if sched.stats["spec_rounds"] == len(trims):
            return
        trims.append(sched.stats["spec_rounds"])
        pool = sched.engine.pool
        for s, r in enumerate(sched.slots):
            if r is None or sched._progress[s] < sched._target[s]:
                continue
            keep = math.ceil((len(r.prompt) + len(r.tokens)) / PS)
            assert pool.n_full[s] == keep, (s, pool.n_full[s], keep)
            assert not pool.table[s, keep:].any()

    kw = dict(traffic or {})
    chunk = kw.pop("chunk", 2)
    want, got, jsched, tsched = _both("w4a4_tmac", sampled, chunk=chunk,
                                      check=committed, spec_decode=True,
                                      **kw)
    kw.setdefault("prefill_chunk", 2 * PS)
    assert tsched.stats["spec_rounds"] > 0 and trims
    assert got == _dense("w4a4_tmac", sampled, chunk=chunk,
                         spec_decode=True, **kw)
    jeng = jsched.engine
    jdense = jserve.make_engine(_float_params()[0], _cfgs("w4a4_tmac")[0],
                                dataclasses.replace(jeng.scfg, paged=False))
    assert want == _drive(jserve.Scheduler(jdense, slots=3, chunk=chunk),
                          _requests(jserve.Request, sampled))
    if traffic is None:
        return
    assert got == want
    assert tsched._step == jsched._step
    for k in ("spec_rounds", "spec_drafted", "spec_accepted", "rounds"):
        assert tsched.stats[k] == jsched.stats[k], k
    assert _pool_stats(tsched.engine.pool) == _pool_stats(jsched.engine.pool)


# ---------------------------------------------------------------------------
# prefix reuse
# ---------------------------------------------------------------------------

def _prefix_requests(make, n=4, new=4):
    base = list(range(1, 9))                     # 2 full pages at ps=4
    return [make(prompt=base + [20 + i], max_new_tokens=new)
            for i in range(n)]


def test_prefix_reuse_shares_pages_and_matches_reference():
    """The reference's prefix-reuse traffic (an 8-token prefix, 4 prompts,
    4 slots): the same hits, fresh pages and peak as the reference, a hit
    rate above 0.3, fewer pages than without sharing, and the dense
    transcripts."""
    jeng, eng = _engines("w4a4_lut", paged=True, page_size=PS)
    jreqs, treqs = (_prefix_requests(jserve.Request),
                    _prefix_requests(tserve.Request))
    jserve.Scheduler(jeng, slots=4, chunk=2).run(jreqs)
    tserve.Scheduler(eng, slots=4, chunk=2).run(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert _pool_stats(eng.pool) == _pool_stats(jeng.pool)
    assert eng.pool.prefix_hits > 0 and eng.pool.prefix_hit_rate > 0.3
    assert eng.pool.peak_pages < 16
    _drained(eng)
    dense = _dense("w4a4_lut", False, slots=4,
                   reqs=lambda m: _prefix_requests(m))
    assert [t for t, _ in dense] == [r.tokens for r in treqs]


def test_prefix_reuse_disabled_allocates_everything():
    jeng, eng = _engines("w4a4_lut", paged=True, page_size=PS,
                         prefix_reuse=False)
    jreqs, treqs = (_prefix_requests(jserve.Request, 3),
                    _prefix_requests(tserve.Request, 3))
    jserve.Scheduler(jeng, slots=3, chunk=2).run(jreqs)
    tserve.Scheduler(eng, slots=3, chunk=2).run(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert eng.pool.prefix_hits == 0
    assert _pool_stats(eng.pool) == _pool_stats(jeng.pool)
    _drained(eng)


# ---------------------------------------------------------------------------
# pool exhaustion, oversized requests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_pool_exhaustion_preempts_youngest_like_the_reference(sampled):
    """3 slots, 11 pages (10 usable) for 3 requests of 6 + 12 tokens: the
    youngest is preempted and requeued with its emitted tokens, as many
    times as the reference preempts; transcripts equal the reference's and
    an uncontended run's."""
    lens, budgets = [6, 6, 6], [12, 12, 12]

    def reqs(make):
        return _requests(make, sampled, lens=lens, budgets=budgets, seed=1)

    want, got, jsched, tsched = _both("w4a4_lut", sampled, reqs=reqs,
                                      num_pages=11)
    assert got == want
    assert tsched.stats["preemptions"] == jsched.stats["preemptions"] > 0
    assert tsched.engine.pool.preemptions == tsched.stats["preemptions"]
    assert tsched._step == jsched._step
    assert _pool_stats(tsched.engine.pool) == _pool_stats(jsched.engine.pool)
    if not sampled:                # a sampled transcript follows the traffic
        _, roomy, _, free = _both("w4a4_lut", False, reqs=reqs)
        assert free.stats["preemptions"] == 0 and got == roomy


@pytest.mark.parametrize("prompt,pages,match", [
    (12, 3, "more KV pages than the whole pool"),
    (8, 4, "exhausted by a single sequence")])
def test_single_oversized_request_raises(prompt, pages, match):
    """A request the whole pool cannot hold raises and names num_pages, at
    admission (its prompt) or at growth (its decode), as the reference."""
    jeng, eng = _engines("w4a4_lut", paged=True, page_size=PS,
                         num_pages=pages)
    for mod, e in ((jserve, jeng), (tserve, eng)):
        with pytest.raises(RuntimeError, match="num_pages") as err:
            mod.Scheduler(e, slots=2, chunk=2).run(
                [mod.Request(prompt=list(range(1, prompt + 1)),
                             max_new_tokens=16)])
        assert match in str(err.value)


# ---------------------------------------------------------------------------
# memory, configuration, reads
# ---------------------------------------------------------------------------

def test_paged_kv_bytes_below_dense_capacity():
    """Resident pages times the page bytes, below the dense capacity; the
    page bytes times the pool's pages equal the pool tensors' bytes."""
    _, dense = _engines("w4a4_lut")
    jeng, eng = _engines("w4a4_lut", paged=True, page_size=PS)
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    jserve.Scheduler(jeng, slots=2, chunk=2).run(
        _requests(jserve.Request)[:3])
    sched.run(_requests(tserve.Request)[:3])
    assert 0 < eng.kv_cache_bytes(2) < dense.kv_cache_bytes(2)
    assert eng.kv_cache_bytes(2) == jeng.kv_cache_bytes(2)
    assert dense.kv_cache_bytes(2) == sum(
        t.nbytes for c in dense.init_cache(2) for t in c.values())
    pool_bytes = sum(t.nbytes for c in sched.cache for t in c.values())
    assert eng.page_bytes(2) * eng.pool.pages_per_shard == pool_bytes
    assert eng.page_bytes(2) == jeng.page_bytes(2)
    with pytest.raises(ValueError, match="paged"):
        dense.page_bytes(2)


def test_paged_config_validation_and_generate():
    """The reference's ServeConfig checks, the auto chunk of 2 pages, the
    null-page guard, and ``generate`` on a paged engine (a dense oracle)."""
    S = tserve.ServeConfig
    for kw, match in ((dict(max_len=30), "divide max_len"),
                      (dict(page_size=0), "page_size"),
                      (dict(num_pages=-1), "num_pages"),
                      (dict(prefill_chunk=6), "multiple of page_size")):
        with pytest.raises(ValueError, match=match):
            S(paged=True, **{"max_len": 32, **kw})
    assert S(paged=True, page_size=4).chunk_tokens == 8
    assert S(paged=True, page_size=8, max_len=64).chunk_tokens == 16
    assert S(max_len=30, page_size=4).chunk_tokens == 8      # dense: no check
    with pytest.raises(ValueError, match="null page"):
        _engines("w4a4_lut", paged=True, num_pages=1)
    _, eng = _engines("w4a4_lut", paged=True)
    _, dense = _engines("w4a4_lut")
    assert eng.paged and not dense.paged and eng.pool is None
    prompts = torch.from_numpy(
        np.random.default_rng(3).integers(0, 512, (2, 5)))
    assert torch.equal(eng.generate(prompts, 4), dense.generate(prompts, 4))


def test_paged_round_reads_the_device_once(monkeypatch):
    """The table travels host to device before every round: a paged round
    still reads the device once (the packed result)."""
    _, eng = _engines("w4a4_lut", paged=True, page_size=PS, num_pages=11)
    sched = tserve.Scheduler(eng, slots=3, chunk=2)
    for r in _requests(tserve.Request, lens=[6, 6, 6], budgets=[12] * 3,
                       seed=1):
        sched.submit(r)
    calls = []
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    per_round = []
    while sched.has_work:
        before = len(calls)
        sched.step()
        per_round.append(calls[before:])
    assert per_round == [["tolist"]] * len(per_round)
    assert sched.stats["preemptions"] > 0
