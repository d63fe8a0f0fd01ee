"""Port vs reference, gemma2-2b served: the Scheduler over the SWA ring
caches, dense and paged, on the smoke config (window 8, max_len 32) in
``w4a4_lut`` with the plain kernel versions and float32 compute, each
package quantizing the same float tree itself.

Transcripts are compared exactly, with the reference's Scheduler over the
same traffic and with the port's own ``Engine.generate`` (the static-batch
oracle, which rings the prefilled K/V with ``_roll_local``): prompts of 4
(inside the window: the chunk lane) and 12 tokens (past it: monolithic
admission, the stitch arranging the rings), a mixed queue that admits
through ``_admit(only_ineligible=True)`` and the chunk lane in one round,
a faulted run against its fault-free twin and the reference's faulted run,
and a mid-stream ``save`` / ``load`` into a fresh Scheduler.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import transformer as JT
from repro.serve import faults as jfaults
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.serve import faults as tfaults

from _torch_threads import one_torch_thread  # noqa: F401

MAX_LEN = 32
W = 8
LAYOUTS = {"dense": {}, "paged": dict(paged=True, page_size=4)}
# long (past the window), short, long, long, short: the head alternates
# between the monolithic admission and the chunk lane
MIXED = [12, 5, 12, 12, 3]
BUDGETS = [5, 6, 4, 5, 6]


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _cfgs():
    return [dataclasses.replace(mod.get_config("gemma2-2b", smoke=True,
                                               quant="w4a4_lut"),
                                compute_dtype="float32")
            for mod in (jconfigs, tconfigs)]


_P, _ENGINES = {}, {}


def _engine(pkg: str, layout: str):
    """One engine per package and layout for the module (the serving state
    lives in each Scheduler; a paged engine's pool is made anew by every
    Scheduler)."""
    if not _P:
        jcfg, tcfg = _cfgs()
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _P["j"] = jp
        _P["t"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  tcfg, device="cpu")
    key = (pkg, layout)
    if key not in _ENGINES:
        jcfg, tcfg = _cfgs()
        kw = dict(quant="w4a4_lut", max_len=MAX_LEN, **LAYOUTS[layout])
        if pkg == "j":
            _ENGINES[key] = jserve.Engine(jcfg, _P["j"],
                                          jserve.ServeConfig(**kw))
        else:
            _ENGINES[key] = tserve.make_engine(
                _P["t"], tcfg, tserve.ServeConfig(**kw), device="cpu")
    return _ENGINES[key]


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, L).tolist() for L in lens]


def _requests(pkg, lens, budgets):
    mod = jserve if pkg == "j" else tserve
    return [mod.Request(prompt=p, max_new_tokens=b)
            for p, b in zip(_prompts(lens), budgets)]


def _drive(sched, reqs):
    """Staggered, as the reference's test: two requests, one round, then
    the rest, then drain."""
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    while sched.has_work:
        sched.step()
    return [(r.finish_reason, list(r.tokens)) for r in reqs]


def _run(pkg, layout, lens, budgets, plan=None, **sched_kw):
    mod = jserve if pkg == "j" else tserve
    eng = _engine(pkg, layout)
    sched = mod.Scheduler(eng, slots=2, chunk=2, **sched_kw)
    eng.set_fault_plan(plan)
    try:
        got = _drive(sched, _requests(pkg, lens, budgets))
    finally:
        eng.set_fault_plan(None)
    return sched, got


_GEN = {}


def _generate(lens, budgets):
    """The port's static-batch oracle, one request at a time."""
    eng = _engine("t", "dense")
    out = []
    for p, b in zip(_prompts(lens), budgets):
        key = (tuple(p), b)
        if key not in _GEN:
            g = eng.generate(torch.tensor([p]), b)
            _GEN[key] = g[0, len(p):].tolist()
        out.append(("length", _GEN[key]))
    return out


STATS = ("rounds", "admission_rounds", "prefill_tokens", "admitted_tokens",
         "emitted_tokens")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("S", [4, 12])
def test_scheduler_matches_reference_and_generate(S, layout):
    """Prompts inside (4) and past (12) the window: transcripts equal the
    reference's and the port's generate; the round counts and admission
    statistics equal the reference's; a paged run drains its pool."""
    lens, budgets = [S] * 4, [5] * 4
    jsched, want = _run("j", layout, lens, budgets)
    tsched, got = _run("t", layout, lens, budgets)
    assert got == want
    assert got == _generate(lens, budgets)
    for k in STATS:
        assert tsched.stats[k] == jsched.stats[k], k
    eng = tsched.engine
    if layout == "paged":
        assert eng.pool.allocated_pages == 0 and not eng.pool.leaked_pages()
        assert eng.pool.peak_pages == jsched.engine.pool.peak_pages


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mixed_queue_admits_through_only_ineligible(layout):
    """A queue of long, short, long, long, short: long heads admit
    monolithically in their equal-length run, the chunk lane takes the
    short ones, in the rounds the reference takes them."""
    tserve.Scheduler._admit_calls = []
    admit = tserve.Scheduler._admit

    def spy(self, now=None, only_ineligible=False):
        n = admit(self, now, only_ineligible)
        type(self)._admit_calls.append((only_ineligible, n))
        return n
    tserve.Scheduler._admit = spy
    try:
        jsched, want = _run("j", layout, MIXED, BUDGETS)
        tsched, got = _run("t", layout, MIXED, BUDGETS)
        calls = tserve.Scheduler._admit_calls
    finally:
        tserve.Scheduler._admit = admit
        del tserve.Scheduler._admit_calls
    assert got == want
    assert got == _generate(MIXED, BUDGETS)
    for k in STATS:
        assert tsched.stats[k] == jsched.stats[k], k
    # every monolithic admission went through the mixed branch, and both
    # kinds of admission happened
    admitted = [n for only, n in calls if n]
    assert calls and all(only for only, _ in calls)
    assert sum(admitted) == 3
    assert tsched.stats["admitted_tokens"] > sum(MIXED[i] for i in (0, 2, 3))


FAULTS = [dict(site="admit", index=1, kind="dispatch"),
          dict(site="decode", index=2, kind="nan_logits"),
          dict(site="decode", index=4, kind="page_table")]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_faulted_run_equals_its_fault_free_twin(layout):
    """A dispatch failure at an admission, a NaN poisoning the rings and a
    page-table corruption (skipped on the dense engine): recovered through
    the rolling snapshot, the transcripts equal the fault-free run and the
    reference's faulted run, with the same recoveries and fault flags."""
    kw = dict(snapshot_interval=1, max_retries=3)
    _, clean = _run("t", layout, MIXED, BUDGETS, **kw)
    jplan = jfaults.FaultPlan([jfaults.Fault(**f) for f in FAULTS])
    tplan = tfaults.FaultPlan([tfaults.Fault(**f) for f in FAULTS])
    jsched, want = _run("j", layout, MIXED, BUDGETS, jplan, **kw)
    tsched, got = _run("t", layout, MIXED, BUDGETS, tplan, **kw)
    assert got == clean == want
    for k in ("recoveries", "dispatch_retries", "failed"):
        assert tsched.stats[k] == jsched.stats[k], k
    assert tsched.stats["recoveries"] >= 2
    assert [(f.fired, f.skipped) for f in tplan.faults] == \
        [(f.fired, f.skipped) for f in jplan.faults]
    assert not tplan.pending


@pytest.mark.parametrize("layout", LAYOUTS)
def test_save_load_into_a_fresh_scheduler_continues(tmp_path, layout):
    """Saved after 3 rounds (rings mid-wrap, a long request admitted, a
    short one mid-prefill), loaded into a fresh Scheduler on a fresh
    engine: every request continues token for token; a paged load brings
    back the ring table."""
    _, want = _run("t", layout, MIXED, BUDGETS)
    eng = _engine("t", layout)
    a = tserve.Scheduler(eng, slots=2, chunk=2)
    reqs = _requests("t", MIXED, BUDGETS)
    for r in reqs:
        a.submit(r)
    for _ in range(3):
        a.step()
    assert a.has_work
    if layout == "paged":
        assert eng.pool.n_ring != [0, 0]
        ring = eng.pool.ring.copy()
    a.save(str(tmp_path))
    _, tcfg = _cfgs()
    fresh = tserve.make_engine(_P["t"], tcfg, tserve.ServeConfig(
        quant="w4a4_lut", max_len=MAX_LEN, **LAYOUTS[layout]), device="cpu")
    b = tserve.Scheduler(fresh, slots=2, chunk=2)
    b.load(str(tmp_path))
    if layout == "paged":
        np.testing.assert_array_equal(fresh.pool.ring, ring)
    b.run()
    got = {tuple(r.prompt): (r.finish_reason, list(r.tokens))
           for r in b.finished}
    assert [got[tuple(p)] for p in _prompts(MIXED)] == want
