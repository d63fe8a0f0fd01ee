"""Port vs reference, the Scheduler's logical clock and QoS policies
(``Request.deadline`` / ``priority`` / ``slack``, ``Scheduler(shed_watermark,
overload_queue)``, ``_expire_deadlines``, ``_shed_overload``, the
most-slack ``_preempt_victim``) on qwen2-7b-smoke in ``w4a4_lut``, the
plain kernel versions and float32 compute.

Every case runs in both packages on the same weights (``params_from_jax``)
and must give equal statuses, transcripts, ``arrival_time``,
``finish_time`` and ``stats``: the reference's deadline, clockless,
shedding, watermark, preemption-victim and submit-validation cases, and
the reference's overload trace itself (``benchmarks/serving_bench.py``'s
``_overload_rows`` at its smoke geometry: 2 slots, chunk 4, 13 pages of 4,
24 requests from ``random.Random(0)``), clean and under its two NaN faults
with a snapshot every round.  A callable clock is read at the top of a step
and again after the round's one host read, never before it.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest

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
# engine configurations: (kv_quant, ServeConfig extras)
CONFIGS = {
    "dense": ("none", {}),
    "paged13": ("none", dict(paged=True, page_size=4, num_pages=13)),
    "int8": ("int8", {}),
}
STAT_KEYS = ("rounds", "shed", "timed_out", "preemptions", "occupancy_sum",
             "emitted_tokens", "recoveries", "failed")


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _cfgs(kv_quant):
    return [dataclasses.replace(
        mod.get_config("qwen2-7b", smoke=True, quant="w4a4_lut"),
        compute_dtype="float32", kv_quant=kv_quant)
        for mod in (jconfigs, tconfigs)]


_PARAMS = {}
_ENGINES = {}


def _engine(pkg: str, config: str):
    """One engine per package and configuration for the whole module."""
    key = (pkg, config)
    if key not in _ENGINES:
        if not _PARAMS:
            jcfg, tcfg = _cfgs("none")
            jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
            _PARAMS["j"] = jp
            _PARAMS["t"] = params_from_jax(
                jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
        kv_quant, extra = CONFIGS[config]
        jcfg, tcfg = _cfgs(kv_quant)
        scfg = dict(quant="w4a4_lut", max_len=MAX_LEN, **extra)
        if pkg == "j":
            _ENGINES[key] = jserve.Engine(jcfg, _PARAMS["j"],
                                          jserve.ServeConfig(**scfg))
        else:
            _ENGINES[key] = tserve.make_engine(
                _PARAMS["t"], tcfg, tserve.ServeConfig(**scfg), device="cpu")
    return _ENGINES[key]


def _mod(pkg):
    return jserve if pkg == "j" else tserve


def _sched(pkg, config="dense", **kw):
    return _mod(pkg).Scheduler(_engine(pkg, config), **kw)


def _outcome(reqs) -> list:
    return [(r.status.value, r.finish_reason, list(r.tokens), r.arrival_time,
             r.finish_time) for r in reqs]


def _stats(sched) -> dict:
    return {k: sched.stats[k] for k in STAT_KEYS}


def _both(case):
    """``case(pkg) -> (scheduler, requests)`` in both packages: outcomes
    and stats equal; returns the port's."""
    jsched, jreqs = case("j")
    tsched, treqs = case("t")
    assert _outcome(treqs) == _outcome(jreqs)
    assert _stats(tsched) == _stats(jsched)
    assert tsched.mean_occupancy == jsched.mean_occupancy
    return tsched, treqs


def _prompts(n, S=5):
    return np.random.default_rng(1).integers(0, 512, (n, S)).tolist()


# ---------------------------------------------------------------------------
# the reference's QoS cases
# ---------------------------------------------------------------------------

def test_deadline_expiry_queued_and_running():
    def case(pkg):
        Request = _mod(pkg).Request
        sched = _sched(pkg, slots=1, chunk=2)
        r_run = Request(prompt=[1, 2, 3], max_new_tokens=12, deadline=5.0)
        r_q = Request(prompt=[4, 5, 6], max_new_tokens=4, deadline=1.0)
        sched.submit(r_run, now=0.0)
        sched.submit(r_q, now=0.0)
        sched.step(now=0.0)              # r_run admitted, r_q queued
        assert r_run.status.value == "running"
        sched.step(now=2.0)              # r_q's deadline passed while queued
        assert r_q.status.value == "timed_out" and r_q.tokens == []
        assert r_q.finish_time == 2.0
        sched.step(now=6.0)              # r_run expires mid-decode
        assert r_run.status.value == "timed_out"
        assert 0 < len(r_run.tokens) < 12  # partial transcript retained
        assert r_run.finish_time == 6.0
        assert not sched.has_work
        assert sched.stats["timed_out"] == 2
        return sched, [r_run, r_q]
    _both(case)


def test_clockless_run_never_expires():
    def case(pkg):
        sched = _sched(pkg, slots=2, chunk=2)
        req = _mod(pkg).Request(prompt=[1, 2, 3], max_new_tokens=4,
                                deadline=0.5)
        sched.run([req])                 # no now= anywhere
        assert req.finish_reason == "length" and len(req.tokens) == 4
        assert req.arrival_time is None and req.finish_time is None
        return sched, [req]
    _both(case)


def test_shedding_is_deterministic_and_priority_ordered():
    """Saturated slots and an overlong queue: the shed set is the lowest
    (priority, slack, -submit order) tail, the same in a second run."""
    def case(pkg):
        Request = _mod(pkg).Request
        sched = _sched(pkg, slots=1, chunk=2, shed_watermark=1.0,
                       overload_queue=2)
        keep = Request(prompt=[1, 2, 3], max_new_tokens=8)
        sched.submit(keep, now=0.0)
        sched.step(now=0.0)              # slot saturated
        waiting = [Request(prompt=[10 + i, 2, 3], max_new_tokens=2,
                           priority=p, deadline=d)
                   for i, (p, d) in enumerate(
                       [(1, None), (0, 9.0), (0, 3.0), (1, 2.0)])]
        for r in waiting:
            sched.submit(r, now=1.0)
        sched.step(now=1.0)              # 4 queued > overload_queue=2
        return sched, [keep] + waiting
    _, got = _both(case)
    # shed 2: priority-0 requests go first, least slack first
    assert [r.status.value for r in got[1:]] == ["queued", "shed", "shed",
                                                 "queued"]
    assert [r.finish_time for r in got[1:]] == [None, 1.0, 1.0, None]
    assert _outcome(case("t")[1]) == _outcome(got)   # deterministic replay


def test_no_shedding_below_watermark():
    def case(pkg):
        sched = _sched(pkg, slots=2, chunk=2, shed_watermark=1.0,
                       overload_queue=1)
        reqs = [_mod(pkg).Request(prompt=p, max_new_tokens=3)
                for p in _prompts(6)]
        for r in reqs:
            sched.submit(r, now=0.0)
        while sched.has_work:
            sched.step(now=0.0)
        assert all(r.finish_reason == "length" for r in reqs[:2])
        assert sched.stats["shed"] < 6   # below-watermark rounds admit
        return sched, reqs
    _both(case)


def test_preemption_prefers_most_slack_victim():
    """Pool exhaustion evicts the slot with the MOST deadline slack, not
    simply the youngest."""
    def case(pkg):
        Request = _mod(pkg).Request
        sched = _sched(pkg, "paged13", slots=2, chunk=2)
        # 4 prompt + 24 new = 28 tokens = 7 pages a slot; two slots want 14
        # of the 12 usable: someone is preempted mid-decode
        tight = Request(prompt=[1, 2, 3, 4], max_new_tokens=24,
                        deadline=100.0)
        loose = Request(prompt=[5, 6, 7, 8], max_new_tokens=24, deadline=1e6)
        sched.submit(tight, now=0.0)
        sched.submit(loose, now=0.0)
        preempted = []
        orig = sched._preempt_victim

        def spy(now_v):
            slot, req = orig(now_v)
            preempted.append(req)
            return slot, req
        sched._preempt_victim = spy
        while sched.has_work:
            sched.step(now=0.0)
        assert preempted and all(r is loose for r in preempted)
        assert tight.finish_reason == "length" and len(tight.tokens) == 24
        assert loose.finish_reason == "length" and len(loose.tokens) == 24
        return sched, [tight, loose]
    _both(case)


def test_preemption_without_deadlines_stays_youngest_first():
    """The same contention without deadlines: the younger admission goes."""
    sched = _sched("t", "paged13", slots=2, chunk=2)
    a, b = (tserve.Request(prompt=p, max_new_tokens=24)
            for p in ([1, 2, 3, 4], [5, 6, 7, 8]))
    sched.submit(a)
    sched.submit(b)
    preempted = []
    orig = sched._preempt_victim

    def spy(now_v):
        slot, req = orig(now_v)
        preempted.append(req)
        return slot, req
    sched._preempt_victim = spy
    sched.run()
    assert preempted and all(r is b for r in preempted)
    assert [len(r.tokens) for r in (a, b)] == [24, 24]


@pytest.mark.parametrize("pkg", ["j", "t"])
def test_submit_rejects_malformed_requests(pkg):
    Request = _mod(pkg).Request
    sched = _sched(pkg, slots=2, chunk=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(prompt=[1], max_new_tokens=-1)
    r = Request(prompt=[1], max_new_tokens=1)
    r.max_new_tokens = -2                # mutated after construction
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(r)
    with pytest.raises(ValueError, match="prompt length"):
        sched.submit(Request(prompt=list(range(MAX_LEN + 1)),
                             max_new_tokens=0))
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.submit(Request(prompt=list(range(20)), max_new_tokens=20))
    with pytest.raises(ValueError, match="deadline"):
        Request(prompt=[1], deadline=float("nan"))
    with pytest.raises(ValueError, match="priority"):
        Request(prompt=[1], priority=float("inf"))
    for field, value in (("deadline", float("inf")), ("deadline", "soon"),
                         ("priority", float("nan")), ("priority", None)):
        bad = Request(prompt=[1], max_new_tokens=1)
        setattr(bad, field, value)
        with pytest.raises(ValueError, match=field):
            sched.submit(bad)
    assert not sched.queue               # nothing malformed got queued
    assert sched._submit_count == 0


def test_submit_stamps_arrival_and_sequence():
    def case(pkg):
        sched = _sched(pkg, slots=2, chunk=2)
        ticks = iter([3.0, 4.5])
        reqs = [_mod(pkg).Request(prompt=p, max_new_tokens=2)
                for p in _prompts(3)]
        sched.submit(reqs[0], now=lambda: next(ticks))
        sched.submit(reqs[1], now=lambda: next(ticks))
        sched.submit(reqs[2])
        assert [r._seq for r in reqs] == [1, 2, 3]
        assert [r.arrival_time for r in reqs] == [3.0, 4.5, None]
        while sched.has_work:
            sched.step(now=7.0)
        return sched, reqs
    _both(case)


# ---------------------------------------------------------------------------
# the callable clock: read at the top of a step and after the host read
# ---------------------------------------------------------------------------

class _Read:
    """Stands for the round's packed result: its ``tolist`` is the host
    read, logged."""

    def __init__(self, packed, events):
        self.packed, self.events = packed, events

    def tolist(self):
        self.events.append("read")
        return self.packed.tolist()


@pytest.mark.parametrize("config", ["dense", "int8"])
def test_callable_clock_is_read_after_the_host_read(config):
    """A counting clock: the step reads it first, the round reads the
    device once, the clock is read again, and every finish time is that
    second reading (an int8 engine's monolithic admission reads it after
    its own host read too)."""
    eng = _engine("t", config)
    events, count = [], [0]

    def clock():
        count[0] += 1
        events.append(("clock", float(count[0])))
        return float(count[0])

    def wrap(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            events.append("dispatch")
            return (*out[:-1], _Read(out[-1], events))
        return call
    eng.step = wrap(eng.step)
    eng.admit_monolithic = wrap(eng.admit_monolithic)
    try:
        sched = tserve.Scheduler(eng, slots=2, chunk=2)
        reqs = [tserve.Request(prompt=p, max_new_tokens=b)
                for p, b in zip(_prompts(3), (1, 3, 2))]
        for r in reqs:
            sched.submit(r, now=0.0)
        steps = []
        while sched.has_work:
            events.clear()
            sched.step(now=clock)
            steps.append(list(events))
    finally:
        del eng.step, eng.admit_monolithic
    tops, later = set(), set()
    for ev in steps:
        assert ev[0][0] == "clock"
        tops.add(ev[0][1])
        # every later reading directly follows a dispatch's host read
        for prev, e in zip(ev, ev[1:]):
            if isinstance(e, tuple):
                assert prev == "read", ev
                later.add(e[1])
            elif e == "read":
                assert prev == "dispatch", ev
    assert all(r.finish_reason == "length" for r in reqs)
    # every finish time is a reading taken after a host read
    assert {r.finish_time for r in reqs} <= later
    assert not tops & later


# ---------------------------------------------------------------------------
# the reference's overload trace, clean and faulted
# ---------------------------------------------------------------------------

def _trace(vocab):
    """``_overload_rows``'s requests, drawn in its order."""
    SLOTS, CHUNK, S, N = 2, 4, 6, 24
    rng = random.Random(0)
    prompts = [[rng.randrange(vocab) for _ in range(S)] for _ in range(N)]
    budgets = [rng.randint(4, 12) for _ in range(N)]
    prios = [rng.randint(0, 1) for _ in range(N)]
    arrivals = [i / 3.0 for i in range(N)]
    deadlines = [arrivals[i] + 4.0 if prios[i] == 0 and rng.random() < 0.5
                 else None for i in range(N)]
    return prompts, budgets, prios, arrivals, deadlines


def _drive(pkg, plan=None, **sched_kw):
    """One logical tick a step, arrivals at i / 3, as ``_overload_rows``."""
    mod = _mod(pkg)
    eng = _engine(pkg, "paged13")
    prompts, budgets, prios, arrivals, deadlines = _trace(eng.cfg.vocab)
    sched = mod.Scheduler(eng, slots=2, chunk=4, shed_watermark=0.6,
                          overload_queue=3, **sched_kw)
    reqs = [mod.Request(prompt=p, max_new_tokens=b, priority=pr, deadline=d)
            for p, b, pr, d in zip(prompts, budgets, prios, deadlines)]
    eng.set_fault_plan(plan)
    try:
        idx, t = 0, 0.0
        while idx < len(reqs) or sched.has_work:
            while idx < len(reqs) and arrivals[idx] <= t:
                sched.submit(reqs[idx], now=t)
                idx += 1
            sched.step(now=t)
            t += 1.0
            assert t <= 4096
    finally:
        eng.set_fault_plan(None)
    sched.check_drained()
    return sched, reqs


def test_overload_trace_matches_reference():
    sched, reqs = _both(_drive)
    st = sched.stats
    # at this geometry the reference's own trace only times out: no shed, no
    # preemption (the chip-scale trace of chip_smoke.py has all three)
    assert st["timed_out"] > 0
    assert {r.finish_reason for r in reqs} <= {"length", "shed",
                                               "timed_out"}
    assert 0 < sched.mean_occupancy <= 1


def test_faulted_overload_trace_matches_reference():
    faults = [dict(site="decode", index=3, kind="nan_logits"),
              dict(site="decode", index=9, kind="nan_logits")]

    def case(pkg):
        fm = jfaults if pkg == "j" else tfaults
        plan = fm.FaultPlan([fm.Fault(**f) for f in faults])
        sched, reqs = _drive(pkg, plan, snapshot_interval=1, max_retries=4)
        assert not plan.pending
        return sched, reqs
    sched, reqs = _both(case)
    assert sched.stats["recoveries"] >= 2
    # served transcripts equal the clean run's of the same requests
    _, clean = _drive("t")
    served = {tuple(r.prompt): r.tokens for r in clean
              if r.finish_reason == "length"}
    for r in reqs:
        if r.finish_reason == "length" and tuple(r.prompt) in served:
            assert r.tokens == served[tuple(r.prompt)]
