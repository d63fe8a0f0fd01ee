"""The port's rolling snapshot and its restore (``Scheduler.snapshot`` /
``restore``, the fault replay through them) on qwen2-7b-smoke with a paged
KV cache, the plain kernel versions and float32 compute.

A restore must rewind the device state, the request states and the
allocator exactly, resume a prompt mid-way through chunked prefill, and
write IN PLACE: every cache leaf, the slot vectors, the sampling vectors
and the engine's device page table keep their addresses (the captured
round graphs on the card are keyed on them).  A sampled run restored
mid-stream reproduces the draw counter and the tokens.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.serve.faults import Fault, FaultPlan

from _torch_threads import one_torch_thread  # noqa: F401

MAX_LEN = 32
PAGED = dict(paged=True, page_size=4)
KNOBS = [(0.9, 0, 1.0), (1.0, 40, 0.95), (0.0, 0, 1.0), (0.8, 5, 0.9)]


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


_PARAMS = {}


def _engine(**scfg):
    if not _PARAMS:
        jcfg = dataclasses.replace(jconfigs.get_config(
            "qwen2-7b", smoke=True, quant="w4a4_lut"), compute_dtype="float32")
        _PARAMS["cfg"] = dataclasses.replace(tconfigs.get_config(
            "qwen2-7b", smoke=True, quant="w4a4_lut"), compute_dtype="float32")
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS["t"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                       _PARAMS["cfg"], device="cpu")
    return tserve.make_engine(_PARAMS["t"], _PARAMS["cfg"], tserve.ServeConfig(
        quant="w4a4_lut", max_len=MAX_LEN, **PAGED, **scfg), device="cpu")


def _reqs(n=4, S=5, budget=8, sampled=False, seed=1):
    prompts = np.random.default_rng(seed).integers(0, 512, (n, S)).tolist()
    knobs = KNOBS if sampled else [(None, None, None)] * n
    return [tserve.Request(prompt=p, max_new_tokens=budget, temperature=t,
                           top_k=k, top_p=q)
            for p, (t, k, q) in zip(prompts, knobs)]


def _drain(sched, max_rounds=64):
    rounds = 0
    while sched.has_work:
        sched.step()
        rounds += 1
        assert rounds <= max_rounds
    return [(r.finish_reason, list(r.tokens)) for r in
            (list(sched.finished) + [r for r in sched.slots if r])]


def _mid_prefill(sched):
    return any(r is not None and sched._progress[s] < sched._target[s]
               for s, r in enumerate(sched.slots))


def _addresses(sched) -> list:
    """Every device tensor a round graph or the Scheduler holds by
    address."""
    vecs = (sched.tok, sched.pos, sched.done, sched.eos, sched.temperature,
            sched.top_k, sched.top_p, sched.engine.table)
    return [t.data_ptr() for c in sched.cache for t in c.values()] + \
        [t.data_ptr() for t in vecs]


def _state(sched) -> dict:
    """The device state by value."""
    out = {f"cache{i}.{k}": t.clone() for i, c in enumerate(sched.cache)
           for k, t in c.items()}
    for name in ("tok", "pos", "done", "eos", "temperature", "top_k",
                 "top_p"):
        out[name] = getattr(sched, name).clone()
    return out


def _assert_state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def test_host_snapshot_restore_is_exact():
    """The rolling snapshot restores the device state, the request states
    and the allocator exactly, in place (the fault-recovery primitive)."""
    eng = _engine()
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    reqs = _reqs()
    for r in reqs:
        sched.submit(r)
    sched.step()
    ptrs = _addresses(sched)
    snap = sched.snapshot()
    mid = [(r.status, list(r.tokens)) for r in reqs]
    pool_mid = eng.pool.state_dict()
    state_mid = _state(sched)
    want = sorted(_drain(sched))
    assert sched.stats["rounds"] > snap["stats"]["rounds"]
    sched.restore(snap)
    assert _addresses(sched) == ptrs
    assert [(r.status, list(r.tokens)) for r in reqs] == mid
    assert eng.pool.state_dict() == pool_mid
    _assert_state_equal(_state(sched), state_mid)
    assert sched.stats == snap["stats"]
    assert sorted(_drain(sched)) == want
    assert _addresses(sched) == ptrs


def test_snapshot_restore_mid_prefill_chunk():
    """A snapshot taken while a long prompt is mid-way through chunked
    prefill carries the chunk cursor; the restored run finishes
    token-identically."""
    eng = _engine(prefill_chunk=4)
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    for r in _reqs(n=2, S=20, budget=6, seed=7):
        sched.submit(r)
    sched.step()                        # 4 of 20 prompt tokens fed
    assert _mid_prefill(sched)
    ptrs = _addresses(sched)
    snap = sched.snapshot()
    pool_mid = eng.pool.state_dict()
    want = sorted(_drain(sched))
    sched.restore(snap)
    assert _mid_prefill(sched)
    assert eng.pool.state_dict() == pool_mid
    assert _addresses(sched) == ptrs
    assert sorted(_drain(sched)) == want


def test_fault_replay_resumes_mid_prefill_chunk():
    """A dispatch fault while a long prompt is mid-way through chunked
    prefill (admit dispatch 2 is the third chunk of the 20-token prompt)
    replays from the rolling snapshot and matches the fault-free run."""
    ref = tserve.Scheduler(_engine(prefill_chunk=4), slots=2, chunk=2)
    reqs = _reqs(n=2, S=20, budget=6)
    ref.run(reqs, max_rounds=64)
    want = [(r.finish_reason, list(r.tokens)) for r in reqs]

    eng = _engine(prefill_chunk=4)
    plan = FaultPlan([Fault(site="admit", index=2, kind="dispatch",
                            duration=0.001),
                      Fault(site="admit", index=4, kind="nan_logits")])
    eng.set_fault_plan(plan)
    sched = tserve.Scheduler(eng, slots=2, chunk=2, snapshot_interval=1,
                             max_retries=3)
    ptrs = _addresses(sched)
    got = _reqs(n=2, S=20, budget=6)
    sched.run(got, max_rounds=64)
    assert not plan.pending
    assert sched.stats["recoveries"] >= 2
    assert sched.stats["dispatch_retries"] == 1
    assert [(r.finish_reason, list(r.tokens)) for r in got] == want
    assert _addresses(sched) == ptrs


def test_sampled_restore_reproduces_the_draw_counter():
    """Sampled requests: a restore rewinds the draw counter and the
    sampling mirrors, and the replay draws the same tokens."""
    eng = _engine(seed=7, temperature=0.7)
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    for r in _reqs(sampled=True):
        sched.submit(r)
    for _ in range(3):
        sched.step()
    ptrs = _addresses(sched)
    snap = sched.snapshot()
    step_mid = sched._step
    mirrors = (list(sched._temp_h), list(sched._topk_h), list(sched._topp_h))
    want = sorted(_drain(sched))
    step_end = sched._step
    assert step_end > step_mid
    sched.restore(snap)
    assert sched._step == step_mid
    assert (sched._temp_h, sched._topk_h, sched._topp_h) == mirrors
    assert _addresses(sched) == ptrs
    assert sorted(_drain(sched)) == want
    assert sched._step == step_end
    assert any(t > 0 for t in mirrors[0])


def test_restore_refuses_a_snapshot_a_later_one_overwrote():
    """Snapshots share one set of host buffers: after snapshot B, restoring
    snapshot A would pair B's device state with A's host state, so it
    raises and leaves the serving state alone; B itself still restores."""
    eng = _engine()
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    for r in _reqs():
        sched.submit(r)
    sched.step()
    snap_a = sched.snapshot()
    sched.step()
    snap_b = sched.snapshot()
    state_b = _state(sched)
    sched.step()
    state_c, step_c = _state(sched), sched._step
    with pytest.raises(RuntimeError, match="stale snapshot"):
        sched.restore(snap_a)
    _assert_state_equal(_state(sched), state_c)
    assert sched._step == step_c
    sched.restore(snap_b)
    _assert_state_equal(_state(sched), state_b)
    assert sched.stats == snap_b["stats"]


def test_submissions_after_the_snapshot_survive_a_restore():
    """Requests submitted after the rolling snapshot rejoin the queue tail
    on restore, so recovery drops no submission."""
    eng = _engine()
    sched = tserve.Scheduler(eng, slots=2, chunk=2, snapshot_interval=1)
    first, late = _reqs(n=2), _reqs(n=2, seed=3)
    for r in first:
        sched.submit(r)
    sched.step()
    for r in late:
        sched.submit(r)
    assert sched._submit_log == late
    sched.restore(sched._snap)
    assert [q is r for q, r in zip(list(sched.queue)[-2:], late)] == \
        [True, True]
    _drain(sched)
    assert all(r.finish_reason == "length" for r in first + late)
