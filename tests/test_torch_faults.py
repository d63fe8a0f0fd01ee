"""Port vs reference, fault injection and recovery (``serve/faults.py``,
``Engine._fault_site`` / ``_cache_finite``, ``Scheduler.snapshot`` /
``restore`` / ``_recover``) on qwen2-7b-smoke, the plain kernel versions
and float32 compute, 2 slots, chunk 2, max_len 32.

The same ``FaultPlan`` runs in both packages over the same requests: the
transcripts, ``recoveries`` / ``dispatch_retries`` / ``failed``, the
per-site dispatch counters and every fault's ``fired`` / ``skipped`` flags
must be equal, and the port's faulted transcripts must equal its own
fault-free run exactly.  Cases: every kind at both sites (dense), every
kind at ``decode`` (paged), the int8 KV cache (dense and paged: a NaN in
``k_scale``, an admission dispatch failure), a speculative tmac engine,
seeded chaos plans, detection without snapshots, the cache sweep's
verdict for NaN and both infinities (bf16, float32, int8 scales),
streaming callbacks, the retry bound, the atomic admission rollback, and
``FaultPlan.random`` against the reference's.
"""
import dataclasses

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
PAGED = dict(paged=True, page_size=4)
INT8 = dict(kv_quant="int8")
SPEC = dict(spec_decode=True, draft_k=2)
# engine configurations: (quant, kv_quant, ServeConfig extras)
CONFIGS = {
    "dense": ("w4a4_lut", "none", {}),
    "paged": ("w4a4_lut", "none", PAGED),
    "int8": ("w4a4_lut", "int8", {}),
    "int8-paged": ("w4a4_lut", "int8", PAGED),
    "spec": ("w4a4_tmac", "none", SPEC),
}


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _cfgs(quant, kv_quant):
    out = []
    for mod in (jconfigs, tconfigs):
        out.append(dataclasses.replace(
            mod.get_config("qwen2-7b", smoke=True, quant=quant),
            compute_dtype="float32", kv_quant=kv_quant))
    return out


_FLOAT = {}
_ENGINES = {}
_CLEAN = {}


def _float_params():
    if not _FLOAT:
        jcfg, tcfg = _cfgs("w4a4_lut", "none")
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _FLOAT["j"] = jp
        _FLOAT["t"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      tcfg, device="cpu")
    return _FLOAT["j"], _FLOAT["t"]


def _engine(pkg: str, config: str):
    """One engine per package and configuration for the whole module (the
    serving state lives in each Scheduler; a paged engine's pool is made
    anew by every Scheduler)."""
    key = (pkg, config)
    if key not in _ENGINES:
        quant, kv_quant, extra = CONFIGS[config]
        jcfg, tcfg = _cfgs(quant, kv_quant)
        jp, tp = _float_params()
        kw = dict(quant=quant, max_len=MAX_LEN, **extra)
        if pkg == "j":
            _ENGINES[key] = jserve.Engine(jcfg, jp, jserve.ServeConfig(**kw))
        else:
            _ENGINES[key] = tserve.make_engine(
                tp, tcfg, tserve.ServeConfig(**kw), device="cpu")
    return _ENGINES[key]


def _prompts(n=4, S=5):
    return np.random.default_rng(1).integers(0, 512, (n, S)).tolist()


def _transcripts(reqs):
    return [(r.finish_reason, list(r.tokens)) for r in reqs]


def _run(pkg, config, plan=None, n=4, budget=6, on_token=None,
         **sched_kw):
    """Drain ``n`` requests through a fresh Scheduler(slots=2, chunk=2) on
    the module's engine with ``plan`` installed."""
    mod = jserve if pkg == "j" else tserve
    eng = _engine(pkg, config)
    sched = mod.Scheduler(eng, slots=2, chunk=2, **sched_kw)
    reqs = [mod.Request(prompt=p, max_new_tokens=budget, on_token=on_token)
            for p in _prompts(n)]
    eng.set_fault_plan(plan)
    try:
        sched.run(reqs, max_rounds=64)
    finally:
        eng.set_fault_plan(None)
    return sched, _transcripts(reqs)


def _clean(config):
    """The port's fault-free transcripts of a configuration (cached)."""
    if config not in _CLEAN:
        _CLEAN[config] = _run("t", config)[1]
    return _CLEAN[config]


def _plans(faults):
    """The same plan in both packages: a list of Fault kwargs."""
    return (jfaults.FaultPlan([jfaults.Fault(**f) for f in faults]),
            tfaults.FaultPlan([tfaults.Fault(**f) for f in faults]))


def _flags(plan):
    return [(f.fired, f.skipped) for f in plan.faults]


def _differential(config, faults, **sched_kw):
    """The faulted run in both packages: everything equal, and the port's
    transcripts equal to its own fault-free run."""
    jplan, tplan = _plans(faults)
    jsched, want = _run("j", config, jplan, **sched_kw)
    tsched, got = _run("t", config, tplan, **sched_kw)
    assert got == want
    assert got == _clean(config)
    for k in ("recoveries", "dispatch_retries", "failed"):
        assert tsched.stats[k] == jsched.stats[k], k
    assert tplan.counters == jplan.counters
    assert _flags(tplan) == _flags(jplan)
    assert not tplan.pending
    return tsched, tplan


# ---------------------------------------------------------------------------
# the differential: every category, dense and paged, int8, speculative
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", tfaults.KINDS)
@pytest.mark.parametrize("site", tfaults.SITES)
def test_single_fault_dense_matches_reference(kind, site):
    sched, plan = _differential(
        "dense", [dict(site=site, index=1, kind=kind, duration=0.001)],
        snapshot_interval=1, max_retries=3)
    if kind == "dispatch" or (kind == "nan_logits"
                              and not plan.faults[0].skipped):
        assert sched.stats["recoveries"] >= 1
    if kind == "page_table":                 # dense engine: no pool
        assert plan.faults[0].skipped


@pytest.mark.parametrize("kind", tfaults.KINDS)
def test_single_fault_paged_matches_reference(kind):
    sched, plan = _differential(
        "paged", [dict(site="decode", index=1, kind=kind, duration=0.001)],
        snapshot_interval=1, max_retries=3)
    assert not plan.faults[0].skipped
    if kind != "stall":
        assert sched.stats["recoveries"] >= 1


@pytest.mark.parametrize("fault", [
    dict(site="decode", index=1, kind="nan_logits"),
    dict(site="admit", index=1, kind="dispatch")], ids=["nan", "dispatch"])
@pytest.mark.parametrize("config", ["int8", "int8-paged"])
def test_int8_kv_fault_matches_reference(config, fault):
    """int8 K codes cannot hold a NaN: the fault poisons ``k_scale``, and
    detection rests on the float leaves and the logits."""
    sched, plan = _differential(config, [fault], snapshot_interval=1,
                                max_retries=3)
    assert sched.stats["recoveries"] == 1
    assert not plan.faults[0].skipped


def test_spec_engine_nan_fault_matches_reference():
    sched, _ = _differential(
        "spec", [dict(site="decode", index=2, kind="nan_logits")],
        snapshot_interval=1, max_retries=3)
    assert sched.stats["recoveries"] == 1
    assert sched.stats["spec_rounds"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_seeded_chaos_plan_matches_reference(seed):
    """A seeded multi-fault plan (both packages draw it with
    ``random.Random``) converges to the fault-free transcripts."""
    kw = dict(n=4, max_index=8, slots=2, duration=0.001)
    jplan = jfaults.FaultPlan.random(seed, **kw)
    tplan = tfaults.FaultPlan.random(seed, **kw)
    jsched, want = _run("j", "paged", jplan, snapshot_interval=1,
                        max_retries=8)
    tsched, got = _run("t", "paged", tplan, snapshot_interval=1,
                       max_retries=8)
    assert got == want == _clean("paged")
    for k in ("recoveries", "dispatch_retries", "failed"):
        assert tsched.stats[k] == jsched.stats[k], k
    assert tplan.counters == jplan.counters
    assert _flags(tplan) == _flags(jplan)
    # faults drawn past the run's dispatch count never fire
    assert all(f.index >= tplan.counters[f.site] for f in tplan.pending)


# ---------------------------------------------------------------------------
# detection guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config,kind", [("dense", "nan_logits"),
                                         ("paged", "page_table")])
def test_corruption_without_snapshots_is_not_served(config, kind):
    """Without snapshots, a NaN poisoning (the finite guards) and a
    corrupted page table (the pool audit) fail the run instead of serving
    tokens."""
    plan = tfaults.FaultPlan([tfaults.Fault(site="decode", index=1,
                                            kind=kind)])
    with pytest.raises(RuntimeError, match="snapshot") as err:
        _run("t", config, plan)
    assert isinstance(err.value.__cause__, tfaults.CacheCorruption)


@pytest.mark.parametrize("config", ["dense", "paged", "int8"])
def test_cache_sweep_catches_a_nan_no_logit_sees(config):
    """A NaN planted in the last layer's ``k`` (int8: ``k_scale``) where no
    row attends — past every live row's position (the mask drops its
    score), or in a page no row maps — leaves every logit finite; the
    round's cache sweep still fails it, in both packages alike."""
    import jax.numpy as jnp
    leaf = "k_scale" if config == "int8" else "k"
    for pkg, mod in (("j", jserve), ("t", tserve)):
        eng = _engine(pkg, config)
        sched = mod.Scheduler(eng, slots=2, chunk=2)
        for p in _prompts(2):
            sched.submit(mod.Request(prompt=p, max_new_tokens=6))
        sched.step()
        assert all(r is not None for r in sched.slots)
        idx = (eng.pool.pages_per_shard - 1, 0) if eng.paged \
            else (1, MAX_LEN - 1)
        if pkg == "j":
            (c,) = sched.cache
            sched.cache = (dict(c, **{leaf: c[leaf].at[(-1,) + idx].set(
                jnp.nan)}),)
        else:
            sched.cache[-1][leaf][idx] = float("nan")
        with pytest.raises(RuntimeError, match="snapshot") as err:
            sched.step()
        assert "non-finite" in str(err.value.__cause__), pkg


def _sweep_caches(layout: str, leaf: str, layer: int, value):
    """A 3-layer cache in both packages from one numpy draw, ``value``
    planted at one position of ``leaf`` in ``layer`` (None: clean)."""
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(7)
    shape = (2, 8, 2, 4)
    jcache, tcache = [], []
    for i in range(3):
        host = {"k": rng.standard_normal(shape, np.float32),
                "v": rng.standard_normal(shape, np.float32)}
        if layout == "int8":
            host = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                    "v": rng.integers(-127, 128, shape).astype(np.int8),
                    "k_scale": rng.random(shape[:3], np.float32),
                    "v_scale": rng.random(shape[:3], np.float32)}
        if value is not None and i == layer % 3:
            host[leaf][(1, 5) + (0,) * (host[leaf].ndim - 2)] = value
        jd, td = {}, {}
        for key, a in host.items():
            if layout == "bf16" and key in ("k", "v"):
                jd[key] = jnp.asarray(a, jnp.bfloat16)
                td[key] = torch.from_numpy(a).to(torch.bfloat16)
            else:
                jd[key], td[key] = jnp.asarray(a), torch.from_numpy(a)
        jcache.append(jd)
        tcache.append(td)
    return jcache, tcache


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf"), None])
@pytest.mark.parametrize("layout,leaf,layer", [
    ("bf16", "k", 0), ("bf16", "v", -1), ("float32", "k", -1),
    ("float32", "v", 0), ("int8", "k_scale", 0), ("int8", "v_scale", -1)])
def test_cache_sweep_verdict_matches_reference(layout, leaf, layer, value):
    """The one-pass sweep (a max-abs norm per leaf) gives the reference's
    verdict, ``isfinite().all()`` leaf by leaf, for NaN and both
    infinities in bf16 and float32 leaves and in an int8 cache's scales."""
    from repro.serve import engine as jengine
    from repro_torch.serve import engine as tengine
    jcache, tcache = _sweep_caches(layout, leaf, layer, value)
    want = bool(jengine._cache_finite(jcache))
    assert want == (value is None)
    assert bool(tengine._cache_finite(tcache)) == want


def test_streaming_callbacks_never_see_poisoned_tokens():
    """Detection precedes emission: every stream of a faulted run ends with
    the clean stream, and holds no token outside it."""
    def stream(into):
        def on_token(req, tok):
            into.setdefault(tuple(req.prompt), []).append(tok)
        return on_token

    clean, streamed = {}, {}
    _run("t", "dense", on_token=stream(clean))
    plan = tfaults.FaultPlan([tfaults.Fault(site="decode", index=1,
                                            kind="nan_logits")])
    sched, _ = _run("t", "dense", plan, on_token=stream(streamed),
                    snapshot_interval=1)
    assert sched.stats["recoveries"] == 1 and not plan.pending
    assert streamed.keys() == clean.keys()
    for k, toks in streamed.items():
        want = clean[k]
        assert toks[-len(want):] == want
        assert set(toks) <= set(want)


def test_retry_bound_fails_requests_like_the_reference():
    """NaN faults at decode dispatches 1, 3 and 5 with ``max_retries=2``:
    the per-request retry count crosses the bound and both requests fail,
    in both packages alike."""
    faults = [dict(site="decode", index=i, kind="nan_logits")
              for i in (1, 3, 5)]
    jplan, tplan = _plans(faults)
    kw = dict(n=2, budget=10, snapshot_interval=1, max_retries=2)
    jsched, want = _run("j", "dense", jplan, **kw)
    tsched, got = _run("t", "dense", tplan, **kw)
    assert got == want
    assert tsched.stats["recoveries"] == 3
    assert tsched.stats["failed"] == 2
    assert all(reason == "failed" for reason, _ in got)
    assert tsched.stats == {k: jsched.stats[k] for k in tsched.stats}
    assert tplan.counters == jplan.counters


def test_dispatch_fault_rolls_back_admission_atomically():
    """An injected admission failure releases the candidates' pages and
    requeues them in order; the retry admits an identical round."""
    sched, _ = _differential(
        "paged", [dict(site="admit", index=0, kind="dispatch")],
        snapshot_interval=1)
    assert sched.stats["dispatch_retries"] == 1
    assert sched.engine.pool.allocated_pages == 0


def test_stats_match_reference_after_recovery():
    """After a NaN recovery the whole statistics dict (rewound by the
    restore, then counted again) equals the reference's."""
    faults = [dict(site="decode", index=2, kind="nan_logits"),
              dict(site="admit", index=3, kind="dispatch")]
    jplan, tplan = _plans(faults)
    jsched, want = _run("j", "dense", jplan, snapshot_interval=1)
    tsched, got = _run("t", "dense", tplan, snapshot_interval=1)
    assert got == want == _clean("dense")
    assert tsched.stats == {k: jsched.stats[k] for k in tsched.stats}
    assert tsched._step == jsched._step


@pytest.mark.parametrize("seed", range(20))
def test_fault_plan_random_matches_reference(seed):
    kw = dict(n=5, max_index=9, slots=3)
    want = jfaults.FaultPlan.random(seed, **kw)
    got = tfaults.FaultPlan.random(seed, **kw)
    assert [dataclasses.astuple(f) for f in got.faults] == \
        [dataclasses.astuple(f) for f in want.faults]
    assert got.counters == want.counters


def test_fault_validation_matches_reference():
    for bad in (dict(site="prefill", index=0, kind="stall"),
                dict(site="decode", index=0, kind="oom")):
        with pytest.raises(ValueError) as jerr:
            jfaults.Fault(**bad)
        with pytest.raises(ValueError) as terr:
            tfaults.Fault(**bad)
        assert str(terr.value) == str(jerr.value)
    assert tfaults.KINDS == jfaults.KINDS and tfaults.SITES == jfaults.SITES
    assert issubclass(tfaults.CacheCorruption, RuntimeError)
