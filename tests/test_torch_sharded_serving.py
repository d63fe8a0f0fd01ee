"""Sharded serving on the CPU: ``serve.sharded.ShardedEngine`` over gloo,
one world of 4 spawned CPU processes per test function, against the
single-process port ``Engine``.

Each rank runs the same ``Scheduler`` (staggered admission: two requests,
a round, then two more mid-flight) on its engine shard; every case asserts
that every rank's temperature-0 transcripts and ``Scheduler.stats`` equal
the single-process engine's, bitwise, at smoke size in float32:

* qwen2-7b ``w4a4_lut`` on 2x2 (head-sharded: the cache holds n_kv/2
  heads, KV bytes per rank = total / 4) and 1x4 (n_kv % 4 != 0: the
  replicated-attention fallback, KV bytes = total);
* gemma2-2b ``w8a8`` 2x2 (sliding-window rings, tied embedding);
* qwen2-7b with an int8 KV cache on 2x2 and 1x4;
* zamba2-2.7b ``w8a8`` 2x2 (Mamba2 state, the shared attention block);
* a sampled 2x2 run (each data shard its own stream: checked for validity
  and agreement across ranks);
* the paged 2x2 fault differential: NaN in one model rank's cache page, a
  corrupted page table, a failed dispatch and a stall, each recovered from
  the rolling snapshot with the clean transcripts; and a NaN that only the
  cache sweep can see (past every live position) on ONE rank, which every
  rank must detect through the sweep's min-reduce over the model axis and
  recover from once;
* the MoE family: qwen2-moe-a2.7b and mixtral-8x22b on 2x2 and 1x4 (expert
  banks split when the model axis divides E).

Every world runs under ``launch``'s own deadline; a failing rank stops the
world (``test_failing_rank_stops_the_world``).
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.dist.mesh import make_serving_mesh
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from repro_torch.serve.faults import Fault, FaultPlan
from repro_torch.serve.sharded import ShardedEngine, launch

from _torch_threads import one_torch_thread  # noqa: F401

WORLD_S = 90                  # each world's deadline, seconds
MAX_LEN = 32

DENSE_CASES = [
    dict(arch="qwen2-7b", quant="w4a4_lut", mesh="2x2", heads=True),
    dict(arch="qwen2-7b", quant="w4a4_lut", mesh="1x4", heads=False),
    dict(arch="gemma2-2b", quant="w8a8", mesh="2x2", heads=True),
    dict(arch="qwen2-7b", quant="w4a4_lut", mesh="2x2", kv_quant="int8",
         heads=True),
    dict(arch="qwen2-7b", quant="w4a4_lut", mesh="1x4", kv_quant="int8",
         heads=False),
    dict(arch="zamba2-2.7b", quant="w8a8", mesh="2x2", heads=True),
]
MOE_CASES = [
    dict(arch="qwen2-moe-a2.7b", quant="w4a4_lut", mesh="2x2"),
    dict(arch="qwen2-moe-a2.7b", quant="w4a4_lut", mesh="1x4"),
    dict(arch="mixtral-8x22b", quant="w8a8", mesh="2x2"),
    dict(arch="mixtral-8x22b", quant="w8a8", mesh="1x4"),
]
FAULT_KINDS = ("nan_logits", "page_table", "dispatch", "stall")
PAGED = dict(paged=True, page_size=4)


def _cfg(case):
    cfg = configs.get_config(case["arch"], smoke=True, quant=case["quant"])
    return dataclasses.replace(cfg, compute_dtype="float32",
                               kv_quant=case.get("kv_quant", "none"))


def _params(cfg):
    return T.init_params(cfg, seed=0, device="cpu")


def _prompts(cfg, n=4, length=6):
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab, (n, length), generator=g).tolist()


def _drive(eng, cfg, **sched_kw):
    """The reference's staggered drive: two requests, a round, two more."""
    sched = Scheduler(eng, slots=4, chunk=2, **sched_kw)
    reqs = [Request(prompt=p, max_new_tokens=5) for p in _prompts(cfg)]
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.step()
    sched.submit(reqs[2])
    sched.submit(reqs[3])
    while sched.has_work:
        sched.step()
    return sched, [list(r.tokens) for r in reqs]


def _fault_drive(eng, cfg, plan):
    eng.set_fault_plan(plan)
    sched = Scheduler(eng, slots=4, chunk=2, snapshot_interval=1,
                      max_retries=6)
    reqs = [Request(prompt=p, max_new_tokens=6)
            for p in _prompts(cfg, length=5)]
    sched.run(reqs)
    return sched, [(r.finish_reason, list(r.tokens)) for r in reqs]


def _sweep_drive(eng, cfg, poison: bool):
    """Two rounds, then (``poison``) a NaN in layer 0's K at the last
    position of slot 0's row, on this rank only, after the third round's
    snapshot: past every live position, so no logit sees it and only the
    cache sweep can."""
    sched = Scheduler(eng, slots=4, chunk=2, snapshot_interval=1)
    reqs = [Request(prompt=p, max_new_tokens=5) for p in _prompts(cfg)]
    for r in reqs:
        sched.submit(r)
    sched.step()
    sched.step()
    if poison:
        step = eng.step

        def poisoned(cache, *a, **k):
            eng.step = step
            cache[0]["k"][0, MAX_LEN - 1] = float("nan")
            return step(cache, *a, **k)

        eng.step = poisoned
    while sched.has_work:
        sched.step()
    return [list(r.tokens) for r in reqs], sched.stats["recoveries"]


def _shard_report(eng, sched, cfg):
    c0 = next(c for c in sched.cache if "k" in c or "shared_k" in c)
    k = c0["k"] if "k" in c0 else c0["shared_k"]
    # the placement hooks: this rank's rows of a slot vector, a cache shard
    # of this rank's layout back on its device (a full cache is refused)
    lo = eng.mesh.data_index * (4 // eng.n_data)
    assert torch.equal(eng.place_slot_state(torch.arange(4)),
                       torch.arange(lo, lo + 4 // eng.n_data))
    placed = eng.place_cache([{n: t.clone() for n, t in c.items()}
                              for c in sched.cache])
    assert all(torch.equal(a[n], b[n]) for a, b in zip(placed, sched.cache)
               for n in a)
    if eng.n_data > 1:
        wide = [{n: torch.cat([t, t]) for n, t in c.items()}
                for c in sched.cache]
        with pytest.raises(ValueError, match="shard"):
            eng.place_cache(wide)
    return dict(head_sharded=eng.head_sharded,
                experts_sharded=eng.experts_sharded,
                tp_leaves=eng.n_tp_leaves, cache_heads=k.shape[-2],
                kv_bytes=eng.kv_cache_bytes(4),
                kv_total=Engine.kv_cache_bytes(eng, 4))


def _serve_cases(mesh_2x2, cases):
    """Every case on a mesh of its own shape over the same four ranks
    (``make_serving_mesh`` makes each its groups)."""
    meshes = {"2x2": mesh_2x2}
    out = []
    for case in cases:
        cfg = _cfg(case)
        if case["mesh"] not in meshes:
            meshes[case["mesh"]] = make_serving_mesh(case["mesh"],
                                                     device="cpu")
        eng = ShardedEngine(cfg, _params(cfg),
                            ServeConfig(max_len=MAX_LEN, quant=case["quant"]),
                            mesh=meshes[case["mesh"]])
        sched, toks = _drive(eng, cfg)
        out.append(dict(toks=toks, stats=sched.stats,
                        **_shard_report(eng, sched, cfg)))
    return out


def _dense_world(mesh_2x2, cases):
    """One rank of the dense world: the cases, the sampled run, the sweep
    case and the paged fault differential."""
    torch.set_num_threads(1)
    results = _serve_cases(mesh_2x2, cases)
    cfg = _cfg(dict(arch="qwen2-7b", quant="w4a4_lut"))
    params = _params(cfg)
    # sampled: each data shard draws its own stream (fold_in_data)
    eng = ShardedEngine(cfg, params, ServeConfig(max_len=MAX_LEN,
                                                 quant="w4a4_lut"),
                        mesh=mesh_2x2)
    sched = Scheduler(eng, slots=4, chunk=2)
    reqs = [Request(prompt=[1 + i, 2, 3, 4], max_new_tokens=4,
                    temperature=0.9, top_k=8) for i in range(4)]
    sched.run(reqs)
    sampled = dict(toks=[list(r.tokens) for r in reqs],
                   free=all(s is None for s in sched.slots)
                   and not sched.queue)
    # the sweep's verdict is min-reduced over the model axis: rank (0, 0)
    # alone holds the NaN, and every rank recovers
    eng = ShardedEngine(cfg, params, ServeConfig(max_len=MAX_LEN,
                                                 quant="w4a4_lut"),
                        mesh=mesh_2x2)
    sweep = _sweep_drive(eng, cfg, poison=mesh_2x2.rank == 0)
    faults = {"sweep": sweep}
    for kind in (None,) + FAULT_KINDS:
        eng = ShardedEngine(cfg, params, ServeConfig(
            max_len=MAX_LEN, quant="w4a4_lut", **PAGED), mesh=mesh_2x2)
        plan = None if kind is None else FaultPlan(
            [Fault(site="decode", index=1, kind=kind, duration=0.001)])
        sched, got = _fault_drive(eng, cfg, plan)
        faults[kind] = dict(got=got, recoveries=sched.stats["recoveries"],
                            pending=[] if plan is None else plan.pending)
    return results, sampled, faults


def _moe_world(mesh_2x2, cases):
    torch.set_num_threads(1)
    return _serve_cases(mesh_2x2, cases)


def _single_device(case):
    cfg = _cfg(case)
    eng = Engine(cfg, _params(cfg), ServeConfig(max_len=MAX_LEN,
                                                quant=case["quant"]),
                 device="cpu")
    sched, toks = _drive(eng, cfg)
    return toks, sched.stats


def _check_case(case, ranks, want):
    toks, stats = want
    cfg = _cfg(case)
    n_data, n_model = map(int, case["mesh"].split("x"))
    for rank, got in enumerate(ranks):
        where = (case, rank)
        assert got["toks"] == toks, where
        assert got["stats"] == stats, where
        assert got["tp_leaves"] > 0, where
        if "heads" in case:
            assert got["head_sharded"] == case["heads"], where
        heads = cfg.n_kv // n_model if got["head_sharded"] else cfg.n_kv
        assert got["cache_heads"] == heads, where
        shrink = n_data * (n_model if got["head_sharded"] else 1)
        assert got["kv_bytes"] == got["kv_total"] // shrink, where
        if cfg.moe is not None:
            assert got["experts_sharded"] == (
                cfg.moe.n_experts % n_model == 0), where


def test_sharded_dense_families_equal_single_device():
    wants = [_single_device(c) for c in DENSE_CASES]
    cfg = _cfg(dict(arch="qwen2-7b", quant="w4a4_lut"))
    clean = Engine(cfg, _params(cfg), ServeConfig(
        max_len=MAX_LEN, quant="w4a4_lut", **PAGED), device="cpu")
    _, fault_want = _fault_drive(clean, cfg, None)
    sweep_want, _ = _sweep_drive(Engine(cfg, _params(cfg), ServeConfig(
        max_len=MAX_LEN, quant="w4a4_lut"), device="cpu"), cfg, False)
    ranks = launch(_dense_world, "2x2", "gloo", timeout_s=WORLD_S,
                   args=(DENSE_CASES,), device="cpu")
    for i, case in enumerate(DENSE_CASES):
        _check_case(case, [r[0][i] for r in ranks], wants[i])
    sampled = [r[1] for r in ranks]
    for s in sampled:
        assert s == sampled[0]
        assert s["free"]
        assert all(len(t) == 4 and all(0 <= x < cfg.vocab for x in t)
                   for t in s["toks"])
    for rank in ranks:
        faults = rank[2]
        assert faults["sweep"] == (sweep_want, 1)
        assert faults[None]["got"] == fault_want
        for kind in FAULT_KINDS:
            assert faults[kind]["got"] == fault_want, kind
            assert not faults[kind]["pending"], kind
            if kind != "stall":
                assert faults[kind]["recoveries"] >= 1, kind
    assert ranks[0][2] == ranks[1][2] == ranks[2][2] == ranks[3][2]


def test_sharded_moe_equal_single_device():
    wants = [_single_device(c) for c in MOE_CASES]
    ranks = launch(_moe_world, "2x2", "gloo", timeout_s=WORLD_S,
                   args=(MOE_CASES,), device="cpu")
    for i, case in enumerate(MOE_CASES):
        _check_case(case, [r[i] for r in ranks], wants[i])


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    import torch.distributed as dist
    dist.barrier()                # would wait forever for rank 1


def test_failing_rank_stops_the_world():
    # rank 0 fails too once its peer is gone, but rank 1 has exited first
    with pytest.raises(RuntimeError, match=r"rank 1 \(code 1\).* of 1x2"):
        launch(_failing_rank, "1x2", "gloo", timeout_s=60, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        launch(_failing_rank, "1x2", "mpi", timeout_s=60, device="cpu")
