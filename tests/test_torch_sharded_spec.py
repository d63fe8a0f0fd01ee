"""The rest of sharded serving on the CPU: speculative rounds, split-head
attention and ``Scheduler.save`` / ``load`` on ``serve.sharded.
ShardedEngine``, in gloo worlds of 4 spawned CPU processes, against the
single-process port ``Engine``, bitwise, at smoke size in float32.

* speculative ``w4a4_tmac`` (``draft_k=3``) on 2x2 dense, 2x2 paged and
  1x4 paged against the single-process NON-speculative scheduler on the
  same codes, with ``spec_rounds > 0`` (the reference's
  ``tests/test_specdec.py`` sharded differential): the drafter's
  row-parallel leaves contract their K slice of the top planes and
  all-reduce exact int32 sums, so its drafts are the single engine's;
* split-head qwen2-7b ``w4a4_lut`` on 2x2: the float 3D leaves split whole
  heads, the cache holds n_kv / 2 heads, KV bytes a rank are the total /
  4, transcripts and ``Scheduler.stats`` equal;
* save after two rounds on 2x2, dense and paged (every rank calls it,
  rank 0 writes), then a load in a SECOND world: transcripts and stats
  equal the uninterrupted run's on every rank; a single process's dense
  checkpoint loads into that world too, and the 2x2 dense checkpoint loads
  into the single-process ``Engine`` (the checkpoint holds the single
  engine's layout).
"""
import dataclasses

import torch

from repro_torch import configs
from repro_torch.dist.mesh import make_serving_mesh
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from repro_torch.serve.sharded import ShardedEngine, launch

from _torch_threads import one_torch_thread  # noqa: F401

WORLD_S = 120                 # each world's deadline, seconds
MAX_LEN = 32
PAGED = dict(paged=True, page_size=4)
SPEC = dict(spec_decode=True, draft_k=3)
SPEC_CASES = [("2x2", {}), ("2x2", PAGED), ("1x4", PAGED)]
SAVE_CASES = [("dense", {}), ("paged", PAGED)]


def _cfg(quant, **over):
    cfg = configs.get_config("qwen2-7b", smoke=True, quant=quant)
    return dataclasses.replace(cfg, compute_dtype="float32", **over)


def _params(cfg):
    return T.init_params(cfg, seed=0, device="cpu")


def _reqs(cfg, budget=7):
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (4, 6), generator=g).tolist()
    return [Request(prompt=p, max_new_tokens=budget) for p in prompts]


def _drain(sched, max_rounds=200):
    rounds = 0
    while sched.has_work:
        sched.step()
        rounds += 1
        assert rounds <= max_rounds
    sched.check_drained()


def _staggered(sched, reqs, rounds=None):
    """Two requests, a round, the other two; then ``rounds`` more rounds
    (None: to the end)."""
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    if rounds is None:
        _drain(sched)
    else:
        for _ in range(rounds):
            sched.step()
        assert sched.has_work                  # genuinely mid-stream


def _finished(sched):
    """Every request's (prompt, tokens, reason), in prompt order: a loaded
    Scheduler's requests are new objects."""
    return sorted((tuple(r.prompt), tuple(r.tokens), r.finish_reason)
                  for r in sched.finished)


def _engine(mesh, cfg, params, quant, **kw):
    scfg = ServeConfig(max_len=MAX_LEN, quant=quant, **kw)
    if mesh is None:
        return Engine(cfg, params, scfg, device="cpu")
    return ShardedEngine(cfg, params, scfg, mesh=mesh)


def _save_run(mesh, cfg, params, kw, ckpt):
    """Serve two rounds, save, serve to the end: the uninterrupted run."""
    sched = Scheduler(_engine(mesh, cfg, params, "w4a4_lut", **kw), slots=4,
                      chunk=2)
    _staggered(sched, _reqs(cfg), rounds=1)
    sched.save(ckpt)
    _drain(sched)
    return _finished(sched), sched.stats


def _load_run(mesh, cfg, params, kw, ckpt):
    sched = Scheduler(_engine(mesh, cfg, params, "w4a4_lut", **kw), slots=4,
                      chunk=2)
    sched.load(ckpt)
    _drain(sched)
    return _finished(sched), sched.stats


def _spec_world(mesh_2x2):
    torch.set_num_threads(1)
    cfg = _cfg("w4a4_tmac")
    params = _params(cfg)
    meshes = {"2x2": mesh_2x2}
    out = []
    for spec, kw in SPEC_CASES:
        if spec not in meshes:
            meshes[spec] = make_serving_mesh(spec, device="cpu")
        sched = Scheduler(_engine(meshes[spec], cfg, params, "w4a4_tmac",
                                  **SPEC, **kw), slots=4, chunk=2)
        reqs = _reqs(cfg)
        for r in reqs:
            sched.submit(r)
        _drain(sched)
        out.append(dict(toks=[list(r.tokens) for r in reqs],
                        stats=sched.stats))
    return out


def test_sharded_spec_equals_single_non_spec():
    cfg = _cfg("w4a4_tmac")
    params = _params(cfg)
    runs = {}
    for name, kw in (("plain", {}), ("spec", SPEC), ("paged", {**SPEC,
                                                            **PAGED})):
        sched = Scheduler(_engine(None, cfg, params, "w4a4_tmac", **kw),
                          slots=4, chunk=2)
        reqs = _reqs(cfg)
        for r in reqs:
            sched.submit(r)
        _drain(sched)
        runs[name] = [list(r.tokens) for r in reqs], sched.stats
    want = runs["plain"][0]
    assert runs["spec"][0] == runs["paged"][0] == want
    ranks = launch(_spec_world, "2x2", "gloo", timeout_s=WORLD_S,
                   device="cpu")
    for rank, got in enumerate(ranks):
        for (spec, kw), case in zip(SPEC_CASES, got):
            where = (rank, spec, kw)
            assert case["toks"] == want, where
            assert case["stats"]["spec_rounds"] > 0, where
            # the same drafts accepted as on one device
            assert case["stats"] == runs["paged" if kw else "spec"][1], where


def _split_world(mesh_2x2):
    torch.set_num_threads(1)
    cfg = _cfg("w4a4_lut", split_head_params=True)
    eng = _engine(mesh_2x2, cfg, _params(cfg), "w4a4_lut")
    sched = Scheduler(eng, slots=4, chunk=2)
    reqs = _reqs(cfg)
    _staggered(sched, reqs)
    return dict(toks=[list(r.tokens) for r in reqs], stats=sched.stats,
                head_sharded=eng.head_sharded,
                heads=sched.cache[0]["k"].shape[-2],
                wq3=tuple(eng.params["blocks"][0]["attn"]["wq3"]["w"].shape),
                kv=eng.kv_cache_bytes(4),
                kv_total=Engine.kv_cache_bytes(eng, 4))


def test_sharded_split_heads_equal_single_device():
    cfg = _cfg("w4a4_lut", split_head_params=True)
    single = Scheduler(_engine(None, cfg, _params(cfg), "w4a4_lut"),
                       slots=4, chunk=2)
    reqs = _reqs(cfg)
    _staggered(single, reqs)
    ranks = launch(_split_world, "2x2", "gloo", timeout_s=WORLD_S,
                   device="cpu")
    for rank, got in enumerate(ranks):
        assert got["toks"] == [list(r.tokens) for r in reqs], rank
        assert got["stats"] == single.stats, rank
        assert got["head_sharded"] and got["heads"] == cfg.n_kv // 2
        assert got["wq3"] == (cfg.d_model, cfg.n_heads // 2, cfg.head_dim)
        assert got["kv"] * 4 == got["kv_total"]


def _save_world(mesh_2x2, root):
    torch.set_num_threads(1)
    cfg = _cfg("w4a4_lut")
    params = _params(cfg)
    return {name: _save_run(mesh_2x2, cfg, params, kw, f"{root}/{name}")
            for name, kw in SAVE_CASES}


def _load_world(mesh_2x2, root):
    torch.set_num_threads(1)
    cfg = _cfg("w4a4_lut")
    params = _params(cfg)
    return {name: _load_run(mesh_2x2, cfg, params, kw, f"{root}/{name}")
            for name, kw in SAVE_CASES + [("single", {})]}


def test_sharded_save_load_across_worlds(tmp_path):
    root = str(tmp_path)
    cfg = _cfg("w4a4_lut")
    params = _params(cfg)
    want = {name: _save_run(None, cfg, params, kw, f"{root}/one_{name}")
            for name, kw in SAVE_CASES}
    # a single process's dense checkpoint, for the mesh to load
    _save_run(None, cfg, params, {}, f"{root}/single")
    ranks = launch(_save_world, "2x2", "gloo", timeout_s=WORLD_S,
                   args=(root,), device="cpu")
    for rank, got in enumerate(ranks):
        assert got == want, rank
    # the mesh's dense checkpoint holds the single engine's layout
    assert _load_run(None, cfg, params, {}, f"{root}/dense") == want["dense"]
    loaded = launch(_load_world, "2x2", "gloo", timeout_s=WORLD_S,
                    args=(root,), device="cpu")
    for rank, got in enumerate(loaded):
        for name, _ in SAVE_CASES:
            assert got[name] == want[name], (rank, name)
        assert got["single"] == want["dense"], rank
