"""Randomized-traffic differential on the port alone (the counterpart of
the reference's ``tests/test_traffic_fuzz.py``): ``serve.sharded.
ShardedEngine`` against the single-device ``Engine`` under the same
Scheduler, on the same seeded request stream and submit/step interleave.

Each stream draws prompts of 1-8 tokens, decode budgets including the
legal 0, EOS ids that may sit inside the prompt, mixed per-request top-k /
top-p at temperature 0 (greedy overrides the filters, so transcripts stay
deterministic) and a staggered plan of submissions before each step.  At
temperature 0 every transcript and finish reason must match token for
token: the engines differ only in how the math is laid out (head-sharded
attention, expert-sharded MoE, data-parallel slot pools).

One gloo world of 4 spawned CPU processes (a module fixture) serves every
sharded stream: qwen2-7b ``w4a4_lut`` on 2x2 (with and without a 4-token
prefill chunk) and 1x4, two streams a mesh, and qwen2-moe-a2.7b on 2x2
(MoE admits monolithically on both engines).  An engine forced to
monolithic admission serves a stream as the chunked one does, dense and
paged.
"""
import dataclasses
import random

import pytest
import torch

from repro_torch import configs
from repro_torch.dist.mesh import make_serving_mesh
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from repro_torch.serve.sharded import ShardedEngine, launch

from _torch_threads import one_torch_thread  # noqa: F401

WORLD_S = 150
MAX_LEN, SLOTS, CHUNK = 32, 4, 3
# (arch, mesh, seed, prefill_chunk)
STREAMS = [("qwen2-7b", "2x2", 100, 4), ("qwen2-7b", "2x2", 101, None),
           ("qwen2-7b", "1x4", 200, None), ("qwen2-7b", "1x4", 201, 4),
           ("qwen2-moe-a2.7b", "2x2", 300, None)]


class MonoEngine(Engine):
    """Every admission through ``admit_monolithic`` (the batched prefill),
    whatever the model."""
    requires_monolithic_admission = True


def make_stream(vocab: int, seed: int):
    rng = random.Random(seed)
    n = rng.randint(6, 10)
    reqs = []
    for _ in range(n):
        L = rng.randint(1, 8)
        prompt = [rng.randrange(vocab) for _ in range(L)]
        budget = rng.choice([0, 0, 1, 2, 3, 5, 8])
        eos = None
        r = rng.random()
        if r < 0.3:
            eos = rng.randrange(vocab)           # may fire mid-decode
        elif r < 0.5:
            eos = prompt[rng.randrange(L)]       # inside the prompt
        reqs.append(dict(prompt=prompt, max_new_tokens=budget, eos_id=eos,
                         temperature=0.0,
                         top_k=rng.choice([None, 0, 3, 8]),
                         top_p=rng.choice([None, 1.0, 0.7])))
    plan = [rng.randint(0, 3) for _ in range(4 * n)]
    return reqs, plan


def drive(engine, specs, plan):
    sched = Scheduler(engine, slots=SLOTS, chunk=CHUNK)
    reqs = [Request(**s) for s in specs]
    i = p = 0
    while i < len(reqs) or sched.has_work:
        take = plan[p % len(plan)]
        p += 1
        for _ in range(min(take, len(reqs) - i)):
            sched.submit(reqs[i])
            i += 1
        if not sched.has_work and i < len(reqs):
            sched.submit(reqs[i])
            i += 1
        sched.step()
    assert all(s is None for s in sched.slots) and not sched.queue
    if engine.paged:
        assert engine.pool.allocated_pages == 0
    return [(list(r.tokens), r.finish_reason) for r in reqs]


def _cfg(arch):
    return dataclasses.replace(
        configs.get_config(arch, smoke=True, quant="w4a4_lut"),
        compute_dtype="float32")


def _scfg(prefill_chunk, **kw):
    return ServeConfig(max_len=MAX_LEN, quant="w4a4_lut",
                       prefill_chunk=prefill_chunk, **kw)


def _world(mesh_2x2):
    torch.set_num_threads(1)
    meshes = {"2x2": mesh_2x2}
    params, out = {}, []
    for arch, spec, seed, chunk in STREAMS:
        if spec not in meshes:
            meshes[spec] = make_serving_mesh(spec, device="cpu")
        cfg = _cfg(arch)
        if arch not in params:
            params[arch] = T.init_params(cfg, seed=0, device="cpu")
        eng = ShardedEngine(cfg, params[arch], _scfg(chunk),
                            mesh=meshes[spec])
        out.append(drive(eng, *make_stream(cfg.vocab, seed)))
    return out


@pytest.fixture(scope="module")
def sharded_runs():
    return launch(_world, "2x2", "gloo", timeout_s=WORLD_S, device="cpu")


_PARAMS = {}


def _single(arch, seed, chunk, engine=Engine, **kw):
    cfg = _cfg(arch)
    if arch not in _PARAMS:
        _PARAMS[arch] = T.init_params(cfg, seed=0, device="cpu")
    eng = engine(cfg, _PARAMS[arch], _scfg(chunk, **kw), device="cpu")
    return drive(eng, *make_stream(cfg.vocab, seed))


@pytest.mark.parametrize("i", range(len(STREAMS)),
                         ids=[f"{a}-{m}-{s}" for a, m, s, _ in STREAMS])
def test_sharded_stream_equals_single_device(sharded_runs, i):
    arch, _, seed, chunk = STREAMS[i]
    want = _single(arch, seed, chunk)
    assert any(t for t, _ in want)
    for rank, got in enumerate(sharded_runs):
        assert got[i] == want, (STREAMS[i], rank)


@pytest.mark.parametrize("paged", [False, True])
def test_monolithic_admission_equals_chunked(paged):
    kw = dict(paged=True, page_size=4) if paged else {}
    want = _single("qwen2-7b", 100, 4, **kw)
    assert _single("qwen2-7b", 100, 4, engine=MonoEngine, **kw) == want
