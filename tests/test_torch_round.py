"""The serving round with its chunk lane as device vectors and its results
packed into one tensor (``Engine.step``, ``Scheduler.step``), against the
reference's ``Engine.step`` and ``Scheduler`` on the same converted
weights, at qwen2-7b-smoke (2 layers, d_model 64) on the ``ref`` backend.

The traffic (7 requests through 2 slots, a 4-token chunk lane, 2 decode
tokens a round) makes chunk lanes of every length from 1 to 4 real
entries, a prompt's last token in the middle of a lane, and requests whose
whole budget is the first token.  Transcripts are compared exactly.
"""
import dataclasses

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
from repro_torch.models import transformer as TT
from repro_torch.serve import graphs
from repro_torch.serve.engine import ChunkLane, pack_round, unpack_round

from _torch_threads import one_torch_thread  # noqa: F401

MAX_LEN = 40
CHUNK_LANE = 4
LENS = [6, 5, 3, 3, 1, 1, 1]
BUDGETS = [1, 5, 4, 5, 3, 4, 5]


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
    """The reference's seed-0 float tree and its conversion to the port."""
    if not _FLOAT:
        import jax
        jcfg, tcfg = _cfgs("w4a4_lut")
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _FLOAT["j"] = jp
        _FLOAT["t"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      tcfg, device="cpu")
    return _FLOAT["j"], _FLOAT["t"]


def _requests(make, vocab):
    rng = np.random.default_rng(7)
    return [make(prompt=rng.integers(0, vocab, L).tolist(),
                 max_new_tokens=b) for L, b in zip(LENS, BUDGETS)]


def _engine(params, mode, **scfg):
    """An engine on ``params`` under ``mode``'s port config."""
    _, tcfg = _cfgs(mode)
    return tserve.make_engine(params, tcfg, tserve.ServeConfig(
        max_len=MAX_LEN, prefill_chunk=CHUNK_LANE, **scfg), device="cpu")


def _engines(params, quant, spec):
    """(target engine, serving engine): the spec engine serves the target
    engine's codes."""
    eng = _engine(params, quant, quant=quant)
    if spec:
        return eng, _engine(eng.params, quant, spec_decode=True)
    return eng, eng


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)
    ops.set_variant(None)


def _record_lanes(eng) -> list:
    """Wrap ``eng.step`` to record each round's lane (None or its first /
    budget_one flags)."""
    seen, step = [], eng.step

    def rec(cache, lane, *a, **k):
        seen.append(None if lane is None else
                    (lane.first.tolist(), lane.budget_one.tolist()))
        return step(cache, lane, *a, **k)

    eng.step = rec
    return seen


_JAX_RUNS = {}


def _jax_transcripts(quant):
    if quant not in _JAX_RUNS:
        jcfg, _ = _cfgs(quant)
        jp, _ = _float_params()
        eng = jserve.make_engine(jp, jcfg, jserve.ServeConfig(
            quant=quant, max_len=MAX_LEN, prefill_chunk=CHUNK_LANE))
        reqs = _requests(jserve.Request, jcfg.vocab)
        jserve.Scheduler(eng, slots=2, chunk=2).run(reqs)
        _JAX_RUNS[quant] = [(r.tokens, r.finish_reason) for r in reqs]
    return _JAX_RUNS[quant]


@pytest.mark.parametrize("quant,spec", [("w4a4_lut", False),
                                        ("w4a4_tmac", False),
                                        ("w4a4_tmac", True)])
def test_device_lane_transcripts_match_reference(quant, spec):
    """Every lane length from 1 to 4, a first token mid-lane, budget-one
    requests: the port's Scheduler serves the reference's transcripts."""
    want = _jax_transcripts(quant)
    _, tp = _float_params()
    _, eng = _engines(tp, quant, spec)
    seen = _record_lanes(eng)
    _, tcfg = _cfgs(quant)
    reqs = _requests(tserve.Request, tcfg.vocab)
    tserve.Scheduler(eng, slots=2, chunk=2).run(reqs)
    assert [(r.tokens, r.finish_reason) for r in reqs] == want
    lanes = [s for s in seen if s is not None]
    sizes = {len(first) for first, _ in lanes}
    # speculative rounds retire rows at other rounds: not every size shows
    assert sizes == set(range(1, CHUNK_LANE + 1)) if not spec else \
        len(sizes) > 2
    assert any(any(first[:-1]) for first, _ in lanes)     # fires mid-lane
    assert any(any(b1) for _, b1 in lanes)


# forwards by lane of this traffic under the per-entry host loop that the
# device lane replaces (the port's seed-0 weights; no EOS): the chunk lane
# runs the 20 real prompt tokens, never a pad
LANE_STEPS = {
    False: ({"chunk": 20, "decode": 16, "draft": 0, "verify": 0}, 36, 8),
    True: ({"chunk": 20, "decode": 0, "draft": 42, "verify": 14}, 62, 14)}


@pytest.mark.parametrize("spec", [False, True])
def test_lane_steps_unchanged(spec):
    quant = "w4a4_tmac" if spec else "w4a4_lut"
    _, tcfg = _cfgs(quant)
    params = TT.init_params(tcfg, seed=0, device="cpu")
    _, eng = _engines(params, quant, spec)
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    sched.run(_requests(tserve.Request, tcfg.vocab))
    lanes, steps, rounds = LANE_STEPS[spec]
    assert eng.lane_steps == lanes
    assert eng.decode_steps == steps
    assert sched.stats["rounds"] == rounds
    assert sched.stats["admitted_tokens"] == sum(LENS)
    assert sched.stats["prefill_tokens"] == CHUNK_LANE * 7   # 7 lanes


READS = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
         "__float__", "__index__")


@pytest.fixture
def device_reads(monkeypatch):
    """Every call of a tensor method that reads values to the host."""
    calls = []
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return calls


@pytest.mark.parametrize("spec", [False, True])
def test_one_device_read_per_round(device_reads, spec):
    """Admissions, parks, EOS pushes, frees and the round itself: each
    Scheduler round reads the device once (the packed result)."""
    quant = "w4a4_tmac" if spec else "w4a4_lut"
    _, tcfg = _cfgs(quant)
    params = TT.init_params(tcfg, seed=0, device="cpu")
    _, eng = _engines(params, quant, spec)
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    reqs = _requests(tserve.Request, tcfg.vocab)
    reqs[1].eos_id = 7
    for r in reqs:
        sched.submit(r)
    per_round = []
    while sched.has_work:
        before = list(device_reads)
        sched.step()
        per_round.append(device_reads[len(before):])
    assert per_round == [["tolist"]] * len(per_round)
    assert len(per_round) == sched.stats["rounds"] > 1


def test_scheduler_state_updated_in_place():
    _, tcfg = _cfgs("w4a4_lut")
    params = TT.init_params(tcfg, seed=0, device="cpu")
    _, eng = _engines(params, "w4a4_lut", False)
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    state = [sched.tok, sched.pos, sched.done, sched.eos]
    ptrs = [t.data_ptr() for t in state]
    sched.run(_requests(tserve.Request, tcfg.vocab))
    after = [sched.tok, sched.pos, sched.done, sched.eos]
    assert all(a is b for a, b in zip(after, state))
    assert [t.data_ptr() for t in after] == ptrs
    assert sched.pos.tolist() == [-1, -1] and sched.done.all()


def _jax_step(jeng, jcache, entries, tok, pos, done, eos, chunk):
    B = tok.shape[0]
    if entries is not None:
        pad = CHUNK_LANE - len(entries["slot"])
        entries = {k: list(v) + [-1 if k == "slot" else 0] * pad
                   for k, v in entries.items()}
    out = jeng.step(jcache, entries, jnp.asarray(tok), jnp.asarray(pos),
                    jnp.asarray(done), jnp.asarray(eos),
                    jnp.zeros((B,), jnp.float32), jnp.zeros((B,), jnp.int32),
                    jnp.ones((B,), jnp.float32), 0, chunk, greedy=True)
    return out[0], [np.asarray(x) for x in out[1:]]


def _lane(entries):
    if entries is None:
        return None
    i32 = torch.int32
    return ChunkLane(*(torch.tensor(entries[k], dtype=i32) for k in
                       ("slot", "tok", "pos")),
                     *(torch.tensor(entries[k], dtype=torch.bool) for k in
                       ("first", "budget_one")))


def test_packed_round_unpacks_to_reference_tuple():
    """Three rounds on the same state through both engines: a full lane
    (one prompt completes mid-lane with a budget of one token, another
    parks), a one-entry lane, a decode-only round.  The port's packed
    result unpacks to the reference's (tok0, done0, tokens, dones, ok,
    n_valid), and the new (tok, pos, done) are the reference's."""
    jcfg, tcfg = _cfgs("w4a4_lut")
    jp, tp = _float_params()
    jeng = jserve.make_engine(jp, jcfg, jserve.ServeConfig(
        quant="w4a4_lut", max_len=MAX_LEN, prefill_chunk=CHUNK_LANE))
    eng = _engine(tp, "w4a4_lut", quant="w4a4_lut")
    a, b, c, d, e = np.random.default_rng(2).integers(0, tcfg.vocab, 5)
    lanes = [{"slot": [0, 0, 1, 1], "tok": [a, b, c, d], "pos": [0, 1, 0, 1],
              "first": [0, 1, 0, 0], "budget_one": [0, 1, 0, 0]},
             {"slot": [1], "tok": [e], "pos": [2], "first": [1],
              "budget_one": [0]},
             None]
    tok = np.array([a, c, 0], np.int32)        # fresh rows parked
    pos = np.array([0, 0, -1], np.int32)
    done = np.ones(3, bool)
    eos = np.array([-1, 5, -1], np.int32)
    jcache, cache = jeng.init_cache(3), eng.init_cache(3)
    jstate = tstate = (tok, pos, done)
    for entries in lanes:
        jcache, jout = _jax_step(jeng, jcache, entries, *jstate, eos, 2)
        cache, *new, packed = eng.step(
            cache, _lane(entries), *(torch.from_numpy(x) for x in tstate),
            torch.from_numpy(eos), 2)
        assert packed.dtype == torch.int32 and packed.shape == (3, 8)
        for got, want in zip([*new, *unpack_round(packed)], jout):
            np.testing.assert_array_equal(got.numpy(), want)
        jstate = tuple(jout[:3])
        tstate = tuple(x.numpy() for x in new)


def test_pack_round_inverts():
    g = torch.Generator().manual_seed(0)
    B, W = 3, 4
    parts = (torch.randint(0, 99, (B,), generator=g, dtype=torch.int32),
             torch.rand(B, generator=g) > 0.5,
             torch.randint(0, 99, (B, W), generator=g, dtype=torch.int32),
             torch.rand(B, W, generator=g) > 0.5,
             torch.rand(B, generator=g) > 0.5,
             torch.randint(0, W + 1, (B,), generator=g, dtype=torch.int32))
    packed = pack_round(*parts)
    assert packed.dtype == torch.int32 and packed.shape == (B, 2 * W + 4)
    for got, want in zip(unpack_round(packed), parts):
        assert torch.equal(got, want)
    for got, want in zip(unpack_round(packed.numpy()), parts):
        np.testing.assert_array_equal(got, want.numpy())


def test_rounds_run_eagerly_on_the_cpu():
    """No graph on the CPU: every round runs op by op, and the private
    eager switch gives the same bits."""
    _, tcfg = _cfgs("w4a4_lut")
    params = TT.init_params(tcfg, seed=0, device="cpu")
    _, eng = _engines(params, "w4a4_lut", False)
    assert not graphs.applies(eng.device)
    tserve.Scheduler(eng, slots=2, chunk=2).run(
        _requests(tserve.Request, tcfg.vocab))
    assert eng.graphs.rounds == {} and eng.graphs.replays == 0
    caches = [eng.init_cache(2), eng.init_cache(2)]
    state = (torch.tensor([3, 4], dtype=torch.int32),
             torch.tensor([0, 5], dtype=torch.int32),
             torch.tensor([False, True]),
             torch.tensor([-1, -1], dtype=torch.int32))
    outs = [eng.step(c, None, *state, 3, _eager=eager)
            for c, eager in zip(caches, (False, True))]
    for x, y in zip(outs[0][1:], outs[1][1:]):
        assert torch.equal(x, y)
    for x, y in zip(*caches):
        assert torch.equal(x["k"], y["k"]) and torch.equal(x["v"], y["v"])


def test_leaf_widths_cover_every_projection():
    """The capture stream's workspaces are reserved at these widths."""
    _, tcfg = _cfgs("w4a4_lut")
    params = TT.init_params(tcfg, seed=0, device="cpu")
    eng = _engine(params, "w4a4_lut", quant="w4a4_lut")
    want = {tcfg.n_heads * tcfg.head_dim, tcfg.n_kv * tcfg.head_dim,
            tcfg.d_model, tcfg.d_ff, tcfg.vocab}
    assert graphs._leaf_widths(eng.params) == want
    assert graphs._leaf_widths(params) == want
