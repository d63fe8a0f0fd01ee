"""Port vs reference, sampling at temperature > 0: ``sample_logits`` (per-row
temperature / top-k / top-p over the port's threefry stream), the key
schedule of ``Engine.step`` (chunk entry ``i`` draws ``step0 + i``, decode
and draft step ``j`` draw ``step0 + C + j``, verify column ``i`` draws
``step0 + C + draft_k + i``, ``C`` the engine's ``prefill_chunk`` on a
round with a chunk lane, else 0), ``generate`` and the ``Scheduler``'s
per-slot sampling vectors and global draw counter, at qwen2-7b-smoke on the
``ref`` backend.

Where the draws are exact.  The random bits and uniforms equal
``jax.random``'s (``tests/test_torch_prng.py``).  Two places are float:
the Gumbel noise passes through ATen's ``log`` (XLA's differs by an ulp,
|d| <= 1e-6), and the top-p cut takes a softmax and a cumsum whose sums
ATen and XLA order differently (a row's cumulative mass differs by up to
~1e-6 here).  So a token may differ only where two candidates' perturbed
scores lie within ``GUMBEL_GAP`` of each other, or where a sorted prefix's
mass lies within ``TOP_P_MARGIN`` of ``top_p``; the unit tests below
assert every difference by that measured margin.  The serving-level
transcripts (``generate``, the ``Scheduler`` plain and speculative) are
asserted equal outright: none of their draws lies that close.
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
from repro_torch.core import prng
from repro_torch.kernels.lutmul import ops
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ChunkLane, unpack_round

from _torch_threads import one_torch_thread  # noqa: F401

MAX_LEN = 40
CHUNK_LANE = 4
TOP_P_MARGIN = 1e-4
GUMBEL_GAP = 1e-5
V = 96


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)
    ops.set_variant(None)


def _logits(seed, B=8, scale=3.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, V))).astype(np.float32)


def _both(logits, seed, temperature, top_k, top_p):
    """(reference tokens, port tokens) for one call; vectors go in as [B]
    arrays, scalars as Python numbers."""
    def j(x, dt):
        return jnp.asarray(x, dt) if isinstance(x, np.ndarray) else x

    def t(x, dt):
        return torch.from_numpy(x).to(dt) if isinstance(x, np.ndarray) else x

    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = jserve.sample_logits(jnp.asarray(logits), jk,
                                j(temperature, jnp.float32),
                                j(top_k, jnp.int32), j(top_p, jnp.float32))
    k = prng.fold_in(prng.prng_key(seed), 3)
    got = tserve.sample_logits(torch.from_numpy(logits), k,
                               t(temperature, torch.float32),
                               t(top_k, torch.int32), t(top_p, torch.float32))
    assert got.dtype == torch.int32
    return np.asarray(want), got.numpy()


def _margins(logits, seed, temperature, top_k, top_p, row):
    """The two measured margins of ``row`` under the reference's own
    arithmetic: how near a sorted prefix's mass comes to ``top_p`` (inf
    when top-p is off), and the gap between the two best perturbed
    scores."""
    B = logits.shape[0]
    temp = np.broadcast_to(np.asarray(temperature, np.float32), (B,))[row]
    tk = int(np.broadcast_to(np.asarray(top_k), (B,))[row])
    tp = float(np.broadcast_to(np.asarray(top_p, np.float32), (B,))[row])
    x = logits[row].astype(np.float64)
    t = max(float(temp), 1e-6)
    s = np.sort(x)[::-1]
    p = np.exp((s - s[0]) / t)
    p /= p.sum()
    before = np.cumsum(p) - p
    margin_p = float(np.abs(before - tp).min()) if tp < 1.0 else np.inf
    keep = np.ones_like(x, bool)
    if tk > 0:
        keep &= x >= s[min(max(tk, 1), V) - 1]
    if tp < 1.0:
        n_keep = max(int((before < tp).sum()), 1)
        keep &= x >= s[n_keep - 1]
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    g = np.asarray(jax.random.gumbel(jk, logits.shape))[row]
    score = np.sort(np.where(keep, x, -1e30) / t + g)[::-1]
    return margin_p, float(score[0] - score[1])


def _assert_equal_or_near(logits, seed, temperature, top_k, top_p) -> int:
    """Tokens equal, except rows with a measured margin under the stated
    bounds; returns the number of such rows."""
    want, got = _both(logits, seed, temperature, top_k, top_p)
    near = 0
    for row in np.flatnonzero(want != got):
        margin_p, gap = _margins(logits, seed, temperature, top_k, top_p,
                                 row)
        assert margin_p < TOP_P_MARGIN or gap < GUMBEL_GAP, (
            f"seed {seed} row {row}: tokens {want[row]} != {got[row]} with "
            f"top-p margin {margin_p:.3g} and score gap {gap:.3g}")
        near += 1
    return near


# ---------------------------------------------------------------------------
# sample_logits against the reference
# ---------------------------------------------------------------------------

def test_temperature_zero_is_argmax_bitwise():
    logits = _logits(0)
    greedy = logits.argmax(-1)
    want, got = _both(logits, 1, 0.0, 0, 1.0)
    np.testing.assert_array_equal(got, greedy)
    np.testing.assert_array_equal(got, want)
    # greedy rows of a sampled call are the same argmax
    temp = np.array([0, 0.8, 0, 1.0, 0, 0.5, 0, 2.0], np.float32)
    want, got = _both(logits, 2, temp, np.zeros(8, np.int32),
                      np.ones(8, np.float32))
    rows = temp <= 0
    np.testing.assert_array_equal(got[rows], greedy[rows])
    np.testing.assert_array_equal(want[rows], greedy[rows])


@pytest.mark.parametrize("key", range(3))
def test_topk1_and_tiny_topp_are_greedy(key):
    logits = _logits(1)
    greedy = logits.argmax(-1)
    for top_k, top_p in ((1, 1.0), (0, 1e-6)):
        want, got = _both(logits, key, 1.0, top_k, top_p)
        np.testing.assert_array_equal(got, greedy)
        np.testing.assert_array_equal(want, greedy)


def test_topk_support():
    """Sampled tokens always come from the k highest logits."""
    logits = _logits(2, B=2)
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    for key in range(8):
        want, got = _both(logits, key, 1.5, 5, 1.0)
        np.testing.assert_array_equal(got, want)
        for b in range(2):
            assert got[b] in top5[b]


def test_per_row_mix():
    """Per-slot knobs: greedy rows stay the argmax, a top_k=1 row is the
    argmax too."""
    logits = _logits(3, B=3)
    want, got = _both(logits, 7, np.array([0.0, 1.0, 0.0], np.float32),
                      np.array([0, 1, 0], np.int32), 1.0)
    np.testing.assert_array_equal(got, logits.argmax(-1))
    np.testing.assert_array_equal(got, want)


def test_unfiltered_sampling_matches_reference():
    """The static short-circuit: a categorical draw of ``logits / t``."""
    for seed in range(12):
        for temp in (0.3, 0.7, 1.0, 1.9):
            assert _assert_equal_or_near(_logits(10 + seed), seed, temp, 0,
                                         1.0) == 0


MIXES = {
    "topk": (1.0, 40, 1.0),
    "topp": (0.8, 0, 0.9),
    "topk-topp": (1.0, 50, 0.95),
    "rows": (np.array([0, 0.7, 1.0, 0.8, 1.0, 0, 1.3, 0.5], np.float32),
             np.array([0, 0, 40, 0, 50, 0, 5, 3], np.int32),
             np.array([1, 1, 1, 0.9, 0.95, 1, 0.5, 0.99], np.float32)),
}


@pytest.mark.parametrize("mix", list(MIXES))
def test_general_path_matches_reference(mix):
    """The per-row path over 40 keys: tokens equal, a difference allowed
    only at a measured top-p or Gumbel margin (counted and printed)."""
    near = sum(_assert_equal_or_near(_logits(100 + s), s, *MIXES[mix])
               for s in range(40))
    print(f"{mix}: {near} of 320 rows at a margin")


def test_top_p_exception_is_taken_by_its_margin():
    """Rows built so that a sorted prefix's mass sits ON ``top_p``: the
    port and the reference may cut the nucleus one token apart there, and
    every such difference must show a margin under ``TOP_P_MARGIN``."""
    B = 8
    logits = np.full((B, V), -30.0, np.float32)
    logits[:, :4] = np.log(np.array([0.4, 0.3, 0.2, 0.1], np.float32))
    mass = np.cumsum([0.4, 0.3, 0.2, 0.1]) - [0.4, 0.3, 0.2, 0.1]
    checked = 0
    for seed in range(20):
        top_p = np.full(B, float(mass[2]), np.float32)     # 0.7: on a cut
        want, got = _both(logits, seed, np.ones(B, np.float32),
                          np.zeros(B, np.int32), top_p)
        for row in np.flatnonzero(want != got):
            margin_p, _ = _margins(logits, seed, 1.0, 0, top_p, row)
            assert margin_p < TOP_P_MARGIN
        checked += 1
        assert set(got) <= {0, 1, 2, 3}
    assert checked == 20


def test_sampled_rows_differ_from_greedy():
    logits = _logits(4, scale=1.0)
    _, got = _both(logits, 0, 1.0, 0, 1.0)
    assert (got != logits.argmax(-1)).any()


# ---------------------------------------------------------------------------
# engines on the smoke config
# ---------------------------------------------------------------------------

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
    """(reference engine, port engine), each quantizing the same float
    tree itself."""
    jcfg, tcfg = _cfgs(quant)
    jp, tp = _float_params()
    jeng = jserve.make_engine(jp, jcfg, jserve.ServeConfig(
        quant=quant, max_len=MAX_LEN, **scfg))
    eng = tserve.make_engine(tp, tcfg, tserve.ServeConfig(
        quant=quant, max_len=MAX_LEN, **scfg), device="cpu")
    return jeng, eng


GENERATE = [(0.7, 0, 1.0, 0), (1.0, 40, 1.0, 1), (0.8, 0, 0.9, 2),
            (1.0, 50, 0.95, 3), (1.3, 3, 0.5, 4)]


@pytest.mark.parametrize("temperature,top_k,top_p,seed", GENERATE)
def test_generate_matches_reference_generate(temperature, top_k, top_p,
                                              seed):
    """The static-batch oracle at temperature > 0: token ``i`` drawn with
    ``fold_in(PRNGKey(seed), i)``, as the reference's python loop."""
    jeng, eng = _engines("w4a4_lut", temperature=temperature, top_k=top_k,
                         top_p=top_p, seed=seed)
    prompts = np.random.default_rng(5 + seed).integers(0, 512, (3, 5))
    want = jeng.generate(jnp.asarray(prompts, jnp.int32), 8, use_scan=False)
    got = eng.generate(torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy = _engines("w4a4_lut")[1].generate(torch.from_numpy(prompts), 8)
    assert not torch.equal(got, greedy)


LENS = [6, 5, 3, 3, 1, 2, 7, 4]
BUDGETS = [5, 6, 4, 7, 3, 5, 6, 4]
# per-request (temperature, top_k, top_p); None takes the engine's default
# (temperature 0.9, top_k 0, top_p 1.0 below)
KNOBS = [(0.0, 0, 1.0), (None, None, None), (1.0, 40, None),
         (0.8, None, 0.9), (1.0, 50, 0.95), (0.0, None, None),
         (1.2, 5, 0.8), (None, 3, None)]


def _requests(make):
    rng = np.random.default_rng(11)
    return [make(prompt=rng.integers(0, 512, L).tolist(), max_new_tokens=b,
                 temperature=t, top_k=k, top_p=p)
            for L, b, (t, k, p) in zip(LENS, BUDGETS, KNOBS)]


@pytest.mark.parametrize("quant,spec", [("w4a4_lut", False),
                                        ("w4a4_tmac", False),
                                        ("w4a4_tmac", True)],
                         ids=["lut", "tmac", "tmac-spec"])
def test_scheduler_matches_reference_scheduler(quant, spec):
    """Mixed greedy and sampled requests through 3 slots, a 4-entry chunk
    lane (short lanes included) and 3 decode tokens a round: the port's
    transcripts and final draw counter equal the reference Scheduler's.
    Exact here: every draw of this traffic lies outside both margins."""
    scfg = dict(prefill_chunk=CHUNK_LANE, temperature=0.9, seed=7,
                spec_decode=spec)
    jeng, eng = _engines(quant, **scfg)
    lanes = []
    step = eng.step

    def rec(cache, lane, *a, **k):
        lanes.append(None if lane is None else lane.slot.shape[0])
        return step(cache, lane, *a, **k)

    eng.step = rec
    jreqs, treqs = _requests(jserve.Request), _requests(tserve.Request)
    jsched = jserve.Scheduler(jeng, slots=3, chunk=3)
    tsched = tserve.Scheduler(eng, slots=3, chunk=3)
    jsched.run(jreqs)
    tsched.run(treqs)
    want = [(r.tokens, r.finish_reason) for r in jreqs]
    got = [(r.tokens, r.finish_reason) for r in treqs]
    same = sum(a == b for a, b in zip(got, want))
    print(f"{quant} spec={spec}: {same} of {len(want)} transcripts equal; "
          f"draw counter {tsched._step} vs {jsched._step}")
    assert got == want
    assert tsched._step == jsched._step
    assert any(n is not None and n < CHUNK_LANE for n in lanes)
    # greedy requests keep their argmax chain, sampled ones leave it
    greedy = [tserve.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                             temperature=0.0) for r in treqs]
    tserve.Scheduler(eng, slots=3, chunk=3).run(greedy)
    for r, g, (t, _, _) in zip(treqs, greedy, KNOBS):
        if t == 0.0:
            assert r.tokens == g.tokens
    assert any(r.tokens != g.tokens for r, g in zip(treqs, greedy))
    if spec:
        st = tsched.stats
        assert st["spec_rounds"] >= 1
        for k in ("spec_rounds", "spec_drafted", "spec_accepted"):
            assert st[k] == jsched.stats[k], k
        print(f"accept rate at temperature > 0: {st['spec_accepted']} of "
              f"{st['spec_drafted']}")


def _jax_entries(entries):
    if entries is None:
        return None
    pad = CHUNK_LANE - len(entries["slot"])
    return {k: list(v) + [-1 if k == "slot" else 0] * pad
            for k, v in entries.items()}


def _lane(entries):
    if entries is None:
        return None
    i32 = torch.int32
    return ChunkLane(*(torch.tensor(entries[k], dtype=i32) for k in
                       ("slot", "tok", "pos")),
                     *(torch.tensor(entries[k], dtype=torch.bool) for k in
                       ("first", "budget_one")))


@pytest.mark.parametrize("spec", [False, True])
def test_engine_step_key_schedule_matches_reference(spec):
    """Rounds at explicit ``step0`` values through both engines' ``step``:
    a 2-entry lane (short of the 4-entry ``prefill_chunk``: decode draws
    still start at ``step0 + 4``), a 1-entry lane, a decode-only round.
    The packed result unpacks to the reference's tuple."""
    quant = "w4a4_tmac" if spec else "w4a4_lut"
    jeng, eng = _engines(quant, prefill_chunk=CHUNK_LANE, spec_decode=spec)
    a, b, c = np.random.default_rng(2).integers(0, 512, 3)
    lanes = [{"slot": [0, 1], "tok": [a, b], "pos": [0, 0],
              "first": [1, 0], "budget_one": [0, 0]},
             {"slot": [1], "tok": [c], "pos": [1], "first": [1],
              "budget_one": [0]},
             None]
    tok = np.array([a, b, 0], np.int32)
    pos = np.array([0, 0, -1], np.int32)
    done = np.ones(3, bool)
    eos = np.full(3, -1, np.int32)
    temp = np.array([1.0, 0.7, 0.0], np.float32)
    top_k = np.array([0, 40, 0], np.int32)
    top_p = np.array([0.9, 1.0, 1.0], np.float32)
    jcache, cache = jeng.init_cache(3), eng.init_cache(3)
    jstate = tstate = (tok, pos, done)
    for step0, entries in zip((5, 1000, 2 ** 31 - 3), lanes):
        out = jeng.step(jcache, _jax_entries(entries),
                        *(jnp.asarray(x) for x in jstate), jnp.asarray(eos),
                        jnp.asarray(temp), jnp.asarray(top_k),
                        jnp.asarray(top_p), step0, 2, greedy=False,
                        spec=spec)
        jcache, jout = out[0], [np.asarray(x) for x in out[1:]]
        cache, *new, packed = eng.step(
            cache, _lane(entries), *(torch.from_numpy(x) for x in tstate),
            torch.from_numpy(eos), 2, spec=spec,
            temperature=torch.from_numpy(temp),
            top_k=torch.from_numpy(top_k), top_p=torch.from_numpy(top_p),
            step0=step0, greedy=False)
        for got, want in zip([*new, *unpack_round(packed)], jout):
            np.testing.assert_array_equal(got.numpy(), want)
        jstate = tuple(jout[:3])
        tstate = tuple(x.numpy() for x in new)


def test_step0_as_device_scalar_equals_int():
    _, eng = _engines("w4a4_lut")
    state = (torch.tensor([3, 4], dtype=torch.int32),
             torch.tensor([2, 5], dtype=torch.int32),
             torch.tensor([False, False]),
             torch.tensor([-1, -1], dtype=torch.int32))
    knobs = dict(temperature=torch.tensor([1.0, 0.8]),
                 top_k=torch.tensor([0, 7], dtype=torch.int32),
                 top_p=torch.tensor([0.95, 1.0]), greedy=False)
    outs = [eng.step(eng.init_cache(2), None, *state, 3, step0=s, **knobs)
            for s in (17, torch.tensor(17, dtype=torch.int32))]
    other = eng.step(eng.init_cache(2), None, *state, 3, step0=18, **knobs)
    assert torch.equal(outs[0][4], outs[1][4])
    assert not torch.equal(outs[0][4], other[4])


def test_sampled_round_needs_its_vectors():
    _, eng = _engines("w4a4_lut")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="temperature, top_k and top_p"):
        eng.step(eng.init_cache(1), None, z, z, torch.zeros(1, dtype=bool),
                 z - 1, 1, greedy=False)


def test_freed_slot_restores_greedy_variant(monkeypatch):
    """A finished sampling request leaves no sampling state in its slot:
    later all-greedy rounds take the argmax-only variant again, which runs
    no PRNG op, and serve the greedy oracle's tokens."""
    _, eng = _engines("w4a4_lut")
    flags = []
    step = eng.step

    def rec(*a, **k):
        flags.append(k["greedy"])
        return step(*a, **k)

    eng.step = rec
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    sched.run([tserve.Request(prompt=[1, 2, 3, 4], max_new_tokens=3,
                              temperature=0.9, top_k=4)])
    assert flags and not any(flags)
    assert all(t <= 0.0 and k == 0 and p >= 1.0 for t, k, p in
               zip(sched._temp_h, sched._topk_h, sched._topp_h))
    want = eng.generate(torch.tensor([[5, 6, 7, 8]]), 4)[:, 4:]

    def no_prng(*a, **k):
        raise AssertionError("a greedy round drew from the PRNG")

    monkeypatch.setattr(prng, "threefry2x32", no_prng)
    flags.clear()
    req = tserve.Request(prompt=[5, 6, 7, 8], max_new_tokens=4)
    sched.run([req])
    assert flags and all(flags)
    assert req.tokens == want[0].tolist()


def test_draw_counter_advances_by_round_shape():
    """``_step`` moves by C + chunk a round (C = prefill_chunk with a chunk
    lane, else 0), and by C + 2 * draft_k + 1 on a speculative round."""
    for spec, per_decode in ((False, 3), (True, 2 * 3 + 1)):
        quant = "w4a4_tmac" if spec else "w4a4_lut"
        _, eng = _engines(quant, prefill_chunk=CHUNK_LANE, spec_decode=spec)
        rounds = []
        step = eng.step

        def rec(cache, lane, *a, **k):
            rounds.append(lane is not None)
            return step(cache, lane, *a, **k)

        eng.step = rec
        sched = tserve.Scheduler(eng, slots=2, chunk=3)
        sched.submit(tserve.Request(prompt=[1, 2, 3, 4, 5, 6],
                                    max_new_tokens=12, temperature=1.0))
        want = 0
        while sched.has_work:
            sched.step()
            want += CHUNK_LANE * rounds[-1] + per_decode
            assert sched._step == want
        assert rounds[:3] == [True, True, False]


READS = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
         "__float__", "__index__")


def test_sampled_rounds_read_the_device_once(monkeypatch):
    """Sampling knobs travel host to device with the admissions: a sampled
    Scheduler round still reads the device once (the packed result)."""
    _, tcfg = _cfgs("w4a4_lut")
    eng = tserve.make_engine(TT.init_params(tcfg, seed=0, device="cpu"),
                             tcfg, tserve.ServeConfig(
                                 quant="w4a4_lut", max_len=MAX_LEN,
                                 prefill_chunk=CHUNK_LANE, temperature=0.8),
                             device="cpu")
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    for r in _requests(tserve.Request):
        sched.submit(r)
    calls = []
    for name in READS:
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
    assert len(per_round) > 1


def test_sampling_fields_accepted_and_validated():
    """``ServeConfig`` and ``Request`` take the reference's sampling fields
    (temperature <= 0 is greedy, top_k 0 and top_p >= 1 no filter) and
    reject values that mean nothing."""
    sc = tserve.ServeConfig(temperature=0.7, top_k=5, top_p=0.9, seed=3)
    assert (sc.temperature, sc.top_k, sc.top_p, sc.seed) == (0.7, 5, 0.9, 3)
    d = tserve.ServeConfig()
    assert (d.temperature, d.top_k, d.top_p, d.seed) == (0.0, 0, 1.0, 0)
    tserve.ServeConfig(temperature=-1.0, top_p=1.5)
    r = tserve.Request(prompt=[1], temperature=1.0, top_k=np.int64(3),
                       top_p=0.5)
    assert (r.temperature, r.top_k, r.top_p) == (1.0, 3, 0.5)
    assert tserve.Request(prompt=[1]).temperature is None
    for bad in (dict(temperature=float("nan")), dict(temperature="0.7"),
                dict(top_k=-1), dict(top_k=1.5), dict(top_k=True),
                dict(top_p=float("inf")), dict(top_p=-0.1)):
        name = next(iter(bad))
        with pytest.raises(ValueError, match=name):
            tserve.ServeConfig(**bad)
        with pytest.raises(ValueError, match=name):
            tserve.Request(prompt=[1], **bad)
    with pytest.raises(ValueError, match="seed"):
        tserve.ServeConfig(seed=1.5)
