"""The serving round as a captured CUDA graph (``serve/graphs.py``) on the
card: full-width qwen2-7b and bitnet-3b at 2 layers, seed-0 random
weights.  A replayed round must equal the eager round bit for bit (cache
bytes, tokens, positions, done flags, the packed result) and count the
same launches, greedy and sampled; a sampled key replays under a new
``step0`` and new sampling values without a recapture; the port's
threefry stream gives the same bits on the card as on the CPU; a paged
round replays under page tables changed since its capture; an int8-KV
round (four cache leaves a layer) replays as its eager round does, dense
and paged, and a round after a monolithic admission replays the graph it
already has; gemma2-2b's rounds past the window (a ring's later writes
land on the window's oldest keys) replay as their eager rounds, and so do
rwkv6-1.6b's and zamba2-2.7b's (each step overwrites the recurrent state
whole); graphs never
move a workspace, never replay under another kernel variant, and a
capture that fails raises.  Faults: a NaN poisoning whose round is a new
key is warmed up, captured and replayed on the poisoned cache, detected and
recovered with the fault-free transcript and key count, and a replayed
round's cache sweep flags a NaN that no logit sees, and the sweep flags
NaN and both infinities in a full-width bf16 or float32 cache, eager and
captured.  Every test needs a CUDA GPU (marker ``gpu``) and skips
elsewhere; the file imports no JAX:
``python -m pytest -q -m gpu tests/test_torch_cuda_graphs.py``.
"""
import dataclasses
import warnings

import pytest
import torch

from repro_torch.configs import (bitnet_3b, gemma2_2b, qwen2_7b, rwkv6_1p6b,
                                  zamba2_2p7b)
from repro_torch.core import prng
from repro_torch.kernels.lutmul import kernel, ops
from repro_torch.models import transformer
from repro_torch.serve import Request, Scheduler, ServeConfig, make_engine
from repro_torch.serve.engine import ChunkLane, unpack_round
from repro_torch.serve.faults import Fault, FaultPlan

pytestmark = [pytest.mark.gpu, pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA GPU: graphs are captured on the card")]

LAYERS = 2
SLOTS = 8
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _dispatch():
    ops.set_backend("cuda")
    ops.set_variant(None)
    yield
    ops.set_backend(None)
    ops.set_variant(None)


_ENGINES = {}


def _engine(name: str):
    """lut, tmac, spec (on the tmac codes), lut8 (an int8 KV cache on the
    lut codes) or bitnet, built once."""
    if name == "lut8" and name not in _ENGINES:
        lut = _engine("lut")
        _ENGINES[name] = make_engine(lut.params, dataclasses.replace(
            lut.cfg, kv_quant="int8"), ServeConfig(max_len=MAX_LEN))
    if name not in _ENGINES:
        if name in ("lut", "tmac", "spec"):
            cfg = dataclasses.replace(qwen2_7b.config(quant="w4a4_lut"),
                                      n_layers=LAYERS)
            params = transformer.init_params(cfg, seed=0, device="cuda")
            _ENGINES["lut"] = make_engine(params, cfg, ServeConfig(
                quant="w4a4_lut", max_len=MAX_LEN))
            tcfg = dataclasses.replace(cfg, quant="w4a4_tmac")
            tmac = make_engine(params, tcfg, ServeConfig(
                quant="w4a4_tmac", max_len=MAX_LEN))
            _ENGINES["tmac"] = tmac
            _ENGINES["spec"] = make_engine(tmac.params, tcfg, ServeConfig(
                max_len=MAX_LEN, spec_decode=True))
            del params
        else:
            cfg = dataclasses.replace(bitnet_3b.config(), n_layers=LAYERS)
            params = transformer.init_params(cfg, seed=0, device="cuda")
            _ENGINES["bitnet"] = make_engine(params, cfg, ServeConfig(
                quant="ternary_a8_tmac", max_len=MAX_LEN))
            del params
        torch.cuda.empty_cache()
    return _ENGINES[name]


def _state(eng, seed=0):
    """A cache of random bf16 rows (int8 KV: random codes and positive
    scales) and 8 slots: live decoders, a row parked mid-prompt (5), a free
    row (3) admitted this round with a one-token budget, a finished row (4)
    and one with an EOS id (1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = eng.init_cache(SLOTS)
    for c in cache:
        for v in c.values():
            if v.dtype == torch.int8:
                v.copy_(torch.randint(-127, 128, v.shape, generator=g,
                                      device="cuda", dtype=torch.int8))
            elif v.dtype == torch.float32:          # int8 KV scales
                v.uniform_(1e-3, 5e-2, generator=g)
            else:
                v.normal_(generator=g)
    V = eng.cfg.vocab
    tok = torch.randint(0, V, (SLOTS,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos = torch.tensor([5, 9, 0, 0, 12, 3, 7, 20], dtype=torch.int32,
                       device="cuda")
    done = torch.tensor([0, 0, 0, 1, 1, 1, 0, 0], dtype=torch.bool,
                        device="cuda")
    eos = torch.tensor([-1, int(tok[1]), -1, -1, -1, -1, -1, -1],
                       dtype=torch.int32, device="cuda")
    t = torch.randint(0, V, (3,), generator=g, dtype=torch.int32,
                      device="cuda")
    lane = ChunkLane(
        torch.tensor([5, 5, 3], dtype=torch.int32, device="cuda"), t,
        torch.tensor([3, 4, 0], dtype=torch.int32, device="cuda"),
        torch.tensor([0, 1, 1], dtype=torch.bool, device="cuda"),
        torch.tensor([0, 0, 1], dtype=torch.bool, device="cuda"))
    return cache, lane, (tok, pos, done), eos


def _copy(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _round(eng, cache, lane, state, eos, chunk, spec, eager, **samp):
    kernel.reset_launches()
    _, tok, pos, done, packed = eng.step(cache, lane, *state, eos, chunk,
                                         spec, _eager=eager, **samp)
    torch.cuda.synchronize()
    return ([tok.clone(), pos.clone(), done.clone(), packed.clone()],
            dict(kernel.LAUNCHES))


ROUNDS = [("lut", None, False), ("lut", "unfused", False),
          ("tmac", None, False), ("spec", None, True),
          ("bitnet", None, False)]


@pytest.mark.parametrize("name,variant,spec", ROUNDS,
                         ids=["lut", "lut-unfused", "tmac", "spec", "bitnet"])
def test_replayed_round_equals_eager_round(name, variant, spec):
    """Three rounds from one state: with the chunk lane (captured), then
    two without (captured, then replayed with no warm-up before it)."""
    eng = _engine(name)
    ops.set_variant(variant)
    cache, lane, state, eos = _state(eng)
    c_eager, c_graph = _copy(cache), cache
    s_eager = s_graph = state
    replays = eng.graphs.replays
    for i, ln in enumerate((lane, None, None)):
        want, want_launches = _round(eng, c_eager, ln, s_eager, eos, 3,
                                     spec, True)
        got, got_launches = _round(eng, c_graph, ln, s_graph, eos, 3, spec,
                                   False)
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        for a, b in zip(c_graph, c_eager):
            assert torch.equal(_bits(a["k"]), _bits(b["k"])), i
            assert torch.equal(_bits(a["v"]), _bits(b["v"])), i
        assert got_launches == want_launches and sum(want_launches.values())
        s_eager, s_graph = tuple(want[:3]), tuple(got[:3])
    assert eng.graphs.replays == replays + 3


def test_ring_round_replays_as_eager_past_the_window():
    """gemma2-2b at 2 layers, full width (a local layer and a global one),
    rows past the 4,096-token window: a round's 8 decode iterations write
    ring slots whose window keys its earlier iterations still read, so the
    capture's warm-up must leave the rings as it found them.  Two rounds,
    the first captured, the second replayed: state, packed results and
    cache bytes equal the eager rounds'."""
    cfg = dataclasses.replace(gemma2_2b.config(quant="w4a4_lut"),
                              n_layers=2)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    eng = make_engine(params, cfg, ServeConfig(quant="w4a4_lut",
                                               max_len=4352))
    del params
    g = torch.Generator(device="cuda").manual_seed(4)
    cache = eng.init_cache(SLOTS)
    for c in cache:
        for v in c.values():
            v.normal_(generator=g)
    assert [c["k"].shape[1] for c in cache] == [4096, 4352]
    tok = torch.randint(0, cfg.vocab, (SLOTS,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos = torch.tensor([4100, 4200, 5, 4095, 4096, 300, 4330, 4097],
                       dtype=torch.int32, device="cuda")
    done = torch.zeros((SLOTS,), dtype=torch.bool, device="cuda")
    eos = torch.full((SLOTS,), -1, dtype=torch.int32, device="cuda")
    c_eager = _copy(cache)
    s_eager = s_graph = (tok, pos, done)
    for i in range(2):
        want, _ = _round(eng, c_eager, None, s_eager, eos, 8, False, True)
        got, _ = _round(eng, cache, None, s_graph, eos, 8, False, False)
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        for a, b in zip(cache, c_eager):
            assert torch.equal(_bits(a["k"]), _bits(b["k"])), i
            assert torch.equal(_bits(a["v"]), _bits(b["v"])), i
        s_eager, s_graph = tuple(want[:3]), tuple(got[:3])
    del eng, cache, c_eager
    torch.cuda.empty_cache()


@pytest.mark.parametrize("mod,layers", [(rwkv6_1p6b, 2), (zamba2_2p7b, 6)],
                         ids=["rwkv6", "zamba2"])
def test_recurrent_round_replays_as_eager(mod, layers):
    """rwkv6-1.6b and zamba2-2.7b (a shared block, then mamba layers) at
    full width: every decode step overwrites the recurrent state whole, so
    the capture's warm-up must put it back.  Two rounds, the first
    captured (its warm-up just before it), the second replayed: state,
    packed results and every cache leaf equal the eager rounds'."""
    cfg = dataclasses.replace(mod.config(quant="w4a4_lut"), n_layers=layers)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    eng = make_engine(params, cfg, ServeConfig(quant="w4a4_lut",
                                               max_len=MAX_LEN))
    del params
    g = torch.Generator(device="cuda").manual_seed(4)
    cache = eng.init_cache(SLOTS)
    for c in cache:
        for v in c.values():
            v.normal_(generator=g)
    tok = torch.randint(0, cfg.vocab, (SLOTS,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos = torch.tensor([5, 9, -1, 0, 12, 3, 7, 20], dtype=torch.int32,
                       device="cuda")
    done = torch.tensor([0, 0, 1, 0, 0, 0, 0, 0], dtype=torch.bool,
                        device="cuda")
    eos = torch.full((SLOTS,), -1, dtype=torch.int32, device="cuda")
    c_eager = _copy(cache)
    s_eager = s_graph = (tok, pos, done)
    for i in range(2):
        want, _ = _round(eng, c_eager, None, s_eager, eos, 8, False, True)
        got, _ = _round(eng, cache, None, s_graph, eos, 8, False, False)
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        for a, b in zip(cache, c_eager):
            for k in a:
                assert torch.equal(_bits(a[k]), _bits(b[k])), (i, k)
        s_eager, s_graph = tuple(want[:3]), tuple(got[:3])
    assert len(eng.graphs.rounds) == 1
    del eng, cache, c_eager
    torch.cuda.empty_cache()


def _knobs(step0: int) -> dict:
    """A sampled round's knobs for the 8 slots: greedy, unfiltered, top-k,
    top-p and both, under ``step0``."""
    f32 = dict(dtype=torch.float32, device="cuda")
    return dict(
        temperature=torch.tensor([1.0, 0.7, 0.0, 0.8, 1.0, 0.0, 1.2, 0.5],
                                 **f32),
        top_k=torch.tensor([0, 40, 0, 0, 50, 0, 5, 0], dtype=torch.int32,
                           device="cuda"),
        top_p=torch.tensor([1.0, 1.0, 1.0, 0.9, 0.95, 1.0, 0.8, 1.0],
                           **f32),
        step0=step0, greedy=False)


@pytest.mark.parametrize("name,spec", [("lut", False), ("spec", True)],
                         ids=["lut", "spec"])
def test_replayed_sampled_round_equals_eager_round(name, spec):
    """Three sampled rounds from one state, each at its own ``step0``: with
    the chunk lane (captured), then two without (the second replays the
    first's graph under a new step0): tokens, state, packed results and
    cache bytes equal the eager rounds', launches too."""
    eng = _engine(name)
    cache, lane, state, eos = _state(eng, seed=6)
    c_eager, c_graph = _copy(cache), cache
    s_eager = s_graph = state
    for i, (ln, step0) in enumerate(((lane, 3), (None, 40), (None, 1234))):
        want, want_launches = _round(eng, c_eager, ln, s_eager, eos, 3,
                                     spec, True, **_knobs(step0))
        got, got_launches = _round(eng, c_graph, ln, s_graph, eos, 3, spec,
                                   False, **_knobs(step0))
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        for a, b in zip(c_graph, c_eager):
            assert torch.equal(_bits(a["k"]), _bits(b["k"])), i
            assert torch.equal(_bits(a["v"]), _bits(b["v"])), i
        assert got_launches == want_launches and sum(want_launches.values())
        s_eager, s_graph = tuple(want[:3]), tuple(got[:3])


def test_new_step0_replays_without_recapture():
    """A sampled key is captured once: new step0 values and new sampling
    vectors replay it (the same cache and state each time, so only the
    draws change)."""
    eng = _engine("lut")
    cache, _, state, eos = _state(eng, seed=7)
    outs = [_round(eng, cache, None, state, eos, 2, False, False,
                   **_knobs(0))[0][3]]
    keys = len(eng.graphs.rounds)
    for step0 in (0, 8, 2 ** 20):
        replays = eng.graphs.replays
        got, _ = _round(eng, cache, None, state, eos, 2, False, False,
                        **_knobs(step0))
        outs.append(got[3])
        assert len(eng.graphs.rounds) == keys
        assert eng.graphs.replays == replays + 1
    knobs = _knobs(8)
    knobs["temperature"] = knobs["temperature"] * 2
    _round(eng, cache, None, state, eos, 2, False, False, **knobs)
    assert len(eng.graphs.rounds) == keys
    ptrs = tuple(t.data_ptr() for c in cache for t in c.values())
    assert len([k for k in eng.graphs.rounds
                if k[:4] == (0, 2, False, False) and k[-1] == ptrs]) == 1
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[1], outs[2])
    assert not torch.equal(outs[2], outs[3])


@pytest.mark.parametrize("seed", [0, 9, -3, 2 ** 31 - 1])
def test_prng_on_the_card_equals_the_cpu(seed):
    """Keys, bits and uniforms of the port's threefry stream, bitwise,
    at the served draw's shape (8 slots x qwen2-7b's vocabulary)."""
    shape = (SLOTS, qwen2_7b.config().vocab)
    kc, kg = prng.prng_key(seed), prng.prng_key(seed, "cuda")
    data = torch.arange(-3, 29, dtype=torch.int32) * 40503
    assert torch.equal(prng.fold_in(kg, data.cuda()).cpu(),
                       prng.fold_in(kc, data))
    kc, kg = prng.fold_in(kc, 17), prng.fold_in(kg, 17)
    assert torch.equal(prng.random_bits(kg, shape).cpu(),
                       prng.random_bits(kc, shape))
    for lo in (0.0, prng._TINY):
        a = prng.uniform(kg, shape, lo, 1.0).cpu()
        b = prng.uniform(kc, shape, lo, 1.0)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_replay_counts_the_forwards_of_its_capture():
    eng = _engine("lut")
    cache, lane, state, eos = _state(eng, seed=1)
    eng.decode_steps = 0
    eng.lane_steps = dict.fromkeys(eng.lane_steps, 0)
    for _ in range(2):
        _round(eng, cache, lane, state, eos, 2, False, False)
    assert eng.lane_steps == {"chunk": 6, "decode": 4, "draft": 0,
                              "verify": 0}
    assert eng.decode_steps == 10
    r = next(r for k, r in eng.graphs.rounds.items()
             if k[:4] == (3, 2, False, True) and k[-1] == tuple(
                 t.data_ptr() for c in cache for t in c.values()))
    assert r.replays == 2 and r.forwards == 5
    assert r.launches == {"lutmul_fused": 7 * LAYERS * 5,
                          "int_matmul_fused": 5}


def test_workspaces_stay_put_across_captures():
    eng = _engine("spec")
    cache, lane, state, eos = _state(eng, seed=2)
    _round(eng, cache, lane, state, eos, 2, True, False)
    ws = eng.graphs._workspaces[SLOTS]
    ptrs = {lib: t.data_ptr() for lib, t in ws.items()}
    eager = {k: t.data_ptr() for k, t in kernel._WORKSPACES.items()}
    for ln, chunk, spec in ((None, 2, True), (None, 3, False),
                            (ChunkLane(*(t[:1] for t in lane)), 1, False),
                            (lane, 4, True)):
        _round(eng, cache, ln, state, eos, chunk, spec, False)
    assert eng.graphs._workspaces == {SLOTS: ws}
    assert {lib: t.data_ptr() for lib, t in ws.items()} == ptrs
    # warm-ups and captures never touch the per-stream eager workspaces
    assert {k: t.data_ptr() for k, t in kernel._WORKSPACES.items()} == eager
    for t in ws.values():
        assert not t.any()


def test_a_launch_that_outgrows_the_graph_workspace_raises():
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randint(0, 16, (8, 256), generator=g, dtype=torch.uint8,
                      device="cuda")
    small = torch.randint(0, 256, (128, 64), generator=g, dtype=torch.uint8,
                          device="cuda")
    wide = torch.randint(0, 256, (128, 4096), generator=g,
                         dtype=torch.uint8, device="cuda")
    ws = kernel.reserve_workspaces([(8, 64)], a.device)
    ptr = ws["lutmul"].data_ptr()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with kernel.graph_workspaces(ws), torch.cuda.stream(s):
        got = kernel.lutmul(a, small)
        with pytest.raises(RuntimeError, match="workspace"):
            kernel.lutmul(a, wide)
    s.synchronize()
    assert torch.equal(got.cpu(), kernel.lutmul(a.cpu(), small.cpu()))
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="workspace"):
        with kernel.graph_workspaces(ws), torch.cuda.graph(graph, stream=s):
            kernel.lutmul(a, wide)
    with pytest.raises(RuntimeError, match="graph_workspaces"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=s):
            kernel.lutmul(a, small)
    torch.cuda.synchronize()
    assert ws["lutmul"].data_ptr() == ptr and not ws["lutmul"].any()
    assert torch.equal(kernel.lutmul(a, wide).cpu(),
                       kernel.lutmul(a.cpu(), wide.cpu()))


def test_a_graph_never_replays_under_another_variant():
    eng = _engine("lut")
    cache, lane, state, eos = _state(eng, seed=4)

    ptrs = tuple(t.data_ptr() for c in cache for t in c.values())

    def graph_of(variant):
        # the whole address tuple: an earlier test's cache may have sat
        # where this one's first tensor does
        return next(r for k, r in eng.graphs.rounds.items()
                    if k[:6] == (3, 2, False, True, "cuda", variant)
                    and k[-1] == ptrs)

    _round(eng, cache, lane, state, eos, 2, False, False)
    fused = graph_of("fused")
    n_fused = fused.replays     # the cache may sit where an earlier one did
    ops.set_variant("unfused")
    _, launches = _round(eng, cache, lane, state, eos, 2, False, False)
    unfused = graph_of("unfused")
    n_unfused = unfused.replays
    assert fused.replays == n_fused
    assert launches == {**dict.fromkeys(kernel.LAUNCHES, 0),
                        "lutmul": 7 * LAYERS * 5, "int_matmul": 5}
    ops.set_variant(None)
    _round(eng, cache, lane, state, eos, 2, False, False)
    assert fused.replays == n_fused + 1 and unfused.replays == n_unfused


def test_scheduler_round_reads_the_card_once():
    """A replayed Scheduler round synchronizes with the card once: the
    packed result's read (``torch.cuda`` sync debug mode counts them)."""
    eng = _engine("tmac")
    sched = Scheduler(eng, slots=SLOTS, chunk=4)
    g = torch.Generator().manual_seed(5)
    for L in (3, 9, 5, 1, 12, 4, 7, 2, 6):
        sched.submit(Request(prompt=torch.randint(
            0, eng.cfg.vocab, (L,), generator=g).tolist(), max_new_tokens=6))
    syncs = []
    while sched.has_work:
        keys = len(eng.graphs.rounds)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sched.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        if len(eng.graphs.rounds) == keys:        # nothing captured
            syncs.append(sum("synchroniz" in str(w.message) for w in seen))
    assert syncs and syncs == [1] * len(syncs)


# ---------------------------------------------------------------------------
# paged rounds: the engine's device table at a fixed address
# ---------------------------------------------------------------------------

_PAGED = {}


def _paged_engine(name: str):
    """A paged engine (4-token pages, no prefix sharing, so no two rows
    write one page) on the codes of ``lut`` or ``spec``."""
    if name not in _PAGED:
        base = _engine(name)
        _PAGED[name] = make_engine(base.params, base.cfg, dataclasses.replace(
            base.scfg, quant=None, paged=True, page_size=4,
            prefix_reuse=False))
    return _PAGED[name]


def _paged_state(eng, seed=0):
    """``_state``'s slots over random page pools, each row mapped 24
    positions past its own, more than four rounds write: a live row never
    reads the null page, which several rows may write at once."""
    cache, lane, state, eos = _state(eng, seed)
    for s, p in enumerate(state[1].tolist()):
        assert eng.pool.admit(s, [1000 * s + i for i in range(p + 1)]) == 0
        assert eng.pool.ensure(s, p + 24)
    return cache, lane, state, eos


def _same_rounds(eng, c_eager, c_graph, lane, s_eager, s_graph, eos, spec):
    want, want_launches = _round(eng, c_eager, lane, s_eager, eos, 3, spec,
                                 True)
    got, got_launches = _round(eng, c_graph, lane, s_graph, eos, 3, spec,
                               False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(c_graph, c_eager):
        assert torch.equal(_bits(a["k"]), _bits(b["k"]))
        assert torch.equal(_bits(a["v"]), _bits(b["v"]))
    assert got_launches == want_launches and sum(want_launches.values())
    return tuple(want[:3]), tuple(got[:3])


@pytest.mark.parametrize("name,spec", [("lut", False), ("spec", True)],
                         ids=["lut", "spec"])
def test_paged_round_replays_equal_eager_under_new_mappings(name, spec):
    """A paged round with the chunk lane and one without, captured and
    replayed, equal the eager rounds (state, packed result, pool bytes);
    then ensure, trim, release and a re-admission change the page tables
    and the same key replays, without a recapture, still equal."""
    eng = _paged_engine(name)
    cache, lane, state, eos = _paged_state(eng, seed=11)
    c_eager, c_graph = _copy(cache), cache
    s_eager = s_graph = state
    for ln in (lane, None):
        s_eager, s_graph = _same_rounds(eng, c_eager, c_graph, ln, s_eager,
                                        s_graph, eos, spec)
    keys = len(eng.graphs.rounds)
    table0 = eng.pool.table.copy()
    pool = eng.pool
    p6 = int(s_eager[1][6])
    assert pool.ensure(0, 48) and pool.ensure(6, 60)
    assert pool.trim(6, p6 + 12) >= 1
    pool.release(7)                    # its history now reads fresh pages
    assert pool.admit(7, list(range(7000, 7021))) == 0
    assert pool.ensure(7, 60)
    assert (pool.table != table0).any()
    replays = eng.graphs.replays
    for _ in range(2):
        s_eager, s_graph = _same_rounds(eng, c_eager, c_graph, None, s_eager,
                                        s_graph, eos, spec)
    assert len(eng.graphs.rounds) == keys
    assert eng.graphs.replays == replays + 2
    assert torch.equal(eng.table.cpu(), torch.from_numpy(pool.table))


def test_paged_and_dense_rounds_have_their_own_keys():
    """The key names the page table's shape and address: a dense engine's
    key has none, a paged engine's has its device table."""
    dense, paged = _engine("lut"), _paged_engine("lut")
    cache, lane, state, eos = _state(dense, seed=12)
    _round(dense, cache, lane, state, eos, 2, False, False)
    pcache, plane, pstate, peos = _paged_state(paged, seed=12)
    _round(paged, pcache, plane, pstate, peos, 2, False, False)
    dkey = dense.graphs.key(cache, lane, state[0], 2, False, True)
    pkey = paged.graphs.key(pcache, plane, pstate[0], 2, False, True,
                            (paged.table,))
    assert dkey in dense.graphs.rounds and pkey in paged.graphs.rounds
    assert dkey[8] is None
    assert pkey[8] == ((SLOTS, MAX_LEN // 4), paged.table.data_ptr())
    # the same round kind; the cache shapes differ (pools against rows)
    assert dkey[:7] == pkey[:7] and dkey[7] != pkey[7]


# run in a process of its own: a failed capture may leave the CUDA context
# unusable for the tests after it
HOST_READ = """
import dataclasses, sys, torch
from repro_torch.configs import qwen2_7b
from repro_torch.kernels.lutmul import ops
from repro_torch.models import transformer
from repro_torch.serve import ServeConfig, make_engine
from repro_torch.serve.engine import ChunkLane, unpack_round
from repro_torch.serve.faults import Fault, FaultPlan

ops.set_backend("cuda")
cfg = dataclasses.replace(qwen2_7b.smoke_config(quant="w4a4_lut"),
                          n_layers=2)
eng = make_engine(transformer.init_params(cfg, seed=0, device="cuda"), cfg,
                  ServeConfig(quant="w4a4_lut", max_len=16))
decode = transformer.decode_step

def reading(*a, **k):
    logits, c = decode(*a, **k)
    logits.isfinite().all().item()          # a host read inside the round
    return logits, c

transformer.decode_step = reading
i32 = dict(dtype=torch.int32, device="cuda")
lane = ChunkLane(torch.tensor([0], **i32), torch.tensor([3], **i32),
                 torch.tensor([0], **i32),
                 torch.ones(1, dtype=torch.bool, device="cuda"),
                 torch.zeros(1, dtype=torch.bool, device="cuda"))
state = (torch.zeros(2, **i32), torch.tensor([0, -1], **i32),
         torch.ones(2, dtype=torch.bool, device="cuda"),
         torch.full((2,), -1, **i32))
try:
    eng.step(eng.init_cache(2), lane, *state, 2)
except RuntimeError as err:
    print("raised:", str(err).splitlines()[0])
    sys.exit(0 if not eng.graphs.rounds and not eng.graphs.replays else 3)
sys.exit(2)
"""


def test_a_host_read_in_a_round_fails_the_capture():
    """A round that reads the device cannot be captured: the step raises
    (no eager fallback) and keeps no graph for its key."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    run = subprocess.run([sys.executable, "-c", HOST_READ], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "raised:" in run.stdout


# ---------------------------------------------------------------------------
# int8 KV rounds and monolithic admission
# ---------------------------------------------------------------------------

def _same_leaves(c_graph, c_eager) -> None:
    for a, b in zip(c_graph, c_eager):
        assert set(a) == {"k", "v", "k_scale", "v_scale"}
        for key in a:
            assert torch.equal(_bits(a[key]), _bits(b[key])), key


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_round_replays_equal_eager_round(paged):
    """Decode rounds over an int8 cache (codes and scales, four leaves a
    layer, all in the key) captured, then replayed with no warm-up before
    it: state, packed result and every cache leaf bitwise the eager
    round's."""
    eng = _paged_engine("lut8") if paged else _engine("lut8")
    cache, _, state, eos = (_paged_state if paged else _state)(eng, seed=21)
    c_eager, c_graph = _copy(cache), cache
    s_eager = s_graph = state
    key = eng.graphs.key(cache, None, state[0], 3, False, True,
                         (eng.table,) if paged else None)
    assert key[-1] == tuple(t.data_ptr() for c in cache for t in c.values())
    assert len(key[-1]) == 4 * LAYERS
    replays = eng.graphs.replays
    for i in range(2):
        want, want_launches = _round(eng, c_eager, None, s_eager, eos, 3,
                                     False, True)
        got, got_launches = _round(eng, c_graph, None, s_graph, eos, 3,
                                   False, False)
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        _same_leaves(c_graph, c_eager)
        assert got_launches == want_launches and sum(want_launches.values())
        s_eager, s_graph = tuple(want[:3]), tuple(got[:3])
    assert eng.graphs.replays == replays + 2 and key in eng.graphs.rounds


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_rounds_after_monolithic_admissions_replay_their_graph(paged):
    """A Scheduler on the int8 engine: each admission is an eager prefill
    and stitch into the live tensors, and every decode round after it
    replays the one greedy key, captured once; the transcripts equal the
    eager (``ref``-free) rounds' run, and the paged run's the dense one's."""
    runs = {}
    for graphs in (True, False):
        eng = _engine("lut8")
        if paged:
            eng = _paged_engine("lut8")
        sched = Scheduler(eng, slots=SLOTS, chunk=4)
        ptrs = [t.data_ptr() for c in sched.cache for t in c.values()]
        g = torch.Generator().manual_seed(6)
        reqs = [Request(prompt=torch.randint(0, eng.cfg.vocab, (L,),
                                             generator=g).tolist(),
                        max_new_tokens=6)
                for L in (5, 5, 9, 3, 12, 12, 7, 2, 5, 8)]
        for r in reqs:
            sched.submit(r)
        keys0, replays0 = len(eng.graphs.rounds), eng.graphs.replays
        step = eng.step
        if not graphs:
            eng.step = lambda *a, **k: step(*a, _eager=True, **k)
        try:
            while sched.has_work:
                sched.step()
        finally:
            eng.step = step
        assert [t.data_ptr() for c in sched.cache
                for t in c.values()] == ptrs
        assert sched.stats["admission_rounds"] >= 2
        if graphs:
            assert len(eng.graphs.rounds) - keys0 <= 1
            assert eng.graphs.replays - replays0 == sched.stats["rounds"]
        runs[graphs] = [r.tokens for r in reqs]
    assert runs[True] == runs[False]
    if paged:
        dense = Scheduler(_engine("lut8"), slots=SLOTS, chunk=4)
        g = torch.Generator().manual_seed(6)
        reqs = [Request(prompt=torch.randint(0, dense.engine.cfg.vocab, (L,),
                                             generator=g).tolist(),
                        max_new_tokens=6)
                for L in (5, 5, 9, 3, 12, 12, 7, 2, 5, 8)]
        dense.run(reqs)
        assert [r.tokens for r in reqs] == runs[True]


# ---------------------------------------------------------------------------
# faults: detection inside replayed rounds, recovery without recapture
# ---------------------------------------------------------------------------

def test_nan_fault_on_a_new_key_is_captured_detected_and_recovered():
    """Two 4-token prompts fill the first round's chunk lane; the second
    round is the first pure-decode round, a new key.  A NaN poisoning at
    that dispatch is warmed up and captured on the poisoned cache (the
    warm-up rewrites the positions the replay writes, with the same bits),
    replayed, detected and recovered from the snapshot: the transcripts
    equal the fault-free run's, which captured as many keys."""
    base = _engine("lut")
    runs = {}
    for faulted in (False, True):
        eng = make_engine(base.params, base.cfg, ServeConfig(max_len=MAX_LEN))
        sched = Scheduler(eng, slots=SLOTS, chunk=4, snapshot_interval=1,
                          max_retries=3)
        ptrs = [t.data_ptr() for c in sched.cache for t in c.values()]
        plan = FaultPlan([Fault("decode", 1, "nan_logits")]) if faulted \
            else None
        eng.set_fault_plan(plan)
        step, keys = eng.step, []

        def counted(*a, **k):
            n = len(eng.graphs.rounds)
            out = step(*a, **k)
            keys.append((n, len(eng.graphs.rounds)))
            return out
        eng.step = counted
        g = torch.Generator().manual_seed(8)
        reqs = [Request(prompt=torch.randint(0, eng.cfg.vocab, (4,),
                                             generator=g).tolist(),
                        max_new_tokens=10) for _ in range(2)]
        try:
            sched.run(reqs)
        finally:
            eng.step = step
            eng.set_fault_plan(None)
        assert [t.data_ptr() for c in sched.cache
                for t in c.values()] == ptrs
        runs[faulted] = ([r.tokens for r in reqs], len(eng.graphs.rounds),
                         sched.stats["recoveries"], keys)
    (clean, clean_keys, _, _), (got, got_keys, recoveries, log) = \
        runs[False], runs[True]
    assert got == clean and got_keys == clean_keys == 2
    assert recoveries == 1
    # the poisoned dispatch captured the decode key; its replay after the
    # restore captured nothing
    assert log[1] == (1, 2) and log[2] == (2, 2)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_replayed_round_sweep_flags_a_nan_no_logit_sees(paged):
    """A NaN planted in the last layer's ``v`` leaf of a finished row (4),
    past every position the round reaches, reaches no logit the guard
    checks; the replayed round's cache sweep still clears the whole ``ok``
    column, as the eager round's does."""
    eng = _paged_engine("lut") if paged else _engine("lut")
    cache, _, state, eos = (_paged_state if paged else _state)(eng, seed=4)
    got, _ = _round(eng, cache, None, state, eos, 2, False, False)
    assert bool(unpack_round(got[3])[4].all())
    row = eng.pool.n_full[4] * 4 - 1 if paged else MAX_LEN - 1
    if paged:
        cache[-1]["v"][int(eng.pool.table[4, row // 4]), row % 4] = \
            float("nan")
    else:
        cache[-1]["v"][4, row] = float("nan")
    keys = len(eng.graphs.rounds)
    for eager in (False, True):
        got, _ = _round(eng, cache, None, state, eos, 2, False, eager)
        assert not bool(unpack_round(got[3])[4].any()), eager
    assert len(eng.graphs.rounds) == keys


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf"), None])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cache_sweep_verdict_on_a_full_width_cache(dtype, value):
    """The one-pass sweep over a full-width cache (28 layers of K and V at
    [8, 256, 4, 128]: many launches of the fused norm) flags one NaN, +Inf
    or -Inf deep inside one leaf, eager and captured, as the plain per-leaf
    ``isfinite().all()`` does."""
    from repro_torch.serve.engine import _cache_finite
    from repro_torch.serve.graphs import no_gc
    gen = torch.Generator(device="cuda").manual_seed(0)
    cache = [{k: torch.randn(8, 256, 4, 128, generator=gen, device="cuda")
              .to(dtype) for k in ("k", "v")} for _ in range(28)]
    if value is not None:
        cache[17]["v"][5, 201, 3, 77] = value
    want = all(bool(torch.isfinite(t).all()) for c in cache
               for t in c.values())
    assert want == (value is None)
    assert bool(_cache_finite(cache)) == want
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _cache_finite(cache)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with no_gc(), torch.cuda.graph(graph, stream=stream):
        ok = _cache_finite(cache)
    graph.replay()
    assert bool(ok) == want
