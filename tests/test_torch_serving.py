"""Port vs reference, the whole slice: ``serve.quantize`` codes, and
``make_engine`` + ``Scheduler`` serving qwen2-7b-smoke in w4a4_lut on
converted weights; plus the port's own serving invariants (scheduler ==
static-batch oracle, EOS / budget retirement, validation, greedy
decoding; sampling is in ``test_torch_sampling.py``).

The transcripts are compared exactly.  The teacher-forced logits along the
reference transcript agree at ``atol=rtol=1e-5`` (float32 compute): the
integer LUT products are exact, but XLA and ATen order the float
reductions (RMS mean, softmax, attention dot products) differently.
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
from repro.serve import quantize as jquant
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import transformer as TT
from repro_torch.serve import quantize as tquant

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 40


def _cfgs(quant="w4a4_lut"):
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
        jcfg, tcfg = _cfgs()
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _FLOAT["j"] = jp
        _FLOAT["t"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      tcfg, device="cpu")
    return _FLOAT["j"], _FLOAT["t"]


def _requests(make, vocab, seed=1):
    rng = np.random.default_rng(seed)
    lens, budgets = [3, 9, 5, 12, 1], [5, 4, 7, 3, 6]
    return [make(prompt=rng.integers(0, vocab, L).tolist(),
                 max_new_tokens=b) for L, b in zip(lens, budgets)]


def _port_engine(backend="ref", max_len=MAX_LEN, **kw):
    _, tcfg = _cfgs()
    _, tp = _float_params()
    ops.set_backend(backend)
    return tserve.make_engine(tp, tcfg, tserve.ServeConfig(
        quant="w4a4_lut", max_len=max_len, **kw), device="cpu")


@pytest.fixture(autouse=True)
def _reset_dispatch():
    yield
    ops.set_backend(None)
    ops.set_variant(None)


# ---------------------------------------------------------------------------
# quantize-at-load: same codes from the same float tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["w4a4_lut", "w4a4_mxu", "w8a8"])
def test_quantize_params_same_codes(mode):
    jcfg, tcfg = _cfgs()
    jp, tp = _float_params()
    jq = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jquant.quantize_params_for_serving(jp, mode=mode)), tcfg,
        device="cpu")
    before = ops.WEIGHT_QUANT_COUNT
    tq = tquant.quantize_params_for_serving(tp, mode=mode)
    # 7 inner projections per layer + the head, each quantized once
    assert ops.WEIGHT_QUANT_COUNT - before == 7 * tcfg.n_layers + 1
    jl = jax.tree_util.tree_flatten_with_path(jq)[0]
    tl = jax.tree_util.tree_flatten_with_path(tq)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    head = tq["lm_head"]
    assert head["w_q"].dtype == torch.int8            # paper: last layer 8-bit
    inner = tq["blocks"][0]["mlp"]["wi"]
    assert inner["w_q"].dtype == (torch.int8 if mode == "w8a8"
                                  else torch.uint8)
    assert "w" not in inner and "scale" in tq["blocks"][0]["ln1"]


@pytest.mark.parametrize("bits", [4, 8])
def test_dequantize_weight_matches(bits):
    w = np.random.default_rng(2).standard_normal((16, 6)).astype(np.float32)
    jl = jquant.quantize_leaf(jnp.asarray(w), bits)
    tl = tquant.quantize_leaf(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(
        tquant.dequantize_weight(tl, torch.float32).numpy(),
        np.asarray(jquant.dequantize_weight(jl, jnp.float32)))


def test_quantize_leaf_mode_tmac_not_ported():
    """The tmac modes now quantize to bitplane leaves with their markers,
    the same leaves as the reference's."""
    w = np.random.default_rng(3).standard_normal((16, 4)).astype(np.float32)
    got = tquant.quantize_leaf_mode(torch.from_numpy(w), "w2a4_tmac")
    want = jquant.quantize_leaf_mode(jnp.asarray(w), "w2a4_tmac")
    assert sorted(got) == sorted(want) == ["w_q", "w_scale", "w_tmac"]
    assert got["w_q"].shape == (2, 2, 4) and got["w_tmac"].shape == (0,)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the whole slice against the reference
# ---------------------------------------------------------------------------

_JAX_RUN = {}


def _jax_transcripts():
    if not _JAX_RUN:
        jcfg, _ = _cfgs()
        jp, _ = _float_params()
        eng = jserve.make_engine(jp, jcfg, jserve.ServeConfig(
            quant="w4a4_lut", max_len=MAX_LEN))
        reqs = _requests(jserve.Request, jcfg.vocab)
        jserve.Scheduler(eng, slots=3, chunk=3).run(reqs)
        _JAX_RUN["reqs"] = reqs
        _JAX_RUN["params"] = eng.params
    return _JAX_RUN["reqs"], _JAX_RUN["params"]


@pytest.mark.parametrize("backend,variant", [("ref", None), ("cuda", None),
                                             ("cuda", "unfused")])
def test_scheduler_transcripts_match_reference(backend, variant):
    jreqs, _ = _jax_transcripts()
    _, tcfg = _cfgs()
    eng = _port_engine(backend)
    ops.set_variant(variant)
    treqs = _requests(tserve.Request, tcfg.vocab)
    tserve.Scheduler(eng, slots=3, chunk=3).run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.tokens == j.tokens
        assert t.finish_reason == j.finish_reason == "length"


def test_teacher_forced_logits_match_reference():
    """Both quantized models, fed the reference transcript token by token,
    give the same logits at every position."""
    jreqs, jparams = _jax_transcripts()
    jcfg, tcfg = _cfgs()
    eng = _port_engine()
    for r in jreqs:
        seq = np.asarray([list(r.prompt) + r.tokens], np.int32)
        want, _ = JT.forward(jparams, jcfg, jnp.asarray(seq))
        got, _ = TT.forward(eng.params, tcfg, torch.from_numpy(seq))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # and the transcript is the argmax chain of those logits
        L = len(r.prompt)
        pred = got[0, L - 1:-1].argmax(-1).tolist()
        assert pred == r.tokens


# ---------------------------------------------------------------------------
# port-internal serving invariants
# ---------------------------------------------------------------------------

def test_scheduler_matches_static_batch_oracle():
    eng = _port_engine(prefill_chunk=4)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (3, 6)))
    want = eng.generate(prompts, max_new_tokens=5)[:, 6:]
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    reqs = [tserve.Request(prompt=prompts[i].tolist(), max_new_tokens=5)
            for i in range(3)]
    sched.submit(reqs[0])
    sched.step()                      # first request mid-flight...
    sched.submit(reqs[1])             # ...then more arrive
    sched.submit(reqs[2])
    while sched.has_work:
        sched.step()
    for i, r in enumerate(reqs):
        assert r.tokens == want[i].tolist(), i
        assert r.done and r.finish_reason == "length"
    assert sched.stats["emitted_tokens"] == 15


def test_decode_steps_counted_per_lane():
    eng = _port_engine(prefill_chunk=4)
    sched = tserve.Scheduler(eng, slots=2, chunk=3)
    sched.submit(tserve.Request(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=4))
    eng.decode_steps = 0
    sched.step()               # 4 chunk-lane entries + 3 decode iterations
    assert eng.decode_steps == 4 + 3
    sched.step()               # 2 entries (2 pads skipped) + 3 decode
    assert eng.decode_steps == 7 + 2 + 3
    assert sched.padding_waste == 8 / 6


def test_eos_and_budget_retirement():
    eng = _port_engine()
    probe = tserve.Request(prompt=[7, 8, 9], max_new_tokens=4)
    tserve.Scheduler(eng, slots=2, chunk=2).run([probe])
    eos = probe.tokens[1]
    reqs = [tserve.Request(prompt=[7, 8, 9], max_new_tokens=4, eos_id=eos),
            tserve.Request(prompt=[1, 2], max_new_tokens=0),
            tserve.Request(prompt=[3, 4], max_new_tokens=1),
            tserve.Request(prompt=[5], max_new_tokens=3)]
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    sched.run(reqs)
    assert reqs[0].finish_reason == "eos"
    assert reqs[0].tokens == probe.tokens[:probe.tokens.index(eos) + 1]
    assert reqs[1].tokens == [] and reqs[1].finish_reason == "length"
    assert len(reqs[2].tokens) == 1 and reqs[2].finish_reason == "length"
    assert len(reqs[3].tokens) == 3
    assert not sched.has_work and all(s is None for s in sched.slots)
    assert sched.pos.tolist() == [-1, -1] and sched.done.all()


def test_raising_stream_callback_fails_only_its_request():
    eng = _port_engine()

    def boom(req, tok):
        raise RuntimeError("client went away")

    seen = []
    reqs = [tserve.Request(prompt=[1, 2, 3], max_new_tokens=3, on_token=boom),
            tserve.Request(prompt=[4, 5], max_new_tokens=3,
                           on_token=lambda r, t: seen.append(t))]
    sched = tserve.Scheduler(eng, slots=2, chunk=2)
    sched.run(reqs)
    assert reqs[0].status == tserve.RequestStatus.FAILED
    assert len(reqs[0].tokens) == 1
    assert reqs[1].status == tserve.RequestStatus.FINISHED
    assert seen == reqs[1].tokens and len(seen) == 3
    assert sched.stats["failed"] == 1


def test_submit_and_config_validation():
    eng = _port_engine(max_len=16)
    sched = tserve.Scheduler(eng, slots=1, chunk=2)
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.submit(tserve.Request(prompt=[1] * 17, max_new_tokens=0))
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.submit(tserve.Request(prompt=[1] * 10, max_new_tokens=7))
    with pytest.raises(ValueError, match="non-empty"):
        tserve.Request(prompt=[])
    with pytest.raises(ValueError, match=">= 0"):
        tserve.Request(prompt=[1], max_new_tokens=-1)
    with pytest.raises(ValueError, match="max_len"):
        tserve.ServeConfig(max_len=0)
    with pytest.raises(ValueError, match="cannot exceed"):
        tserve.ServeConfig(max_len=4, prefill_chunk=5)
    with pytest.raises(ValueError, match="prefill_chunk"):
        tserve.ServeConfig(prefill_chunk=0)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        tserve.Scheduler(eng, slots=1, chunk=0)
    assert tserve.ServeConfig().chunk_tokens == 8


def test_make_engine_defaults_to_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    _, tp = _float_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.make_engine(tp, tcfg, tserve.ServeConfig(quant="w4a4_lut"))


def test_sample_logits_greedy_first_index_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert tserve.sample_logits(logits).tolist() == [1, 0]
    # the reference at temperature 0, on logits full of ties
    x = np.random.default_rng(4).integers(0, 3, (16, 40)).astype(np.float32)
    want = jserve.sample_logits(jnp.asarray(x), None, 0.0, 0, 1.0)
    got = tserve.sample_logits(torch.from_numpy(x), None, 0.0, 0, 1.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_matches_reference_generate():
    """The static-batch oracle against the reference's python-loop
    ``generate`` on the same quantized weights, greedy."""
    jcfg, _ = _cfgs()
    jp, _ = _float_params()
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 5))
    jeng = jserve.make_engine(jp, jcfg, jserve.ServeConfig(
        quant="w4a4_lut", max_len=16))
    want = jeng.generate(jnp.asarray(prompts, jnp.int32), 6, use_scan=False)
    got = _port_engine(max_len=16).generate(torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
