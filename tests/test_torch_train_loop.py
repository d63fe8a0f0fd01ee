"""Port vs reference, the training loop and its parts: ``loop.run`` with
checkpoint restarts, ``make_eval_fn`` (the deployed model's evaluation),
``StragglerMonitor`` and the error-feedback gradient compression, on the
CPU at smoke sizes (plain kernel versions).

Tolerances and why:

* ``StragglerMonitor``: equal reports (plain Python on both sides).
* ``compress_decompress``: bitwise against the reference run op by op
  (under ``jax.jit`` XLA may fuse ``gf - q * scale`` into one rounding).
* ``compressed_psum``: every rank gets the same mean, within half a scale
  step of the exact mean of the ranks' gradients, and the error-feedback
  identity (decoded codes plus residuals give back the gradients) holds
  to 1e-6; a world of 1 equals the reference's ``shard_map`` on one device
  within rtol 1e-6.
* ``make_eval_fn``: weight quantizations independent of the number of
  batches, as the reference's ``test_qat_eval_weight_code_cache``; the
  loss within rtol 1e-3 of the reference's (bf16 compute, activation codes
  from float sums in other orders).
* ``loop.run``: the failure-injected run's history equals the
  uninterrupted one's bitwise (the CPU is deterministic); against the
  reference's history at rtol 1e-2 (bf16 compute: each step's float sums
  differ in order, and ten AdamW steps of lr 1e-3 carry the differences
  on).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.dist.straggler import StragglerConfig as JStragglerConfig
from repro.dist.straggler import StragglerMonitor as JStragglerMonitor
from repro.models import transformer as JT
from repro.optim import grad_compress as jgc
from repro.train import loop as jloop
from repro.train.step import TrainConfig as JTrainConfig
from repro_torch import configs as tconfigs
from repro_torch.ckpt import checkpoint
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import flatten
from repro_torch.data import pipeline as tpipe
from repro_torch.dist.straggler import StragglerConfig, StragglerMonitor
from repro_torch.kernels.lutmul import ops
from repro_torch.optim import grad_compress as tgc
from repro_torch.serve.sharded import launch
from repro_torch.train import loop as tloop
from repro_torch.train.step import TrainConfig

from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "minicpm-2b"
EVAL_RTOL = 1e-3
HISTORY_RTOL = 1e-2
PSUM_S = 120


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


_P = {}


def _setup():
    """The smoke config (bf16 compute, as the reference's loop test), the
    reference's parameters and a factory of the port's copies."""
    if not _P:
        jc = jconfigs.get_config(ARCH, smoke=True)
        tc = tconfigs.get_config(ARCH, smoke=True)
        jp = jax.jit(JT.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jc)
        host = jax.tree_util.tree_map(np.asarray, jp)
        _P.update(jc=jc, tc=tc, jp=jp,
                  fresh=lambda: params_from_jax(host, tc, device="cpu"))
    return _P


def _dcfg(mod, vocab):
    return mod.DataConfig(seed=3, vocab=vocab, seq_len=16, global_batch=4)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["persistent", "recovers"])
def test_straggler_monitor_matches_reference(case):
    """The reference's sequence (h2 slow every evaluation, patience 2) and
    one where the slow host recovers for an evaluation, clearing its
    strikes; the window keeps the last samples only."""
    kw = dict(threshold=1.5, patience=2,
              window=32 if case == "persistent" else 1)
    ref = JStragglerMonitor(JStragglerConfig(**kw))
    port = StragglerMonitor(StragglerConfig(**kw))
    assert port.evaluate() == ref.evaluate() == {"slow": {}, "exclude": [],
                                                 "median": None}
    reports = []
    for i in range(5):
        slow = 2.5 if case == "persistent" or i != 3 else 1.0
        for mon in (ref, port):
            for h in ("h0", "h1", "h2", "h3"):
                mon.record(h, 1.0 + 0.01 * i if h != "h2" else slow)
        reports.append(port.evaluate())
        assert reports[-1] == ref.evaluate(), i
    assert reports[1]["exclude"] == ["h2"] and "h2" in reports[1]["slow"]
    if case == "recovers":
        assert reports[3]["exclude"] == [] and reports[3]["slow"] == {}
        assert reports[4]["exclude"] == []      # one strike since


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_compress_decompress_bitwise(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(256,)) * 1e-3).astype(np.float32)
    r = (rng.normal(size=(256,)) * 1e-5).astype(np.float32)
    scale = np.float32(np.abs(g + r).max() / np.float32(127))
    with jax.disable_jit():
        jq, jr = jgc.compress_decompress(jnp.asarray(g), jnp.asarray(r),
                                         jnp.asarray(scale))
    tq, tr = tgc.compress_decompress(torch.from_numpy(g),
                                     torch.from_numpy(r),
                                     torch.tensor(scale))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tr.numpy().view(np.uint32),
                                  np.asarray(jr).view(np.uint32))


def _grads(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"a": torch.from_numpy((rng.normal(size=(8, 16)) * 1e-2)
                                  .astype(np.float32)),
            "b": {"w": torch.from_numpy(rng.normal(size=(32,))
                                        .astype(np.float32))}}


def _psum_rank(mesh):
    g = _grads(mesh.rank)
    res = tgc.init_residual(g)
    out, new_res = tgc.compressed_psum(g, res, mesh.data.group)
    return ({k: v.numpy() for k, v in zip(*flatten(out))},
            {k: v.numpy() for k, v in zip(*flatten(new_res))})


@pytest.mark.parametrize("world", [1, 4])
def test_compressed_psum_gloo(world):
    ranks = launch(_psum_rank, f"{world}x1", "gloo", timeout_s=PSUM_S,
                   device="cpu")
    grads = [dict(zip(*flatten(_grads(r)))) for r in range(world)]
    out0 = ranks[0][0]
    for out, _ in ranks[1:]:
        for k in out0:
            np.testing.assert_array_equal(out[k], out0[k])
    for k in out0:
        exact = np.mean([g[k].numpy() for g in grads], axis=0)
        scale = max(np.abs(g[k].numpy()).max() for g in grads) / 127
        assert np.abs(out0[k] - exact).max() <= 0.5 * scale * (1 + 1e-5)
        # error feedback: the decoded sum plus the residuals is the sum
        back = out0[k] * world + sum(r[k] for _, r in ranks)
        np.testing.assert_allclose(back, exact * world, rtol=1e-6,
                                   atol=1e-6 * np.abs(exact * world).max())
    if world == 1:
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        from repro.dist.sharding import make_mesh
        jg = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    _grads(0))
        want, _ = shard_map(
            lambda g, r: jgc.compressed_psum(g, r, "dp"),
            mesh=make_mesh((1,), ("dp",)), in_specs=(P(), P()),
            out_specs=(P(), P()))(jg, jgc.init_residual(jg))
        for path, w in zip(out0, jax.tree_util.tree_leaves(want),
                           strict=True):
            np.testing.assert_allclose(out0[path], np.asarray(w), rtol=1e-6)


# ---------------------------------------------------------------------------
# the deployed model's evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["w4a4_mxu", "w4a4_lut"])
def test_eval_fn_quantizes_once_and_matches_reference(mode):
    P = _setup()
    dcfg = _dcfg(tpipe, P["tc"].vocab)
    params = P["fresh"]()
    evaluate = tloop.make_eval_fn(P["tc"], mode)
    b1 = [tpipe.lm_batch(dcfg, 10 ** 6)]
    b3 = [tpipe.lm_batch(dcfg, 10 ** 6 + i) for i in range(3)]
    c0 = ops.WEIGHT_QUANT_COUNT
    l1 = evaluate(params, b1)
    d1 = ops.WEIGHT_QUANT_COUNT - c0
    c0 = ops.WEIGHT_QUANT_COUNT
    l3 = evaluate(params, b3)
    d3 = ops.WEIGHT_QUANT_COUNT - c0
    assert d1 == d3 > 0
    assert np.isfinite([l1, l3]).all()
    want = jloop.make_eval_fn(P["jc"], mode)(P["jp"], b3)
    np.testing.assert_allclose(l3, want, rtol=EVAL_RTOL)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _run(tmp, name, steps=10, **kw):
    P = _setup()
    return tloop.run(P["tc"], P["fresh"], _dcfg(tpipe, P["tc"].vocab),
                     TrainConfig(total_steps=12, peak_lr=1e-3, warmup=2),
                     tloop.RunConfig(steps=steps, ckpt_every=3,
                                     ckpt_dir=str(tmp / name), **kw))


def _losses(run):
    return {m["step"]: m["loss"] for m in run["history"]}


def test_failure_injection_resumes_identically_and_matches_reference(
        tmp_path):
    """A failure at step 7 restarts from the step-6 checkpoint (written
    asynchronously) and ends with the uninterrupted run's history, bit for
    bit; that history follows the reference's ``loop.run``."""
    a = _run(tmp_path, "a")
    b = _run(tmp_path, "b", fail_at_step=7)
    assert a["restarts"] == 0 and b["restarts"] == 1
    la, lb = _losses(a), _losses(b)
    assert sorted(la) == sorted(lb) == list(range(10))
    assert la == lb
    assert [m["step"] for m in b["history"]] == [0, 1, 2, 3, 4, 5, 6, 6, 7,
                                                 8, 9]
    assert b["straggler"]["exclude"] == []
    for m in a["history"]:
        assert m["wall_s"] > 0 and m["grads_s"] > 0 and m["update_s"] > 0
    P = _setup()
    ref = jloop.run(P["jc"], lambda: P["jp"], _dcfg(jpipe, P["jc"].vocab),
                    JTrainConfig(total_steps=12, peak_lr=1e-3, warmup=2),
                    jloop.RunConfig(steps=10, ckpt_every=3,
                                    ckpt_dir=str(tmp_path / "ref"),
                                    async_ckpt=False))
    lr = {m["step"]: m["loss"] for m in ref["history"]}
    for s in range(10):
        np.testing.assert_allclose(la[s], lr[s], rtol=HISTORY_RTOL,
                                   err_msg=f"step {s}")
    assert la[9] < la[0]


def test_loop_resumes_from_an_existing_checkpoint(tmp_path):
    """A second ``run`` over the same directory starts at the committed
    step's ``next_step`` and continues the first run's trajectory."""
    first = _run(tmp_path, "c", steps=4, async_ckpt=False)
    assert checkpoint.latest_step(str(tmp_path / "c")) == 3
    again = _run(tmp_path, "c", steps=6, async_ckpt=False)
    assert [m["step"] for m in again["history"]] == [3, 4, 5]
    whole = _run(tmp_path, "d", steps=6)
    assert _losses(whole)[3] == _losses(first)[3] == _losses(again)[3]
    assert _losses(whole)[5] == _losses(again)[5]


def test_loop_runs_periodic_qat_eval(tmp_path):
    P = _setup()
    r = tloop.run(P["tc"], P["fresh"], _dcfg(tpipe, P["tc"].vocab),
                  TrainConfig(total_steps=4, warmup=1),
                  tloop.RunConfig(steps=4, ckpt_every=10,
                                  ckpt_dir=str(tmp_path), eval_every=2,
                                  eval_batches=1))
    evs = [m.get("eval_loss") for m in r["history"]]
    assert evs[1] is not None and evs[3] is not None
    assert evs[0] is None and evs[2] is None
    assert np.isfinite([evs[1], evs[3]]).all()


def test_async_save_snapshots_cpu_leaves(tmp_path):
    """The loop updates its parameters in place after an async save
    returns: the checkpoint holds the values at the save."""
    t = {"a": torch.arange(6, dtype=torch.float32)}
    th = checkpoint.save(str(tmp_path), 1, t, async_save=True)
    t["a"].add_(100.0)
    th.join()
    got, _ = checkpoint.restore(str(tmp_path), t)
    assert torch.equal(got["a"], torch.arange(6, dtype=torch.float32))


def test_step_timer_spans_on_the_cpu():
    timer = tloop.StepTimer("cpu")
    timer.start()
    timer.mark("grads")
    timer.mark("update")
    sp = timer.seconds()
    assert set(sp) == {"grads", "update", "total"}
    assert sp["total"] == pytest.approx(sp["grads"] + sp["update"])


def test_simulated_failure_past_max_restarts_raises(tmp_path):
    with pytest.raises(tloop.SimulatedFailure):
        _run(tmp_path, "e", steps=2, fail_at_step=0, max_restarts=0)
