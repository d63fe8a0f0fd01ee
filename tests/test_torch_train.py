"""Port vs reference, training: the data pipeline, the LR schedules,
AdamW, the QAT linear, the loss functions and their gradients, remat and
one train step, on the CPU at smoke sizes (float32 compute, plain kernel
versions, the reference compiled with ``jax.jit``).

Tolerances and why:

* batches (``lm_batch``, ``image_batch``, ``iterate``): bitwise.
* learning rates (``cosine``, ``wsd``): bitwise against the reference's
  schedule called op by op (the port evaluates ``cos`` / ``pow`` with the
  C library's ``cosf`` / ``powf``, as XLA's CPU backend does there);
  within rtol 1e-6 of it under ``jax.jit``, where XLA multiplies by the
  reciprocal of each constant divisor (a few ulps near the cosine's end,
  where ``1 + cos`` cancels).
* ``fake_quant`` and the ``"qat"`` linear on fixed inputs: bitwise against
  the reference run op by op.  Under ``jax.jit`` XLA rewrites the
  quantizers' division by a constant (``amax / 7``) as a multiply by its
  float32 reciprocal, which the port does not mirror (it keeps the IEEE
  division of the North star): a scale can differ by an ulp there.
* AdamW and clipping: rtol 1e-6 (XLA contracts ``b1 * m + c1 * g`` into a
  fused multiply-add; the reduction orders of the norm differ).
* losses: rtol 2e-6.  Gradients: each leaf within 1e-4 of its own max |g|
  plus 1e-3 of the tree's max |g| (float32 sums in other orders; the
  floor keeps leaves whose true gradient is 0, like an attention key
  bias, from dividing noise by noise).  In QAT mode an A4 code can round
  the other way where those sums differ in the last bit: on minicpm-2b's
  smoke config 11 of 32,768 codes differ, the first in layer 1's MLP
  (``scripts/qat_code_flips.py``), which moves the loss by 1.2e-5 and a
  gradient leaf by 0.8 % (measured); QAT losses are held to rtol 5e-5
  and gradients to 2e-2 of the same scale.  MobileNetV2 in QAT mode: one A4
  code of its third layer falls on the other side of a rounding boundary
  and the flip cascades (7.6 % of the activation codes differ by half a
  step or more downstream, measured), so its gradients are held to 0.1
  of the tree's max |g| and its loss to rtol 1e-5.
* remat ``"full"`` / ``"dots"`` / ``"none"``: bitwise equal to each other.
* one train step: parameters within 1e-4 absolute.  A first AdamW step
  moves a weight by lr * g / (|g| + eps) with lr = 1e-3, so where |g| is
  near eps = 1e-8 a gradient's float32 rounding moves the weight by a
  share of lr.  The moments as the gradients (with bf16 parameters, whose
  gradients are bf16, rtol 1e-2: an element may round to the next bf16
  value); bf16 compute parameters within one bf16 ulp of the
  reference's.
* the QAT projection: bitwise, including the stacked layers' shared
  column scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.core import quantization as jq
from repro.data import pipeline as jpipe
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import mobilenet as JM
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.convert import mobilenet_params_from_jax, params_from_jax
from repro_torch.core import quantization as tq
from repro_torch.core.tree import flatten, unflatten
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.lutmul import ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tsched
from repro_torch.train import step as TS

from _torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
QAT_LOSS_RTOL = 5e-5
QAT_GRAD_RTOL = 2e-2
MB_QAT_GRAD = 0.1
MB_QAT_LOSS_RTOL = 1e-5
ADAM_RTOL = 1e-6
STEP_ATOL = 1e-4
SCHED_JIT_RTOL = 1e-6
LMS = ["minicpm-2b", "qwen2-moe-a2.7b", "rwkv6-1.6b", "gemma2-2b"]


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint8)


def _cfgs(arch, quant="none"):
    if arch == "mobilenetv2":
        return (jconfigs.get_config(arch, smoke=True, quant=quant),
                tconfigs.get_config(arch, smoke=True, quant=quant))
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    return j, t


_P = {}


def _params(arch):
    """The reference's smoke parameters and the port's copy, made once."""
    if arch not in _P:
        jc, tc = _cfgs(arch)
        if arch == "mobilenetv2":
            jp = jax.jit(JM.init_params, static_argnums=1)(
                jax.random.PRNGKey(0), jc)
            tp = mobilenet_params_from_jax(_np_tree(jp), device="cpu")
        elif jc.enc_dec:
            jp = jax.jit(JE.init_params, static_argnums=1)(
                jax.random.PRNGKey(0), jc)
            tp = params_from_jax(_np_tree(jp), tc, device="cpu")
        else:
            jp = jax.jit(JT.init_params, static_argnums=1)(
                jax.random.PRNGKey(0), jc)
            tp = params_from_jax(_np_tree(jp), tc, device="cpu")
        _P[arch] = (jp, tp)
    return _P[arch]


def _port_tree(tree, arch, tc):
    if arch == "mobilenetv2":
        return mobilenet_params_from_jax(_np_tree(tree), device="cpu")
    return params_from_jax(_np_tree(tree), tc, device="cpu")


def _batch(arch, jc, B=2, S=16):
    if arch == "mobilenetv2":
        return jpipe.image_batch(jpipe.DataConfig(seed=3, global_batch=4), 0,
                                 resolution=jc.resolution,
                                 n_classes=jc.n_classes)
    b = jpipe.lm_batch(jpipe.DataConfig(seed=3, vocab=jc.vocab, seq_len=S,
                                        global_batch=B), 0)
    if jc.enc_dec:
        b["frames"] = np.random.default_rng(0).standard_normal(
            (B, jc.enc_seq, jc.d_model)).astype(np.float32)
    return b


def _jloss(arch, jc):
    if arch == "mobilenetv2":
        return lambda p, b: JM.loss_fn(p, jc, b)
    if jc.enc_dec:
        return lambda p, b: JE.loss_fn(p, jc, b)
    return lambda p, b: JT.loss_fn(p, jc, b)


def _assert_grads_close(want_tree, got_tree, rtol=GRAD_RTOL,
                        floor=GRAD_FLOOR, tree_rel=None):
    paths, want = flatten(want_tree)
    got = flatten(got_tree)[1]
    gmax = max(float(w.abs().max()) for w in want if w.numel())
    for p, w, g in zip(paths, want, got, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, p
        err = float((w - g).abs().max()) if w.numel() else 0.0
        if tree_rel is not None:
            assert err <= tree_rel * gmax, (p, err, gmax)
        else:
            lim = rtol * (float(w.abs().max()) + floor * gmax)
            assert err <= lim, (p, err, lim)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,n_shards,shard",
                         [(0, 0, 1, 0), (7, 3, 2, 0), (7, 3, 2, 1),
                          (1, 10 ** 6, 4, 3)])
def test_lm_batch_bitwise(seed, step, n_shards, shard):
    kw = dict(seed=seed, vocab=512, seq_len=24, global_batch=8,
              n_shards=n_shards, shard=shard)
    want = jpipe.lm_batch(jpipe.DataConfig(**kw), step)
    got = tpipe.lm_batch(tpipe.DataConfig(**kw), step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,step,n_shards,shard,res,classes",
                         [(0, 0, 1, 0, 32, 10), (3, 5, 2, 1, 16, 1000)])
def test_image_batch_bitwise(seed, step, n_shards, shard, res, classes):
    kw = dict(seed=seed, global_batch=8, n_shards=n_shards, shard=shard)
    want = jpipe.image_batch(jpipe.DataConfig(**kw), step, resolution=res,
                             n_classes=classes)
    got = tpipe.image_batch(tpipe.DataConfig(**kw), step, resolution=res,
                            n_classes=classes)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


@pytest.mark.parametrize("kind", ["lm", "image"])
def test_iterate_bitwise(kind):
    kw = dict(seed=2, vocab=64, seq_len=8, global_batch=4)
    want = jpipe.iterate(jpipe.DataConfig(**kw), 5, kind)
    got = tpipe.iterate(tpipe.DataConfig(**kw), 5, kind)
    for _ in range(3):
        w, g = next(want), next(got)
        for k in w:
            np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]))


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw,n", [
    ("cosine", dict(peak_lr=3e-4, warmup=100, total=10_000), 10_005),
    ("cosine", dict(peak_lr=1e-3, warmup=2, total=12), 16),
    ("wsd", dict(peak_lr=1e-3, warmup=2, stable=6, decay=0), 16),
    ("wsd", dict(peak_lr=3e-4, warmup=100, stable=8_000, decay=1_000),
     10_005)])
def test_schedule_bitwise_at_every_step(name, kw, n):
    """Every step of the warmup, the stable or cosine part and the decay
    tail (and past the end), as a vector and as the 0-d int32 step
    counter a train step passes."""
    steps = np.arange(n, dtype=np.int32)
    want = np.asarray(jsched.make(name, **kw)(jnp.asarray(steps)))
    fn = tsched.make(name, **kw)
    got = fn(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # under jit XLA multiplies by the reciprocal of each constant divisor
    # and takes its own cos: a few ulps
    jit = np.asarray(jax.jit(jsched.make(name, **kw))(jnp.asarray(steps)))
    np.testing.assert_allclose(got.numpy(), jit, rtol=SCHED_JIT_RTOL)
    for s in (0, 1, kw["warmup"], n // 2, n - 1):
        one = fn(torch.tensor(s, dtype=torch.int32))
        assert one.dim() == 0 and _bits(one.numpy()) == _bits(want[s])


def _adam_inputs(seed=0):
    rng = np.random.default_rng(seed)
    p = {"a": rng.normal(size=(3, 64, 32)).astype(np.float32),
         "b": {"w": rng.normal(size=(128,)).astype(np.float32)}}
    g = {"a": (rng.normal(size=(3, 64, 32)) * 1e-2).astype(np.float32),
         "b": {"w": (rng.normal(size=(128,)) * 1e-3).astype(np.float32)}}
    return p, g


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("keep_master", [False, True])
@pytest.mark.parametrize("clip", [1e9, 0.1])
def test_adamw_update_matches_reference(keep_master, clip):
    p, g = _adam_inputs()
    jcfg = jadamw.AdamWConfig(grad_clip=clip)
    tcfg = tadamw.AdamWConfig(grad_clip=clip)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jadamw.init(jp, keep_master=keep_master)
    tp, ts = _t(p), tadamw.init(_t(p), keep_master=keep_master)
    jupd = jax.jit(jadamw.update, static_argnums=4)
    for _ in range(3):
        jp, js, jgn = jupd(jp, jax.tree_util.tree_map(jnp.asarray, g), js,
                           jnp.float32(1e-3), jcfg)
        tp, ts, tgn = tadamw.update(tp, _t(g), ts, torch.tensor(1e-3), tcfg)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    np.testing.assert_allclose(float(tgn), float(jgn), rtol=ADAM_RTOL)
    for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        for w, t in zip(jax.tree_util.tree_leaves(want), flatten(got)[1]):
            np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                       rtol=ADAM_RTOL, atol=1e-9)
    assert ("master" in ts) == keep_master


def test_adamw_donate_gives_the_same_values_in_place():
    p, g = _adam_inputs(1)
    want, wst, _ = tadamw.update(_t(p), _t(g), tadamw.init(_t(p)),
                                 torch.tensor(1e-3))
    tp = _t({"a": p["a"].copy(), "b": {"w": p["b"]["w"].copy()}})
    st = tadamw.init(tp)
    got, gst, _ = tadamw.update(tp, _t(g), st, torch.tensor(1e-3),
                                donate=True)
    assert got["a"] is tp["a"] and gst["m"]["a"] is st["m"]["a"]
    for w, t in zip(flatten((want, wst["m"], wst["v"]))[1],
                    flatten((got, gst["m"], gst["v"]))[1]):
        assert torch.equal(w, t)


def test_adamw_first_step_is_lr_times_sign():
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    cfg = tadamw.AdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                             grad_clip=1e9)
    new, st, _ = tadamw.update(p, g, tadamw.init(p), torch.tensor(0.01), cfg)
    np.testing.assert_allclose(new["w"].numpy(), p["w"].numpy() - 0.01
                               * np.sign(g["w"].numpy()), rtol=1e-4)
    assert int(st["step"]) == 1


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, g = _adam_inputs(2)
    jc, jgn = jadamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    tc, tgn = tadamw.clip_by_global_norm(_t(g), max_norm)
    np.testing.assert_allclose(float(tgn), float(jgn), rtol=ADAM_RTOL)
    for w, t in zip(jax.tree_util.tree_leaves(jc), flatten(tc)[1]):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=ADAM_RTOL)


# ---------------------------------------------------------------------------
# the QAT linear and the projection
# ---------------------------------------------------------------------------

def _fixed(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("cfg", ["W4", "A4", "W8", "A8"])
def test_fake_quant_bitwise(cfg):
    x = _fixed((4, 16, 64), 1)
    if cfg.startswith("A"):
        x = np.maximum(x, 0)
    with jax.disable_jit():
        want = jq.fake_quant(jnp.asarray(x), getattr(jq, cfg))
    got = tq.fake_quant(torch.from_numpy(x), getattr(tq, cfg))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_qat_linear_bitwise_and_straight_through():
    x, w = _fixed((2, 8, 64), 2), _fixed((64, 32), 3) * 0.1
    with jax.disable_jit():
        want = JL.linear({"w": jnp.asarray(w)}, jnp.asarray(x), "qat",
                         jnp.float32)
        jgx, jgw = jax.grad(lambda x, w: jnp.sum(JL.linear(
            {"w": w}, x, "qat", jnp.float32) ** 2), (0, 1))(
                jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = TL.linear({"w": tw}, tx, "qat", torch.float32)
    np.testing.assert_array_equal(_bits(got.detach().numpy()), _bits(want))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-6)


def test_jit_divides_by_the_reciprocal_where_the_port_divides():
    """Recorded divergence: inside ``jax.jit`` XLA turns ``amax / 7`` into
    ``amax * float32(1/7)``; the port, like the op-by-op reference, divides.
    On weights already on the W4 grid this moves codes sitting exactly on
    a .5 tie (ROADMAP §3)."""
    x = jnp.asarray(_fixed((64, 64), 4))
    eager = np.asarray(jq.compute_scale(x, jq.W4))
    jit = np.asarray(jax.jit(lambda v: jq.compute_scale(v, jq.W4))(x))
    port = tq.compute_scale(torch.from_numpy(np.asarray(x)), tq.W4).numpy()
    np.testing.assert_array_equal(_bits(port), _bits(eager))
    amax = np.abs(np.asarray(x)).max(0, keepdims=True)
    np.testing.assert_array_equal(
        _bits(jit), _bits(amax * np.float32(1 / 7)))


@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma2-2b",
                                  "qwen2-moe-a2.7b", "whisper-large-v3"])
def test_qat_project_shares_the_stacked_column_scale(arch):
    """The reference's projection of its stacked leaves == the port's
    ``qat_project`` of the per-layer leaves, bit for bit (run op by op on
    both sides: the division is the IEEE one)."""
    jp, tp = _params(arch)
    _, tc = _cfgs(arch)

    def proj(path, leaf):
        if jax.tree_util.keystr(path).endswith("['w']") and leaf.ndim >= 2:
            return jq.fake_quant(leaf, jq.W4)
        return leaf
    with jax.disable_jit():
        want = _port_tree(jax.tree_util.tree_map_with_path(proj, jp), arch,
                          tc)
    got = TS.qat_project(tp, tc)
    paths, w_leaves = flatten(want)
    moved = 0
    for p, w, g, before in zip(paths, w_leaves, flatten(got)[1],
                               flatten(tp)[1], strict=True):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()),
                                      err_msg=p)
        moved += int(not torch.equal(g, before))
    assert moved > 0


def test_qat_project_mobilenet_leaves_are_per_leaf():
    """MobileNetV2's leaves are not stacked: every ``['w']`` leaf (the
    HWIO convolutions and ``fc``) takes its own per-channel W4 scale, the
    batch-norm leaves and ``fc.b`` stay as they are."""
    _, tp = _params("mobilenetv2")
    tc = tconfigs.get_config("mobilenetv2", smoke=True, quant="qat")
    got = TS.qat_project(tp, tc)
    n = 0
    for p, g, x in zip(*flatten(got), flatten(tp)[1]):
        if p.endswith("['w']"):
            assert torch.equal(g, tq.fake_quant(x, tq.W4)), p
            n += 1
        else:
            assert g is x, p
    assert n == 53


def test_qat_project_scale_is_not_per_layer():
    """Two layers of minicpm's pattern share each column's scale: a
    per-layer scale gives other weights."""
    _, tp = _params("minicpm-2b")
    _, tc = _cfgs("minicpm-2b")
    got = TS.qat_project(tp, tc)["blocks"]
    naive = [tq.fake_quant(b["attn"]["wq"]["w"], tq.W4)
             for b in tp["blocks"]]
    assert len(naive) == 2
    assert any(not torch.equal(n, g["attn"]["wq"]["w"])
               for n, g in zip(naive, got))
    donated = TS.qat_project(jax.tree_util.tree_map(torch.clone, tp), tc,
                             donate=True)
    for a, b in zip(flatten(got)[1], flatten(donated)[1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# loss functions and gradients
# ---------------------------------------------------------------------------

def _loss_and_grads(arch, quant):
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch, quant)
    b = _batch(arch, jc)
    jl, jg = jax.jit(jax.value_and_grad(_jloss(arch, jc)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = TS.value_and_grad(TS.loss_for(tc), tp, TS.to_device(b, "cpu"))
    return float(jl), _port_tree(jg, arch, tc), float(tl), tg


@pytest.mark.parametrize("quant", ["none", "qat"])
@pytest.mark.parametrize("arch", LMS + ["whisper-large-v3"])
def test_loss_and_grads_match_reference(arch, quant):
    jl, jg, tl, tg = _loss_and_grads(arch, quant)
    qat = quant == "qat"
    np.testing.assert_allclose(tl, jl, rtol=QAT_LOSS_RTOL if qat
                               else LOSS_RTOL)
    _assert_grads_close(jg, tg, rtol=QAT_GRAD_RTOL if qat else GRAD_RTOL)


@pytest.mark.parametrize("quant", ["none", "qat"])
def test_mobilenet_loss_and_grads_match_reference(quant):
    jl, jg, tl, tg = _loss_and_grads("mobilenetv2", quant)
    if quant == "none":
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        _assert_grads_close(jg, tg)
    else:
        np.testing.assert_allclose(tl, jl, rtol=MB_QAT_LOSS_RTOL)
        _assert_grads_close(jg, tg, tree_rel=MB_QAT_GRAD)


def test_zamba2_grads_are_nan_where_the_reference_s_are():
    """Recorded reference fault (ROADMAP §3): the Mamba2 SSD's backward
    gives NaN gradients on zamba2's smoke config; the port reproduces them
    leaf for leaf and element for element, and is finite elsewhere."""
    jl, jg, tl, tg = _loss_and_grads("zamba2-2.7b", "none")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    n_nan = 0
    for p, w, g in zip(*flatten(jg), flatten(tg)[1]):
        assert torch.equal(torch.isnan(w), torch.isnan(g)), p
        n_nan += int(torch.isnan(w).sum())
    assert n_nan > 0


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", LMS)
def test_remat_variants_are_bitwise_equal(arch):
    """``remat`` "full", "dots" and "none" give the same loss and
    gradients bit for bit; in the backward, "full" recomputes the
    forward's 2-D matrix products and "dots" does not."""
    _, tp = _params(arch)
    out, mms = {}, {}
    for remat in ("none", "full", "dots"):
        _, tc = _cfgs(arch, "qat")
        tc = dataclasses.replace(tc, remat=remat)
        b = TS.to_device(_batch(arch, tc), "cpu")
        leaves = [x.detach().requires_grad_(True) for x in flatten(tp)[1]]
        tree = unflatten(tp, leaves)
        loss = TT.loss_fn(tree, tc, b)
        mode = _CountMM()
        with mode:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        out[remat], mms[remat] = (loss, grads), mode.mm
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    assert mms["full"] > mms["none"] == mms["dots"]


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "qat_project", "micro2",
                                     "bf16_params"])
def test_train_step_matches_reference(variant):
    quant = "qat" if variant == "qat_project" else "none"
    kw = {"plain": {}, "qat_project": dict(qat_project=True),
          "micro2": dict(n_microbatches=2),
          "bf16_params": dict(bf16_params=True)}[variant]
    arch = "minicpm-2b"
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch, quant)
    common = dict(total_steps=12, peak_lr=1e-3, warmup=0, schedule="wsd")
    jt = JS.TrainConfig(**common, **kw)
    tt = TS.TrainConfig(**common, **kw)
    b = _batch(arch, jc, B=4)
    js = JS.init_state(jp, bf16_params=jt.bf16_params)
    js, jm = jax.jit(JS.make_train_step(jc, jt))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    ts = TS.init_state(jax.tree_util.tree_map(torch.clone, tp),
                       bf16_params=tt.bf16_params)
    ts, tm = TS.make_train_step(tc, tt)(ts, b)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]),
                               rtol=1e-3 if tt.bf16_params else 1e-6)
    assert _bits(tm["lr"].numpy()) == _bits(jm["lr"])
    assert int(ts["opt"]["step"]) == 1
    if tt.bf16_params:
        want = _port_tree(jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), js["params"]), arch, tc)
        for p, w, g in zip(*flatten(want), flatten(ts["params"])[1]):
            assert g.dtype == torch.bfloat16, p
            ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                          - 7)
            assert bool(((g.float() - w).abs() <= ulp).all()), p
        want = _port_tree(js["opt"]["master"], arch, tc)
        got = ts["opt"]["master"]
    else:
        want = _port_tree(js["params"], arch, tc)
        got = ts["params"]
    for p, w, g in zip(*flatten(want), flatten(got)[1]):
        assert g.dtype == torch.float32, p
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=p)
    for name in ("m", "v"):
        # bf16 gradients: an element's rounding may differ by a bf16 ulp
        _assert_grads_close(_port_tree(js["opt"][name], arch, tc),
                            ts["opt"][name],
                            rtol=1e-2 if tt.bf16_params else GRAD_RTOL)
