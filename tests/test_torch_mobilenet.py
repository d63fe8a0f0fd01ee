"""Port vs reference: MobileNetV2 (``models/mobilenet``) at the smoke config
(width 0.25, 32x32, 10 classes), from the reference's own weights
(``convert.mobilenet_params_from_jax``).

Tolerances and why:

* float forward and ``loss_fn``: max |diff| <= 1e-4 x max |logit|.  Both
  run 52 float32 convolutions with other summation orders (XLA vs ATen's
  CPU convolution); each conv output differs in the last ulp or two.
* QAT: every layer fed the reference's own input gives conv outputs within
  1e-5 relative and, from the reference's conv output, BN + ReLU6 +
  fake-quant bitwise.  End to end a last-ulp difference can move an
  activation code across a rounding boundary (one step of amax/15), so the
  whole QAT forward is held only to finite logits of the right shape and
  top-1 agreement on most images.
* streamlined pointwise stages: integer codes exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import streamline as jst
from repro.core import thresholds as jth
from repro.core.quantization import A4 as JA4
from repro.core.quantization import quantize as jquantize
from repro.models import mobilenet as jm
from repro_torch.configs import get_config
from repro_torch.convert import mobilenet_params_from_jax
from repro_torch.core import streamline as tst
from repro_torch.core import thresholds as tth
from repro_torch.core.quantization import A4, quantize
from repro_torch.models import mobilenet as tm

from _torch_threads import one_torch_thread  # noqa: F401

FLOAT_RTOL = 1e-4


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("mobilenetv2", smoke=True)
    tcfg = get_config("mobilenetv2", smoke=True)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    # BN statistics away from identity, so the folded affine is exercised
    rng = np.random.default_rng(5)
    for name, p in params.items():
        if name == "fc":
            continue
        C = p["bn_gamma"].shape[0]
        p["bn_gamma"] = jnp.asarray(rng.uniform(0.5, 1.5, C), jnp.float32)
        p["bn_beta"] = jnp.asarray(rng.normal(0, 0.2, C), jnp.float32)
        p["bn_mean"] = jnp.asarray(rng.normal(0, 0.1, C), jnp.float32)
        p["bn_var"] = jnp.asarray(rng.uniform(0.5, 1.5, C), jnp.float32)
    tree = jax.tree_util.tree_map(np.array, params)
    tparams = mobilenet_params_from_jax(tree, device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    return jcfg, tcfg, params, tparams, x


@pytest.mark.parametrize("smoke_cfg", [True, False])
def test_conv_shapes_match_reference(smoke_cfg):
    jl = jm._conv_shapes(jget_config("mobilenetv2", smoke=smoke_cfg))
    tl = tm._conv_shapes(get_config("mobilenetv2", smoke=smoke_cfg))
    assert tl == jl
    layers = tl[0]
    assert sum(k == 1 for _, _, _, k, _, _, _ in layers) == 34
    assert len(layers) == 52


def test_init_params_shapes_match_reference(smoke):
    jcfg, tcfg, params, _, _ = smoke
    got = tm.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert set(got) == set(params)
    for name, p in params.items():
        for k, v in p.items():
            assert tuple(got[name][k].shape) == v.shape, (name, k)
            assert got[name][k].dtype == torch.float32


@pytest.mark.parametrize("size", [7, 8, 9, 16])
@pytest.mark.parametrize("depthwise", [False, True])
def test_stride2_same_padding_matches_xla(size, depthwise):
    """XLA pads (0, 1) at stride 2 on an even size, (1, 1) on an odd one;
    ``conv2d(padding=1)`` would pad (1, 1) always."""
    rng = np.random.default_rng(size)
    C = 4
    x = rng.standard_normal((2, size, size, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1 if depthwise else C, 6 if not depthwise
                             else C)).astype(np.float32)
    want = jm._conv({"w": jnp.asarray(w)}, jnp.asarray(x), 3, 2, depthwise,
                    None, False)
    got = tm._conv({"w": torch.from_numpy(w)}, torch.from_numpy(x), 3, 2,
                   depthwise, None, False)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert tm.same_padding(size, 3, 2) == ((0, 1) if size % 2 == 0
                                           else (1, 1))


def _max_rel(got, want):
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_float_forward_matches_reference(smoke):
    jcfg, tcfg, params, tparams, x = smoke
    want = jm.forward(params, jcfg, jnp.asarray(x), train_qat=False)
    got = tm.forward(tparams, tcfg, torch.from_numpy(x), train_qat=False)
    assert tuple(got.shape) == want.shape == (4, 10)
    assert _max_rel(got.numpy(), want) <= FLOAT_RTOL


def test_loss_fn_matches_reference(smoke):
    jcfg, tcfg, params, tparams, x = smoke
    labels = np.array([1, 7, 3, 0], np.int32)
    jc = dataclasses.replace(jcfg, quant="none")
    tc = dataclasses.replace(tcfg, quant="none")
    want = jm.loss_fn(params, jc, {"images": jnp.asarray(x),
                                   "labels": jnp.asarray(labels)})
    got = tm.loss_fn(tparams, tc, {"images": torch.from_numpy(x),
                                   "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=FLOAT_RTOL)


def _reference_walk(params, cfg, x, train_qat):
    """(name, layer input, conv output, layer output) of every conv of the
    reference forward, in order."""
    fb, ib = cfg.first_last_bits, cfg.inner_bits
    out = []
    h = jnp.asarray(x)
    inp = block = None
    for name, _, _, k, s, dw, _ in jm._conv_shapes(cfg)[0]:
        p = params[name]
        if name not in ("stem", "head") and name.rsplit("_", 1)[0] != block:
            block, inp = name.rsplit("_", 1)[0], h      # a block's input
        bits = fb if name in ("stem", "head") else ib
        c = jm._conv(p, h, k, s, dw, bits, train_qat)
        if name.endswith("project"):
            y = jm._bn_only(p, c)
            if inp.shape == y.shape:
                y = y + inp
        else:
            y = jm._bn_relu6(p, c, bits, train_qat)
        out.append((name, h, c, y))
        h = y
    return out


def test_qat_layers_match_reference(smoke):
    jcfg, tcfg, params, tparams, x = smoke
    fb, ib = jcfg.first_last_bits, jcfg.inner_bits
    shapes = {n: (k, s, dw)
              for n, _, _, k, s, dw, _ in jm._conv_shapes(jcfg)[0]}
    for name, h, c, y in _reference_walk(params, jcfg, x, train_qat=True):
        k, s, dw = shapes[name]
        bits = fb if name in ("stem", "head") else ib
        got_c = tm._conv(tparams[name], torch.from_numpy(np.array(h)), k, s,
                         dw, bits, True)
        assert _max_rel(got_c.numpy(), c) <= 1e-5, name
        tc = torch.from_numpy(np.array(c))
        if name.endswith("project"):
            got_y = tm._bn_only(tparams[name], tc)
            want_y = jm._bn_only(params[name], c)
        else:
            got_y = tm._bn_relu6(tparams[name], tc, bits, True)
            want_y = y
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y),
                                      err_msg=name)


def test_qat_forward_end_to_end(smoke):
    jcfg, tcfg, params, tparams, x = smoke
    want = np.asarray(jm.forward(params, jcfg, jnp.asarray(x)))
    got = tm.forward(tparams, tcfg, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75


def test_streamlined_pointwise_stages_match_reference(smoke):
    """Every pointwise conv of the smoke model as an integer stage in both
    packages: the same input codes (the reference's float activation,
    quantized with the ReLU6-cap scale 6/15 by each package), the same
    thresholds, the same output codes."""
    jcfg, _, params, tparams, x = smoke
    scale = 6.0 / 15
    n = 0
    for name, h, _, _ in _reference_walk(params, jcfg, x, train_qat=False):
        if params[name]["w"].shape[:2] != (1, 1):
            continue
        n += 1
        hn = np.array(h).reshape(-1, h.shape[-1])
        jcodes = jquantize(jnp.asarray(hn), jnp.float32(scale), 0, JA4)
        tcodes = quantize(torch.from_numpy(hn), torch.tensor(scale), 0, A4)
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        p, tp = params[name], tparams[name]
        jbn = jth.BNParams(p["bn_gamma"], p["bn_beta"], p["bn_mean"],
                           p["bn_var"])
        tbn = tth.BNParams(tp["bn_gamma"], tp["bn_beta"], tp["bn_mean"],
                           tp["bn_var"])
        js = jst.streamline_stage(p["w"][0, 0], jbn, jnp.float32(scale))
        ts = tst.streamline_stage(tp["w"][0, 0], tbn, torch.tensor(scale))
        np.testing.assert_array_equal(ts.thresholds.numpy(),
                                      np.asarray(js.thresholds))
        want = jst.integer_stage_forward(js, jcodes, backend="ref")
        got = tst.integer_stage_forward(ts, tcodes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        fref = tst.float_stage_reference(tp["w"][0, 0], tbn,
                                         torch.tensor(scale), tcodes)
        assert int((got - fref).abs().max()) <= 1, name
    assert n == 34
