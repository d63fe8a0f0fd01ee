"""Port vs reference: the quantization primitives of ``core/quantization``
(paper Eq. (4)/(5), QAT fake-quant, the post-update projection).

Codes, scales and fake-quantized values are held bitwise for W4/A4/W8/A8,
per channel and per tensor, on 2-D and NHWC inputs, including values on the
.5 rounding boundaries and A8 codes above 127 (XLA's cast to int8
saturates; the port's must too).  ``quant_error`` is a mean, whose float32
summation order differs between XLA and ATen: it is held to 1e-6 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro_torch.core import quantization as tq

from _torch_threads import one_torch_thread  # noqa: F401

CFGS = {"W4": (jq.W4, tq.W4), "A4": (jq.A4, tq.A4), "W8": (jq.W8, tq.W8),
        "A8": (jq.A8, tq.A8)}
SHAPES = {"2d": (16, 24), "nhwc": (2, 5, 5, 8)}


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2.5).astype(np.float32)


def _cfgs(name, per_channel):
    j, t = CFGS[name]
    return (dataclasses.replace(j, per_channel=per_channel),
            dataclasses.replace(t, per_channel=per_channel))


def _same(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
    assert t.detach().numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("name", sorted(CFGS))
def test_quant_config_levels(name):
    j, t = CFGS[name]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.qmin, t.qmax, t.n_levels) == (j.qmin, j.qmax, j.n_levels)
    narrow_j = dataclasses.replace(j, narrow_range=True)
    narrow_t = dataclasses.replace(t, narrow_range=True)
    assert (narrow_t.qmin, narrow_t.n_levels) == (narrow_j.qmin,
                                                  narrow_j.n_levels)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_primitives_bitwise(name, per_channel, shape):
    jc, tc = _cfgs(name, per_channel)
    x = _x(SHAPES[shape], seed=len(name) + per_channel)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    sj, st = jq.compute_scale(xj, jc), tq.compute_scale(xt, tc)
    _same(st, sj)
    qj, qt = jq.quantize(xj, sj, 0, jc), tq.quantize(xt, st, 0, tc)
    _same(qt, qj)
    _same(tq.dequantize(qt, st), jq.dequantize(qj, sj))
    _same(tq.fake_quant(xt, tc), jq.fake_quant(xj, jc))
    pj, pt = jq.quantize_pair(xj, jc), tq.quantize_pair(xt, tc)
    _same(pt[0], pj[0])
    _same(pt[1], pj[1])
    np.testing.assert_allclose(float(tq.quant_error(xt, tc)),
                               float(jq.quant_error(xj, jc)), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_half_boundaries_round_to_even(name):
    """Values whose x / scale lands exactly on k + 0.5 (the scale a power
    of two, so the division is exact) round half to even in both."""
    jc, tc = CFGS[name]
    ks = np.arange(-300, 300, dtype=np.float32)
    x = ((ks + 0.5) * 0.25).astype(np.float32).reshape(1, -1)
    scale = np.float32(0.25)
    _same(tq.quantize(torch.from_numpy(x), torch.tensor(scale), 0, tc),
          jq.quantize(jnp.asarray(x), jnp.asarray(scale), 0, jc))
    # the same with a Python-number scale and a tensor zero point
    _same(tq.quantize(torch.from_numpy(x), 0.25, torch.tensor(1.0), tc),
          jq.quantize(jnp.asarray(x), 0.25, jnp.float32(1.0), jc))


def test_a8_codes_saturate_like_xla():
    """A8 is uint8 but its codes are cast to int8: XLA saturates 128..255
    at 127, a plain PyTorch cast would wrap them negative."""
    x = np.linspace(0.0, 6.0, 64, dtype=np.float32).reshape(4, 16)
    qj = jq.quantize(jnp.asarray(x), jnp.float32(6.0 / 255), 0, jq.A8)
    qt = tq.quantize(torch.from_numpy(x), torch.tensor(6.0 / 255), 0, tq.A8)
    _same(qt, qj)
    assert int(qt.max()) == 127 and int(qt.min()) == 0


def test_fake_quant_is_straight_through():
    x = torch.from_numpy(_x((4, 6), seed=9)).requires_grad_(True)
    y = tq.fake_quant(x, tq.W4)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_project_params_bitwise():
    rng = np.random.default_rng(4)
    tree = {"conv": {"w": rng.standard_normal((3, 3, 4, 8))
                     .astype(np.float32),
                     "b": rng.standard_normal(8).astype(np.float32)},
            "fc": [rng.standard_normal((8, 5)).astype(np.float32)]}
    jspec = {"conv": {"w": jq.W4, "b": None}, "fc": [jq.W8]}
    tspec = {"conv": {"w": tq.W4, "b": None}, "fc": [tq.W8]}
    want = jq.project_params({"conv": {k: jnp.asarray(v) for k, v in
                                       tree["conv"].items()},
                              "fc": [jnp.asarray(tree["fc"][0])]}, jspec)
    got = tq.project_params({"conv": {k: torch.from_numpy(v) for k, v in
                                      tree["conv"].items()},
                             "fc": [torch.from_numpy(tree["fc"][0])]}, tspec)
    _same(got["conv"]["w"], want["conv"]["w"])
    _same(got["conv"]["b"], want["conv"]["b"])
    _same(got["fc"][0], want["fc"][0])
    assert torch.equal(got["conv"]["b"], torch.from_numpy(tree["conv"]["b"]))
