"""Port vs reference, the decoder variants no public decoder config selects:
the qwen2-7b smoke config without rotary embeddings (``rope_mode="none"``),
with the plain GELU MLP (``mlp="gelu"``, whisper's ``wo(gelu_tanh(wi
x))``), and with both beside an int8 KV cache, float32 compute, plain
kernel versions.

* ``init_params`` gives a GELU block ``wi`` and ``wo`` only, as the
  reference's;
* ``forward``, ``prefill`` and twelve ``decode_step`` calls (a late and a
  free row) within 1e-5 of the reference's logits, float and ``w4a4_lut``;
* the Scheduler's transcripts equal the reference's, dense and paged, in
  ``w4a4_lut`` (3 staggered requests of 5, 12 and 20 tokens on 2 slots).
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
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.configs import BlockSpec
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import transformer as TT

from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "qwen2-7b"
VARIANTS = {"rope_none": dict(rope_mode="none"),
            "gelu": dict(mlp="gelu"),
            "both_int8": dict(rope_mode="none", mlp="gelu", kv_quant="int8")}
TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 64
LAYOUTS = {"dense": {}, "paged": dict(paged=True, page_size=4)}
LENS = [5, 12, 20]
BUDGETS = [6, 5, 4]
J_FORWARD = jax.jit(JT.forward, static_argnums=1)
J_PREFILL = jax.jit(JT.prefill, static_argnums=1)
J_DECODE = jax.jit(JT.decode_step, static_argnums=1)


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _cfg(mod, variant, quant="none"):
    over = dict(VARIANTS[variant])
    mlp = over.pop("mlp", None)
    cfg = dataclasses.replace(mod.get_config(ARCH, smoke=True, quant=quant),
                              compute_dtype="float32", **over)
    if mlp is not None:
        spec = JT.BlockSpec if mod is jconfigs else BlockSpec
        cfg = dataclasses.replace(cfg, pattern=(spec(mlp=mlp),))
    return cfg


_P = {}


def _params(variant, quant="none"):
    """The reference's float32 parameters (quantized by the reference for
    ``quant``) and the port's copy, made once."""
    if (variant, quant) not in _P:
        if quant == "none":
            jp = JT.init_params(jax.random.PRNGKey(0),
                                _cfg(jconfigs, variant))
        else:
            jp = jquantize(_params(variant)[0], quant)
        _P[variant, quant] = (jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), _cfg(tconfigs, variant),
            device="cpu"))
    return _P[variant, quant]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_is_supported_and_inits_the_reference_leaves(variant):
    tcfg = _cfg(tconfigs, variant)
    TT.check_supported(tcfg)
    tp = TT.init_params(tcfg, 0, "cpu")
    jp, _ = _params(variant)
    want = set(jp["blocks"][0]["mlp"])
    assert set(tp["blocks"][0]["mlp"]) == want
    gelu = VARIANTS[variant].get("mlp") == "gelu"
    assert want == ({"wi", "wo"} if gelu else {"wi", "wg", "wo"})


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_prefill_and_decode_match_reference(variant, quant):
    jp, tp = _params(variant, quant)
    jcfg, tcfg = _cfg(jconfigs, variant, quant), _cfg(tconfigs, variant,
                                                      quant)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (3, 9)).astype(np.int32)
    want, _ = J_FORWARD(jp, jcfg, jnp.asarray(toks))
    got, _ = TT.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    want, _ = J_PREFILL(jp, jcfg, jnp.asarray(toks))
    got, _ = TT.prefill(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    B, T = 3, 16
    jc = JT.init_cache(jcfg, B, T)
    tc = TT.init_cache(tcfg, B, T, device="cpu")
    steps = rng.integers(0, 512, (12, B)).astype(np.int32)
    for i in range(12):
        pos = np.array([i, i - 4 if i >= 4 else -1, -1], np.int32)
        want, jc = J_DECODE(jp, jcfg, jnp.asarray(steps[i]), jc,
                            jnp.asarray(pos))
        got, tc = TT.decode_step(tp, tcfg, torch.from_numpy(steps[i]), tc,
                                 torch.from_numpy(pos))
        rows = pos >= 0
        np.testing.assert_allclose(_np(got)[rows], np.asarray(want)[rows],
                                   **TOL)
    assert ("k_scale" in tc[0]) == (tcfg.kv_quant == "int8")


def _transcripts(pkg, variant, layout):
    mod, cfgs = (jserve, jconfigs) if pkg == "j" else (tserve, tconfigs)
    params = _params(variant, "w4a4_lut")[0 if pkg == "j" else 1]
    kw = dict(device="cpu") if pkg == "t" else {}
    eng = mod.make_engine(params, _cfg(cfgs, variant, "w4a4_lut"),
                          mod.ServeConfig(quant="w4a4_lut", max_len=MAX_LEN,
                                          **LAYOUTS[layout]), **kw)
    sched = mod.Scheduler(eng, slots=2, chunk=2)
    rng = np.random.default_rng(1)
    reqs = [mod.Request(prompt=rng.integers(0, 512, L).tolist(),
                        max_new_tokens=b) for L, b in zip(LENS, BUDGETS)]
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    while sched.has_work:
        sched.step()
    return sched, [(r.finish_reason, list(r.tokens)) for r in reqs]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_scheduler_transcripts_equal_reference(variant, layout):
    jsched, want = _transcripts("j", variant, layout)
    tsched, got = _transcripts("t", variant, layout)
    assert got == want
    assert [len(t) for _, t in got] == BUDGETS
    for k in ("rounds", "admission_rounds", "admitted_tokens",
              "emitted_tokens"):
        assert tsched.stats[k] == jsched.stats[k], k
