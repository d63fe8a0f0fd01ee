"""Port vs reference, serving the MoE family on the CPU: qwen2-moe-a2.7b
(global dispatch, a shared expert) and mixtral-8x22b (local attention,
``norm_topk``) at their smoke configs, float32 compute, plain kernel
versions.

* ``forward`` (logits and the summed aux), ``prefill`` and ``decode_step``
  (the deterministic capacity of a batch with a free slot, at the drop-free
  smoke capacity factor and at 1.25) within 1e-5 of the reference's;
* the Scheduler's greedy transcripts and counters equal the reference's in
  ``w4a4_lut`` (and ``w4a4_tmac`` on qwen2-moe), each package quantizing
  the same float tree itself, on seeded traffic with mixed lengths, free
  slots, an EOS and mixtral's prompts past the window: every admission is
  monolithic, a dispatch per equal-length run, its dummy rows routed with
  the live ones;
* within the port: paged == dense, and the refusals (speculative decoding,
  the verify forward, SSM blocks with an int8 cache, enc-dec blocks, MoE
  with an int8 cache).
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

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]
ATOL = 1e-5                   # float32 sums in other orders
MAX_LEN = 32
LENS = [6, 3, 9, 1, 7, 6, 12]     # mixtral's window is 8: 9 and 12 wrap
BUDGETS = [5, 6, 4, 3, 6, 7, 5]


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _cfg(mod, arch, quant="none", cf=None):
    cfg = dataclasses.replace(mod.get_config(arch, smoke=True, quant=quant),
                              compute_dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


_P = {}


def _params(arch):
    """The reference's float32 smoke parameters and the port's copy."""
    if arch not in _P:
        jp = JT.init_params(jax.random.PRNGKey(0), _cfg(jconfigs, arch))
        _P[arch] = (jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), _cfg(tconfigs, arch),
            device="cpu"))
    return _P[arch]


def _served(arch, quant):
    jp, _ = _params(arch)
    if quant == "none":
        return jp, _params(arch)[1]
    jq = jquantize(jp, quant)
    return jq, params_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                               _cfg(tconfigs, arch), device="cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("quant", ["none", "w4a4_lut"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, quant):
    jp, tp = _served(arch, quant)
    jc, tc = _cfg(jconfigs, arch, quant), _cfg(tconfigs, arch, quant)
    toks = _tokens(3, 12)
    lw, aw = JT.forward(jp, jc, jnp.asarray(toks))
    lt, at = TT.forward(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), rtol=0,
                               atol=ATOL)
    assert float(at) > 0
    np.testing.assert_allclose(float(at), float(aw), rtol=1e-6)
    lw, _ = JT.prefill(jp, jc, jnp.asarray(toks))
    lt, _ = TT.prefill(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("cf", [None, 1.25], ids=["smoke", "cf1.25"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, cf):
    """Prefill four rows of 6 tokens, free row 2 (negative position), then
    decode six steps (mixtral's ring of 8 wraps): every row routes, the
    free one too, under the reference's deterministic capacity."""
    jp, tp = _served(arch, "w4a4_lut")
    jc = _cfg(jconfigs, arch, "w4a4_lut", cf)
    tc = _cfg(tconfigs, arch, "w4a4_lut", cf)
    B, S = 4, 6
    toks = _tokens(B, S, seed=1)
    jeng = jserve.make_engine(jp, jc, jserve.ServeConfig(max_len=MAX_LEN))
    teng = tserve.make_engine(tp, tc, tserve.ServeConfig(max_len=MAX_LEN),
                              device="cpu")
    lw, jcache = JT.prefill(jp, jc, jnp.asarray(toks), full_kv=True)
    jcache = jeng._grow_cache(jcache, S)
    lt, tcache = TT.prefill(tp, tc, torch.from_numpy(toks))
    tcache = teng._grow_cache(tcache, S)
    pos = np.full((B,), S, np.int32)
    pos[2] = -1
    tok = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)
    for step in range(6):
        lw, jcache = JT.decode_step(jp, jc, jnp.asarray(tok), jcache,
                                    jnp.asarray(pos))
        lt, tcache = TT.decode_step(tp, tc, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lw), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)


def _traffic(mod, eos_of: dict):
    rng = np.random.default_rng(3)
    reqs = [mod.Request(prompt=rng.integers(0, 512, L).tolist(),
                        max_new_tokens=b) for L, b in zip(LENS, BUDGETS)]
    for i, eos in eos_of.items():
        reqs[i].eos_id = eos
    return reqs


def _serve(pkg, arch, quant, cf=None, paged=False, eos_of=None, params=None):
    mod, cfgs = (jserve, jconfigs) if pkg == "j" else (tserve, tconfigs)
    cfg = _cfg(cfgs, arch, quant, cf)
    if params is None:
        params = _params(arch)[0 if pkg == "j" else 1]
    kw = dict(device="cpu") if pkg == "t" else {}
    eng = mod.make_engine(params, cfg, mod.ServeConfig(
        quant=quant, max_len=MAX_LEN, paged=paged, page_size=4), **kw)
    assert eng.requires_monolithic_admission
    sched = mod.Scheduler(eng, slots=3, chunk=2)
    reqs = _traffic(mod, eos_of or {})
    for r in reqs[:2]:
        sched.submit(r)
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    while sched.has_work:
        sched.step()
    return sched, [(r.finish_reason, list(r.tokens)) for r in reqs]


SCHED_CASES = [("qwen2-moe-a2.7b", "w4a4_lut", None),
               ("qwen2-moe-a2.7b", "w4a4_lut", 1.25),
               ("qwen2-moe-a2.7b", "w4a4_tmac", None),
               ("mixtral-8x22b", "w4a4_lut", None)]


@pytest.mark.parametrize("arch,quant,cf", SCHED_CASES,
                         ids=["qwen-lut", "qwen-lut-cf1.25", "qwen-tmac",
                              "mixtral-lut"])
def test_scheduler_transcripts_equal_reference(arch, quant, cf):
    # an EOS that request 1 meets at its third token (found by the port's
    # own run without one), so the traffic ends a request early
    _, plain = _serve("t", arch, quant, cf)
    eos_of = {1: plain[1][1][2]}
    jsched, want = _serve("j", arch, quant, cf, eos_of=eos_of)
    tsched, got = _serve("t", arch, quant, cf, eos_of=eos_of)
    assert got == want
    assert got[1][0] == "eos"
    for k in ("rounds", "admission_rounds", "prefill_tokens",
              "admitted_tokens", "emitted_tokens"):
        assert tsched.stats[k] == jsched.stats[k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_equals_dense(arch):
    _, dense = _serve("t", arch, "w4a4_lut")
    tsched, paged = _serve("t", arch, "w4a4_lut", paged=True)
    assert paged == dense
    pool = tsched.engine.pool
    assert pool.allocated_pages == 0 and not pool.leaked_pages()


def test_spec_decode_and_verify_refuse_moe_as_the_reference_does():
    arch = "qwen2-moe-a2.7b"
    for mod, cfgs, kw in ((jserve, jconfigs, {}),
                          (tserve, tconfigs, dict(device="cpu"))):
        cfg = _cfg(cfgs, arch, "w4a4_tmac")
        params = _params(arch)[0 if mod is jserve else 1]
        with pytest.raises(ValueError, match="MoE routing"):
            mod.make_engine(params, cfg, mod.ServeConfig(
                quant="w4a4_tmac", max_len=MAX_LEN, spec_decode=True), **kw)
    tc = _cfg(tconfigs, arch)
    cache = TT.init_cache(tc, 2, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="speculative decoding supports"):
        TT.verify_step(_params(arch)[1], tc, torch.zeros((2, 3), dtype=torch
                       .int32), cache, torch.zeros((2,), dtype=torch.int32))


def test_check_supported_still_refuses_ssm_encdec_and_int8_moe():
    """Enc-dec and an MoE block without its config are still refused; an
    int8 KV cache beside MoE or recurrent blocks is served now (full and
    smoke configs, ``tests/test_torch_int8_families.py``)."""
    base = tconfigs.get_config("qwen2-moe-a2.7b", smoke=True)
    TT.check_supported(base)
    for bad, what in (
            (dict(enc_dec=True), "enc_dec"),
            (dict(moe=None), "MoEConfig")):
        with pytest.raises(NotImplementedError, match=what):
            TT.check_supported(dataclasses.replace(base, **bad))
    TT.check_supported(dataclasses.replace(
        base, pattern=(BlockSpec(kind="mamba2", mlp="none"),),
        kv_quant="int8"))
    for arch in ARCHS:
        for smoke in (False, True):
            TT.check_supported(dataclasses.replace(
                tconfigs.get_config(arch, smoke=smoke), kv_quant="int8"))
