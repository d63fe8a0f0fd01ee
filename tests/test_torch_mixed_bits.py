"""Mixed per-leaf weight widths in the port against the reference:
``quantize_params_for_serving(..., bits_plan=)``, ``init_served_params``
under a plan, the one-hot sub-4-bit leaf, the pickers
(``pick_formulation``, ``pick_variant``, ``set_autotune``), a mixed-plan
forward, the Scheduler, and ``ShardedEngine`` with a plan on a 2-process
gloo mesh.

Plans come from both packages' ``plan_mixed_bits`` (the reference's on its
tree after ``jax.tree_util.tree_map``, the port's on its own tree) and the
quantized trees are compared bitwise after ``convert.params_from_jax``.
Logits agree at ``atol=rtol=1e-5`` in float32 (the integer sums are exact;
XLA and ATen order the float reductions differently), as the port's other
serving tests.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.kernels.lutmul import ops as jops
from repro.models import transformer as JT
from repro.roofline import analysis as janalysis
from repro.serve import quantize as jquant
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.convert import params_from_jax
from repro_torch.dist.mesh import ServingMesh
from repro_torch.kernels.lutmul import kernel, ops
from repro_torch.models import transformer as TT
from repro_torch.roofline import analysis as tanalysis
from repro_torch.serve import quantize as tquant
from repro_torch.serve.sharded import ShardedEngine, launch

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 32
WORLD_S = 90


@pytest.fixture(autouse=True)
def _reset_dispatch():
    yield
    ops.set_backend(None)
    ops.set_variant(None)
    ops.set_autotune(None)


def _cfgs(arch: str, quant: str):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True,
                                                quant=quant),
                            compute_dtype="float32")
    return j, t


_FLOAT = {}


def _float(arch: str):
    """The reference's seed-0 float tree (through ``tree_map``: sorted
    dicts) and the port's copy of it."""
    if arch not in _FLOAT:
        jcfg, tcfg = _cfgs(arch, "none")
        jp = jax.tree_util.tree_map(
            np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
        _FLOAT[arch] = jp, params_from_jax(jp, tcfg, device="cpu")
    return _FLOAT[arch]


def _plans(arch: str, target: float):
    jp, tp = _float(arch)
    _, tcfg = _cfgs(arch, "none")
    return (janalysis.plan_mixed_bits(jp, target),
            tanalysis.plan_mixed_bits(tp, target, tcfg))


def _ref_quantized(arch: str, target: float, mode: str):
    jp, _ = _float(arch)
    jplan, _ = _plans(arch, target)
    jq = jquant.quantize_params_for_serving(jp, mode=mode, bits_plan=jplan)
    _, tcfg = _cfgs(arch, mode)
    return jq, params_from_jax(jax.tree_util.tree_map(np.asarray, jq), tcfg,
                               device="cpu")


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _at(tree, keys):
    for k in keys:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _planes(leaf) -> object:
    if "w_tmac" not in leaf:
        return None
    return "ternary" if "w_tern" in leaf else int(leaf["w_q"].shape[0])


# ---------------------------------------------------------------------------
# the quantized trees
# ---------------------------------------------------------------------------

CASES = [("bitnet-3b", 2.0, "w4a4_mxu"), ("qwen2-7b", 3.2, "w4a4_tmac"),
         ("qwen2-7b", 2.0, "w4a4_tmac"), ("qwen2-7b", 1.8, "w4a4_lut")]


@pytest.mark.parametrize("arch,target,mode", CASES)
def test_quantized_tree_under_a_plan_matches_reference(arch, target, mode):
    _, tp = _float(arch)
    _, tplan = _plans(arch, target)
    _, want = _ref_quantized(arch, target, mode)
    before = ops.WEIGHT_QUANT_COUNT
    got = tquant.quantize_params_for_serving(tp, mode, bits_plan=tplan)
    _, tcfg = _cfgs(arch, mode)
    assert ops.WEIGHT_QUANT_COUNT - before == 7 * tcfg.n_layers + 1
    wl, gl = _flat(want), _flat(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    mean_scales = 0
    for (path, a), (_, b) in zip(wl, gl):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        leaf = _at(got, path[:-1])
        if path[-1].key == "w_scale" and _planes(leaf) in (1, "ternary"):
            # w1 / ternary: a mean-|w| scale, the port's a float64 mean
            # rounded once, XLA's a float32 one (module docstring of
            # test_torch_tmac: up to 4 ulp); the codes stay bitwise
            np.testing.assert_array_max_ulp(b.numpy(), a.numpy(), maxulp=4)
            mean_scales += 1
        else:
            assert torch.equal(a, b), path
    if arch == "qwen2-7b" and target < 3:     # w1 (and ternary) leaves
        assert mean_scales >= tcfg.n_layers
    # every planned leaf carries its plan's width; the head stays w8a8
    for path, leaf_mode in tplan.items():
        blk, grp, name = (path.split("]")[i].split("[")[1].strip("'")
                          for i in (1, 2, 3))
        leaf = got["blocks"][int(blk)][grp][name]
        spec = ops.parse_mode(leaf_mode)[1]
        assert _planes(leaf) == spec, path
    assert got["lm_head"]["w_q"].dtype == torch.int8
    assert "w_tmac" not in got["lm_head"]


def test_reference_case_plan_keys_match_serving_walk():
    """The reference's own case: bitnet-3b at 2.0 bits over w4a4_mxu, w2
    planes on attention and MLP, the head in the base format."""
    _, tp = _float("bitnet-3b")
    _, tplan = _plans("bitnet-3b", 2.0)
    qp = tquant.quantize_params_for_serving(tp, "w4a4_mxu", bits_plan=tplan)
    blk = qp["blocks"][0]
    for sub in (blk["attn"]["wq"], blk["mlp"]["wi"]):
        assert "w_tmac" in sub and sub["w_q"].shape[-3] == 2
    assert "w_tmac" not in qp["lm_head"]


@pytest.mark.parametrize("target", [3.2, 2.0])
def test_init_served_params_under_a_plan(target):
    _, tcfg = _cfgs("qwen2-7b", "w4a4_tmac")
    plan = tanalysis.plan_mixed_bits(TT.init_params(tcfg, 0, "meta"),
                                     target, tcfg)
    want = tquant.quantize_params_for_serving(
        TT.init_params(tcfg, 0, "cpu"), "w4a4_tmac", bits_plan=plan)
    got = tquant.init_served_params(tcfg, "w4a4_tmac", seed=0, device="cpu",
                                    bits_plan=plan)
    wl, gl = _flat(want), _flat(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert {_planes(got["blocks"][0]["mlp"][k]) for k in ("wi", "wg")} != \
        {4}


def test_bank_modes_follow_the_plan():
    """A plan entry of a MoE expert bank goes through ``legacy_mode``: a
    tmac mode stores nibbles (a8: int8), as the reference's."""
    rng = np.random.default_rng(4)
    wf = rng.standard_normal((4, 16, 8)).astype(np.float32)
    for plan_mode, dtype in (("w2a4_tmac", torch.uint8),
                             ("w2a8_tmac", torch.int8),
                             ("w8a8", torch.int8)):
        plan = {"['blocks'][0]['moe']['wi']": plan_mode}
        got = tquant.quantize_params_for_serving(
            {"blocks": [{"moe": {"wi": torch.from_numpy(wf)}}]}, "w4a4_lut",
            bits_plan=plan)["blocks"][0]["moe"]["wi"]
        want = jquant.quantize_params_for_serving(
            {"blocks": [{"moe": {"wi": jnp.asarray(wf)}}]}, "w4a4_lut",
            bits_plan=plan)["blocks"][0]["moe"]["wi"]
        assert got["w_q"].dtype == dtype
        for k in ("w_q", "w_scale"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the one-hot sub-4-bit leaf and the pickers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["w2a4", "w3a4", "w1a4", "ternary_a4"])
def test_onehot_sub4_leaf_matches_reference(mode, monkeypatch):
    """The picker forced to one-hot (as the reference's traffic fuzz forces
    it): the leaf's own-width codes nibble-packed, bitwise; the matmul on
    that leaf runs the LUT kernel and equals the reference's output."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    monkeypatch.setattr(jops, "pick_formulation",
                        lambda *a, **k: "onehot")
    monkeypatch.setattr(ops, "pick_formulation", lambda *a, **k: "onehot")
    want = jquant.quantize_leaf_mode(jnp.asarray(w), mode)
    got = tquant.quantize_leaf_mode(torch.from_numpy(w), mode)
    assert sorted(got) == sorted(want) == ["w_q", "w_scale"]
    assert got["w_q"].dtype == torch.uint8 and got["w_q"].shape == (32, 24)
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
    if ops.parse_mode(mode)[1] in ("ternary", 1):     # mean scale: 4 ulp
        np.testing.assert_array_max_ulp(got["w_scale"].numpy(),
                                        np.asarray(want["w_scale"]),
                                        maxulp=4)
    else:
        np.testing.assert_array_equal(got["w_scale"].numpy(),
                                      np.asarray(want["w_scale"]))
    # the reference's codes through both packages' matmuls
    wq, ws = (torch.from_numpy(np.array(want[k])) for k in ("w_q",
                                                            "w_scale"))
    ref_y = np.asarray(jops.prequant_matmul(
        jnp.asarray(x), want["w_q"], want["w_scale"], mode=mode,
        compute_dtype=jnp.float32, backend="ref"))
    calls = []
    for name in ("lutmul_fused", "int_matmul_fused"):
        real = getattr(kernel, name)
        monkeypatch.setattr(kernel, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    for backend in ("ref", "cuda"):
        y = ops.prequant_matmul(torch.from_numpy(x), wq, ws, mode=mode,
                                compute_dtype=torch.float32, backend=backend)
        np.testing.assert_array_equal(y.numpy(), ref_y)
    assert calls == ["lutmul_fused"]      # the cuda backend's kernel
    assert ops.lut_leaf(mode) and ops.lut_leaf("w4a4_lut")
    assert not ops.lut_leaf("w4a4_mxu") and not ops.lut_leaf("w2a4_tmac")


def test_pick_formulation_defaults():
    ops._FORMULATION_CACHE.clear()
    ops.set_autotune(False)
    try:
        assert ops.pick_formulation(2, 4, 256, 256, "ref") == "tmac"
        assert ops.pick_formulation("ternary", 4, 256, 256, "ref") == "tmac"
        assert ops.pick_formulation(4, 4, 256, 256, "ref") == "onehot"
        # a8 activations never fit the 4-bit one-hot product table
        assert ops.pick_formulation(4, 8, 256, 256, "ref") == "tmac"
        for spec in (1, "ternary", 2, 3, 4):
            for ab in (4, 8):
                assert ops.pick_formulation(spec, ab, 64, 32, "ref") == \
                    jops.pick_formulation(spec, ab, 64, 32, "ref")
        # autotuning times only on the card: the plain backend keeps the
        # default and caches it
        ops.set_autotune(True)
        assert ops.pick_formulation(3, 4, 128, 64, "ref") == "tmac"
        assert ops._FORMULATION_CACHE[(3, 4, 128, 64, "ref")] == "tmac"
        with pytest.raises(ValueError, match="unsupported weight"):
            ops.pick_formulation(5, 4, 64, 64, "ref")
    finally:
        ops.set_autotune(None)
        ops._FORMULATION_CACHE.clear()


def test_pick_variant_defaults_and_ab(monkeypatch):
    ops._VARIANT_CACHE.clear()
    ops.set_autotune(False)
    try:
        assert ops.pick_variant("lutmul", 8, 64, 64, "ref") == "unfused"
        assert ops.pick_variant("lutmul", 8, 64, 64, "cuda") == "fused"
        ops.set_variant("unfused")
        assert ops.pick_variant("lutmul", 8, 64, 64, "cuda") == "unfused"
        assert ops.variant_key("cuda") == "unfused"
        ops.set_variant(None)
    finally:
        ops.set_autotune(None)
    ops._VARIANT_CACHE.clear()
    monkeypatch.setenv("REPRO_TORCH_LUTMUL_AUTOTUNE", "1")
    assert ops.autotune_enabled()
    try:
        # without callables: the default, not cached
        assert ops.pick_variant("lutmul", 9, 64, 64, "ref") == "unfused"
        assert ("lutmul", 9, 64, 64, "ref") not in ops._VARIANT_CACHE
        got = ops.pick_variant(
            "lutmul", 9, 64, 64, "ref",
            bench_fns={"fused": lambda: None,
                       "unfused": lambda: time.sleep(0.002)})
        assert got == "fused"
        # cached: a second call returns the winner without bench_fns
        assert ops.pick_variant("lutmul", 9, 64, 64, "ref") == "fused"
        # a graph key sees the timed choice that left the default
        assert ops.variant_key("ref") == (
            "unfused", (("lutmul", 9, 64, 64, "ref"), "fused"))
        ops.set_variant("unfused")
        assert ops.pick_variant("lutmul", 9, 64, 64, "ref") == "unfused"
    finally:
        ops.set_variant(None)
        ops._VARIANT_CACHE.clear()
        ops._TIMED_VARIANTS.clear()
    assert ops.variant_key("ref") == "unfused"


# ---------------------------------------------------------------------------
# serving under a plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("target", [3.2, 2.0])
def test_mixed_forward_logits_match_reference(target, backend):
    jcfg, tcfg = _cfgs("qwen2-7b", "w4a4_tmac")
    jq, tq = _ref_quantized("qwen2-7b", target, "w4a4_tmac")
    tok = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 9))
    want, _ = JT.forward(jq, jcfg, jnp.asarray(tok, jnp.int32))
    ops.set_backend(backend)
    got, _ = TT.forward(tq, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _requests(make, vocab, n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [make(prompt=rng.integers(0, vocab, 6).tolist(),
                 max_new_tokens=5) for _ in range(n)]


def _port_engine(target, **kw):
    _, tcfg = _cfgs("qwen2-7b", "w4a4_tmac")
    _, tp = _float("qwen2-7b")
    _, plan = _plans("qwen2-7b", target)
    return tcfg, tserve.make_engine(tp, tcfg, tserve.ServeConfig(
        quant="w4a4_tmac", bits_plan=plan, max_len=MAX_LEN, **kw),
        device="cpu")


@pytest.mark.parametrize("target", [3.2, 2.0])
def test_scheduler_equals_generate_under_a_plan(target):
    tcfg, eng = _port_engine(target, prefill_chunk=4)
    assert eng.scfg.bits_plan
    leaf = eng.params["blocks"][0]["mlp"]["wg"]
    assert _planes(leaf) == (2 if target == 3.2 else 1)
    reqs = _requests(tserve.Request, tcfg.vocab)
    prompts = torch.tensor([r.prompt for r in reqs])
    want = eng.generate(prompts, max_new_tokens=5)[:, 6:].tolist()
    sched = tserve.Scheduler(eng, slots=3, chunk=2)
    sched.run(reqs)
    assert [r.tokens for r in reqs] == want
    # the reference engine under its own plan: the agreement is reported
    jcfg, _ = _cfgs("qwen2-7b", "w4a4_tmac")
    jp, _ = _float("qwen2-7b")
    jplan, _ = _plans("qwen2-7b", target)
    jeng = jserve.make_engine(jp, jcfg, jserve.ServeConfig(
        quant="w4a4_tmac", bits_plan=jplan, max_len=MAX_LEN))
    jreqs = _requests(jserve.Request, jcfg.vocab)
    jserve.Scheduler(jeng, slots=3, chunk=2).run(jreqs)
    same = sum(a == b for j, t in zip(jreqs, reqs)
               for a, b in zip(j.tokens, t.tokens))
    print(f"mixed {target} bits: {same} of {sum(map(len, want))} tokens "
          "equal to the JAX engine's")


def _drive(eng, cfg):
    sched = tserve.Scheduler(eng, slots=4, chunk=2)
    reqs = _requests(tserve.Request, cfg.vocab)
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.step()
    sched.submit(reqs[2])
    sched.submit(reqs[3])
    while sched.has_work:
        sched.step()
    return [list(r.tokens) for r in reqs], sched.stats


def _sharded_rank(mesh: ServingMesh, target: float):
    torch.set_num_threads(1)
    _, tcfg = _cfgs("qwen2-7b", "w4a4_tmac")
    params = TT.init_params(tcfg, 0, "cpu")
    plan = tanalysis.plan_mixed_bits(params, target, tcfg)
    eng = ShardedEngine(tcfg, params, tserve.ServeConfig(
        quant="w4a4_tmac", bits_plan=plan, max_len=MAX_LEN), mesh=mesh)
    mlp = eng.params["blocks"][0]["mlp"]
    return _drive(eng, tcfg), {k: _planes(mlp[k]) for k in mlp}


def test_sharded_engine_with_a_plan_equals_single_engine():
    target = 2.0
    _, tcfg = _cfgs("qwen2-7b", "w4a4_tmac")
    params = TT.init_params(tcfg, 0, "cpu")
    plan = tanalysis.plan_mixed_bits(params, target, tcfg)
    single = tserve.make_engine(params, tcfg, tserve.ServeConfig(
        quant="w4a4_tmac", bits_plan=plan, max_len=MAX_LEN), device="cpu")
    want = _drive(single, tcfg)
    ranks = launch(_sharded_rank, "1x2", "gloo", timeout_s=WORLD_S,
                   args=(target,), device="cpu")
    for got, planes in ranks:
        assert got == want
        assert planes == {"wi": 2, "wg": 1, "wo": 2}
