"""Port vs reference, the MoE FFN (``models/moe.py``) on the CPU.

The same numpy-seeded inputs and the reference's weights (converted from
its JAX tree) go through ``repro.models.moe`` and the port:

* ``moe_ffn`` under global and grouped dispatch, with and without a shared
  expert, ``norm_topk`` on and off, float32 compute, at the smoke configs'
  capacity factor (2.0: drop-free) and at 1.25 (routes dropped): expert ids,
  gates and keep masks equal (the seeded inputs' k-th and (k+1)-th
  probabilities are asserted apart by more than 1e-6, so an ulp of softmax
  cannot reorder them), outputs and aux within 1e-5 of max |y|;
* ``expert_matmul`` on a given bf16 buffer with nibble and int8 banks:
  codes, ``a_scale``, int32 accumulators and bf16 outputs bitwise equal to
  the reference's ``_expert_einsum`` on XLA:CPU, the kernel wrappers' CPU
  path (fused and unfused) equal to the plain version;
* ``init_moe`` shapes, the ``_MOE_W`` serving quantization (and the tmac
  coercion) equal to the reference's ``quantize_params_for_serving``,
  ``params_from_jax`` on a MoE tree, ``init_served_params`` equal to
  quantizing ``init_params``, and both MoE configs field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels.lutmul import ops
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.quantize import (init_served_params,
                                        quantize_params_for_serving)

from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]
TOL = 1e-5                    # of max |y|: float32 sums in other orders
GAP = 1e-6                    # least top-k margin of the seeded inputs
D = 32
B, S = 2, 16


@pytest.fixture(autouse=True)
def _ref_backend():
    ops.set_backend("ref")
    yield
    ops.set_backend(None)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


_BANKS = {}


def _bank(E, k, shared, norm_topk):
    key = (E, k, shared, norm_topk)
    if key not in _BANKS:
        cfg = JM.MoEConfig(n_experts=E, top_k=k, d_ff=24, shared_ff=shared,
                           norm_topk=norm_topk)
        _BANKS[key] = JM.init_moe(jax.random.PRNGKey(E + k + shared), D,
                                  cfg)
    return _BANKS[key]


def _ref_routing(p, xf, cfg):
    """The reference's routing of a [T, d] group, step by step: ids, gates,
    positions within the expert, keep, and the smallest top-k margin."""
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(xf) @ p["router"]["w"], axis=-1))
    gates, ids = jax.lax.top_k(jnp.asarray(probs), cfg.top_k)
    gates, ids = np.asarray(gates), np.asarray(ids)
    if cfg.norm_topk:
        gates = gates / gates.sum(-1, keepdims=True)
    srt = -np.sort(-probs, axis=-1)
    margin = float((srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]).min())
    flat = ids.reshape(-1)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, 0) - onehot)[np.arange(flat.size), flat])
    return ids, gates, pos, margin


@pytest.mark.parametrize("cf", [2.0, 1.25], ids=["dropfree", "drops"])
@pytest.mark.parametrize("norm_topk", [False, True])
@pytest.mark.parametrize("shared", [0, 48], ids=["routed", "shared"])
@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("E,k", [(8, 4), (4, 2)])
def test_moe_ffn_matches_reference(E, k, dispatch, shared, norm_topk, cf):
    jcfg = JM.MoEConfig(n_experts=E, top_k=k, d_ff=24, shared_ff=shared,
                        norm_topk=norm_topk, capacity_factor=cf,
                        dispatch=dispatch)
    tcfg = TM.MoEConfig(**dataclasses.asdict(jcfg))
    p = _bank(E, k, shared, norm_topk)
    # a direction common to every token crowds the same experts, so the
    # 1.25 capacity drops routes
    rng = np.random.default_rng(E * k + shared)
    x = (rng.standard_normal((B, S, D))
         + 1.5 * rng.standard_normal(D)).astype(np.float32)
    want, aux_w = JM.moe_ffn(p, jnp.asarray(x), jcfg,
                             compute_dtype=jnp.float32)
    pt = _torch(p)
    got, aux_t = TM.moe_ffn(pt, torch.from_numpy(x), tcfg,
                            compute_dtype=torch.float32)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(float(aux_t), float(aux_w), rtol=TOL)
    # the routing decisions, group by group, exactly
    groups = [x[b] for b in range(B)] if dispatch == "grouped" \
        else [x.reshape(B * S, D)]
    T = groups[0].shape[0]
    C = TM.capacity(tcfg, T)
    gates, ids, pos, keep, _ = TM.route(
        pt, torch.from_numpy(np.stack(groups)), tcfg, C)
    dropped = 0
    for g, xf in enumerate(groups):
        r_ids, r_gates, r_pos, margin = _ref_routing(p, xf, jcfg)
        assert margin > GAP, margin
        np.testing.assert_array_equal(_np(ids[g]), r_ids.reshape(-1))
        np.testing.assert_array_equal(_np(pos[g]), r_pos)
        np.testing.assert_array_equal(_np(keep[g]), r_pos < C)
        np.testing.assert_allclose(_np(gates[g]), r_gates.reshape(-1),
                                   rtol=TOL)
        dropped += int((r_pos >= C).sum())
    if cf == 2.0 and dispatch == "global":
        assert dropped == 0
    if cf == 1.25:
        assert dropped > 0, "the 1.25 variant must drop routes"


def test_capacity_follows_the_reference_arithmetic():
    cfg = TM.MoEConfig(n_experts=60, top_k=4, d_ff=8)
    assert TM.capacity(cfg, 8 * 64) == int(8 * 64 * 4 / 60 * 1.25) == 42
    assert TM.capacity(cfg, 8) == 1
    qwen = tconfigs.get_config("qwen2-moe-a2.7b")
    assert TM.decode_capacity(qwen.moe, 8) == 1
    # mixtral keeps MoEConfig's default dispatch, "global", as the
    # reference's config does
    mixtral = tconfigs.get_config("mixtral-8x22b")
    assert mixtral.moe.dispatch == "global"
    assert TM.decode_capacity(mixtral.moe, 8) == int(8 * 2 / 8 * 1.25) + 1
    assert TM.decode_capacity(mixtral.moe, 8) == 3
    assert TM.decode_capacity(dataclasses.replace(mixtral.moe,
                                                  dispatch="grouped"),
                              8) is None
    g = dataclasses.replace(cfg, dispatch="grouped")
    assert TM.capacity(g, 1) == 4 and TM.expert_rows(g, 8, 1) == 32
    assert TM.decode_rows(g, 8) == 32 and TM.decode_rows(cfg, 8) == 1
    assert TM.capacity(cfg, 8, fixed=3) == 3


def _ref_einsum_parts(a, w):
    """``_expert_einsum``'s intermediates, its own expressions on XLA:CPU:
    codes, a_scale, int32 accumulators."""
    w_q = w["w_q"]
    if w_q.dtype == jnp.uint8:
        from repro.core.lut import unpack_int4
        w_int = jnp.swapaxes(unpack_int4(jnp.swapaxes(w_q, -1, -2),
                                         signed=True), -1, -2)
        qmax = 7
    else:
        w_int, qmax = w_q, 127
    a_scale = jnp.maximum(jnp.max(jnp.abs(a.astype(jnp.float32)), axis=-1,
                                  keepdims=True), 1e-8) / qmax
    a_q = jnp.clip(jnp.round(a / a_scale.astype(a.dtype)), -qmax - 1,
                   qmax).astype(jnp.int8)
    acc = jnp.einsum("ecd,edf->ecf", a_q, w_int,
                     preferred_element_type=jnp.int32)
    return a_q, a_scale, acc


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("mode", ["w4a4_lut", "w8a8"])
def test_expert_matmul_bitwise_equals_expert_einsum(mode, C):
    E, K, N = 6, 64, 40
    rng = np.random.default_rng(C)
    wf = rng.standard_normal((E, K, N)).astype(np.float32)
    jw = jquantize({"moe": {"wi": jnp.asarray(wf)}}, mode)["moe"]["wi"]
    tw = quantize_params_for_serving({"moe": {"wi": torch.from_numpy(wf)}},
                                     mode)["moe"]["wi"]
    for key in ("w_q", "w_scale"):
        np.testing.assert_array_equal(_np(tw[key]), np.asarray(jw[key]))
    a = rng.standard_normal((E, C, K)).astype(np.float32) * 3.0
    a[0, 0, :3] = [0.5, -1.5, 2.5]           # .5 ties after the scale
    a[1] = 0.0                               # an all-zero row: 1e-8 scale
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    want = JM._expert_einsum(ja, jw, jnp.bfloat16)
    a_q, a_scale, acc = _ref_einsum_parts(ja, jw)
    qmax = 7 if mode == "w4a4_lut" else 127
    t_q, t_scale = TM.quantize_experts(ta, qmax)
    np.testing.assert_array_equal(_np(t_q), np.asarray(a_q))
    np.testing.assert_array_equal(_np(t_scale).view(np.int32),
                                  np.asarray(a_scale).view(np.int32))
    t_acc = (t_q.double() @ TM._bank_codes(tw).double()).to(torch.int32)
    np.testing.assert_array_equal(_np(t_acc), np.asarray(acc))
    got = TM.expert_matmul(ta, tw, torch.bfloat16)
    np.testing.assert_array_equal(_np(got), _np(want))
    # the kernel backend's per-expert wrappers, fused and unfused, take
    # their plain versions on CPU tensors: the same bits
    for variant in ("fused", "unfused"):
        ops.set_variant(variant)
        try:
            kern = TM.expert_matmul(ta, tw, torch.bfloat16, backend="cuda")
        finally:
            ops.set_variant(None)
        np.testing.assert_array_equal(_np(kern), _np(want))


def test_expert_matmul_float_bank_matches_reference():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((4, 3, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32, 16)).astype(np.float32)
    want = JM._expert_einsum(jnp.asarray(a), jnp.asarray(w), jnp.float32)
    got = TM.expert_matmul(torch.from_numpy(a), torch.from_numpy(w),
                           torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=TOL * np.abs(np.asarray(want)).max())


def _c_signature(lib):
    """ctypes kinds of ``csrc/<lib>.cu``'s ``<lib>_launch`` parameters."""
    import ctypes
    import pathlib
    import re
    src = (pathlib.Path(__file__).parents[1] / "src" / "repro_torch"
           / "csrc" / f"{lib}.cu").read_text()
    params = re.search(rf'extern "C" int {lib}_launch\(([^)]*)\)',
                       src).group(1).split(",")
    return [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lib", ["lutmul", "int_matmul"])
def test_launch_helper_passes_each_experts_slice(monkeypatch, lib, fused):
    """The one launch helper of the LUT and int8 wrappers, with the entry
    stubbed: its ctypes signature is the C entry's, a 2D call is one
    launch on the tensors' own pointers, and a stacked call launches
    expert e on every [E, ...] operand's e-th slice."""
    import types
    from repro_torch.kernels.lutmul import kernel
    calls, sig = [], {}

    def entry(lib_name, fn_name, argtypes, restype=None):
        sig[fn_name] = list(argtypes)

        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append(args)
            return 0
        return fn
    monkeypatch.setattr(kernel, "_entry", entry)
    monkeypatch.setattr(kernel, "_workspace", lambda *a: torch.zeros(1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    E, M, K, N = 3, 2, 8, 4
    if lib == "lutmul":
        a = torch.zeros((E, M, K), dtype=torch.uint8)
        w = torch.zeros((E, K // 2, N), dtype=torch.uint8)
    else:
        a = torch.zeros((E, M, K), dtype=torch.int8)
        w = torch.zeros((E, K, N), dtype=torch.int8)
    a_s = torch.zeros((E, M, 1)) if fused else None
    w_s = torch.zeros((E, 1, N)) if fused else None
    out = torch.zeros((E, M, N),
                      dtype=torch.bfloat16 if fused else torch.int32)

    def launch(*ops_):
        if lib == "lutmul":
            kernel._lut_launch(*ops_, int(fused), True, "lutmul")
        else:
            kernel._int_launch(*ops_, int(fused), "int_matmul")
    # pointers of a, w, a_scale, w_scale, out in the entry's arguments
    at = [0, 1, 3, 4, 5] if lib == "lutmul" else [0, 1, 2, 3, 4]
    launch(a[1], w[1], None if a_s is None else a_s[1],
           None if w_s is None else w_s[1], out[1])
    launch(a, w, a_s, w_s, out)
    assert sig[f"{lib}_launch"] == _c_signature(lib)
    assert len(calls) == 1 + E
    for args, e in zip(calls, [1] + list(range(E))):
        want = [t if t is None else t[e].data_ptr()
                for t in (a, w, a_s, w_s, out)]
        assert [args[i] for i in at] == want
        assert args[-5:-1] == (M, K, N, int(fused))


@pytest.mark.parametrize("shared", [0, 48])
def test_init_moe_shapes_match_reference(shared):
    jcfg = JM.MoEConfig(n_experts=5, top_k=2, d_ff=24, shared_ff=shared)
    want = JM.init_moe(jax.random.PRNGKey(0), D, jcfg)
    gen = torch.Generator().manual_seed(0)
    got = TM.init_moe(gen, D, TM.MoEConfig(**dataclasses.asdict(jcfg)))
    w_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), want)
    g_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), got)
    assert g_shapes == w_shapes
    assert all(t.dtype == torch.float32
               for t in jax.tree_util.tree_leaves(got))


_TREES = {}


def _tree(arch):
    """The reference's smoke parameters (float32) as numpy, and as the
    port's tensors."""
    if arch not in _TREES:
        cfg = jconfigs.get_config(arch, smoke=True)
        jp = jax.tree_util.tree_map(
            np.asarray, JT.init_params(jax.random.PRNGKey(0), cfg))
        _TREES[arch] = (jp, params_from_jax(
            jp, tconfigs.get_config(arch, smoke=True), device="cpu"))
    return _TREES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_unstacks_moe_layers(arch):
    jp, tp = _tree(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    assert len(tp["blocks"]) == cfg.n_layers
    for i, bp in enumerate(tp["blocks"]):
        want = jax.tree_util.tree_map(lambda a: a[i], jp["blocks"][0])
        assert set(bp["moe"]) == set(want["moe"])
        for key in ("wi", "wg", "wo"):
            assert tuple(bp["moe"][key].shape) == want["moe"][key].shape
            np.testing.assert_array_equal(_np(bp["moe"][key]),
                                          want["moe"][key])
        np.testing.assert_array_equal(_np(bp["moe"]["router"]["w"]),
                                      want["moe"]["router"]["w"])


@pytest.mark.parametrize("mode", ["w4a4_lut", "w4a4_tmac", "w8a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serving_leaves_equal_reference(arch, mode):
    jp, _ = _tree(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    want = jax.tree_util.tree_map(np.asarray, jquantize(
        jax.tree_util.tree_map(jnp.asarray, jp), mode))
    got = quantize_params_for_serving(
        params_from_jax(jp, cfg, device="cpu"), mode)
    conv = params_from_jax(want, cfg, device="cpu")
    w_leaves = jax.tree_util.tree_leaves_with_path(conv)
    g_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path
    moe = got["blocks"][0]["moe"]
    E = cfg.moe.n_experts
    bits = 8 if mode == "w8a8" else 4
    for key, (K, N) in (("wi", (cfg.d_model, cfg.moe.d_ff)),
                        ("wo", (cfg.moe.d_ff, cfg.d_model))):
        leaf = moe[key]
        assert "w_tmac" not in leaf          # tmac is coerced to nibbles
        assert tuple(leaf["w_q"].shape) == (E, K * bits // 8, N)
        assert tuple(leaf["w_scale"].shape) == (E, 1, N)
    assert set(moe["router"]) == {"w"}       # the router stays float
    if "shared" in moe:
        assert set(moe["shared_gate"]) == {"w"}
        assert ("w_tmac" in moe["shared"]["wi"]) == (mode == "w4a4_tmac")


def test_legacy_mode_coerces_tmac_like_the_reference():
    from repro_torch.serve.quantize import legacy_mode
    assert legacy_mode("w4a4_lut") == "w4a4_lut"
    assert legacy_mode("w8a8") == "w8a8"
    assert legacy_mode("w4a4_tmac") == "w4a4_mxu"
    assert legacy_mode("w2a8_tmac") == "w8a8"
    assert legacy_mode("ternary_a4_tmac") == "w4a4_mxu"


@pytest.mark.parametrize("arch", ARCHS + ["qwen2-7b", "gemma2-2b",
                                          "minicpm-2b"])
def test_init_served_params_equals_quantized_init(arch):
    """The served tree made a layer at a time has the codes of quantizing
    the whole float tree (MoE banks, dense layers, tied embeddings)."""
    cfg = tconfigs.get_config(arch, smoke=True, quant="w4a4_lut")
    want = quantize_params_for_serving(
        TT.init_params(cfg, seed=3, device="cpu"), "w4a4_lut")
    got = init_served_params(cfg, "w4a4_lut", seed=3, device="cpu")
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    g_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    block = got["blocks"][0]
    leaf = block["moe"]["wi"] if "moe" in block else block["mlp"]["wi"]
    assert leaf["w_q"].dtype == torch.uint8
    assert ("lm_head" in got) != cfg.tie_embeddings


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch, smoke):
    for quant in ("none", "w4a4_lut"):
        j = jconfigs.get_config(arch, smoke=smoke, quant=quant)
        t = tconfigs.get_config(arch, smoke=smoke, quant=quant)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert type(t.moe).__name__ == "MoEConfig"
        assert t.n_groups == j.n_groups
    for arch_ in ARCHS:
        assert tconfigs.ALIASES[arch_] == jconfigs.ALIASES[arch_]
