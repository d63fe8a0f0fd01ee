"""Tensor-parallel marking and slicing (``repro_torch.dist``), in process.

* ``mark_tp_params`` gives every leaf of the five smoke serving trees
  (qwen2-7b, gemma2-2b, qwen2-moe-a2.7b, mixtral-8x22b, zamba2-2.7b,
  converted from the reference's quantized tree with ``params_from_jax``)
  the mode and split axis the reference's ``repro.dist.tp.mark_tp_params``
  gives it, at n_model 2 and 4: the port's layer ``i`` is the reference's
  pattern position ``i % len(pattern)`` of its ``[G, ...]`` stacks;
* the reference's fallbacks: indivisible leaves, heads and experts stay
  replicated, GQA with n_kv % tp != 0 falls back to replicated attention,
  markers are inert on one device;
* ``shard_params`` slices to the right shapes, and the ranks' slices put
  back together are the full leaves;
* ``parse_mesh``, the engine's guard rails, ``fold_in_data`` == ``jax.random.
  fold_in(key, d)`` bitwise;
* the card's shape-stable attention products (``attention.scores_stable``
  / ``weighted_stable``) against the einsums they replace, on the CPU
  (``test_torch_cuda_sharded.py`` holds their bits across rows and heads
  on the card).
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import tp as jtp
from repro.models import transformer as JT
from repro.serve.quantize import quantize_params_for_serving as jquantize
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.dist import tp
from repro_torch.dist.mesh import Axis, parse_mesh
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serve import ServeConfig
from repro_torch.serve.quantize import quantize_params_for_serving

from _torch_threads import one_torch_thread  # noqa: F401

TREES = [("qwen2-7b", "w4a4_lut"), ("gemma2-2b", "w8a8"),
         ("qwen2-moe-a2.7b", "w4a4_lut"), ("mixtral-8x22b", "w8a8"),
         ("zamba2-2.7b", "w8a8")]
_CACHE = {}


def _trees(arch, quant):
    """(port cfg, reference quantized tree, the port's conversion of it)."""
    if (arch, quant) not in _CACHE:
        jcfg = jconfigs.get_config(arch, smoke=True, quant=quant)
        jq = jquantize(JT.init_params(jax.random.PRNGKey(0), jcfg),
                       mode=quant)
        cfg = configs.get_config(arch, smoke=True, quant=quant)
        pt = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), cfg,
                             device="cpu")
        _CACHE[arch, quant] = cfg, jq, pt
    return _CACHE[arch, quant]


def _ref_split(spec):
    """A PartitionSpec as the port's split axis (negative) or None."""
    entries = tuple(spec)
    if "model" not in entries:
        return None
    return entries.index("model") - len(entries)


def _modes(tree, dims, path=()):
    """{path: (mode, {array: split axis})} of every marked leaf dict."""
    out = {}
    if isinstance(tree, dict):
        mode = tp.leaf_tp_mode(tree)
        if mode is not None:
            return {path: (mode, dims)}
        for k, v in tree.items():
            out.update(_modes(v, dims[k], path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_modes(v, dims[i], path + (i,)))
    return out


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("arch,quant", TREES)
def test_marking_matches_reference(arch, quant, n_model):
    cfg, jq, pt = _trees(arch, quant)
    jmarked, jspecs, jn = jtp.mark_tp_params(jq, n_model,
                                             head_dim=cfg.head_dim)
    marked, dims, n = tp.mark_tp_params(pt, n_model, head_dim=cfg.head_dim)
    ref = {p: (m, {k: _ref_split(s) for k, s in d.items()})
           for p, (m, d) in _modes(jmarked, jspecs).items()}
    got = _modes(marked, dims)
    assert ref and jn > 0 and n > 0
    P = len(cfg.pattern)
    # every port layer carries its pattern position's reference marking
    folded = {}
    for path, val in got.items():
        key = (("blocks", path[1] % P) + path[2:]
               if path[0] == "blocks" else path)
        assert ref.get(key) == val, (path, ref.get(key), val)
        folded.setdefault(key, 0)
        folded[key] += 1
    assert set(folded) == set(ref)
    assert all(c == cfg.n_layers // P for k, c in folded.items()
               if k[0] == "blocks")
    # head-parallel exactly where the reference's is, and the counts
    assert tp.has_marker(marked, "tp_head") == jtp.has_marker(jmarked,
                                                             "tp_head")
    jt, jh = jtp.attn_group_counts(jmarked)
    t, h = tp.attn_group_counts(marked)
    assert (h == 0) == (jh == 0) and (h == t) == (jh == jt)


def _served(arch="qwen2-7b", quant="w4a4_lut"):
    cfg = configs.get_config(arch, smoke=True, quant=quant)
    return cfg, quantize_params_for_serving(
        T.init_params(cfg, seed=0, device="cpu"), mode=quant)


def test_col_row_marking_and_split_axes():
    cfg, q = _served()
    marked, dims, n = tp.mark_tp_params(q, 4)
    attn = marked["blocks"][0]["attn"]
    assert n > 0
    assert tp.leaf_tp_mode(attn["wq"]) == "col"
    assert dims["blocks"][0]["attn"]["wq"] == dict(
        w_q=-1, w_scale=-1, b=None, tp_col=None)
    assert tp.leaf_tp_mode(attn["wo"]) == "row"
    assert dims["blocks"][0]["attn"]["wo"]["w_q"] == -2
    assert dims["blocks"][0]["attn"]["wo"]["w_scale"] is None
    assert tp.leaf_tp_mode(marked["lm_head"]) == "col"       # w8a8 head
    assert tp.leaf_tp_mode(marked["embed"]) is None


def test_indivisible_leaves_stay_replicated():
    cfg, q = _served()
    marked, dims, n = tp.mark_tp_params(q, 7)
    assert n == 0
    assert tp.leaf_tp_mode(marked["blocks"][0]["attn"]["wq"]) is None
    assert dims["blocks"][0]["attn"]["wq"]["w_q"] is None


def test_head_parallel_attention():
    cfg, q = _served()
    marked, dims, _ = tp.mark_tp_params(q, 2, head_dim=cfg.head_dim)
    attn = marked["blocks"][0]["attn"]
    for k in ("wq", "wk", "wv"):
        assert tp.leaf_tp_mode(attn[k]) == "head", k
        assert dims["blocks"][0]["attn"][k]["b"] == -1
    assert tp.leaf_tp_mode(attn["wo"]) == "row"
    assert tp.attn_group_counts(marked) == (cfg.n_layers, cfg.n_layers)
    # n_heads not divisible: no head marking, and nothing splits 3 ways
    marked3, _, _ = tp.mark_tp_params(q, 3, head_dim=cfg.head_dim)
    assert not tp.has_marker(marked3, "tp_head")
    assert tp.leaf_tp_mode(marked3["blocks"][0]["attn"]["wq"]) is None


def test_gqa_indivisible_kv_falls_back_to_replicated_attention():
    cfg, q = _served("mixtral-8x22b")
    assert cfg.n_kv % 4 and cfg.n_heads % 4 == 0
    marked, _, _ = tp.mark_tp_params(q, 4, head_dim=cfg.head_dim)
    attn = marked["blocks"][0]["attn"]
    assert not tp.has_marker(marked, "tp_head")
    assert tp.leaf_tp_mode(attn["wq"]) == "col"
    assert tp.leaf_tp_mode(attn["wo"]) == "row"
    marked2, _, _ = tp.mark_tp_params(q, 2, head_dim=cfg.head_dim)
    assert tp.leaf_tp_mode(marked2["blocks"][0]["attn"]["wq"]) == "head"


def test_expert_banks_and_router():
    cfg, q = _served("qwen2-moe-a2.7b")
    marked, dims, _ = tp.mark_tp_params(q, 2, head_dim=cfg.head_dim)
    moe = marked["blocks"][0]["moe"]
    for k in ("wi", "wg", "wo"):
        assert tp.leaf_tp_mode(moe[k]) == "exp", k
        assert dims["blocks"][0]["moe"][k]["w_q"] == -3
        assert dims["blocks"][0]["moe"][k]["w_scale"] == -3
    assert tp.leaf_tp_mode(moe["router"]) is None
    assert tp.leaf_tp_mode(moe["shared"]["wi"]) == "col"
    assert tp.leaf_tp_mode(moe["shared"]["wo"]) == "row"
    # 3 does not divide the smoke experts: the banks stay replicated
    assert cfg.moe.n_experts % 3
    marked3, _, _ = tp.mark_tp_params(q, 3, head_dim=cfg.head_dim)
    for k in ("wi", "wg", "wo"):
        assert tp.leaf_tp_mode(marked3["blocks"][0]["moe"][k]) is None


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b"])
def test_markers_are_inert_on_one_device(arch):
    cfg, q = _served(arch)
    marked, _, n = tp.mark_tp_params(q, 2, head_dim=cfg.head_dim)
    assert n > 0
    toks = torch.arange(6, dtype=torch.int64)[None] % cfg.vocab
    a, _ = T.prefill(q, cfg, toks)
    b, _ = T.prefill(marked, cfg, toks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("n_model", [2, 4])
def test_shard_params_slices(arch, n_model):
    cfg, q = _served(arch)
    marked, dims, _ = tp.mark_tp_params(q, n_model, head_dim=cfg.head_dim)
    shards = [tp.shard_params(marked, SimpleNamespace(
        model_index=i, n_model=n_model)) for i in range(n_model)]

    def walk(full, dim_tree, parts):
        if isinstance(full, dict):
            for k in full:
                walk(full[k], dim_tree[k], [p[k] for p in parts])
        elif isinstance(full, (list, tuple)):
            for i in range(len(full)):
                walk(full[i], dim_tree[i], [p[i] for p in parts])
        elif dim_tree is None:
            assert all(p is full for p in parts)
        else:
            shape = list(full.shape)
            shape[dim_tree] //= n_model
            assert all(list(p.shape) == shape for p in parts)
            assert torch.equal(torch.cat(parts, dim_tree), full)

    walk(marked, dims, shards)
    attn = shards[0]["blocks"][0]["attn"]
    if tp.leaf_tp_mode(attn["wq"]) == "head":
        assert attn["wq"]["w_q"].shape[-1] == \
            cfg.n_heads * cfg.head_dim // n_model
        # packed int4 rows of wo: K // 2 split evenly
        assert attn["wo"]["w_q"].shape[-2] == \
            cfg.n_heads * cfg.head_dim // 2 // n_model


def test_parse_mesh():
    assert parse_mesh("2x4") == (2, 4)
    assert parse_mesh("1X8") == (1, 8)
    for bad in ("8", "0x4", "2x"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


def test_sharded_engine_guard_rails():
    from repro_torch.serve.sharded import ShardedEngine
    cfg = configs.get_config("qwen2-7b", smoke=True, quant="w4a4_lut")
    params = T.init_params(cfg, seed=0, device="cpu")
    fake = SimpleNamespace(n_data=2, n_model=2)   # never reached
    with pytest.raises(ValueError, match="quant"):
        ShardedEngine(cfg, params, ServeConfig(max_len=16), mesh=fake)
    # speculation is served sharded, under the single engine's drafter
    # rule: LUT nibble leaves have no planes to truncate
    rank = SimpleNamespace(n_data=2, n_model=2, model_index=0,
                           device=torch.device("cpu"))
    with pytest.raises(ValueError, match="draftable"):
        ShardedEngine(cfg, params, ServeConfig(
            max_len=16, quant="w4a4_lut", spec_decode=True), mesh=rank)
    wcfg = configs.get_config("whisper-large-v3", smoke=True)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ShardedEngine(wcfg, {}, ServeConfig(max_len=16, quant="w8a8"),
                      mesh=fake)


@pytest.mark.parametrize("seed,d", [(0, 0), (0, 1), (7, 3), (-5, 2)])
def test_fold_in_data_equals_jax(seed, d):
    key = prng.prng_key(seed)
    assert torch.equal(tp.fold_in_data(key), key)          # no context
    with tp.tp_context(Axis(None, 2, 0), 2, Axis(None, 4, d)):
        got = tp.fold_in_data(key)
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), d))
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("S,T", [(1, 40), (1, 600), (5, 5)])
def test_stable_attention_products_match_einsum(S, T):
    g = torch.Generator().manual_seed(0)
    qg = torch.randn((3, S, 2, 3, 16), generator=g)
    k = torch.randn((3, T, 2, 16), generator=g)
    v = torch.randn((3, T, 2, 16), generator=g)
    p = torch.softmax(torch.randn((3, S, 2, 3, T), generator=g), -1)
    torch.testing.assert_close(A.scores_stable(qg, k),
                               torch.einsum("bshgd,bkhd->bshgk", qg, k),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(A.weighted_stable(p, v),
                               torch.einsum("bshgk,bkhd->bshgd", p, v),
                               rtol=0, atol=1e-5)
