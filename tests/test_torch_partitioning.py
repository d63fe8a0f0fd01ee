"""Port vs reference, sharding rules and leaf specs: ``dist.sharding``
(``Rules``, ``production_rules``, ``use_rules``, ``current_rules``,
``spec_for``, ``constrain``) and ``dist.partitioning`` (``leaf_spec``,
``param_specs``, ``state_specs``) against ``repro.dist.sharding`` and
``repro.dist.partitioning``, exactly.

Every leaf of every LM config's smoke parameters (converted from the
reference's tree, so both walk the same leaves), under four rule tables
(FSDP over "data"; FSDP over ("pod", "data") on the multi-pod table;
MoE expert-parallel; MoE tensor-parallel): the port's spec equals the
reference's with the leading entry of a stacked ``[G, ...]`` leaf
dropped.  The train state's specs (AdamW moments under ``['opt']``) the
same way.  The reference's own cases
(``tests/test_serve_and_dist.py``) in the port's layout.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import partitioning as JP
from repro.dist import sharding as JS
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro.train import step as JTS
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import flatten
from repro_torch.dist import partitioning as TP
from repro_torch.dist import sharding as TS
from repro_torch.train import step as TTS

from _torch_threads import one_torch_thread  # noqa: F401

LMS = ["qwen2-7b", "bitnet-3b", "gemma2-2b", "minicpm-2b",
       "phi3-medium-14b", "qwen2-moe-a2.7b", "mixtral-8x22b", "rwkv6-1.6b",
       "zamba2-2.7b", "whisper-large-v3", "qwen2-vl-72b"]


def _rules(name, mod):
    if name == "fsdp":
        r = mod.production_rules()
        r["fsdp"] = "data"
    elif name == "multi_pod":
        r = mod.production_rules(multi_pod=True)
        r["fsdp"] = ("pod", "data")
    elif name == "moe_ep":
        r = mod.production_rules()
        r.update(expert="model", expert_mlp=None, fsdp="data")
    else:
        r = mod.production_rules()
        r.update(expert=None, expert_mlp="model", fsdp="data",
                 moe_capacity="data")
    return r


RULES = ["fsdp", "multi_pod", "moe_ep", "moe_tp"]
_P = {}


def _params(arch):
    if arch not in _P:
        jc = jconfigs.get_config(arch, smoke=True)
        tc = tconfigs.get_config(arch, smoke=True)
        init = JE.init_params if jc.enc_dec else JT.init_params
        jp = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(0), jc)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                             device="cpu")
        _P[arch] = (jc, jp, tp)
    return _P[arch]


_STACK = ("['blocks']", "['enc_blocks']", "['dec_blocks']")


def _ref_path(path: str, period: int) -> tuple:
    """The reference's keystr for a port leaf path, and whether the
    reference stacks it (layer i of ``blocks`` is stacked at pattern
    position i % period; the encoder's and decoder's stacks are one
    stacked dict each)."""
    for s in _STACK:
        i = path.find(s + "[")
        if i < 0:
            continue
        j = path.index("]", i + len(s) + 1)
        layer = int(path[i + len(s) + 1:j])
        pos = f"[{layer % period}]" if s == "['blocks']" else ""
        return path[:i] + s + pos + path[j + 1:], True
    return path, False


def _ref_specs(tree, rules):
    specs = JP.state_specs(tree, rules)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _check_tree(port_tree, ref_tree, rules_name, period):
    trules, jrules = _rules(rules_name, TS), _rules(rules_name, JS)
    want = _ref_specs(ref_tree, jrules)
    paths, leaves = flatten(port_tree)
    got = [TP.port_leaf_spec(p, x.dim(), trules)
           for p, x in zip(paths, leaves)]
    assert len(paths) > 0
    seen = set()
    for path, spec in zip(paths, got):
        ref, stacked = _ref_path(path, period)
        assert ref in want, path
        assert spec == (want[ref][1:] if stacked else want[ref]), (
            path, spec, want[ref])
        seen.add(ref)
    assert seen == set(want)            # every reference leaf was met


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", LMS)
def test_param_specs_equal_reference_less_the_layer_dim(arch, rules):
    jc, jp, tp = _params(arch)
    _check_tree(tp, jp, rules, len(jc.pattern))
    # param_specs gives the same specs in the tree's structure
    specs = TP.param_specs(tp, _rules(rules, TS))
    assert isinstance(specs, type(tp)) and specs.keys() == tp.keys()


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b",
                                  "whisper-large-v3"])
def test_state_specs_moments_take_their_parameter_s(arch):
    jc, jp, tp = _params(arch)
    jstate = JTS.init_state(jp)
    tstate = TTS.init_state(tp)
    _check_tree(tstate, jstate, "fsdp", len(jc.pattern))
    specs = TP.state_specs(tstate, _rules("fsdp", TS))
    stack = "dec_blocks" if jc.enc_dec else "blocks"
    key = "self_attn" if jc.enc_dec else "attn"
    for moment in ("m", "v"):
        assert specs["opt"][moment][stack][0][key]["wq"]["w"] == \
            specs["params"][stack][0][key]["wq"]["w"] == ("data", "model")
    assert specs["opt"]["step"] == ()


def test_param_specs_match_rules():
    """The reference's case, the per-layer leaves less the layer entry."""
    _, _, tp = _params("qwen2-7b")
    rules = TS.production_rules()
    rules["fsdp"] = "data"
    specs = TP.param_specs(tp, rules)
    assert specs["blocks"][0]["attn"]["wq"]["w"] == ("data", "model")
    assert specs["blocks"][0]["attn"]["wo"]["w"] == ("model", "data")
    assert specs["blocks"][0]["mlp"]["wi"]["w"] == ("data", "model")
    assert specs["embed"]["emb"] == ("model", "data")
    assert specs["final_norm"]["scale"] == ()


def test_moe_param_specs_ep_vs_tp():
    _, _, tp = _params("qwen2-moe-a2.7b")
    ep = TS.production_rules()
    ep.update(expert="model", expert_mlp=None, fsdp="data")
    assert TP.param_specs(tp, ep)["blocks"][0]["moe"]["wi"] == (
        "model", "data", None)
    tpr = TS.production_rules()
    tpr.update(expert=None, expert_mlp="model", fsdp="data")
    specs = TP.param_specs(tp, tpr)
    assert specs["blocks"][0]["moe"]["wi"] == (None, "data", "model")
    assert specs["blocks"][0]["moe"]["wo"] == (None, "model", "data")


@pytest.mark.parametrize("path,ndim", [
    ("['blocks'][0]['attn']['wq']['w']", 3),
    ("['blocks'][0]['attn']['wo']['w_q']", 3),
    ("['blocks'][0]['attn']['w_scale']", 2),
    ("['blocks'][0]['attn']['wq3']['w']", 4),
    ("['blocks'][0]['attn']['wo3']['w']", 4),
    ("['blocks'][0]['moe']['wg']['w_q']", 4),
    ("['blocks'][0]['moe']['wo']", 4),
    ("['lm_head']['w_q']", 2),
    ("['embed']['emb']", 2),
    ("['blocks'][0]['mlp']['wo']['w']", 1),
    ("['blocks'][0]['ln1']['scale']", 2)])
@pytest.mark.parametrize("rules", RULES)
def test_leaf_spec_equals_reference(path, ndim, rules):
    """The rule on paths the smoke trees do not hold (serving codes and
    scales, split-head leaves), at the reference's ranks."""
    got = TP.leaf_spec(path, ndim, _rules(rules, TS))
    assert got == tuple(JP.leaf_spec(path, ndim, _rules(rules, JS)))


def test_production_rules_and_spec_for_equal_reference():
    for multi in (False, True):
        assert dict(TS.production_rules(multi)) == dict(
            JS.production_rules(multi))
    r = _rules("multi_pod", TS)
    jr = _rules("multi_pod", JS)
    axes = ("batch", None, "heads", ("data",), "fsdp", "nope")
    assert TS.spec_for(r, *axes) == tuple(JS.spec_for(jr, *axes))
    assert isinstance(r, TS.Rules)


@dataclasses.dataclass
class _Mesh:
    """The sizes of a ``dist.mesh.ServingMesh`` (the only part of it that
    ``constrain`` reads), without a process group."""
    n_data: int
    n_model: int


def test_constrain_is_the_identity_outside_use_rules():
    x = torch.arange(12.0).reshape(3, 4)
    assert TS.current_rules() is None
    assert TS.constrain(x, "batch", "nonsense", "more", "axes") is x


def test_use_rules_nests_and_constrain_checks_inside():
    x = torch.zeros(4, 6, 8)
    outer, inner = TS.production_rules(), _rules("multi_pod", TS)
    with TS.use_rules(outer, _Mesh(2, 1)) as got:
        assert got is outer
        assert TS.current_rules()[0] is outer
        assert TS.constrain(x, "batch", "seq", None) is x
        with pytest.raises(ValueError, match="rank"):
            TS.constrain(x, "batch", None, None, "heads")
        with TS.use_rules(inner, _Mesh(2, 1)):
            assert TS.current_rules()[0] is inner
            with pytest.raises(ValueError, match="pod"):
                TS.constrain(x, "batch", None, None)
            assert TS.constrain(x, None, "seq", None) is x
        assert TS.current_rules()[0] is outer
        with TS.use_rules(inner):                   # no mesh: rank only
            assert TS.constrain(x, "batch", None, None) is x
    assert TS.current_rules() is None


def test_model_forward_under_rules_is_unchanged():
    """The models' constraint points pass a forward through unchanged
    under an installed table (each rank holds its own shard)."""
    cfg = dataclasses.replace(tconfigs.get_config("qwen2-moe-a2.7b",
                                                  smoke=True),
                              compute_dtype="float32")
    from repro_torch.models import transformer as TT
    p = TT.init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)))
    want = TT.forward(p, cfg, toks)[0]
    with TS.use_rules(_rules("moe_tp", TS), _Mesh(1, 1)):
        got = TT.forward(p, cfg, toks)[0]
    assert torch.equal(got, want)
