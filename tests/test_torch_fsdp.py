"""The FSDP train step (``train.fsdp``) in a gloo world of 4 spawned CPU
processes against the single-process ``make_train_step`` with
``n_microbatches = 4`` (rank r takes microbatch r), over 2 steps, at smoke
size in float32.

Every rank's shares of the parameters and of both AdamW moments, and the
loss and gradient norm, must equal the single-process step's bit for
bit after each step: the ranks' gradients are added in rank order from
zero as the single process adds its microbatches, the norm is taken over
each whole leaf in tree order, and AdamW is elementwise.

Cases: minicpm-2b at 16 tokens; minicpm-2b at d_model 70 (70 = 4 x 17
+ 2: every sharded leaf zero-padded to 4 equal shares) at 24 tokens with
kv_block 8 (the blocked attention path, forward and backward);
qwen2-moe-a2.7b (expert banks sharded on d_model, the MoE aux loss).
The specs are the reference's train-cell rules (``fsdp="data"``; the MoE
case expert-parallel as ``launch.mesh.rules_for`` sets qwen2-moe).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.tree import flatten
from repro_torch.dist import partitioning, sharding
from repro_torch.models import transformer as T
from repro_torch.serve.sharded import launch
from repro_torch.train import fsdp
from repro_torch.train import step as TS

from _torch_threads import one_torch_thread  # noqa: F401

WORLD_S = 120
N = 4
STEPS = 2
TCFG = TS.TrainConfig(peak_lr=1e-3, warmup=1, total_steps=10)
CASES = [
    dict(arch="minicpm-2b", S=16),
    dict(arch="minicpm-2b", S=24, d_model=70, kv_block=8),
    dict(arch="qwen2-moe-a2.7b", S=16),
]


def _cfg(case):
    over = {k: case[k] for k in ("d_model", "kv_block") if k in case}
    return dataclasses.replace(configs.get_config(case["arch"], smoke=True),
                               compute_dtype="float32", **over)


def _rules(cfg):
    r = sharding.production_rules()
    r["fsdp"] = "data"
    if cfg.moe is not None:
        r.update(expert="model", expert_mlp=None)
    return r


def _batches(cfg, S):
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, cfg.vocab, (N, S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(STEPS)]


def _snapshot(state, metrics) -> dict:
    return dict(params=flatten(state["params"])[1],
                m=flatten(state["opt"]["m"])[1],
                v=flatten(state["opt"]["v"])[1],
                step=int(state["opt"]["step"]),
                loss=metrics["loss"].clone(),
                grad_norm=metrics["grad_norm"].clone())


def _fsdp_world(mesh, cases):
    torch.set_num_threads(1)
    out = []
    for case in cases:
        cfg = _cfg(case)
        rules = _rules(cfg)
        params = T.init_params(cfg, device="cpu")
        layout = fsdp.fsdp_layout(params, rules, N)
        state = fsdp.init_fsdp_state(params, layout, N, mesh.data.index)
        del params
        step = fsdp.make_fsdp_train_step(cfg, mesh, rules, layout, TCFG)
        snaps = []
        for batch in _batches(cfg, case["S"]):
            state, metrics = step(state, batch)
            snaps.append(_snapshot(state, metrics))
        out.append(dict(snaps=snaps, dims=layout.dims,
                        bytes=fsdp.resident_bytes(state)))
    return out


def _single(case):
    cfg = _cfg(case)
    params = T.init_params(cfg, device="cpu")
    layout = fsdp.fsdp_layout(params, _rules(cfg), N)
    state = TS.init_state(params)
    full_bytes = fsdp.resident_bytes(state)
    step = TS.make_train_step(cfg, dataclasses.replace(
        TCFG, n_microbatches=N))
    snaps = []
    for batch in _batches(cfg, case["S"]):
        state, metrics = step(state, batch)
        snaps.append(_snapshot(state, metrics))
    return layout, snaps, full_bytes


@pytest.fixture(scope="module")
def world():
    """One world for the module: every case's snapshots by rank."""
    return launch(_fsdp_world, f"{N}x1", "gloo", timeout_s=WORLD_S,
                  args=(CASES,), device="cpu")


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c['arch']}-S{c['S']}" for c in CASES])
def test_fsdp_step_equals_the_microbatched_single_process_step(world, i):
    case = CASES[i]
    layout, want, full_bytes = _single(case)
    assert any(d is not None for d in layout.dims), case
    if "d_model" in case:                 # every sharded leaf padded
        assert all(layout.sizes[j] % N for j, d in enumerate(layout.dims)
                   if d is not None), case
    for r, rank in enumerate(world):
        got = rank[i]
        assert got["dims"] == layout.dims
        # the shares of the parameters and moments a rank keeps
        assert got["bytes"] < full_bytes / 2, (case, r)
        for t, (g, w) in enumerate(zip(got["snaps"], want)):
            where = (case["arch"], case["S"], r, t)
            assert g["step"] == w["step"] == t + 1, where
            assert torch.equal(g["loss"], w["loss"]), where
            assert torch.equal(g["grad_norm"], w["grad_norm"]), where
            for key in ("params", "m", "v"):
                for j, (a, b) in enumerate(zip(g[key], w[key], strict=True)):
                    share = fsdp._share(b, layout.dims[j], N, r)
                    assert torch.equal(a, share), (where, key, j)


def test_layout_shards_the_leaves_the_specs_name():
    """A leaf is sharded along the entry naming "data", nowhere else, and
    not at all on a one-rank mesh."""
    cfg = _cfg(CASES[0])
    params = T.init_params(cfg, device="meta")
    rules = _rules(cfg)
    layout = fsdp.fsdp_layout(params, rules, N)
    paths, leaves = flatten(params)
    for path, d, x in zip(paths, layout.dims, leaves):
        spec = partitioning.port_leaf_spec(path, x.dim(), rules)
        assert d == (spec.index("data") if "data" in spec else None), path
    assert dict(zip(paths, layout.dims))["['blocks'][0]['attn']['wq']['w']"] \
        == 0
    assert dict(zip(paths, layout.dims))["['blocks'][0]['attn']['wo']['w']"] \
        == 1
    assert set(fsdp.fsdp_layout(params, rules, 1).dims) == {None}


def test_share_pads_and_splits():
    x = torch.arange(2 * 7, dtype=torch.float32).reshape(2, 7)
    parts = [fsdp._share(x, 1, 3, r) for r in range(3)]
    assert all(p.shape == (2, 3) for p in parts)
    assert torch.equal(torch.cat(parts, 1)[:, :7], x)
    assert torch.equal(parts[2][:, 1:], torch.zeros(2, 2))
    assert fsdp._share(x, None, 3, 1) is x


def test_fsdp_step_refusals():
    class Mesh:
        n_data, n_model = 2, 2
    cfg = _cfg(CASES[0])
    layout = fsdp.Layout((), ())
    with pytest.raises(ValueError, match="data axis"):
        fsdp.make_fsdp_train_step(cfg, Mesh(), _rules(cfg), layout, TCFG)
    Mesh.n_model = 1
    for over in (dict(qat_project=True), dict(bf16_params=True),
                 dict(n_microbatches=2)):
        with pytest.raises(ValueError, match="n_microbatches=1"):
            fsdp.make_fsdp_train_step(cfg, Mesh(), _rules(cfg), layout,
                                      dataclasses.replace(TCFG, **over))
