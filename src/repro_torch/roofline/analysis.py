"""Parameter and FLOP counts and the mixed per-leaf weight-width planner
(port of the counting and planning half of ``repro.roofline.analysis``).

``plan_mixed_bits`` reads nothing but each leaf's ``.shape``, so a caller
can plan a full-width model from ``transformer.init_params(cfg,
device="meta")`` without holding its float weights.

The reference keeps a pattern position's layers as one ``[G, ...]`` stack
and plans one leaf per stack (``['blocks'][j]``, or ``['enc_blocks']`` /
``['dec_blocks']`` of an encoder-decoder).  The port keeps one dict a layer
(``['blocks'][i]``, ``i = g * len(cfg.pattern) + j``), so the planner
groups the layers of a pattern position into the reference's stacks
(:func:`_reference_view`), runs the reference's greedy over them and
gives each group's mode to every layer in it.  The greedy demotes the
first of equal savings, so the walk order decides ties: it takes every
dict in sorted key order, the order of the reference's trees once they
have been through any JAX transformation (``jit``, ``eval_shape``,
``tree_map``).  The port's dicts keep insertion order (``wq, wk, wv, wo``;
``wi, wg, wo``), which would give another plan (full-width qwen2-7b at 2.0
bits: w1 on ``wi`` instead of ``wg``).
"""
from __future__ import annotations

import math
import re
from typing import Optional

from repro_torch.serve.quantize import _INNER_W

_MOE_BANK = re.compile(r"\['moe'\]\['w[igo]'\]")
_STACKED = re.compile(r"\['(blocks|enc_blocks|dec_blocks)'\](?:\[(\d+)\])?")


def _leaves(tree, path: str = ""):
    """(path, leaf) of every leaf with a shape, paths as the reference's
    ``jax.tree_util.keystr``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif hasattr(tree, "shape"):
        yield path, tree


def count_params(params, moe_top_k: Optional[int] = None,
                 n_experts: Optional[int] = None) -> dict:
    """{"total": N, "active": N_active}: every leaf's elements, and with
    ``moe_top_k`` / ``n_experts`` the expert banks counted at top_k of
    n_experts."""
    total = 0
    expert = 0
    for name, leaf in _leaves(params):
        n = math.prod(leaf.shape)
        total += n
        if _MOE_BANK.search(name):
            expert += n
    active = total
    if expert and moe_top_k and n_experts:
        active = total - expert + expert * moe_top_k / n_experts
    return {"total": total, "active": active}


def model_flops(kind: str, n_active: float, global_batch: int,
                seq_len: int) -> float:
    """6ND for a training step, 2ND for a prefill, 2N a sequence for a
    decode step (one token each)."""
    if kind == "train":
        return 6.0 * n_active * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active * global_batch * seq_len
    return 2.0 * n_active * global_batch


# ---------------------------------------------------------------------------
# mixed per-layer weight bit widths (the tmac serving family)
# ---------------------------------------------------------------------------

# demotion ladder: width spec -> effective bits per weight
_BITS_LADDER = ((4, 4.0), (3, 3.0), (2, 2.0), ("ternary", 1.58), (1, 1.0))


class _Stack:
    """A leaf of one pattern position over its layers: the shape of the
    reference's stacked ``[G, ...]`` leaf."""

    def __init__(self, shape: tuple):
        self.shape = shape
        self.ndim = len(shape)


def _stack(layers: list):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lyr[k] for lyr in layers]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([lyr[i] for lyr in layers]) for i in range(len(first))]
    return _Stack((len(layers),) + tuple(first.shape))


def _reference_view(params: dict, cfg) -> dict:
    """``params`` as the reference holds it: ``blocks`` as one stack per
    pattern position (layers j, j + P, ...), ``enc_blocks`` and
    ``dec_blocks`` as one stack each."""
    view = {}
    for k, v in params.items():
        if k == "blocks":
            P = len(cfg.pattern)
            view[k] = [_stack(v[j::P]) for j in range(P)]
        elif k in ("enc_blocks", "dec_blocks"):
            view[k] = _stack(v)
        else:
            view[k] = v
    return view


def _layer_paths(path: str, params: dict, cfg) -> list:
    """The port's paths of the reference's path ``path``: one a layer of
    its stack."""
    m = _STACKED.match(path)
    if m is None:
        return [path]
    stack, j = m.group(1), m.group(2)
    rest = path[m.end():]
    layers = range(len(params[stack]))
    if stack == "blocks":
        layers = layers[int(j)::len(cfg.pattern)]
    return [f"['{stack}'][{i}]{rest}" for i in layers]


def plan_mixed_bits(params, target_bits: float, cfg, abits: int = 4,
                    attn_floor: float = 2.0, mlp_floor: float = 1.0) -> dict:
    """Per-leaf tmac weight widths that bring the parameter-weighted mean
    width to ``target_bits``.

    Decode's projections are bound by their weight bytes, and the tmac
    kernel's work is linear in the plane count, so fewer weight bits cut
    both.  Greedy, as the reference: demote the group (a pattern
    position's leaf over its layers) with the largest saving one ladder
    step (4 -> 3 -> 2 -> ternary -> 1) until the mean reaches the target,
    attention projections kept at ``attn_floor`` bits or more, the rest at
    ``mlp_floor``.  The embedding and the head are outside the plan (the
    serving walk keeps the head at 8 bits, the paper's first/last-layer
    rule).

    Returns ``{path: mode}`` keyed by the paths
    ``serve.quantize.quantize_params_for_serving`` builds
    (``"['blocks'][i]['attn']['wq']['w']"``), one per layer: pass it as that
    function's ``bits_plan`` or as ``ServeConfig.bits_plan``.  ``cfg``
    gives the pattern length.
    """
    leaves: list[list] = []       # [path, n_params, is_attn, ladder_idx]

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                v = tree[k]
                sub = f"{path}['{k}']"
                if isinstance(v, dict) and "w" in v and _INNER_W.search(
                        sub + "['w']") and getattr(v["w"], "ndim", 0) >= 2:
                    leaves.append([sub + "['w']", math.prod(v["w"].shape),
                                   "['attn']" in sub, 0])
                else:
                    walk(v, sub)
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, f"{path}[{i}]")

    walk(_reference_view(params, cfg))
    if not leaves:
        return {}
    total = sum(n for _, n, _, _ in leaves)

    def avg() -> float:
        return sum(n * _BITS_LADDER[i][1] for _, n, _, i in leaves) / total

    while avg() > target_bits:
        best, best_save = None, 0.0
        for leaf in leaves:
            _, n, is_attn, i = leaf
            if i + 1 >= len(_BITS_LADDER):
                continue
            floor = attn_floor if is_attn else mlp_floor
            if _BITS_LADDER[i + 1][1] < floor:
                continue
            save = n * (_BITS_LADDER[i][1] - _BITS_LADDER[i + 1][1])
            if save > best_save:
                best, best_save = leaf, save
        if best is None:          # every leaf at its floor
            break
        best[3] += 1

    def mode(spec) -> str:
        return (f"ternary_a{abits}_tmac" if spec == "ternary"
                else f"w{spec}a{abits}_tmac")

    return {layer: mode(_BITS_LADDER[i][0])
            for path, _, _, i in leaves
            for layer in _layer_paths(path, params, cfg)}
