"""Parameter and optimizer-state specs from leaf *names* (port of
``repro.dist.partitioning``).

``param_specs`` walks a parameter tree and gives each leaf a spec (a
tuple of mesh-axis entries, one a dimension) from its key path, with the
reference's regexes: projection weights get (fsdp, tensor-parallel) on
their trailing (d_in, d_out) dimensions, expert banks (expert, fsdp,
expert_mlp), the embedding (vocab, fsdp), the head (fsdp, vocab);
everything unmatched is replicated (``()``).

The reference stacks each pattern position's layers into ``[G, ...]``
leaves (``blocks``, ``enc_blocks``, ``dec_blocks``); the port keeps a
list of per-layer dicts.  A per-layer leaf's spec is the reference's
spec of the stacked leaf without its leading (layer) entry, so the rank
rule and the regexes see the stacked rank.

``state_specs`` reuses the same rule: AdamW's moments live under
``['opt']['m']`` / ``['opt']['v']`` (and ``['opt']['master']``) with the
parameter's path as suffix, so they take their parameter's spec.
"""
from __future__ import annotations

import re

from repro_torch.core.tree import flatten, unflatten
from repro_torch.dist.sharding import Rules, spec_entry

# weights whose trailing dims are [d_in, d_out] with d_out the TP dim
_COL_PARALLEL = re.compile(
    r"\['(wq|wk|wv|wi|wg|wr|wu|in_proj)'\]\['(w|w_q)'\]$")
# output projections: [tp_in, d_out] — TP on the contracting dim
_ROW_PARALLEL = re.compile(r"\['(wo|out_proj)'\]\['(w|w_q)'\]$")
# split-head 3D variants [d, H, dh] / [H, dh, d]
_COL_3D = re.compile(r"\['(wq3|wk3|wv3)'\]\['w'\]$")
_ROW_3D = re.compile(r"\['wo3'\]\['w'\]$")
# MoE expert banks are raw leaves [E, d, ff] / [E, ff, d]
_MOE_IN = re.compile(r"\['moe'\]\['w[ig]'\](\['w_q'\])?$")
_MOE_OUT = re.compile(r"\['moe'\]\['wo'\](\['w_q'\])?$")
_EMBED = re.compile(r"\['embed'\]\['emb'\]$")
_HEAD = re.compile(r"\['lm_head'\]\['(w|w_q)'\]$")
_SCALE = re.compile(r"\['w_scale'\]$")
# a per-layer leaf of a stack the reference keeps as one [G, ...] leaf
_STACKED = re.compile(r"\['(blocks|enc_blocks|dec_blocks)'\]\[\d+\]")


def _tail(ndim: int, *entries) -> tuple:
    """Right-align ``entries`` onto an ndim-rank spec, None-padding the
    leading (stack) dims; drops entries that don't fit small ranks."""
    entries = entries[-ndim:] if len(entries) > ndim else entries
    return ((None,) * (ndim - len(entries))) + tuple(spec_entry(e)
                                                     for e in entries)


def leaf_spec(path: str, ndim: int, rules: Rules) -> tuple:
    """The reference's spec of a leaf of rank ``ndim`` at ``path``."""
    g = rules.get
    tp_attn = g("heads")
    tp_mlp = g("mlp")
    tp = tp_attn if "['attn']" in path else tp_mlp
    if ndim < 2:
        return ()
    if _MOE_IN.search(path):
        return _tail(ndim, g("expert"), g("fsdp"), g("expert_mlp"))
    if _MOE_OUT.search(path):
        return _tail(ndim, g("expert"), g("expert_mlp"), g("fsdp"))
    if _EMBED.search(path):
        return _tail(ndim, g("vocab"), g("fsdp"))
    if _HEAD.search(path):
        return _tail(ndim, g("fsdp"), g("vocab"))
    if _COL_3D.search(path):
        return _tail(ndim, g("fsdp"), g("heads"), None)
    if _ROW_3D.search(path):
        return _tail(ndim, g("heads"), None, g("fsdp"))
    if _COL_PARALLEL.search(path):
        return _tail(ndim, g("fsdp"), tp)
    if _ROW_PARALLEL.search(path):
        return _tail(ndim, tp, g("fsdp"))
    if _SCALE.search(path):
        return _tail(ndim, None, tp)
    return ()


def port_leaf_spec(path: str, ndim: int, rules: Rules) -> tuple:
    """A port leaf's spec: :func:`leaf_spec` at the reference's rank, less
    the leading layer entry of a stacked leaf."""
    if _STACKED.search(path):
        return leaf_spec(path, ndim + 1, rules)[1:]
    return leaf_spec(path, ndim, rules)


def _specs(tree, rules: Rules):
    paths, leaves = flatten(tree)
    return unflatten(tree, [port_leaf_spec(p, getattr(x, "ndim", 0), rules)
                            for p, x in zip(paths, leaves)])


def param_specs(params, rules: Rules):
    """Spec tree for a parameter tree (tensors, meta tensors included)."""
    return _specs(params, rules)


def state_specs(state, rules: Rules):
    """Spec tree for a train state (``{"params", "opt"}``): the optimizer
    moments take their parameter's spec through the path suffix."""
    return _specs(state, rules)
