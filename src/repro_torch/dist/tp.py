"""Tensor-parallel plumbing for the quantized/LUT projections (port of
``repro.dist.tp``).

The integer weight codes of every projection are split across the model
axis of a ``dist.mesh.ServingMesh`` and each rank runs its share of the LUT
contraction.  Four layouts, as the reference's:

  * **column-parallel** (``tp_col``): codes and per-channel scales split
    along N; every rank computes its output columns with the unsharded math,
    then an ``all_gather`` rebuilds the full activation.
  * **row-parallel** (``tp_row``): codes split along K.  The activation
    scale is taken over the full K (the unsharded scale), every rank
    contracts its K slice into int32 partial sums, and an int32
    ``all_reduce`` adds them: integer addition is exact, so the dequant
    epilogue sees the unsharded accumulator bit for bit.
  * **head-parallel** (``tp_head``): column-parallel without the gather, for
    the Q/K/V projections when both head counts divide the model axis.
    Attention (scores, softmax, KV cache) then runs on ``n_heads / tp``
    local heads, and the head-local output feeds the row-parallel ``wo``
    directly: its K slice is the local heads, and the full-K activation
    scale is the max of the per-rank maxima (exact).
  * **expert-parallel** (``tp_exp``): MoE expert banks ``[E, K, N]`` split
    along the expert axis when ``E`` divides the model axis; the router
    stays replicated, every rank runs its ``E / tp`` experts and an
    ``all_gather`` rebuilds the expert-output buffer.

:func:`mark_tp_params` inserts a zero-size marker (``tp_col`` / ``tp_row``
/ ``tp_head`` / ``tp_exp``) into each sharded leaf dict; ``layers.linear``
reads it with :func:`leaf_tp_mode`.  :func:`shard_params` then slices every
marked leaf to this rank's part (the counterpart of the reference's
``device_put`` with ``NamedSharding``).  The float 3D split-head leaves
(``split_head_params``: ``wq3``/``wk3``/``wv3`` [d, H, dh], ``wo3`` [H,
dh, d]) go head-parallel as whole groups: the Q/K/V leaves split their
head axis (an exact column split of a float product), ``wo3`` stays
replicated behind an all-gather of the local heads
(``models.attention._proj_out``).

:func:`tp_context` is installed by the sharded engine around its rounds;
outside it every hook here is the identity and the markers are inert, so
single-device code pays nothing.  The collectives the model code calls
(:func:`all_gather`, :func:`all_reduce_sum`, :func:`all_reduce_max`,
:func:`all_reduce_min`) call NCCL directly on CUDA tensors; a gloo group
holding CUDA tensors (ranks that share one card) stages them through
pinned host memory, in one code path.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import prng

# parent-key names whose quantized leaves are output projections: codes
# split along K with an exact int32 all-reduce.  Everything else eligible is
# column-parallel (split N, gather), which is correct for any projection.
_ROW_PARALLEL_NAMES = frozenset({"wo", "out_proj"})
# leaves under these parent keys never shard (embeddings are a lookup)
_SKIP_NAMES = frozenset({"embed"})
# the QKV projections that go head-parallel when the head counts divide
_HEAD_COL_NAMES = ("wq", "wk", "wv")
# their float split-head (3D) counterparts; ``wo3`` stays replicated
_HEAD_COL_3D = ("wq3", "wk3", "wv3")
# direct children of a "moe" dict that are stacked expert banks [E, K, N]
_EXPERT_BANK_NAMES = frozenset({"wi", "wg", "wo"})
MARKERS = ("tp_col", "tp_row", "tp_head", "tp_exp")

_CTX: list = []


@contextlib.contextmanager
def tp_context(model_axis, model_size: int, data_axis=None):
    """Activate tensor-parallel dispatch for the code run inside this block
    (the sharded engine wraps its rounds with it).  The axes are
    ``dist.mesh.Axis`` tuples (group, size, this rank's index)."""
    _CTX.append((model_axis, model_size, data_axis))
    try:
        yield
    finally:
        _CTX.pop()


def model_axis():
    return _CTX[-1][0] if _CTX else None


def model_size() -> int:
    return _CTX[-1][1] if _CTX else 1


def data_axis():
    """The data axis inside a tp_context (None outside one or when none is
    configured): the serving round uses it to turn local batch rows into
    global slot ids."""
    return _CTX[-1][2] if _CTX else None


def fold_in_data(key: torch.Tensor) -> torch.Tensor:
    """Give each data shard its own sampling stream: ``fold_in(key, data
    index)`` (the identity outside the context or when no data axis is
    configured).  Greedy decode never reads the key."""
    axis = data_axis()
    if axis is None:
        return key
    return prng.fold_in(key, axis.index)


def leaf_tp_mode(p: dict) -> Optional[str]:
    """Static layout of a (possibly marked) param leaf dict."""
    for name in MARKERS:
        if name in p:
            return name[3:]
    return None


def head_shardable(n_heads: int, n_kv: int, n_model: int) -> bool:
    """True when attention can run on local heads: every rank gets whole Q
    heads AND whole KV heads (``n_kv % n_model != 0`` falls back to
    replicated attention)."""
    return n_model > 1 and n_heads % n_model == 0 and n_kv % n_model == 0


# ---------------------------------------------------------------------------
# parameter marking and slicing
# ---------------------------------------------------------------------------

def _divisible(leaf: dict, mode: str, n_model: int) -> bool:
    w_q = leaf["w_q"]
    if w_q.dim() < 2:
        return False
    if mode == "row":
        # packed int4 rows are K//2: an even row split keeps every rank's K
        # slice even, so nibble pairs never straddle a boundary
        return w_q.shape[-2] % n_model == 0
    return w_q.shape[-1] % n_model == 0


def _leaf_split_dims(leaf: dict, mode: str) -> dict:
    """The axis (negative, from the end) each array of a sharded leaf splits
    along, or None where it is replicated: the reference's ``_leaf_specs``.
    Biases are replicated for col/row (added after the gather / reduce) and
    split along N for head-parallel leaves, whose output stays local; expert
    banks split the expert axis of codes and scales; a float split-head
    leaf (``w`` [d, H, dh], ``b`` [H, dh]) splits the head axis of both."""
    dims = {}
    for k in leaf:
        if "w" in leaf:
            dims[k] = -2 if k in ("w", "b") else None
        elif mode == "exp":
            dims[k] = -3 if k in ("w_q", "w_scale") else None
        elif k == "w_q":
            dims[k] = -2 if mode == "row" else -1
        elif k == "w_scale" and mode in ("col", "head"):
            dims[k] = -1
        elif k == "b" and mode == "head":
            dims[k] = -1
        else:
            dims[k] = None
    return dims


def _marked(leaf: dict, mode: str) -> tuple[dict, dict]:
    out = dict(leaf)
    ref = leaf["w_q"] if "w_q" in leaf else leaf["w"]
    out["tp_" + mode] = torch.zeros((0,), dtype=torch.int8,
                                    device=ref.device)
    return out, _leaf_split_dims(out, mode)


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replicated(v) for v in tree)
    return None


def _attn_head_counts(attn: dict, head_dim: int) -> tuple[int, int]:
    """(n_heads, n_kv) of one attention param dict, from leaf shapes."""
    if "wq3" in attn:
        return attn["wq3"]["w"].shape[-2], attn["wk3"]["w"].shape[-2]
    return (attn["wq"]["w_q"].shape[-1] // head_dim,
            attn["wk"]["w_q"].shape[-1] // head_dim)


def _is_attn_group(v) -> bool:
    """An attention group: quantized ``wq/wk/wv/wo`` leaves or float
    split-head ``wq3/wk3/wv3/wo3`` leaves."""
    if not isinstance(v, dict):
        return False
    return all(k in v and isinstance(v[k], dict) and "w_q" in v[k]
               for k in ("wq", "wk", "wv", "wo")) or all(
        k in v and isinstance(v[k], dict) and "w" in v[k]
        for k in _HEAD_COL_3D + ("wo3",))


def _mark_attn_heads(attn: dict):
    """Head-parallel marking of one attention group (the caller checked
    divisibility): (marked, dims, n_sharded).  Split-head leaves mark
    ``wq3``/``wk3``/``wv3`` (their head axis splits) and leave ``wo3``
    replicated.  Otherwise the output projection is ordinary row-parallel:
    its K rows are head-major, so the even K split IS the head split and
    the head-local attention output is already this rank's K slice (told
    apart by shape in ``ops.prequant_matmul``)."""
    out, dims = dict(attn), _replicated(attn)
    if "wq3" in attn:
        for k in _HEAD_COL_3D:
            out[k], dims[k] = _marked(attn[k], "head")
        return out, dims, len(_HEAD_COL_3D)
    for k in _HEAD_COL_NAMES:
        out[k], dims[k] = _marked(attn[k], "head")
    out["wo"], dims["wo"] = _marked(attn["wo"], "row")
    return out, dims, len(_HEAD_COL_NAMES) + 1


def _attn_head_marking_ok(attn: dict, head_dim: Optional[int],
                          n_model: int) -> bool:
    if head_dim is None or n_model <= 1:
        return False
    if not head_shardable(*_attn_head_counts(attn, head_dim), n_model):
        return False
    if "wq3" in attn:
        return True
    # every quantized leaf must split cleanly too (packed int4 wo rows are
    # n_heads * head_dim // 2: an odd per-rank row count would straddle a
    # nibble pair)
    return all(_divisible(attn[k], "col", n_model)
               for k in _HEAD_COL_NAMES) \
        and _divisible(attn["wo"], "row", n_model)


def mark_tp_params(params, n_model: int, head_dim: Optional[int] = None):
    """Tag every shardable quantized leaf of a serving tree.

    Walks the tree for serving-code leaves (``{"w_q", "w_scale"}``, from
    ``serve.quantize``) whose parent key names a projection.  Attention
    groups (dicts holding ``wq/wk/wv/wo``, or the float split-head
    ``wq3/wk3/wv3/wo3``) go head-parallel when
    ``head_dim`` is given and both head counts divide ``n_model``;
    otherwise, and for every other projection, ``wo``/``out_proj`` become
    row-parallel and the rest column-parallel.  MoE expert banks
    (``wi/wg/wo`` directly under a ``moe`` dict) split the expert axis when
    ``E % n_model == 0``; the router stays replicated, so the top-k choice
    is the same everywhere.  Leaves whose split axis does not divide stay
    replicated (correct, just not distributed).

    Returns ``(marked, dims, n_sharded)``: ``dims`` has the structure of
    ``marked`` and holds, per array, the axis :func:`shard_params` splits
    (negative, from the end) or None (the reference's PartitionSpecs)."""
    n_sharded = 0

    def walk(tree, skip=False, in_moe=False):
        nonlocal n_sharded
        if isinstance(tree, dict):
            if not skip and _is_attn_group(tree) \
                    and _attn_head_marking_ok(tree, head_dim, n_model):
                out, dims, n = _mark_attn_heads(tree)
                n_sharded += n
                return out, dims
            out, dims = {}, {}
            for k, v in tree.items():
                if in_moe and k in _EXPERT_BANK_NAMES \
                        and isinstance(v, dict) and "w_q" in v:
                    if n_model > 1 and v["w_q"].dim() >= 3 \
                            and v["w_q"].shape[-3] % n_model == 0:
                        out[k], dims[k] = _marked(v, "exp")
                        n_sharded += 1
                    else:
                        out[k], dims[k] = v, _replicated(v)
                    continue
                if in_moe and k == "router":
                    # a replicated router: the same top-k on every rank
                    out[k], dims[k] = walk(v, skip=True)
                    continue
                if (not skip and not in_moe and isinstance(v, dict)
                        and "w_q" in v and k not in _SKIP_NAMES):
                    mode = "row" if k in _ROW_PARALLEL_NAMES else "col"
                    if n_model > 1 and _divisible(v, mode, n_model):
                        out[k], dims[k] = _marked(v, mode)
                        n_sharded += 1
                        continue
                out[k], dims[k] = walk(v, skip or k in _SKIP_NAMES,
                                       k == "moe")
            return out, dims
        if isinstance(tree, (tuple, list)):
            pairs = [walk(v, skip, in_moe) for v in tree]
            return (type(tree)(p[0] for p in pairs),
                    type(tree)(p[1] for p in pairs))
        return tree, None

    marked, dims = walk(params)
    return marked, dims, n_sharded


def shard_params(marked, mesh):
    """This rank's part of a marked tree: every array of a marked leaf cut
    to its ``model_index``-th slice along :func:`mark_tp_params`' axis (a
    copy, so the full tensor can be freed); everything else as it is."""
    idx, n = mesh.model_index, mesh.n_model

    def cut(t: torch.Tensor, dim) -> torch.Tensor:
        if dim is None:
            return t
        step = t.shape[dim] // n
        return t.narrow(dim, idx * step, step).clone(
            memory_format=torch.contiguous_format)

    def walk(tree):
        if isinstance(tree, dict):
            mode = leaf_tp_mode(tree)
            if mode is not None:
                dims = _leaf_split_dims(tree, mode)
                return {k: cut(v, dims[k]) for k, v in tree.items()}
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return walk(marked)


def has_marker(params, marker: str) -> bool:
    """True if any leaf dict in ``params`` carries ``marker`` (e.g.
    ``"tp_head"``: the sharded engine keys its cache layout off it)."""
    if isinstance(params, dict):
        return marker in params or any(has_marker(v, marker)
                                       for v in params.values())
    if isinstance(params, (tuple, list)):
        return any(has_marker(v, marker) for v in params)
    return False


def attn_group_counts(params) -> tuple[int, int]:
    """(attention groups, head-marked attention groups) in a marked tree:
    the cache layout is one choice for the whole engine, so head marking
    must be all-or-nothing."""
    if _is_attn_group(params):
        return 1, int("tp_head" in params.get("wq3", params.get("wq")))
    if isinstance(params, dict):
        children = params.values()
    elif isinstance(params, (tuple, list)):
        children = params
    else:
        children = ()
    total = marked = 0
    for v in children:
        t, m = attn_group_counts(v)
        total, marked = total + t, marked + m
    return total, marked


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _staged(x: torch.Tensor, axis) -> bool:
    """A CUDA tensor on a gloo group: the collective runs on a pinned host
    copy (gloo does not reduce device memory)."""
    return x.is_cuda and dist.get_backend(axis.group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a device tensor (the copy waits for it)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_gather(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order along
    ``axis`` (the reference's tiled ``all_gather``)."""
    if axis.size == 1:
        return x
    src = _host(x) if _staged(x, axis) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim).to(x.device)


def _all_reduce(x: torch.Tensor, axis, op) -> torch.Tensor:
    if axis.size == 1:
        return x
    out = _host(x) if _staged(x, axis) else x.clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=axis.group)
    return out.to(x.device)


def all_reduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """The exact int32 sum of the ranks' partial accumulators."""
    if x.dtype != torch.int32:
        raise TypeError(f"all_reduce_sum adds int32 accumulators, got "
                        f"{x.dtype}: a float sum would depend on the order")
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise max of the ranks' float tensors (exact)."""
    if not x.is_floating_point():
        raise TypeError(f"all_reduce_max takes a float tensor, got "
                        f"{x.dtype}")
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def all_reduce_min(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise min of the ranks' integer tensors."""
    if x.is_floating_point() or x.dtype == torch.bool:
        raise TypeError(f"all_reduce_min takes an integer tensor, got "
                        f"{x.dtype}")
    return _all_reduce(x, axis, dist.ReduceOp.MIN)
