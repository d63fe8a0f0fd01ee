"""FSDP training over a process group: parameters and AdamW moments
sharded along the dimension ``dist.partitioning`` names for the ``fsdp``
axis (the reference's ZeRO-style train cells: ``launch.mesh.rules_for``
sets ``fsdp="data"`` for every train shape).

Each rank of a ``(n_data, 1)`` mesh holds its 1/n share of every leaf
whose spec names the data axis, and of that leaf's moments; a leaf whose
dimension does not divide is zero-padded to n equal shares (the pad's
gradient is zero, so its moments and values stay zero).  Every other leaf
is replicated.  A step:

1. all-gathers the parameters and runs the forward and backward on the
   rank's rows of the batch (``n_microbatches = n`` of ``make_train_step``,
   rank r taking microbatch r);
2. reduce-scatters the gradients: shard j of each rank's gradient goes to
   rank j (a gather), which adds them in rank order from zero, as the
   single-process step adds its microbatches, then divides by n
   (replicated leaves and the loss: all-gathered and added the same way);
3. takes the global norm over the whole gradient: rank 0 gathers each
   sharded leaf's reduced shares and adds each full leaf's sum of squares
   in tree order, as ``adamw.global_norm`` does, and broadcasts the norm;
4. runs AdamW on the rank's share with the clip from that norm.

Every collective on a CUDA tensor over gloo goes through pinned host
copies (``dist.tp``).  The order of every sum is the single-process
step's, so on one device the new parameters, moments, loss and gradient
norm equal ``make_train_step(n_microbatches=n)``'s bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.tree import flatten, unflatten
from repro_torch.dist import tp as tp_lib
from repro_torch.dist.partitioning import port_leaf_spec
from repro_torch.dist.sharding import entry_axes, use_rules
from repro_torch.optim import adamw
from repro_torch.train.step import (TrainConfig, _split_batch, loss_for,
                                    lr_schedule, to_device, value_and_grad)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where each leaf is sharded: ``dims`` (flattened leaf order) the
    sharded dimension or None, ``sizes`` that dimension's full length."""
    dims: tuple
    sizes: tuple


def fsdp_layout(params, rules, n_data: int) -> Layout:
    """The layout of ``params`` (full tensors or meta tensors) under
    ``rules`` on a mesh with ``n_data`` ranks on its ``"data"`` axis: a
    leaf is sharded along the dimension whose spec entry names it."""
    paths, leaves = flatten(params)
    dims = []
    for path, x in zip(paths, leaves):
        spec = port_leaf_spec(path, x.dim(), rules)
        named = [d for d, e in enumerate(spec) if "data" in entry_axes(e)]
        dims.append(named[0] if named and n_data > 1 else None)
    return Layout(tuple(dims), tuple(x.shape[d] if d is not None else 0
                                     for x, d in zip(leaves, dims)))


def _share(x: torch.Tensor, dim: Optional[int], n: int,
           r: int) -> torch.Tensor:
    """Rank r's share of ``x`` along ``dim`` (zero-padded to n equal
    shares), a fresh tensor; ``x`` itself when ``dim`` is None."""
    if dim is None:
        return x
    c = -(-x.shape[dim] // n)
    pad = n * c - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    return x.narrow(dim, r * c, c).clone()


def init_fsdp_state(params, layout: Layout, n: int, r: int) -> dict:
    """Rank r's state: its shares of the parameters and AdamW moments."""
    shards = unflatten(params, [_share(x, d, n, r) for x, d in zip(
        flatten(params)[1], layout.dims, strict=True)])
    return {"params": shards, "opt": adamw.init(shards)}


class _Clock:
    """Host seconds spent in collectives (CUDA tensors on gloo are staged
    through the host, so each call returns once its data is there)."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds += time.perf_counter() - t0
        return out


def _gather(x: torch.Tensor, dim: Optional[int], size: int, axis
            ) -> torch.Tensor:
    if dim is None:
        return x
    full = tp_lib.all_gather(x, axis, dim)
    if full.shape[dim] != size:
        full = full.narrow(dim, 0, size).contiguous()
    return full


def _rank_order_sum(parts: list) -> torch.Tensor:
    total = torch.zeros_like(parts[0])
    for x in parts:
        total = total + x
    return total


def _all_gather_list(x: torch.Tensor, axis) -> list:
    """Every rank's ``x`` (same shape), in rank order, on the host when
    ``x`` is a CUDA tensor on gloo."""
    src = tp_lib._host(x) if tp_lib._staged(x, axis) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return parts


def _reduce_scatter(g: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """This rank's share of the ranks' ``g`` added in rank order from
    zero: shard j of every rank's gradient is gathered on rank j (one
    ``gather`` a destination: gloo has no all-to-all in every torch)."""
    n = axis.size
    shards = [_share(g, dim, n, j) for j in range(n)]
    if tp_lib._staged(g, axis):
        shards = [tp_lib._host(s) for s in shards]
    mine = None
    for j in range(n):
        recv = ([torch.empty_like(shards[j]) for _ in range(n)]
                if j == axis.index else None)
        dist.gather(shards[j], recv, dst=dist.get_global_rank(axis.group, j),
                    group=axis.group)
        if recv is not None:
            mine = recv
    return _rank_order_sum(mine).to(g.device)


def _global_norm(shares: list, layout: Layout, axis) -> torch.Tensor:
    """``adamw.global_norm`` of the whole gradient from the ranks' shares:
    rank 0 gathers each sharded leaf whole and adds the leaves' sums of
    squares in tree order; the float32 norm is broadcast to every rank."""
    first = dist.get_global_rank(axis.group, 0)
    total = 0
    for g, d, s in zip(shares, layout.dims, layout.sizes):
        if d is None:
            whole = g
        else:
            src = tp_lib._host(g) if tp_lib._staged(g, axis) \
                else g.contiguous()
            parts = ([torch.empty_like(src) for _ in range(axis.size)]
                     if axis.index == 0 else None)
            dist.gather(src, parts, dst=first, group=axis.group)
            if axis.index != 0:
                continue
            whole = torch.cat(parts, d).narrow(d, 0, s).contiguous() \
                .to(g.device)
        if axis.index == 0:
            total = total + torch.sum(torch.square(whole.to(torch.float32)))
    gn = adamw._sqrt(torch.as_tensor(total, dtype=torch.float32)) \
        if axis.index == 0 else shares[0].new_zeros((), dtype=torch.float32)
    src = tp_lib._host(gn.reshape(1)) if tp_lib._staged(gn, axis) \
        else gn.reshape(1).clone()
    dist.broadcast(src, first, group=axis.group)
    return src.to(shares[0].device)[0]


def make_fsdp_train_step(model_cfg, mesh, rules, layout: Layout,
                         tcfg: TrainConfig = TrainConfig(),
                         donate: bool = False) -> Callable:
    """``train_step(state, batch, mark=None) -> (new_state, metrics)`` on
    rank ``mesh.data.index`` of a ``(n_data, 1)`` ``dist.mesh`` mesh;
    ``state`` from :func:`init_fsdp_state`.  ``batch`` is the whole
    batch (every rank gets the same); the rank takes its rows.  The model
    runs under ``use_rules(rules, mesh)``.  ``metrics``: ``loss``,
    ``grad_norm``, ``lr`` as ``make_train_step``'s, and ``collective_s``,
    the host seconds spent in collectives.  ``mark`` as
    ``make_train_step``'s ("grads" after the reduce-scatter, "update")."""
    if mesh.n_model != 1:
        raise ValueError(f"the FSDP step shards over the data axis only; "
                         f"the mesh is {mesh.n_data}x{mesh.n_model}")
    if tcfg.qat_project or tcfg.bf16_params or tcfg.n_microbatches != 1:
        raise ValueError("the FSDP step takes n_microbatches=1 (each rank "
                         "is one microbatch), no qat_project and no "
                         "bf16_params")
    loss_fn = loss_for(model_cfg)
    sched = lr_schedule(tcfg)
    axis = mesh.data
    n, r = axis.size, axis.index

    def train_step(state: dict, batch: dict,
                   mark: Optional[Callable] = None):
        clock = _Clock()
        shards = state["params"]
        leaves = flatten(shards)[1]
        dev = leaves[0].device
        batch = to_device(batch, dev)
        mb = _split_batch(batch, n)[r] if n > 1 else batch
        full = unflatten(shards, [clock(_gather, x, d, s, axis) for x, d, s
                                  in zip(leaves, layout.dims, layout.sizes)])
        with use_rules(rules, mesh):
            loss_r, grads = value_and_grad(loss_fn, full, mb)
        del full
        div = torch.full((), float(n), dtype=torch.float32, device=dev)
        loss = _rank_order_sum(clock(_all_gather_list, loss_r.reshape(1),
                                     axis)).to(dev)[0] / div
        shares = []
        for g, d in zip(flatten(grads)[1], layout.dims):
            if d is None:
                g = _rank_order_sum(clock(_all_gather_list, g, axis)).to(dev)
            else:
                g = clock(_reduce_scatter, g, d, axis)
            shares.append(g / div)
        del grads
        if mark is not None:
            mark("grads")
        gn = clock(_global_norm, shares, layout, axis)
        lr = sched(state["opt"]["step"])
        new_shards, new_opt, gn = adamw.update(
            shards, unflatten(shards, shares), state["opt"], lr, tcfg.adamw,
            donate=donate, grad_norm=gn)
        if mark is not None:
            mark("update")
        metrics = {"loss": loss, "grad_norm": gn, "lr": lr,
                   "collective_s": clock.seconds}
        return {"params": new_shards, "opt": new_opt}, metrics

    return train_step


def resident_bytes(tree) -> int:
    """Bytes of the tensors of ``tree``."""
    return sum(x.numel() * x.element_size() for x in flatten(tree)[1]
               if isinstance(x, torch.Tensor))

