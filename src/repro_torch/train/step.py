"""Train step factory (port of ``repro.train.step``): loss -> gradients
(microbatches summed in order, then divided) -> clip -> AdamW -> the
optional QAT weight projection.

One factory serves every model family; the loss is chosen by the config
(``loss_for``).  Gradients come from ``torch.autograd`` over the port's
PyTorch forward: the QAT forward is ``fake_quant`` (straight through) and
float matmuls, as the reference's, so training launches none of the
integer kernels.  A step returns a new state dict and the metrics, as the
reference's pure step does; with ``donate=True`` the new parameters and
moments are written into the old state's tensors (JAX's buffer donation),
so the device holds one copy of them.

The QAT projection (paper Sec. 3.6) snaps every projection weight (a leaf
named ``['w']``) onto the W4 grid after the update.  The reference applies
it to its stacked ``[G, ...]`` leaves, so a column's scale is shared by
every layer at the same pattern position (every encoder or decoder layer
of an encoder-decoder); :func:`qat_project` takes that shared scale over
the port's per-layer leaves (``quantization.shared_scale``), which makes
the projected weights the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import torch

from repro_torch.core.quantization import W4, fake_quant, shared_scale
from repro_torch.core.tree import flatten, tree_map, unflatten
from repro_torch.models import encdec, mobilenet, transformer
from repro_torch.optim import adamw, schedules


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"              # cosine | wsd
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()
    n_microbatches: int = 1
    qat_project: bool = False             # paper Sec 3.6 post-update projection
    bf16_params: bool = False             # bf16 compute params + fp32 master


def loss_for(cfg) -> Callable:
    if getattr(cfg, "enc_dec", False):
        return lambda p, b: encdec.loss_fn(p, cfg, b)
    if isinstance(cfg, mobilenet.MobileNetConfig):
        return lambda p, b: mobilenet.loss_fn(p, cfg, b)
    return lambda p, b: transformer.loss_fn(p, cfg, b)


def init_state(params, bf16_params: bool = False) -> dict:
    if bf16_params:
        compute = tree_map(
            lambda x: x.to(torch.bfloat16)
            if x.dtype == torch.float32 and x.dim() >= 1 else x, params)
        return {"params": compute, "opt": adamw.init(params, keep_master=True)}
    return {"params": params, "opt": adamw.init(params)}


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays (``data.pipeline``) as tensors on
    ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _split_batch(batch: dict, n: int) -> list:
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def value_and_grad(loss_fn: Callable, params, batch: dict):
    """(loss, gradients shaped as ``params``) of ``loss_fn(params,
    batch)`` by autograd; a leaf the loss does not reach gets zeros."""
    leaves = flatten(params)[1]
    with torch.enable_grad():
        ins = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss = loss_fn(unflatten(params, ins), batch)
        grads = torch.autograd.grad(loss, ins, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten(params, grads)


_STACKED = re.compile(r"^\['(blocks|enc_blocks|dec_blocks)'\]\[(\d+)\]")


def qat_project(params, model_cfg, donate: bool = False):
    """``fake_quant(w, W4)`` of every leaf whose path ends in ``['w']`` and
    that is 2-D or more in the reference's layout, with one column scale
    per reference leaf: layers stacked there (the same pattern position of
    ``blocks``; all of ``enc_blocks``; all of ``dec_blocks``) share it.
    With ``donate`` the projected values are written into the leaves."""
    paths, leaves = flatten(params)
    period = len(getattr(model_cfg, "pattern", ())) or 1
    groups: dict = {}
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        if not path.endswith("['w']"):
            continue
        m = _STACKED.match(path)
        if m:
            pos = int(m.group(2)) % period if m.group(1) == "blocks" else 0
            key = (m.group(1), pos, path[m.end():])
            stacked = True
        else:
            key, stacked = (path,), False
        if leaf.dim() + stacked >= 2:
            groups.setdefault(key, []).append(i)
    out = list(leaves)
    for idx in groups.values():
        scale = shared_scale([leaves[i] for i in idx], W4)
        for i in idx:
            q = fake_quant(leaves[i], W4, scale=scale)
            out[i] = leaves[i].copy_(q) if donate else q
    return unflatten(params, out)


def lr_schedule(tcfg: TrainConfig) -> Callable:
    """The step -> learning-rate function ``tcfg`` names."""
    if tcfg.schedule == "wsd":
        return schedules.make(
            "wsd", peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
            stable=int(tcfg.total_steps * 0.8),
            decay=int(tcfg.total_steps * 0.1))
    return schedules.make("cosine", peak_lr=tcfg.peak_lr,
                          warmup=tcfg.warmup, total=tcfg.total_steps)


def make_train_step(model_cfg, tcfg: TrainConfig = TrainConfig(),
                    donate: bool = False):
    """``train_step(state, batch, mark=None) -> (new_state, metrics)``.

    ``batch`` holds numpy arrays or tensors; they move to the parameters'
    device.  ``mark(name)``, when given, is called after the gradients
    (``"grads"``) and after the update and projection (``"update"``):
    ``loop.StepTimer`` times the two halves with it.  ``metrics`` are
    device tensors: ``loss``, ``grad_norm`` and ``lr``."""
    loss_fn = loss_for(model_cfg)
    sched = lr_schedule(tcfg)

    def train_step(state: dict, batch: dict,
                   mark: Optional[Callable] = None):
        params = state["params"]
        dev = flatten(params)[1][0].device
        batch = to_device(batch, dev)
        n = tcfg.n_microbatches
        if n > 1:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for mb in _split_batch(batch, n):
                loss_mb, g = value_and_grad(loss_fn, params, mb)
                loss = loss + loss_mb
                grads = tree_map(torch.add, grads, g)
            div = torch.full((), float(n), dtype=torch.float32, device=dev)
            loss = loss / div
            grads = tree_map(lambda g: g / div, grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        if mark is not None:
            mark("grads")
        lr = sched(state["opt"]["step"])
        new_params, new_opt, gnorm = adamw.update(
            params, grads, state["opt"], lr, tcfg.adamw, donate=donate)
        del grads
        if tcfg.qat_project:
            new_params = qat_project(new_params, model_cfg, donate=donate)
        if mark is not None:
            mark("update")
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
