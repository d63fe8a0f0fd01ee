"""AdamW over trees of tensors (port of ``repro.optim.adamw``).

The state is ``{"m", "v", "step"[, "master"]}``: float32 moments shaped as
the parameters, an int32 step counter and, with ``keep_master``, a float32
master copy of parameters that are kept in bf16 for compute.  ``update``
follows the reference's order of operations in float32: ``b ** step`` (the
C library's ``powf`` on the host, as the reference's XLA CPU backend calls
it), ``m / (1 - b1 ** t)``, ``mhat / (sqrt(vhat) + eps) + wd * p``, then
``p - lr * delta`` cast back to the parameter's dtype.  The square root is
correctly rounded on every device (ATen's float32 CPU ``sqrt`` can be an
ulp off).

The port's parameter tree is a list of per-layer dicts where the reference
stacks each pattern position's layers into one ``[G, ...]`` leaf, so
:func:`global_norm` sums other partial sums in another order: the gradient
norm (and the clip scale drawn from it) matches the reference's only to a
float32 tolerance, not bitwise.

``update(..., donate=True)`` writes the new parameters and moments into the
old state's tensors (JAX's buffer donation): one copy of the parameters and
moments instead of two at the peak, with the same values.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import flatten, tree_map, unflatten
from repro_torch.optim.schedules import libm_f32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: CUDA's is; on the CPU the
    float64 root rounded once."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def init(params, keep_master: bool = False) -> dict:
    """``keep_master=True``: params may be bf16 for compute; a float32
    master copy lives in the optimizer state."""
    leaves = flatten(params)[1]
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(tree):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), tree)
    st = {"m": zeros(params), "v": zeros(params),
          "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if keep_master:
        st["master"] = tree_map(lambda x: x.to(torch.float32, copy=True),
                                params)
    return st


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in tree order, of each leaf's sum
    of squares (float32)."""
    total = 0
    for leaf in flatten(tree)[1]:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return _sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(grads, max_norm: float, gn=None):
    """(min(1, max_norm / norm), norm); ``gn`` is the norm when the caller
    has it (a sharded step's, over the whole gradient)."""
    if gn is None:
        gn = global_norm(grads)
    return torch.clamp_max(_f32(max_norm, gn) / torch.clamp_min(gn, 1e-9),
                           1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm) in float32, the norm)."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def update(params, grads, opt_state: dict, lr: torch.Tensor,
           cfg: AdamWConfig = AdamWConfig(), donate: bool = False,
           grad_norm: torch.Tensor = None):
    """Returns (new_params, new_opt_state, grad_norm).  With ``donate`` the
    results live in the tensors of ``params`` and ``opt_state``, which
    must not be read as the old values afterwards.  ``grad_norm``, when
    given, is the clip's norm in place of ``global_norm(grads)``: an FSDP
    rank's ``grads`` are its share of a gradient whose norm is global."""
    # clipped leaf by leaf inside ``upd`` (the values clip_by_global_norm
    # gives, without a second copy of every gradient)
    scale, gn = _clip_scale(grads, cfg.grad_clip, grad_norm)
    step = opt_state["step"] + 1
    t = step.to(torch.float32)
    one = _f32(1.0, t)
    b1c = one - libm_f32("powf", _f32(cfg.b1, t), t)
    b2c = one - libm_f32("powf", _f32(cfg.b2, t), t)
    b1, b2 = _f32(cfg.b1, t), _f32(cfg.b2, t)
    c1, c2 = _f32(1 - cfg.b1, t), _f32(1 - cfg.b2, t)
    eps, wd = _f32(cfg.eps, t), _f32(cfg.weight_decay, t)
    lr = torch.as_tensor(lr, dtype=torch.float32).to(t.device)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = b1 * m + c1 * g
        v_new = b2 * v + c2 * g * g
        mhat = m_new / b1c
        vhat = v_new / b2c
        pf = p.to(torch.float32)
        delta = mhat / (_sqrt(vhat) + eps) + wd * pf
        new = (pf - lr * delta).to(p.dtype)
        if donate:
            p.copy_(new)
            m.copy_(m_new)
            v.copy_(v_new)
            return p, m, v
        return new, m_new, v_new

    src = opt_state.get("master", params)    # fp32 master if present
    flat_p = flatten(src)[1]
    flat_g = flatten(grads)[1]
    flat_m = flatten(opt_state["m"])[1]
    flat_v = flatten(opt_state["v"])[1]
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m,
                                                 flat_v, strict=True)]
    new_src = unflatten(src, [o[0] for o in out])
    new_state = {"m": unflatten(src, [o[1] for o in out]),
                 "v": unflatten(src, [o[2] for o in out]), "step": step}
    if "master" in opt_state:
        new_state["master"] = new_src
        if donate:
            for p, x in zip(flatten(params)[1], flatten(new_src)[1]):
                p.copy_(x)
            new_p = params
        else:
            new_p = tree_map(lambda x, p: x.to(p.dtype), new_src, params)
    else:
        new_p = new_src
    return new_p, new_state, gn
