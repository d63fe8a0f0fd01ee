"""JAX parameter trees -> port parameters.

``params_from_jax(tree, cfg)`` takes the reference's parameter pytree after
``jax.tree_util.tree_map(np.asarray, params)`` — float or already quantized
by ``repro.serve.quantize`` — and returns the port's dict-of-tensors:
the ``[G, ...]`` block stacks of each pattern position are unstacked into a
per-layer list (layer ``g * len(pattern) + j``), every leaf keeps its
``[K, N]`` / ``[K//2, N]`` / ``[P, K//8, N]`` layout and dtype (the
zero-size ``w_tmac`` / ``w_tern`` markers become shape-``(0,)`` tensors),
so both packages compute the same function from the same weights and
codes.  An encoder-decoder tree (whisper: ``enc_blocks`` /
``dec_blocks``, one ``[L, ...]`` stack each) becomes ``models.encdec``'s
two per-layer lists.  ``mobilenet_params_from_jax`` does the same for the
reference's MobileNetV2 tree (``{name: {"w", "bn_*"}, "fc": {"w", "b"}}``,
HWIO weights).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack(stack, n: int, dev) -> list:
    """Layer i of every ``[n, ...]`` leaf of ``stack``, for i < n."""
    return [_map(stack, lambda a, i=i: _tensor(a[i], dev)) for i in range(n)]


def params_from_jax(tree: dict, cfg, device=None) -> dict:
    dev = resolve_device(device)
    if "enc_blocks" in tree:
        out = {k: _map(v, lambda a: _tensor(a, dev))
               for k, v in tree.items() if k not in ("enc_blocks",
                                                     "dec_blocks")}
        out["enc_blocks"] = _unstack(tree["enc_blocks"], cfg.n_enc_layers,
                                     dev)
        out["dec_blocks"] = _unstack(tree["dec_blocks"], cfg.n_layers, dev)
        return out
    P = len(cfg.pattern)
    G = cfg.n_layers // P
    stacks = tree["blocks"]
    if len(stacks) != P:
        raise ValueError(f"tree has {len(stacks)} pattern positions, cfg "
                         f"{cfg.name} has {P}")
    blocks = []
    for g in range(G):
        for j in range(P):
            blocks.append(_map(stacks[j], lambda a, g=g: _tensor(a[g], dev)))
    out = {k: _map(v, lambda a: _tensor(a, dev))
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def mobilenet_params_from_jax(tree: dict, device=None) -> dict:
    """The reference's MobileNetV2 parameters (numpy leaves) as tensors in
    the same layout."""
    dev = resolve_device(device)
    return _map(tree, lambda a: _tensor(a, dev))
