"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (port of ``repro.optim.grad_compress``).

Each leaf's ``g + residual`` is quantized to int8 under one scale shared
by the process group (a ``MAX`` all-reduce of the leaves' max-abs), the
int32 codes are summed with a ``SUM`` all-reduce, which is exact, and the
sum is dequantized and divided by the group's size; the quantization error
is carried to the next step as the new residual (error feedback).  The
quantizer divides by the scale tensor (an IEEE division on every device)
and rounds half to even (``torch.round``), as the reference's ``jnp.round``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.tree import flatten, tree_map, unflatten


def init_residual(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_decompress(g: torch.Tensor, residual: torch.Tensor,
                        scale: torch.Tensor):
    """Quantize (g + residual) with a given shared scale: (int8 codes, the
    new residual)."""
    gf = g.to(torch.float32) + residual
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, gf - q.to(torch.float32) * scale


def compressed_psum(grads, residuals, group=None):
    """Error-feedback compressed mean over the ranks of ``group`` (the
    default process group when None; ``dist.mesh`` builds a mesh axis's
    group).  Returns (reduced_grads, new_residuals)."""
    n = dist.get_world_size(group)

    def one(g, r):
        gf = g.to(torch.float32) + r
        amax = torch.clamp_min(torch.amax(torch.abs(gf)), 1e-12)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax / torch.full((), 127.0, device=amax.device)
        q, r_new = compress_decompress(g, r, scale)
        s = q.to(torch.int32)       # int32: at most 127 * n per element
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        mean = s.to(torch.float32) * scale / torch.full(
            (), float(n), device=s.device)
        return mean, r_new

    out = [one(g, r) for g, r in zip(flatten(grads)[1],
                                     flatten(residuals)[1], strict=True)]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
