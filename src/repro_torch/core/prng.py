"""The port's own counter-based random stream: the parts of ``jax.random``
that serving draws from (the threefry2x32 implementation with
partitionable bits), bit for bit, in torch integer ops on the key's device.

A key is an int32 tensor ``[..., 2]`` holding the two uint32 words of a
``jax.random`` key as their bit patterns.  Words are int32 and every add
wraps modulo 2^32; ``>>`` on int32 is arithmetic, so a logical shift masks
after it.  Nothing here reads a device value to the host, so a captured
CUDA graph holds the whole computation.

* :func:`threefry2x32` — 20 rounds with the rotation constants
  (13, 15, 26, 6) / (17, 29, 16, 24), key words extended with
  ``k0 ^ k1 ^ 0x1BD11BDA``, a key injection every 4 rounds.
* :func:`prng_key` — ``jax.random.PRNGKey(seed)``: ``[0, seed]`` (uint32).
* :func:`fold_in` — ``jax.random.fold_in``: the hash of the counter pair
  ``(0, data)``, ``data`` taken as uint32 (a negative value wraps); a
  vector of data gives one key per element.
* :func:`random_bits` — the partitionable form: element ``n`` (row-major
  flat index) hashes the counter pair ``(n >> 32, n & 0xFFFFFFFF)``, and
  its bits are the two output words XORed.
* :func:`uniform`, :func:`gumbel`, :func:`categorical` — as
  ``jax.random``: the top 23 bits as a mantissa in [1, 2) minus 1, scaled
  and clamped to ``minval``; ``-log(-log(uniform(tiny, 1)))``; the argmax of
  Gumbel noise plus logits (first index on ties).  The bits and uniforms
  equal ``jax.random``'s exactly; the two ``log``\\ s are ATen's, which may
  differ from XLA's by an ulp.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = 1.1754943508222875e-38          # float32's smallest normal number


def _i32(value: int) -> int:
    """A Python int's low 32 bits as a signed int32 value."""
    return ((value + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(key: torch.Tensor, x0, x1):
    """The threefry2x32 hash of the counter words ``(x0, x1)`` under
    ``key`` (int32 ``[..., 2]``, broadcast against the counters): the two
    output words, int32."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + (ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return torch.tensor([0, _i32(int(seed))], dtype=torch.int32,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: a new key from ``key`` [2] and
    ``data`` (a Python int or an integer tensor, taken as uint32).  A data
    tensor of shape ``S`` gives keys ``[*S, 2]``."""
    if isinstance(data, int):
        data = torch.full((), _i32(data), dtype=torch.int32,
                          device=key.device)
    else:
        data = data.to(torch.int32)
    y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack([y0, y1], -1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 as int32 bit patterns) for
    fewer than 2^31 elements, whose high counter words are all 0."""
    lo = torch.arange(math.prod(shape), dtype=torch.int32, device=key.device)
    y0, y1 = threefry2x32(key, torch.zeros((), dtype=torch.int32,
                                           device=key.device), lo)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int],
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    floats = mant.view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    lo = float(lo)
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: int64 indices."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


