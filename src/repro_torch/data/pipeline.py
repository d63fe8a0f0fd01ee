"""Deterministic, shard-aware synthetic data pipeline (a numpy copy of
``repro.data.pipeline``: the same batches, bit for bit).

Every host generates exactly its shard of the global batch from
(seed, step, shard_index) — no host-to-host coordination, which is the
property that makes elastic restarts and straggler exclusion cheap: a host
that takes over another's shard produces bit-identical data.

Synthetic task: next-token prediction over a mixture of periodic integer
sequences (learnable — losses drop fast) plus uniform noise tokens.
Batches are numpy arrays on the host; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 1024
    seq_len: int = 128
    global_batch: int = 8
    n_shards: int = 1
    shard: int = 0
    noise_frac: float = 0.1


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard]))


def lm_batch(cfg: DataConfig, step: int) -> dict:
    """Returns {"tokens": [b, S], "labels": [b, S]} for this shard."""
    b = cfg.global_batch // cfg.n_shards
    rng = _batch_rng(cfg, step)
    period = rng.integers(2, 17, size=(b, 1))
    phase = rng.integers(0, cfg.vocab, size=(b, 1))
    stride = rng.integers(1, 7, size=(b, 1))
    t = np.arange(cfg.seq_len + 1)[None, :]
    seq = (phase + stride * (t % period)) % cfg.vocab
    noise = rng.random(size=seq.shape) < cfg.noise_frac
    seq = np.where(noise, rng.integers(0, cfg.vocab, size=seq.shape), seq)
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


def image_batch(cfg: DataConfig, step: int, resolution: int = 32,
                n_classes: int = 10) -> dict:
    """Class-conditional gaussian-blob images, NHWC float32."""
    b = cfg.global_batch // cfg.n_shards
    rng = _batch_rng(cfg, step)
    labels = rng.integers(0, n_classes, size=(b,))
    # the reference draws (and discards) a normal block here; drawing it
    # keeps the generator's stream, and so every image, the same
    rng.standard_normal((n_classes, resolution, resolution, 3))
    cls_rng = np.random.default_rng(cfg.seed + 1234)
    patterns = cls_rng.standard_normal((n_classes, resolution, resolution, 3))
    imgs = patterns[labels] + 0.3 * rng.standard_normal(
        (b, resolution, resolution, 3))
    return {"images": imgs.astype(np.float32),
            "labels": labels.astype(np.int32)}


def iterate(cfg: DataConfig, start_step: int = 0,
            kind: str = "lm", **kw) -> Iterator[dict]:
    step = start_step
    while True:
        yield (lm_batch(cfg, step) if kind == "lm"
               else image_batch(cfg, step, **kw))
        step += 1
