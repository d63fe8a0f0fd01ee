"""Deterministic fault injection for the serving stack (port of
``repro.serve.faults``).

A ``FaultPlan`` is a seeded, replayable list of faults the engine applies at
its two dispatch sites (``admit`` / ``decode``), keyed on a MONOTONE
per-site dispatch counter.  The counter never rewinds — after a recovery
restores an earlier snapshot, the replayed dispatches run at *higher*
indices, so a consumed fault does not re-fire.  That is the transient-fault
model: each injected fault happens exactly once, and transcripts with
faults + recovery are token-identical to the fault-free run.

Fault categories (the ``kind`` field):

  * ``"nan_logits"`` — poison the live KV cache of one ACTIVE slot with a
    NaN, in place (the float K row at position 0 of every layer for float
    caches, the ``k_scale`` plane for int8-KV, the mapped pool page for
    paged engines).  The real decode round then carries the NaN through
    attention into that row's logits and into the cache rows it writes,
    which the engine's finite-logits and cache-finiteness guards surface
    to the scheduler.
  * ``"page_table"`` — corrupt one row of the host page table with an
    out-of-range page id; ``PagePool.validate()`` catches it before the
    table is copied to the device.  Skipped (marked fired) on dense
    engines.
  * ``"dispatch"`` — raise :class:`InjectedFault` BEFORE the round runs
    (the lost-accelerator-call category).  Engine and scheduler state are
    untouched, so a retry round simply re-dispatches.
  * ``"stall"`` — ``time.sleep`` at the dispatch boundary (slow host).
    Transcripts do not observe it.

Everything here is host-side and pure-Python deterministic: a plan built
from the same seed injects the same faults at the same dispatch indices as
the reference's.  The device is read only when a ``nan_logits`` fault comes
due (to pick an active victim from ``pos``).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import List, Sequence

import numpy as np


class EngineFault(RuntimeError):
    """Base of every recoverable serving fault the scheduler handles."""


class InjectedFault(EngineFault):
    """A fault-plan dispatch failure (raised before the round runs)."""


class CacheCorruption(EngineFault):
    """A guard detected corrupted serving state (non-finite logits or cache,
    page table / allocator audit failure).  The scheduler restores its last
    snapshot and retries the affected requests."""


KINDS = ("nan_logits", "page_table", "dispatch", "stall")
SITES = ("admit", "decode")


@dataclasses.dataclass
class Fault:
    site: str                 # "admit" | "decode"
    index: int                # per-site dispatch index at which to fire
    kind: str                 # one of KINDS
    slot: int = 0             # preferred victim slot (mod active slots)
    duration: float = 0.01    # stall seconds
    fired: bool = False
    skipped: bool = False     # fired but not applicable (e.g. dense engine)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """An ordered set of :class:`Fault`\\ s plus the per-site dispatch
    counters.  Hand one to ``Engine.set_fault_plan``; the engine calls
    :meth:`apply` at every dispatch."""

    def __init__(self, faults: Sequence[Fault]):
        self.faults: List[Fault] = list(faults)
        self.counters = {site: 0 for site in SITES}

    @classmethod
    def random(cls, seed: int, n: int = 3, kinds: Sequence[str] = KINDS,
               sites: Sequence[str] = SITES, max_index: int = 10,
               slots: int = 4, duration: float = 0.01) -> "FaultPlan":
        """A seeded plan: ``n`` faults at distinct (site, index) dispatch
        points drawn from ``[0, max_index)`` — same seed, same plan."""
        rng = random.Random(seed)
        points = [(s, i) for s in sites for i in range(max_index)]
        rng.shuffle(points)
        return cls([Fault(site=s, index=i, kind=rng.choice(list(kinds)),
                          slot=rng.randrange(slots), duration=duration)
                    for s, i in points[:n]])

    @property
    def pending(self) -> List[Fault]:
        return [f for f in self.faults if not f.fired]

    # -- the engine-facing hook ---------------------------------------------

    def apply(self, site: str, engine, cache, pos):
        """Fire every due fault for this dispatch; returns ``cache`` (a NaN
        fault poisons its tensors in place).  ``pos`` is the ``[slots]``
        position vector (a device tensor, read only for a due NaN fault) —
        negative entries are free slots, which NaN poisoning must avoid
        (their keys are masked, so the fault would be silent)."""
        idx = self.counters[site]
        self.counters[site] = idx + 1
        for f in self.faults:
            if f.fired or f.site != site or f.index != idx:
                continue
            f.fired = True
            if f.kind == "dispatch":
                raise InjectedFault(
                    f"injected dispatch failure at {site}[{idx}]")
            if f.kind == "stall":
                time.sleep(f.duration)
            elif f.kind == "page_table":
                if engine.pool is None:
                    f.skipped = True
                else:
                    pool = engine.pool
                    slot = f.slot % pool.slots
                    pool.table[slot, 0] = pool.pages_per_shard + 3
            elif f.kind == "nan_logits":
                self._poison_nan(engine, cache,
                                 np.asarray(pos.tolist()), f)
        return cache

    @staticmethod
    def _poison_nan(engine, cache, pos, fault: Fault) -> None:
        """NaN one active slot's attended K (or k_scale) at position 0 in
        every layer, in place — the poison flows through the real attention
        and head into that row's logits.  ``pos`` covers every slot; the
        engine says where the slot's row or page lies on this device
        (``Engine.poison_row`` / ``poison_page``)."""
        active = np.flatnonzero(pos >= 0)
        if active.size == 0:
            fault.skipped = True
            return
        slot = int(active[fault.slot % active.size])
        pool = engine.pool
        pattern = engine.cfg.pattern
        for i, c in enumerate(cache):
            spec = pattern[i % len(pattern)]
            if spec.kind != "attn":
                continue
            # int8 K codes cannot hold a NaN — poison the float scale
            key = "k_scale" if "k_scale" in c else "k"
            if pool is None:
                row = engine.poison_row(slot)
                if row is not None:
                    c[key][row, 0] = float("nan")
                continue
            is_local = spec.attn_type == "local" and bool(engine.cfg.window)
            table, n = ((pool.ring, pool.n_ring[slot]) if is_local
                        else (pool.table, pool.n_full[slot]))
            pid = int(table[slot, 0])
            # never poison the null page (page 0): every slot's masked
            # writes route there by design.  Table values are shard-local;
            # the engine maps them to its device pages (a sharded engine
            # holds one data shard's pages, and one of its model ranks
            # takes the poison)
            if n > 0 and pid > 0:
                page = engine.poison_page(pool.shard_of(slot), pid)
                if page is not None:
                    c[key][page, 0] = float("nan")


__all__ = ["EngineFault", "InjectedFault", "CacheCorruption", "Fault",
           "FaultPlan", "KINDS", "SITES"]
