"""Paged KV-cache pool (port of ``repro.serve.paged``): the host-side
block allocator with prefix reuse.

Instead of a dense ``[slots, max_len]`` KV buffer per layer, every layer
holds a shared pool of ``num_pages`` fixed-size pages (``[num_pages,
page_size, n_kv, head_dim]``) and each decode slot owns a *page table* — a
fixed-shape ``[slots, entries]`` int32 row of physical page ids.  Memory
then scales with the tokens actually resident, not with the worst case,
and identical prompt prefixes can map to the SAME physical pages.

This module is the host-side half: allocation, refcounts, hash-chained
prefix identity and the numpy page tables.  The device-side half (the
ordered gather and the per-token scatter, so the attention reads the dense
buffer's values) lives in ``models.attention``; ``serve.engine`` copies
the full table (and the ring table of a model with local layers) into
device tensors at fixed addresses before every round, which the captured
round graphs read.

Design points:

  * **Page id 0 of every shard is the reserved null page.**  Unallocated
    table entries are 0, and every masked or free-slot write lands there,
    so a freed-and-reused page can never be corrupted by a stale slot.
    Usable pages per shard = ``pages_per_shard - 1``.
  * **Prefix reuse is hash-chained page identity**: page ``j`` of a prompt
    is identified by ``(identity of page j-1, tokens of page j)``; only
    FULL pages register (a partial tail is still being written).  A new
    admission walks its chain against the registry and maps every leading
    hit to the existing physical page (refcount++); the first miss — the
    copy-on-write divergence point — and everything after it get fresh
    pages which the admission prefill then fills.  Registered pages are
    immutable afterwards (decode only writes at positions >= prompt
    length), so sharing is safe; content is bit-identical across sharers
    because every per-token computation in prefill is causal and row-wise.
  * **SWA rings are page-aligned**: local-attention layers keep their
    rolling ``min(max_len, window)``-slot ring in pool pages addressed
    through a separate per-slot ring table (never shared), which the
    engine copies into a second device tensor (``Engine.ring_table``)
    beside the full one.  The allocator keeps the reference's shards too;
    the port runs one.
  * **Sharding**: page ids are SHARD-LOCAL: each shard runs an
    independent allocator and prefix registry over its own slots.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of the paged cache (everything shape-determining)."""
    page_size: int
    max_len: int
    full_entries: int            # max_len // page_size
    ring_entries: int            # min(max_len, window) // page_size, or 0
    ring_len: int                # min(max_len, window), or 0

    @staticmethod
    def build(cfg, max_len: int, page_size: int) -> "PagedLayout":
        if page_size < 1 or max_len % page_size:
            raise ValueError(
                f"page_size ({page_size}) must divide max_len ({max_len})")
        has_ring = any(
            spec.kind == "attn" and spec.attn_type == "local"
            and bool(getattr(cfg, "window", None))
            for spec in getattr(cfg, "pattern", ()))
        ring_len = min(max_len, cfg.window) if has_ring else 0
        if ring_len % page_size:
            raise ValueError(
                f"page_size ({page_size}) must divide the SWA ring length "
                f"({ring_len} = min(max_len, window)) — rings are stored as "
                "page-aligned windows")
        return PagedLayout(page_size=page_size, max_len=max_len,
                           full_entries=max_len // page_size,
                           ring_entries=ring_len // page_size,
                           ring_len=ring_len)

    def auto_pages_per_shard(self, slots_per_shard: int) -> int:
        """Worst-case capacity + the null page: exhaustion-free default."""
        return slots_per_shard * (self.full_entries + self.ring_entries) + 1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Shard:
    """One data shard's allocator state (free heap, refcounts, registry)."""

    def __init__(self, pages: int):
        self.free = list(range(1, pages))        # id 0 = reserved null page
        heapq.heapify(self.free)
        self.ref = np.zeros((pages,), np.int32)
        self.hash2page: dict = {}                # chain key -> page id
        self.page_key: dict = {}                 # page id -> chain key
        # registered pages whose content has actually been written: chunked
        # prefill registers a prompt's pages at admission but fills them a
        # chunk at a time, and only a FILLED page may be prefix-shared
        self.ready: set = set()

    def alloc(self) -> int:
        return heapq.heappop(self.free)

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when the page was actually freed."""
        self.ref[pid] -= 1
        if self.ref[pid] > 0:
            return False
        key = self.page_key.pop(pid, None)
        if key is not None and self.hash2page.get(key) == pid:
            del self.hash2page[key]
        self.ready.discard(pid)
        heapq.heappush(self.free, pid)
        return True


class PagePool:
    """Block allocator + page tables for one engine's slot pool.

    All methods are host-side and deterministic (lowest-id-first allocation,
    FIFO-order admission gating is the caller's job).  ``table`` / ``ring``
    / ``start`` are plain numpy arrays the engine snapshots to device per
    dispatch.
    """

    def __init__(self, slots: int, layout: PagedLayout, *,
                 pages_per_shard: Optional[int] = None, n_shards: int = 1,
                 prefix_reuse: bool = True):
        if slots % n_shards:
            raise ValueError(f"slots ({slots}) must divide over page shards "
                             f"({n_shards})")
        self.layout = layout
        self.slots = slots
        self.n_shards = n_shards
        self.slots_per_shard = slots // n_shards
        if pages_per_shard is None:
            pages_per_shard = layout.auto_pages_per_shard(
                self.slots_per_shard)
        if pages_per_shard < 2:
            raise ValueError("pages_per_shard must be >= 2 (one null page "
                             "+ at least one usable page)")
        self.pages_per_shard = pages_per_shard
        self.prefix_reuse = prefix_reuse
        self._shards = [_Shard(pages_per_shard) for _ in range(n_shards)]
        E = max(layout.full_entries, 1)
        self.table = np.zeros((slots, E), np.int32)
        self.ring = np.zeros((slots, max(layout.ring_entries, 1)), np.int32)
        self.start = np.zeros((slots,), np.int32)   # first stitched token
        self.n_full = [0] * slots
        self.n_ring = [0] * slots
        # stats
        self.allocated_pages = 0                 # unique in-use pages, now
        self.peak_pages = 0
        self.prefix_hits = 0                     # prompt pages mapped shared
        self.prefix_fresh = 0                    # prompt pages freshly filled
        self.preemptions = 0                     # bumped by the scheduler
        self._peak_per_shard = 0

    # -- geometry ------------------------------------------------------------

    def shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def free_pages(self, shard: int) -> int:
        return len(self._shards[shard].free)

    @property
    def peak_pages_per_shard(self) -> int:
        """Peak unique in-use pages on the busiest shard (the per-shard
        residency figure the sharded engine reports)."""
        return getattr(self, "_peak_per_shard", 0)

    def _entries_for(self, n_tokens: int) -> tuple[int, int]:
        """(full entries, ring entries) needed to hold ``n_tokens``."""
        lay = self.layout
        nf = min(_ceil_div(n_tokens, lay.page_size), lay.full_entries)
        nr = 0
        if lay.ring_entries:
            nr = min(_ceil_div(min(n_tokens, lay.ring_len), lay.page_size),
                     lay.ring_entries)
        return nf, nr

    # -- admission / growth / release ---------------------------------------

    def admit(self, slot: int, tokens: Sequence[int], *,
              fills_now: bool = True, share: bool = True) -> Optional[int]:
        """Map ``slot`` onto pages holding ``tokens`` (the prompt, or prompt
        + already-emitted tokens on a preemption resume).

        Walks the hash chain over the FULL prompt pages and shares every
        leading READY hit (a page is ready once its content is actually
        written — registered-but-unfilled pages of an in-flight chunked
        admission never match); allocates fresh pages for the divergence
        tail and the ring.  Returns the first token index the admission
        must fill (``start_tok`` — everything before it lives in shared
        pages), or None when the shard has too few free pages (the caller
        gates admission / preempts).  Leaves no state behind on failure.

        ``fills_now=True`` (the monolithic path: one prefill dispatch
        writes every page before anything else runs) marks the fresh full
        pages ready immediately; chunked admissions pass ``fills_now=False``
        and report progress through :meth:`mark_filled`.  ``share=False``
        fully isolates the admission — neither maps shared pages nor
        registers its own (chunked SWA admissions replay their window from
        position 0, so their pages must never be mixed with a monolithic
        sharer's prefill-written bits, in either direction).
        """
        assert self.n_full[slot] == 0 and self.n_ring[slot] == 0, \
            f"slot {slot} already mapped"
        sh = self._shards[self.shard_of(slot)]
        L = len(tokens)
        nf, nr = self._entries_for(L)
        ps = self.layout.page_size
        keys, key = [], None
        for j in range(L // ps):                 # full pages only
            key = (key, tuple(int(t) for t in tokens[j * ps:(j + 1) * ps]))
            keys.append(key)
        shared: list[int] = []
        if self.prefix_reuse and share:
            for key in keys:
                pid = sh.hash2page.get(key)
                if pid is None or pid not in sh.ready:
                    break
                shared.append(pid)
        fresh = nf - len(shared)
        if len(sh.free) < fresh + nr:
            return None
        row = self.table[slot]
        for j, pid in enumerate(shared):
            sh.ref[pid] += 1
            row[j] = pid
        for j in range(len(shared), nf):
            pid = sh.alloc()
            sh.ref[pid] = 1
            row[j] = pid
            if self.prefix_reuse and share and j < len(keys):   # register
                sh.hash2page[keys[j]] = pid
                sh.page_key[pid] = keys[j]
                if fills_now:
                    sh.ready.add(pid)
        for j in range(nr):
            pid = sh.alloc()
            sh.ref[pid] = 1
            self.ring[slot, j] = pid
        self.n_full[slot], self.n_ring[slot] = nf, nr
        start = len(shared) * ps
        self.start[slot] = start
        self.prefix_hits += len(shared)
        self.prefix_fresh += fresh
        self._bump(fresh + nr)
        return start

    def mark_filled(self, slot: int, n_tokens: int) -> None:
        """Record that ``slot``'s first ``n_tokens`` positions have been
        written on device: every fully-covered registered page becomes ready
        (shareable).  The chunked-prefill scheduler calls this as each
        round's writes commit; already-ready (shared) pages are no-ops."""
        sh = self._shards[self.shard_of(slot)]
        for j in range(min(n_tokens // self.layout.page_size,
                           self.n_full[slot])):
            pid = int(self.table[slot, j])
            if pid in sh.page_key:
                sh.ready.add(pid)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s mapping to cover ``n_tokens`` positions (called
        before every decode chunk).  Atomic: allocates nothing on failure."""
        sh = self._shards[self.shard_of(slot)]
        nf, nr = self._entries_for(n_tokens)
        extra_f = max(0, nf - self.n_full[slot])
        extra_r = max(0, nr - self.n_ring[slot])
        if len(sh.free) < extra_f + extra_r:
            return False
        for j in range(self.n_full[slot], nf):
            pid = sh.alloc()
            sh.ref[pid] = 1
            self.table[slot, j] = pid
        for j in range(self.n_ring[slot], nr):
            pid = sh.alloc()
            sh.ref[pid] = 1
            self.ring[slot, j] = pid
        self.n_full[slot] = max(self.n_full[slot], nf)
        self.n_ring[slot] = max(self.n_ring[slot], nr)
        self._bump(extra_f + extra_r)
        return True

    def trim(self, slot: int, keep_tokens: int) -> int:
        """Shrink ``slot``'s FULL mapping to the fewest entries covering
        ``keep_tokens`` positions — the paged rollback of rejected
        speculative writes: a draft/verify round maps pages for the whole
        ``draft_k+1``-token block up front, and the tail past the accepted
        prefix unmaps here so low-accept rounds can't hold pages other
        slots need.  Callers keep at least the committed sequence (prompt +
        emitted + the pending token's slot), so registered prompt pages are
        never reachable by a trim; shared pages just drop one reference.
        Ring entries never shrink (the SWA ring is a rolling window).
        Returns the number of pages actually freed."""
        sh = self._shards[self.shard_of(slot)]
        nf, _ = self._entries_for(max(int(keep_tokens), 1))
        freed = 0
        for j in range(nf, self.n_full[slot]):
            freed += sh.decref(int(self.table[slot, j]))
            self.table[slot, j] = 0
        self.n_full[slot] = min(self.n_full[slot], nf)
        self.allocated_pages -= freed
        return freed

    def release(self, slot: int) -> None:
        """Return every page ``slot`` references (shared pages survive while
        other sharers hold them) and point the slot back at the null page so
        its idempotent free-slot decode writes can never corrupt anything."""
        sh = self._shards[self.shard_of(slot)]
        freed = 0
        for j in range(self.n_full[slot]):
            freed += sh.decref(int(self.table[slot, j]))
        for j in range(self.n_ring[slot]):
            freed += sh.decref(int(self.ring[slot, j]))
        self.table[slot] = 0
        self.ring[slot] = 0
        self.start[slot] = 0
        self.n_full[slot] = self.n_ring[slot] = 0
        self.allocated_pages -= freed

    def _bump(self, n: int) -> None:
        self.allocated_pages += n
        self.peak_pages = max(self.peak_pages, self.allocated_pages)
        per = max(self.pages_per_shard - 1 - len(s.free)
                  for s in self._shards)
        self._peak_per_shard = max(self._peak_per_shard, per)

    # -- stats ---------------------------------------------------------------

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hits + self.prefix_fresh
        return self.prefix_hits / total if total else 0.0

    @property
    def usable_pages(self) -> int:
        """Total allocatable pages across shards (null pages excluded)."""
        return self.n_shards * (self.pages_per_shard - 1)

    @property
    def saturation(self) -> float:
        """Fraction of usable pages currently allocated — the quantity the
        scheduler's shed watermark is compared against."""
        return self.allocated_pages / self.usable_pages

    # -- invariant audit / leak telemetry ------------------------------------

    def _in_use(self, shard: int) -> dict:
        """page id -> reference count recomputed from the slot mappings."""
        refs: dict = {}
        lo = shard * self.slots_per_shard
        for slot in range(lo, lo + self.slots_per_shard):
            for j in range(self.n_full[slot]):
                pid = int(self.table[slot, j])
                refs[pid] = refs.get(pid, 0) + 1
            for j in range(self.n_ring[slot]):
                pid = int(self.ring[slot, j])
                refs[pid] = refs.get(pid, 0) + 1
        return refs

    def validate(self) -> list:
        """Cheap host-side audit of the allocator invariants; returns a list
        of problem strings (empty = healthy).  Run before a dispatch, it
        catches an out-of-range or stale table entry BEFORE the device
        scatter/gather would silently clamp it into corrupting a live
        page."""
        errs = []
        P = self.pages_per_shard
        for s in range(self.n_shards):
            sh = self._shards[s]
            refs = self._in_use(s)
            for pid in refs:
                if not 0 < pid < P:
                    errs.append(f"shard {s}: table entry {pid} out of "
                                f"range (0, {P})")
            want = np.zeros((P,), np.int32)
            for pid, n in refs.items():
                if 0 < pid < P:
                    want[pid] = n
            bad = np.flatnonzero(want != sh.ref)
            if bad.size:
                errs.append(
                    f"shard {s}: refcount mismatch at pages "
                    f"{bad[:4].tolist()} (mapped {want[bad[:4]].tolist()} "
                    f"vs recorded {sh.ref[bad[:4]].tolist()})")
            free = set(sh.free)
            overlap = free & {p for p in refs if 0 < p < P}
            if overlap:
                errs.append(f"shard {s}: free-list/in-use overlap "
                            f"{sorted(overlap)[:4]}")
            if len(free) != len(sh.free):
                errs.append(f"shard {s}: duplicate free-list entries")
        total = sum(len(self._in_use(s)) for s in range(self.n_shards))
        if not errs and total != self.allocated_pages:
            errs.append(f"allocated_pages {self.allocated_pages} != "
                        f"{total} pages mapped by slots")
        return errs

    def leaked_pages(self) -> list:
        """Pages still holding references that NO slot mapping reaches —
        i.e. real leaks (shared prefix pages held by live sharers are
        reachable, so they don't count).  Returns (shard, page) tuples.
        At scheduler drain this and ``allocated_pages`` must both be
        empty/zero."""
        leaks = []
        for s in range(self.n_shards):
            reachable = set(self._in_use(s))
            for pid in range(1, self.pages_per_shard):
                if self._shards[s].ref[pid] > 0 and pid not in reachable:
                    leaks.append((s, pid))
        return leaks

    # -- snapshot / restore ---------------------------------------------------

    @staticmethod
    def _key_to_prefix(key) -> list:
        """Flatten a nested chain key ((...), page_tokens) to the flat token
        prefix it identifies — the JSON/msgpack-serializable canonical form."""
        pages = []
        while key is not None:
            key, toks = key
            pages.append(list(toks))
        return [t for page in reversed(pages) for t in page]

    def _key_from_prefix(self, prefix) -> tuple:
        ps = self.layout.page_size
        key = None
        for j in range(len(prefix) // ps):
            key = (key, tuple(int(t) for t in prefix[j * ps:(j + 1) * ps]))
        return key

    def state_dict(self) -> dict:
        """JSON-able snapshot of the complete allocator state (tables,
        free lists, refcounts, prefix registry, stats) — what the
        scheduler's snapshot/checkpoint carries for crash recovery."""
        return {
            "table": self.table.tolist(),
            "ring": self.ring.tolist(),
            "start": self.start.tolist(),
            "n_full": list(self.n_full),
            "n_ring": list(self.n_ring),
            "shards": [{
                "free": sorted(sh.free),
                "ref": sh.ref.tolist(),
                "registry": [[self._key_to_prefix(key), int(pid)]
                             for key, pid in sh.hash2page.items()],
                "ready": sorted(sh.ready),
            } for sh in self._shards],
            "stats": {
                "allocated_pages": self.allocated_pages,
                "peak_pages": self.peak_pages,
                "prefix_hits": self.prefix_hits,
                "prefix_fresh": self.prefix_fresh,
                "preemptions": self.preemptions,
                "peak_per_shard": self._peak_per_shard,
            },
        }

    def load_state(self, state: dict) -> None:
        """Restore :meth:`state_dict` in place (geometry must match)."""
        self.table = np.asarray(state["table"], np.int32)
        self.ring = np.asarray(state["ring"], np.int32)
        self.start = np.asarray(state["start"], np.int32)
        self.n_full = list(state["n_full"])
        self.n_ring = list(state["n_ring"])
        if len(state["shards"]) != self.n_shards:
            raise ValueError("page-pool shard count mismatch")
        for sh, rec in zip(self._shards, state["shards"]):
            sh.free = list(rec["free"])
            heapq.heapify(sh.free)
            sh.ref = np.asarray(rec["ref"], np.int32)
            sh.hash2page = {}
            sh.page_key = {}
            for prefix, pid in rec["registry"]:
                key = self._key_from_prefix(prefix)
                sh.hash2page[key] = int(pid)
                sh.page_key[int(pid)] = key
            # older snapshots predate ready tracking: every registered page
            # they carry was written by a monolithic admission
            sh.ready = set(rec.get("ready", sh.page_key))
        st = state["stats"]
        self.allocated_pages = int(st["allocated_pages"])
        self.peak_pages = int(st["peak_pages"])
        self.prefix_hits = int(st["prefix_hits"])
        self.prefix_fresh = int(st["prefix_fresh"])
        self.preemptions = int(st["preemptions"])
        self._peak_per_shard = int(st["peak_per_shard"])
