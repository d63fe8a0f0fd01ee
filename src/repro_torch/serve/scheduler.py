"""Continuous-batching scheduler with chunked prefill, per-request
sampling, self-speculative rounds, paged block accounting and fault
recovery from rolling snapshots, deadlines, deterministic overload
shedding, slack-aware preemption and save/load (port of
``repro.serve.scheduler``).

A fixed pool of ``slots`` decode lanes over one set of live cache buffers.
Requests queue FIFO; every round runs ONE ``Engine.step`` carrying up to
``prefill_chunk`` prompt tokens (mid-prefill slots first, then new
admissions from the queue head) followed by ``chunk`` decode tokens for
every slot.  A prompt's last chunk entry samples its first output token in
the same round and the slot joins the decode lane immediately.  Free slots
carry the negative-position sentinel; mid-prefill slots park done=True on
their latest (token, position), so iterations that do not target them
rewrite the same KV bits.  On a ``spec_decode`` engine the decode lane is a
speculative round whenever every occupied slot has the headroom for its
``draft_k + 1``-token block, else a plain round; a row emits only the
first ``n_valid`` tokens of its round.

The per-slot state (``tok``, ``pos``, ``done``, ``eos`` and the sampling
vectors ``temperature``, ``top_k``, ``top_p``) lives on the device at fixed
addresses and is updated in place; what the host decides (admissions,
parks, frees, EOS ids, sampling knobs, kept in host mirrors) travels
host-to-device, and a round reads the device once: the engine's packed
result, as in the reference (``repro/serve/engine.py``: "a round of tokens
needs exactly one host round-trip").  A round whose every slot is greedy
by the host mirrors runs the engine's argmax-only variant; a freed slot
falls back to the engine's defaults.  The global draw counter ``_step``
advances by ``C + chunk`` a round (``C + 2 * draft_k + 1`` on a
speculative one, ``C`` the engine's ``prefill_chunk`` when the round has a
chunk lane, else 0), as the reference's does.

With a paged engine (``ServeConfig(paged=True)``) the scheduler also runs
the reference's block accounting on ``engine.pool``: every round first maps
pages for the chunk ahead (``max(chunk, draft_k + 1)`` positions on a
speculative engine); when the pool runs dry the slot with the most
deadline slack (youngest first among equals, and when no request carries a
deadline) is preempted, its pages released, and it is requeued at the
queue head with its emitted tokens, so its re-admission prefills prompt +
emitted and continues exactly.  Admission is gated on free pages (FIFO, no
skip-ahead) and maps every leading ready prefix page shared; a fresh row
parks at ``(seq[p0], p0)``, its first entry after the shared prefix.
Pages become shareable as each round's chunk lane commits, are released
when a request finishes, and a speculative round's pages past the
accepted sequence are trimmed.  ``run`` ends with :meth:`check_drained`.

An engine that ``requires_monolithic_admission`` (an int8 KV cache) admits
as the reference's ``Scheduler._admit`` does instead: each round first
fills free slots from the queue head with the leading run of EQUAL-length
requests in one ``Engine.admit_monolithic`` dispatch (prefilled unpadded
across all ``slots`` rows, dummy rows for the empty ones; a paged engine
maps each request's pages first, FIFO, no skip-ahead), reads its
(tok0, done0, ok0) once, then maps the pages of the round ahead and runs a
pure-decode round.  An admission advances the draw counter by one: its
first tokens are draw ``fold_in(key, _step)``.  On a model with sliding
windows admission is decided per request (``Engine.chunk_eligible``): when
the queue head's prompt is longer than the window, the round first admits
the head's equal-length run of such prompts monolithically
(``_admit(only_ineligible=True)``), and the chunk lane then admits only if
the new head is eligible (no skip-ahead past a blocked head); its chunk
admissions on a paged pool share no prefix pages.

Detection and recovery, as the reference's: the engine's finite-logits
column (ANDed with its cache sweep) and, paged, ``PagePool.validate()``
surface corrupted state as :class:`~repro_torch.serve.faults.CacheCorruption`;
with ``snapshot_interval > 0`` the scheduler takes a rolling
:meth:`snapshot` every ``snapshot_interval`` rounds and on an
:class:`~repro_torch.serve.faults.EngineFault` restores it and replays —
in-flight requests carry a ``retries`` count and fail past
``max_retries``.  An injected dispatch failure rolls its admission back
locally and simply re-dispatches.  Detection precedes every emit, so a
streaming callback never sees a poisoned token (a replay may repeat tokens
streamed before the snapshot: at-least-once delivery).  The snapshot's
device state goes into host buffers allocated once and reused, and
:meth:`restore` copies it back into the live tensors in place, so the
captured round graphs, keyed on the cache's addresses, replay as before.

Logical time, as the reference's: every QoS decision reads the ``now=``
the caller threads through :meth:`submit` / :meth:`step` / :meth:`run` (a
value or a zero-argument callable), never the wall clock, so a run
replays exactly; without a clock nothing expires.  A step first retires
every request whose ``deadline`` passed (``timed_out``: queued ones with no
tokens, running ones with their partial transcript), then, with
``shed_watermark`` set, sheds the queue past ``overload_queue`` once the
page pool (dense: the slot map) is that full — lowest priority first,
then least slack, then latest submitted — and only then takes its
snapshot, so a restore never brings back a retired request.  A callable
clock is read at the top of the step and again after the round's one
host read, to stamp finish times; ``stats["occupancy_sum"]`` adds each
round's occupied share of the slots (:attr:`mean_occupancy`).

:meth:`save` writes the whole serving state through ``ckpt.checkpoint``
(the cache and slot vectors, the host mirrors, cursors, counters, the
pool's state and every request); :meth:`load` reads it into a Scheduler of
the same geometry, copying every tensor into the live ones in place, so a
Scheduler whose rounds are already captured replays them after a load and
a fresh process continues token-identically.  Divergence: :meth:`run`
always ends with :meth:`check_drained` (the reference's only under its
``guards``, which the port keeps always on).
"""
from __future__ import annotations

import collections
import math
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.serve.engine import ChunkLane, Engine, unpack_round
from repro_torch.serve.faults import (CacheCorruption, EngineFault,
                                      InjectedFault)
from repro_torch.serve.request import Request, RequestStatus


class Scheduler:
    """FIFO admission over a fixed slot map; ``Engine`` executes the batch."""

    def __init__(self, engine: Engine, slots: int = 4, chunk: int = 8, *,
                 max_retries: int = 2, snapshot_interval: int = 0,
                 shed_watermark: Optional[float] = None,
                 overload_queue: Optional[int] = None):
        if engine.is_encdec:
            raise NotImplementedError(
                "continuous batching serves decoder-only LMs")
        if slots < 1 or chunk < 1:
            raise ValueError(f"slots and chunk must be >= 1, got slots="
                             f"{slots}, chunk={chunk}")
        self.engine = engine
        self.n_slots = slots
        self.chunk = chunk
        # fault-recovery policy: retries a request may survive in flight
        # (and rounds without progress before a fault is re-raised); a
        # rolling snapshot every ``snapshot_interval`` rounds (0 = none)
        self.max_retries = max_retries
        self.snapshot_interval = snapshot_interval
        # overload policy: shed the queue past ``overload_queue`` (default
        # ``slots``) once the pool (dense: the slot map) is this full
        self.shed_watermark = shed_watermark
        self.overload_queue = slots if overload_queue is None else \
            overload_queue
        dev = engine.device
        self.cache = engine.init_cache(slots)
        # per-slot device state ([slots] vectors; free slot: pos=-1, done)
        self.tok = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.pos = torch.full((slots,), -1, dtype=torch.int32, device=dev)
        self.done = torch.ones((slots,), dtype=torch.bool, device=dev)
        self.eos = torch.full((slots,), -1, dtype=torch.int32, device=dev)
        self.temperature = torch.zeros((slots,), dtype=torch.float32,
                                       device=dev)
        self.top_k = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.top_p = torch.ones((slots,), dtype=torch.float32, device=dev)
        # per-slot EOS ids (-1 = none) and sampling knobs mirrored host-side
        # (admission rewrites the device vectors without device reads)
        scfg = engine.scfg
        self._eos_h = [-1] * slots
        self._temp_h = [scfg.temperature] * slots
        self._topk_h = [scfg.top_k] * slots
        self._topp_h = [scfg.top_p] * slots
        self._push_sampling_state()
        self._step = 0                  # global draw index (PRNG fold-in)
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * slots
        self.finished: List[Request] = []
        self._admit_seq = [0] * slots
        self._admit_counter = 0
        # chunked-prefill cursors: tokens fed so far / tokens to feed
        self._progress = [0] * slots
        self._target = [0] * slots
        # fault-recovery state: the rolling snapshot, the requests submitted
        # since it was taken (restore requeues them), the snapshot's host
        # buffers (made at the first snapshot, then reused) and the number
        # of snapshots taken (only the latest one's buffers are intact)
        self._snap = None
        self._snap_bufs = None
        self._snap_gen = 0
        self._submit_log: List[Request] = []
        self._submit_count = 0           # submissions so far (``_seq``)
        self._ticks = 0
        self._retries_since_progress = 0
        # ``occupancy_sum``: each round's occupied share of the slots
        self.stats = {"rounds": 0, "admission_rounds": 0,
                      "prefill_tokens": 0,
                      "admitted_tokens": 0, "emitted_tokens": 0,
                      "occupancy_sum": 0.0, "preemptions": 0, "shed": 0,
                      "timed_out": 0, "failed": 0, "recoveries": 0,
                      "dispatch_retries": 0, "spec_rounds": 0,
                      "spec_drafted": 0, "spec_accepted": 0}

    # -- paged helpers -------------------------------------------------------

    @staticmethod
    def _seq(req: Request) -> List[int]:
        """The tokens a (re-)admission must prefill: the prompt plus every
        token already emitted (non-empty only on a preemption resume)."""
        return list(req.prompt) + [int(t) for t in req.tokens]

    def _preempt_victim(self, now_v) -> tuple:
        """Preempt the slot with the MOST deadline slack (it can be
        requeued and still make its deadline; a request without a deadline
        has infinite slack), the youngest by admission order among equals
        and when no request carries a deadline: its pages are released,
        its sampling mirrors reset, and the request keeps its emitted
        tokens."""
        victim = max((s for s, r in enumerate(self.slots) if r is not None),
                     key=lambda s: (self.slots[s].slack(now_v),
                                    self._admit_seq[s]))
        req = self.slots[victim]
        self.slots[victim] = None
        self.engine.pool.release(victim)
        self._reset_slot_sampling(victim)
        self._progress[victim] = self._target[victim] = 0
        req.status = RequestStatus.QUEUED
        req.slot = None
        self.stats["preemptions"] += 1
        self.engine.pool.preemptions += 1
        return victim, req

    def _ensure_chunk_pages(self, now_v=None) -> None:
        """Grow every active slot's mapping to cover the round ahead; when
        the pool runs dry, preempt and requeue (most slack, then youngest,
        first) until the rest fit (one sequence alone exhausting the pool
        is a configuration error)."""
        pool = self.engine.pool
        scfg = self.engine.scfg
        # a speculative round writes a draft_k+1-token block per slot:
        # reserve for either lane (the round's kind is decided after
        # assembly; the trim after a spec round gives the excess back)
        W = max(self.chunk, scfg.draft_k + 1) if scfg.spec_decode \
            else self.chunk
        freed, evicted = [], []
        while True:
            active = [(s, r) for s, r in enumerate(self.slots)
                      if r is not None]
            # a decoder's pending token is the first of the round's writes
            # (W - 1 past its residency); a slot mid-prefill that completes
            # this round decodes a full W past its sequence
            need = [(s, min(len(r.prompt) + len(r.tokens) + W
                            - (0 if self._progress[s] < self._target[s]
                               else 1), scfg.max_len))
                    for s, r in active]
            if next((s for s, n in need if not pool.ensure(s, n)),
                    None) is None:
                break
            if len(active) == 1:
                raise RuntimeError(
                    "KV page pool exhausted by a single sequence — "
                    "raise ServeConfig.num_pages (or lower max_len)")
            slot, req = self._preempt_victim(now_v)
            evicted.append(req)
            freed.append(slot)
        if evicted:
            # evicted most expendable first: appendleft in eviction order
            # puts the least expendable evictee at the queue head
            for req in evicted:
                self.queue.appendleft(req)
            self._free_on_device(freed)

    # -- admission -----------------------------------------------------------

    def submit(self, request: Request, now=None) -> Request:
        """Validate and queue a request (malformed ones raise here) at
        logical time ``now`` (a value or a zero-argument clock, read
        here), stamped as its ``arrival_time``."""
        L = len(request.prompt)
        max_len = self.engine.scfg.max_len
        if request.max_new_tokens < 0:
            raise ValueError(
                f"max_new_tokens must be >= 0, got {request.max_new_tokens}")
        if L > max_len:
            raise ValueError(
                f"prompt length ({L}) exceeds max_len ({max_len})")
        if L + request.max_new_tokens > max_len:
            raise ValueError(
                f"prompt ({L}) + max_new_tokens ({request.max_new_tokens}) "
                f"exceeds max_len ({max_len})")
        if request.deadline is not None and (
                not isinstance(request.deadline, (int, float))
                or not math.isfinite(request.deadline)):
            raise ValueError(
                f"deadline must be a finite logical time, got "
                f"{request.deadline!r}")
        if not isinstance(request.priority, (int, float)) or \
                not math.isfinite(request.priority):
            raise ValueError(
                f"priority must be finite, got {request.priority!r}")
        request.arrival_time = now() if callable(now) else now
        request.status = RequestStatus.QUEUED
        self._submit_count += 1
        request._seq = self._submit_count
        if self.snapshot_interval:
            self._submit_log.append(request)
        self.queue.append(request)
        return request

    def _to_device(self, rows, dtype=torch.int32) -> torch.Tensor:
        """Host rows as one device tensor (on the card through pinned
        memory, asynchronously: the host allocator keeps the pinned block
        until the copy has run)."""
        t = torch.tensor(rows, dtype=dtype)
        if self.engine.device.type == "cuda":
            return t.pin_memory().to(self.engine.device, non_blocking=True)
        return t

    def _sampling_for(self, req: Request):
        scfg = self.engine.scfg
        temp = scfg.temperature if req.temperature is None else req.temperature
        top_k = scfg.top_k if req.top_k is None else req.top_k
        top_p = scfg.top_p if req.top_p is None else req.top_p
        return float(temp), int(top_k), float(top_p)

    def _reset_slot_sampling(self, slot: int) -> None:
        """Freed slots fall back to the engine defaults, so a past sampling
        request does not keep the greedy variant off."""
        scfg = self.engine.scfg
        self._eos_h[slot] = -1
        (self._temp_h[slot], self._topk_h[slot],
         self._topp_h[slot]) = (scfg.temperature, scfg.top_k, scfg.top_p)

    def _push_sampling_state(self) -> None:
        """The host mirrors into the fixed device vectors."""
        ik = self._to_device([self._eos_h, self._topk_h])
        tp = self._to_device([self._temp_h, self._topp_h], torch.float32)
        self.eos.copy_(ik[0])
        self.top_k.copy_(ik[1])
        self.temperature.copy_(tp[0])
        self.top_p.copy_(tp[1])

    def _write_slots(self, rows: dict, tok: bool) -> torch.Tensor:
        """Set ``pos`` (and ``tok``) of the slots in ``rows`` ({slot: (tok,
        pos)}) in place from a host-built mask, without reading them;
        returns the mask."""
        m, t, p = [0] * self.n_slots, [0] * self.n_slots, [0] * self.n_slots
        for s, (ts, ps) in rows.items():
            m[s], t[s], p[s] = 1, ts, ps
        mtp = self._to_device([m, t, p])
        mask = mtp[0] != 0
        if tok:
            self.tok.copy_(torch.where(mask, mtp[1], self.tok))
        self.pos.copy_(torch.where(mask, mtp[2], self.pos))
        return mask

    def _free_on_device(self, freed: List[int]) -> None:
        """Mark freed slots done with the negative-position sentinel."""
        mask = self._write_slots({s: (0, -1) for s in freed}, tok=False)
        self.done.logical_or_(mask)

    def _retire(self, req: Request, reason: str, now_v=None) -> None:
        """Finish ``req`` with ``reason`` at ``now_v`` and give back its
        slot: sampling mirrors reset, cursors cleared, pages released."""
        slot = req.slot
        req.finish(reason, now_v)
        self.finished.append(req)
        if slot is not None:
            self.slots[slot] = None
            self._reset_slot_sampling(slot)
            self._progress[slot] = self._target[slot] = 0
            if self.engine.paged:
                self.engine.pool.release(slot)

    # -- deadlines and load shedding (logical time only) ---------------------

    def _expire_deadlines(self, now_v) -> None:
        """Finish every request whose deadline passed — queued ones without
        a token, running ones with their partial transcript — as
        ``timed_out``; nothing without a clock."""
        if now_v is None:
            return
        expired = [r for r in self.queue
                   if r.deadline is not None and r.deadline <= now_v]
        if expired:
            # Request compares by value: filter by identity
            gone = set(map(id, expired))
            self.queue = collections.deque(
                r for r in self.queue if id(r) not in gone)
        freed = []
        for s, r in enumerate(self.slots):
            if r is not None and r.deadline is not None \
                    and r.deadline <= now_v:
                expired.append(r)
                freed.append(s)
        for r in expired:
            self._retire(r, "timed_out", now_v)
            self.stats["timed_out"] += 1
        if freed:
            self._free_on_device(freed)

    def _shed_overload(self, now_v) -> None:
        """Deterministic admission control: once the page pool (dense: the
        slot map) is ``shed_watermark`` full and more than
        ``overload_queue`` requests wait, shed the excess — lowest priority
        first, then least deadline slack, then latest submitted.  The same
        state and clock shed the same set."""
        if self.shed_watermark is None or not self.queue:
            return
        if self.engine.paged:
            saturation = self.engine.pool.saturation
        else:
            saturation = sum(r is not None for r in self.slots) / self.n_slots
        if saturation < self.shed_watermark:
            return
        excess = len(self.queue) - self.overload_queue
        if excess <= 0:
            return
        order = sorted(self.queue,
                       key=lambda r: (r.priority, r.slack(now_v),
                                      -getattr(r, "_seq", 0)))
        victims = set(map(id, order[:excess]))
        self.queue = collections.deque(
            r for r in self.queue if id(r) not in victims)
        for r in order[:excess]:
            self._retire(r, "shed", now_v)
            self.stats["shed"] += 1

    # -- snapshot / restore / fault recovery ---------------------------------

    def _device_state(self) -> list:
        """The device tensors a snapshot holds, in a fixed order: every
        cache leaf (layer by layer), then tok, pos and done."""
        return [t for c in self.cache for t in c.values()] + \
            [self.tok, self.pos, self.done]

    def snapshot(self) -> dict:
        """Host-side copy of the complete serving state: the cache, the
        slot vectors, the sampling mirrors, the draw counter, the queue and
        slot request states, the page pool's allocator and the statistics
        — everything :meth:`restore` needs to replay token-identically.
        Per-request ``retries`` stays out (the retry bound must survive
        restores).  The device tensors are copied into host buffers (pinned
        on the card) that the Scheduler allocates at its first snapshot and
        reuses, so a snapshot is valid until the next one (:meth:`restore`
        refuses an older one); on the card the copies are asynchronous,
        ordered on the stream before the next round's writes."""
        live = self._device_state()
        if self._snap_bufs is None:
            pin = self.engine.device.type == "cuda"
            self._snap_bufs = [torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=pin) for t in live]
        for buf, t in zip(self._snap_bufs, live):
            buf.copy_(t, non_blocking=True)
        self._snap_gen += 1
        reqs = list(self.queue) + [r for r in self.slots if r is not None]
        return {
            "gen": self._snap_gen,
            "device": self._snap_bufs,
            "eos_h": list(self._eos_h), "temp_h": list(self._temp_h),
            "topk_h": list(self._topk_h), "topp_h": list(self._topp_h),
            "step": self._step,
            "admit_seq": list(self._admit_seq),
            "admit_counter": self._admit_counter,
            "progress": list(self._progress),
            "target": list(self._target),
            "queue": list(self.queue),
            "slots": list(self.slots),
            "finished_len": len(self.finished),
            "req_state": [(r, r.status, list(r.tokens), r.finish_reason,
                           r.finish_time, r.slot) for r in reqs],
            "pool": (self.engine.pool.state_dict()
                     if self.engine.paged else None),
            "stats": dict(self.stats),
        }

    def restore(self, snap: dict) -> None:
        """Reinstate a :meth:`snapshot`: the device state is copied back
        into the live cache leaves and slot vectors IN PLACE (no tensor
        changes address, so every captured round graph stays valid), the
        sampling vectors are pushed in place, request objects are rewound,
        the allocator is reloaded.  Requests submitted after the snapshot
        rejoin the queue tail in submit order, so recovery never drops a
        submission.  Only the latest snapshot can be restored: a later one
        has overwritten the host buffers an older one refers to."""
        if snap["gen"] != self._snap_gen:
            raise RuntimeError(
                f"stale snapshot: it is snapshot {snap['gen']} but snapshot "
                f"{self._snap_gen} has since reused its device buffers")
        for t, buf in zip(self._device_state(), snap["device"]):
            t.copy_(buf, non_blocking=True)
        self._eos_h = list(snap["eos_h"])
        self._temp_h = list(snap["temp_h"])
        self._topk_h = list(snap["topk_h"])
        self._topp_h = list(snap["topp_h"])
        self._push_sampling_state()
        self._step = snap["step"]
        self._admit_seq = list(snap["admit_seq"])
        self._admit_counter = snap["admit_counter"]
        self._progress = list(snap["progress"])
        self._target = list(snap["target"])
        self.queue = collections.deque(snap["queue"])
        self.slots = list(snap["slots"])
        del self.finished[snap["finished_len"]:]
        for r, status, toks, reason, ftime, slot in snap["req_state"]:
            r.status = status
            r.tokens = list(toks)
            r.finish_reason = reason
            r.finish_time = ftime
            r.slot = slot
        if snap["pool"] is not None:
            self.engine.pool.load_state(snap["pool"])
        self.stats = dict(snap["stats"])
        for r in self._submit_log:       # post-snapshot submissions survive
            r.status = RequestStatus.QUEUED
            r.tokens = []
            r.finish_reason = None
            r.finish_time = None
            r.slot = None
            self.queue.append(r)

    def _recover(self, err: EngineFault, now_v) -> None:
        """Bounded-retry fault recovery.  A dispatch failure already rolled
        back locally: count it, and the next round re-dispatches.
        Corruption restores the rolling snapshot, charges one retry to
        every request that was in flight, and fails any that crossed
        ``max_retries``.  More than ``max_retries`` faults without a
        successful round in between re-raise."""
        self._retries_since_progress += 1
        if self._retries_since_progress > self.max_retries:
            raise err
        if isinstance(err, InjectedFault):
            self.stats["recoveries"] += 1
            self.stats["dispatch_retries"] += 1
            return
        if self._snap is None:
            raise RuntimeError(
                "corrupted serving state detected but snapshots are "
                "disabled — construct Scheduler(snapshot_interval=1) to "
                "enable recovery") from err
        affected = [r for r in self.slots if r is not None]
        self.restore(self._snap)         # also rewinds stats
        self.stats["recoveries"] += 1
        for r in affected:
            r.retries += 1
            if r.retries > self.max_retries:
                # Request compares by value: filter by identity
                if any(q is r for q in self.queue):
                    self.queue = collections.deque(
                        q for q in self.queue if q is not r)
                if r.slot is not None and self.slots[r.slot] is r:
                    self._free_on_device([r.slot])
                self._retire(r, "failed", now_v)
                self.stats["failed"] += 1

    # -- save / load (crash recovery across processes) -----------------------

    def _tree(self, cache: list) -> dict:
        return {"cache": cache, "tok": self.tok, "pos": self.pos,
                "done": self.done}

    def save(self, ckpt_dir: str, step: Optional[int] = None):
        """Write the whole serving state as a committed ``ckpt.checkpoint``
        step (default: the round count): the cache and slot vectors (copied
        to the host, which on the card waits for the device), the host
        mirrors, draw counter, cursors, counters, the pool's state and
        every queued, running and finished request.  Streaming callbacks
        stay out: a loaded request streams nothing until a callback is set
        again.  On a ``ShardedEngine`` every rank calls it (collective): the
        cache is gathered into the single engine's layout, rank 0 writes
        and commits, and every rank waits until it has."""
        tree = self._tree(self.engine.checkpoint_cache(self.cache))
        recs = {
            "queue": [_req_record(r) for r in self.queue],
            "slots": [None if r is None else _req_record(r)
                      for r in self.slots],
            "finished": [_req_record(r) for r in self.finished],
        }
        extra = {"serving": {
            "step": self._step, "ticks": self._ticks,
            "eos_h": self._eos_h, "temp_h": self._temp_h,
            "topk_h": self._topk_h, "topp_h": self._topp_h,
            "admit_seq": self._admit_seq,
            "admit_counter": self._admit_counter,
            "progress": self._progress,
            "target": self._target,
            "submit_count": self._submit_count,
            "stats": self.stats,
            "pool": (self.engine.pool.state_dict()
                     if self.engine.paged else None),
            "geometry": self._geometry(),
            **recs,
        }}
        step = self._ticks if step is None else step
        if not self.engine.sharded:
            return ckpt_lib.save(ckpt_dir, step, tree, extra=extra)
        import torch.distributed as dist
        if self.engine.mesh.rank == 0:
            ckpt_lib.save(ckpt_dir, step, tree, extra=extra)
        dist.barrier()                  # committed before any rank goes on
        return None

    def _geometry(self) -> dict:
        return {"slots": self.n_slots, "chunk": self.chunk,
                "max_len": self.engine.scfg.max_len,
                "paged": self.engine.paged,
                "prefill_chunk": self.engine.prefill_chunk}

    def load(self, ckpt_dir: str, step: Optional[int] = None) -> None:
        """Reinstate :meth:`save`'s state (default: the latest step) into
        this Scheduler, whose engine must have the saving one's geometry
        and cache layout.  Every tensor is copied into the live cache and
        slot vectors IN PLACE, so captured round graphs replay as before;
        the pool is reloaded and the requests are rebuilt as new
        ``Request`` objects (in ``queue``, ``slots`` and ``finished``).  A
        rolling snapshot taken before the load is dropped.  On a
        ``ShardedEngine`` every rank reads the step and keeps its slices of
        the cache; a dense checkpoint of a mesh loads into one device's
        Scheduler and back, the slot geometry being the same."""
        geo = ckpt_lib.manifest(ckpt_dir, step)["extra"]["serving"][
            "geometry"]
        if geo != self._geometry():
            raise ValueError(
                f"serving-checkpoint geometry {geo} does not match this "
                f"scheduler/engine {self._geometry()}")
        like = self.engine.checkpoint_cache(self.cache, like=True)
        restored, extra = ckpt_lib.restore(ckpt_dir, self._tree(like), step)
        s = extra["serving"]
        for c, rc in zip(self.cache,
                         self.engine.cache_part(restored["cache"])):
            for k, t in c.items():
                t.copy_(rc[k])
        for name in ("tok", "pos", "done"):
            getattr(self, name).copy_(restored[name])
        self._eos_h = list(s["eos_h"])
        self._temp_h = list(s["temp_h"])
        self._topk_h = list(s["topk_h"])
        self._topp_h = list(s["topp_h"])
        self._push_sampling_state()
        self._step = s["step"]
        self._ticks = s["ticks"]
        self._admit_seq = list(s["admit_seq"])
        self._admit_counter = s["admit_counter"]
        self._progress = list(s["progress"])
        self._target = list(s["target"])
        self._submit_count = s["submit_count"]
        self.stats = dict(s["stats"])
        if s["pool"] is not None:
            self.engine.pool.load_state(s["pool"])
        self.queue = collections.deque(
            _req_from_record(d) for d in s["queue"])
        self.slots = [None if d is None else _req_from_record(d)
                      for d in s["slots"]]
        self.finished = [_req_from_record(d) for d in s["finished"]]
        self._snap = None
        self._submit_log.clear()

    # -- the scheduling loop -------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    @property
    def padding_waste(self) -> float:
        """prefill_tokens / admitted_tokens (1.0 = every chunk-lane entry
        carried a real prompt token)."""
        a = self.stats["admitted_tokens"]
        return self.stats["prefill_tokens"] / a if a else 0.0

    @property
    def mean_occupancy(self) -> float:
        """Mean share of the slots holding a request, per round."""
        n = self.stats["rounds"]
        return self.stats["occupancy_sum"] / n if n else 0.0

    def _assemble_chunk(self):
        """This round's chunk-lane entries: continue mid-prefill slots in
        admission order, then admit from the queue head (no skip-ahead, and
        never a head the chunk lane may not admit) while budget and free
        slots last.  Returns (the lane's real
        entries as a ``ChunkLane`` of device vectors | None, plan {slot:
        new progress}, fresh [(slot, req)], completing {slots whose last
        prompt token lands this round}, parks {slot: (tok, pos)})."""
        C = self.engine.prefill_chunk
        e_slot: List[int] = []
        e_tok: List[int] = []
        e_pos: List[int] = []
        e_first: List[bool] = []
        e_b1: List[bool] = []
        plan: dict = {}
        fresh: List[tuple] = []
        completing: set = set()
        parks: dict = {}

        def feed(slot, req, p0):
            seq, L = self._seq(req), self._target[slot]
            take = min(C - len(e_slot), L - p0)
            for p in range(p0, p0 + take):
                last = p == L - 1
                e_slot.append(slot)
                e_tok.append(int(seq[p]))
                e_pos.append(p)
                e_first.append(last)
                e_b1.append(last and req.remaining <= 1)
                if last:
                    completing.add(slot)
            plan[slot] = p0 + take

        for slot in sorted(
                (s for s in range(self.n_slots)
                 if self.slots[s] is not None
                 and self._progress[s] < self._target[s]),
                key=lambda s: self._admit_seq[s]):
            if len(e_slot) >= C:
                break
            feed(slot, self.slots[slot], self._progress[slot])
        pool = self.engine.pool
        # SWA admissions share no prefix pages: they replay the window from
        # position 0, and their chunk-lane bits must never mix with a
        # monolithic sharer's
        share = self.engine.chunk_window_limit is None
        while len(e_slot) < C and self.queue:
            req = self.queue[0]
            seq = self._seq(req)
            L = len(seq)
            if not self.engine.chunk_eligible(L):
                break               # the head takes the monolithic admission
            slot = next((s for s in range(self.n_slots)
                         if self.slots[s] is None), None)
            if slot is None:
                break
            p0 = 0
            if self.engine.paged:
                start = pool.admit(slot, seq, fills_now=False, share=share)
                if start is None:
                    if (not any(r is not None for r in self.slots)
                            and pool.allocated_pages == 0):
                        raise RuntimeError(
                            "request needs more KV pages than the whole "
                            "pool holds — raise ServeConfig.num_pages")
                    break
                # a fully shared prompt still replays its last token: that
                # entry's logits are the first-token logits
                p0 = min(start, L - 1)
                if (L - p0 <= C - len(e_slot) and not pool.ensure(
                        slot, min(L + self.chunk,
                                  self.engine.scfg.max_len))):
                    # completes this round but its decode growth does not
                    # fit: undo the mapping and wait (no skip-ahead)
                    pool.release(slot)
                    break
            self.queue.popleft()
            req.status = RequestStatus.RUNNING
            req.slot = slot
            self.slots[slot] = req
            self._target[slot] = L
            self._progress[slot] = p0
            (self._temp_h[slot], self._topk_h[slot],
             self._topp_h[slot]) = self._sampling_for(req)
            self._eos_h[slot] = -1 if req.eos_id is None else int(req.eos_id)
            fresh.append((slot, req))
            parks[slot] = (int(seq[p0]), p0)
            feed(slot, req, p0)
        if not e_slot:
            return None, plan, fresh, completing, parks
        if fresh:
            self._push_sampling_state()
        lane = self._to_device([e_slot, e_tok, e_pos, e_first, e_b1])
        lane = ChunkLane(lane[0], lane[1], lane[2], lane[3] != 0,
                         lane[4] != 0)
        return lane, plan, fresh, completing, parks

    def _admit(self, now=None, only_ineligible: bool = False) -> int:
        """Monolithic admission, as the reference's ``_admit``: fill free
        slots from the queue head with its leading run of equal-length
        requests in ONE ``Engine.admit_monolithic`` dispatch (batched
        exact-length prefill, masked stitch, first-token draw, slot-state
        merge), read once; returns the requests admitted.  With
        ``only_ineligible`` (an engine with a chunk lane) the run also
        stops at the first request the chunk lane may admit.  A paged
        engine maps each candidate's pages first; those that do not fit go
        back to the queue head in FIFO order."""
        free = [s for s in range(self.n_slots) if self.slots[s] is None]
        take: List[Request] = []
        for r in self.queue:
            if len(take) >= len(free):
                break
            if only_ineligible and self.engine.chunk_eligible(
                    len(self._seq(r))):
                break
            if take and len(self._seq(r)) != len(self._seq(take[0])):
                break
            take.append(r)
        for _ in take:
            self.queue.popleft()
        admitted = list(zip(free, take))
        pool = self.engine.pool
        if self.engine.paged and admitted:
            fits = []
            for i, (slot, req) in enumerate(admitted):
                if pool.admit(slot, self._seq(req)) is None:
                    if (not fits
                            and not any(r is not None for r in self.slots)
                            and pool.allocated_pages == 0):
                        raise RuntimeError(
                            "request needs more KV pages than the whole "
                            "pool holds — raise ServeConfig.num_pages")
                    for _, r in reversed(admitted[i:]):
                        self.queue.appendleft(r)
                    admitted = fits
                    break
                fits.append((slot, req))
        if not admitted:
            return 0
        R = self.n_slots
        # every admitted request is P tokens (an equal-length run), and
        # submit() guarantees P <= max_len
        P = len(self._seq(admitted[0][1]))
        prompts = np.zeros((R, P), np.int32)
        lengths = np.ones((R,), np.int32)
        mask = np.zeros((R,), bool)
        budget_one = np.zeros((R,), bool)
        for slot, req in admitted:
            prompts[slot] = self._seq(req)
            lengths[slot] = P
            mask[slot] = True
            # <= 1: a budget-0 request finishes at admission too (its token
            # is drawn, not emitted); ``remaining`` so a preempted request
            # resumes with what is left of its budget
            budget_one[slot] = req.remaining <= 1
            (self._temp_h[slot], self._topk_h[slot],
             self._topp_h[slot]) = self._sampling_for(req)
            self._eos_h[slot] = -1 if req.eos_id is None else int(req.eos_id)
        self._push_sampling_state()
        try:
            self.cache, tok, pos, done, packed = self.engine.admit_monolithic(
                self.cache, prompts, lengths, mask, budget_one, self.eos,
                self.tok, self.pos, self.done, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, step0=self._step,
                greedy=self._greedy())
        except InjectedFault:
            # the dispatch never ran: release this admission's pages, put
            # the candidates back at the queue head in FIFO order, and let
            # the retry path re-dispatch an identical admission
            for slot, _ in admitted:
                if self.engine.paged:
                    pool.release(slot)
                self._reset_slot_sampling(slot)
            self._push_sampling_state()
            for _, req in reversed(admitted):
                self.queue.appendleft(req)
            raise
        self.tok.copy_(tok)
        self.pos.copy_(pos)
        self.done.copy_(done)
        self._step += 1
        self.stats["admission_rounds"] += 1
        self.stats["prefill_tokens"] += R * P
        self.stats["admitted_tokens"] += P * len(admitted)
        # the admission's one device-to-host read
        tok0_h, done0_h, ok0_h = np.asarray(packed.tolist(), np.int64).T
        bad = [s for s, _ in admitted if not ok0_h[s]]
        if bad:
            raise CacheCorruption(
                f"non-finite logits at admission for slots {bad}")
        if callable(now):       # finish times stamp after the host read
            now = now()
        for slot, req in admitted:
            req.status = RequestStatus.RUNNING
            req.slot = slot
            self._admit_counter += 1
            self._admit_seq[slot] = self._admit_counter
            self._progress[slot] = self._target[slot] = P
            cb_ok = True
            if req.remaining >= 1:
                cb_ok = self._deliver(req, int(tok0_h[slot]))
            if not cb_ok:
                # a raising streaming callback fails only its request
                self._retire(req, "failed", now)
                self.stats["failed"] += 1
                self._free_on_device([slot])
            elif done0_h[slot]:
                eos = self._eos_h[slot]
                self._retire(req, "eos" if eos >= 0 and req.tokens
                             and req.tokens[-1] == eos else "length", now)
            else:
                self.slots[slot] = req
        return len(admitted)

    def _greedy(self) -> bool:
        """Every slot greedy by the host mirrors: the argmax-only variant,
        chosen without a read."""
        return all(t <= 0.0 and k == 0 and p >= 1.0 for t, k, p in
                   zip(self._temp_h, self._topk_h, self._topp_h))

    def step(self, now=None) -> int:
        """One round at logical time ``now`` (a value or a zero-argument
        clock): expire deadlines, shed overload, (maybe) snapshot, map the
        pages of the round ahead (paged), admit into free slots through the
        chunk lane, decode one chunk, retire finished sequences.  Returns
        the tokens emitted (0 on a recovered fault: the retry replays next
        round).  An engine that requires monolithic admission admits first
        (:meth:`_admit`), then maps the pages of the round ahead and
        decodes, with no chunk lane; on an engine with sliding windows a
        queue head longer than the window admits monolithically first, and
        the chunk lane admits after it only if the new head is eligible."""
        now_v = now() if callable(now) else now
        self._expire_deadlines(now_v)
        self._shed_overload(now_v)
        if self.snapshot_interval and \
                self._ticks % self.snapshot_interval == 0:
            self._snap = self.snapshot()
            self._submit_log.clear()
        self._ticks += 1
        try:
            emitted = self._step_inner(now, now_v)
        except EngineFault as err:
            self._recover(err, now_v)
            return 0
        self._retries_since_progress = 0
        return emitted

    def _step_inner(self, now, now_v) -> int:
        paged = self.engine.paged
        if self.engine.requires_monolithic_admission:
            self._admit(now)
            if not any(r is not None for r in self.slots):
                return 0
            if paged:
                self._ensure_chunk_pages(now_v)
            lane, plan, fresh, completing, parks = None, {}, [], set(), {}
        else:
            if self.queue and not self.engine.chunk_eligible(
                    len(self._seq(self.queue[0]))):
                # the head's prompt is past the window: admit its
                # equal-length run first; the chunk lane's admission loop
                # then stops at a head it may not admit (no skip-ahead)
                self._admit(now, only_ineligible=True)
            if paged:
                self._ensure_chunk_pages(now_v)
            lane, plan, fresh, completing, parks = self._assemble_chunk()
        if not any(r is not None for r in self.slots):
            return 0
        if parks:
            # fresh rows park at their first entry BEFORE the dispatch, so
            # chunk iterations ahead of their first target re-run the same
            # write the entry itself makes (the free-slot sentinel's
            # clamped write would land on page 0 of the row's table, a
            # shared page under prefix reuse)
            self._write_slots(parks, tok=True)
        # the host mirrors pick the argmax-only variant without a read
        greedy = self._greedy()
        scfg = self.engine.scfg
        use_spec = scfg.spec_decode
        if use_spec:
            # a speculative block writes draft_k+1 positions from every
            # occupied row's post-chunk-lane held position: fall back to a
            # plain round when any row sits too close to max_len for the
            # block to land unclamped
            lim = scfg.max_len - (scfg.draft_k + 1)
            for slot, req in enumerate(self.slots):
                if req is None:
                    continue
                p = plan.get(slot, self._progress[slot])
                if p < self._target[slot]:
                    held = p - 1                  # parks on its latest entry
                elif slot in completing:
                    held = self._target[slot]     # becomes a decoder at L
                else:
                    held = len(req.prompt) + len(req.tokens) - 1
                if held > lim:
                    use_spec = False
                    break
        try:
            self.cache, tok, pos, done, packed = self.engine.step(
                self.cache, lane, self.tok, self.pos, self.done, self.eos,
                self.chunk, spec=use_spec, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, step0=self._step,
                greedy=greedy)
        except InjectedFault:
            # the dispatch never ran: roll back this round's fresh chunk
            # admissions (pages released, requests back at the queue head
            # in FIFO order) and re-raise for the retry path
            for slot, req in reversed(fresh):
                if paged:
                    self.engine.pool.release(slot)
                self.slots[slot] = None
                self._reset_slot_sampling(slot)
                self._progress[slot] = self._target[slot] = 0
                req.status = RequestStatus.QUEUED
                req.slot = None
                self.queue.appendleft(req)
            if fresh:
                self._push_sampling_state()
                # the free-slot sentinel the parks overwrote
                self._free_on_device([slot for slot, _ in fresh])
            raise
        # a speculative round draws draft_k drafts and draft_k + 1 verify
        # columns
        C = self.engine.prefill_chunk if lane is not None else 0
        self._step += C + (2 * scfg.draft_k + 1 if use_spec else self.chunk)
        self.tok.copy_(tok)
        self.pos.copy_(pos)
        self.done.copy_(done)
        # the round's one device-to-host read
        tok0_h, done0_h, toks_h, dones_h, ok_h, nv_h = unpack_round(
            np.asarray(packed.tolist(), dtype=np.int64))
        if not ok_h.all():
            # poisoned tokens never reach a streaming callback: detection
            # precedes every emit below
            raise CacheCorruption("non-finite logits in decode for slots "
                                  f"{np.flatnonzero(~ok_h).tolist()}")
        # the chunk lane commits: freshly covered pages become shareable
        for slot, p in plan.items():
            self._progress[slot] = p
            if paged:
                self.engine.pool.mark_filled(slot, p)
        for slot, req in fresh:
            self._admit_counter += 1
            self._admit_seq[slot] = self._admit_counter
        if lane is not None:
            self.stats["admission_rounds"] += 1
            self.stats["prefill_tokens"] += self.engine.prefill_chunk
            self.stats["admitted_tokens"] += lane.slot.shape[0]
        self.stats["rounds"] += 1
        self.stats["occupancy_sum"] += (
            sum(r is not None for r in self.slots) / self.n_slots)
        if use_spec:
            # every live decode row drafted draft_k tokens and committed
            # n_valid - 1 of them (the last is the verifier's own token)
            self.stats["spec_rounds"] += 1
            self.stats["spec_drafted"] += int((nv_h > 0).sum()) * \
                scfg.draft_k
            self.stats["spec_accepted"] += int(np.maximum(nv_h - 1, 0).sum())
        if callable(now):       # finish times stamp after the host read
            now = now()
        emitted, freed = 0, []
        for slot, req in enumerate(self.slots):
            if req is None or self._progress[slot] < self._target[slot]:
                continue            # free, or still mid-prefill
            cb_ok = True
            if slot in completing:
                # the first output token was sampled in this same round
                if req.remaining >= 1:
                    cb_ok = self._deliver(req, int(tok0_h[slot]))
                    emitted += 1 if cb_ok else 0
                if cb_ok and done0_h[slot]:
                    eos = self._eos_h[slot]
                    req.finish("eos" if eos >= 0 and req.tokens
                               and req.tokens[-1] == eos else "length", now)
            if cb_ok and not req.done:
                # only the first n_valid columns of the row are real
                for j in range(int(nv_h[slot])):
                    cb_ok = self._deliver(req, int(toks_h[slot, j]))
                    if not cb_ok:
                        break
                    emitted += 1
                    if dones_h[slot, j]:
                        req.finish("eos", now)
                        break
                    if req.remaining <= 0:
                        req.finish("length", now)
                        break
            if not cb_ok:
                req.finish("failed", now)
                self.stats["failed"] += 1
            if req.done:
                self.finished.append(req)
                self.slots[slot] = None
                self._reset_slot_sampling(slot)
                self._progress[slot] = self._target[slot] = 0
                if paged:
                    self.engine.pool.release(slot)
                freed.append(slot)
        if use_spec and paged:
            # the paged rollback of rejected speculation: unmap the pages
            # grown for the draft_k+1 block past the committed sequence
            # (the pending token's position stays mapped)
            for slot, req in enumerate(self.slots):
                if req is None or self._progress[slot] < self._target[slot]:
                    continue
                self.engine.pool.trim(slot,
                                      len(req.prompt) + len(req.tokens))
        if freed:
            self._free_on_device(freed)
        self.stats["emitted_tokens"] += emitted
        return emitted

    @staticmethod
    def _deliver(req: Request, token: int) -> bool:
        """Emit one token; False when the streaming callback raised."""
        try:
            req.emit(token)
            return True
        except Exception:
            return False

    def run(self, requests: Sequence[Request] = (), now=None,
            max_rounds: int = 100_000) -> List[Request]:
        """Submit ``requests`` and drive rounds (at logical time ``now``)
        until everything finishes."""
        for r in requests:
            self.submit(r, now)
        rounds = 0
        while self.has_work:
            self.step(now)
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("scheduler failed to drain "
                                   f"({len(self.queue)} queued)")
        self.check_drained()
        return self.finished

    def check_drained(self) -> None:
        """Leak check at drain (paged): with no work left, the pool holds
        no allocated page and no page is referenced without a slot mapping
        reaching it."""
        if self.has_work or not self.engine.paged:
            return
        pool = self.engine.pool
        leaked = pool.leaked_pages()
        if pool.allocated_pages or leaked:
            raise RuntimeError(
                f"page leak at drain: {pool.allocated_pages} pages still "
                f"allocated, unreachable={leaked}")


def _req_record(r: Request) -> dict:
    """A JSON-able record of one request (``on_token`` left out)."""
    return {"prompt": [int(t) for t in r.prompt],
            "max_new_tokens": r.max_new_tokens,
            "eos_id": r.eos_id, "temperature": r.temperature,
            "top_k": r.top_k, "top_p": r.top_p,
            "deadline": r.deadline, "priority": r.priority,
            "status": r.status.value, "tokens": list(r.tokens),
            "finish_reason": r.finish_reason, "slot": r.slot,
            "arrival_time": r.arrival_time, "finish_time": r.finish_time,
            "retries": r.retries, "seq": getattr(r, "_seq", 0)}


def _req_from_record(d: dict) -> Request:
    r = Request(prompt=d["prompt"], max_new_tokens=d["max_new_tokens"],
                eos_id=d["eos_id"], temperature=d["temperature"],
                top_k=d["top_k"], top_p=d["top_p"],
                deadline=d["deadline"], priority=d["priority"])
    r.status = RequestStatus(d["status"])
    r.tokens = list(d["tokens"])
    r.finish_reason = d["finish_reason"]
    r.slot = d["slot"]
    r.arrival_time = d["arrival_time"]
    r.finish_time = d["finish_time"]
    r.retries = d["retries"]
    r._seq = d["seq"]
    return r
