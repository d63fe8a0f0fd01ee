"""One captured CUDA graph per serving round key: the port's counterpart of
the reference's compiled round (``Engine._build_step_fn`` and its
``_step_fns`` cache, ``repro/serve/engine.py:391, 343``).

Run op by op, a round of ``Engine.step`` is thousands of launches from
Python (qwen2-7b: about three thousand per forward), and the card idles
while the host issues them.  :class:`RoundGraphs` captures the eager round
(``Engine._round``) once per key into a ``torch.cuda.CUDAGraph`` and
replays it, so a round costs the host a few copies and one graph launch.

* **Key:** (n_real, chunk, spec, greedy) — the reference's (C, chunk,
  greedy, spec) with the lane's real entries for C — and what the graph was
  captured over: the batch, the cache tensors' shape and addresses, a
  paged engine's page tables' shapes and addresses (None on a dense one),
  and the kernel backend and variant.  ``ops.set_backend`` and
  ``ops.set_variant`` are module globals read while the round is
  captured, so a graph captured under one never replays under another.
* **Static buffers:** tok, pos, done, eos and the chunk lane's five
  vectors; on a sampled key (``greedy`` False) also the per-slot
  temperature, top_k and top_p vectors and the round's first draw index
  ``step0`` (an int32 scalar), so a new ``step0`` or new sampling values
  replay the same graph.  The seed's key is the engine's constant
  ``Engine.key``.  A round copies its inputs into them; the graph writes
  the new tok, pos and done back into them and the packed result
  (``engine.pack_round``) into its static output.  A greedy key's graph
  has no draw in it.
* **Page tables:** a paged round reads the engine's device tables
  (``Engine.table``, int32 ``[slots, E]``, and on a model with local
  layers ``Engine.ring_table``, ``[slots, Er]``) where they lie, like the
  cache: ``Engine.step`` copies the pool's mapping into them before each
  round, so a graph captured under one mapping replays under any other.
* **Workspaces:** graphs record addresses, so the K-split kernels'
  workspaces of a batch size are allocated once, before its first
  capture, at the largest (rows, columns) the engine's leaves give
  (``kernel.reserve_workspaces``); warm-ups and captures take them
  (``kernel.graph_workspaces``), and a launch that would need more
  raises.  Replays run in order on one stream, so graphs share them.
* **Warm-up:** each key first runs once eagerly on the capture stream, as
  ``torch.cuda.graphs`` asks: the cuBLAS handle and workspace of that
  stream, the rope table, the kernels' selection words and ctypes entries
  are made there, outside the capture.  On a full-length cache its writes
  are the ones the replay then makes again, bit for bit (the same inputs
  at the same positions), and a later iteration's write lies behind an
  earlier query's mask.  A local layer's ring is not like that: iteration
  ``j`` writes slot ``(pos + j) % T``, where the earlier iterations of the
  replay still read the window's oldest keys.  Nor is a recurrent state
  (Mamba2's ``h`` and ``conv``, RWKV6's ``S``, ``xt``, ``xc``): every step
  overwrites it whole, so after a warm-up every slot's state would be a
  round ahead.  So the warm-up saves the local layers' cache leaves and
  every recurrent leaf and puts them back after it, in place (a copy made
  only while a key is captured).
* **Garbage collection:** the collector is off during each capture
  (:func:`no_gc`): cyclic garbage released inside a capture (seen after
  torch.profiler sessions) calls the runtime in ways a capture forbids,
  and the capture fails.
* **Failure:** a capture that fails raises; there is no eager fallback on
  the card.
* **Counters:** a replay runs no Python, so it adds the kernel launches
  (``kernel.LAUNCHES``) and the forwards by lane (``Engine.lane_steps``,
  ``decode_steps``) that its capture recorded; the warm-up and the
  capture themselves count neither, since they serve no request.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from repro_torch.kernels.lutmul import kernel, ops
from repro_torch.models import moe, transformer


class _Round:
    """One key's graph, its static buffers and what its capture recorded."""

    def __init__(self, lane, tok, pos, done, eos, samp):
        self.lane = None if lane is None else type(lane)(
            *(t.clone() for t in lane))
        self.samp = None if samp is None else type(samp)(
            *(t.clone() for t in samp))
        self.tok, self.pos = tok.clone(), pos.clone()
        self.done, self.eos = done.clone(), eos.clone()
        self.graph = torch.cuda.CUDAGraph()
        self.packed = None
        self.launches: dict = {}
        self.lanes: dict = {}
        self.decode_steps = 0
        self.replays = 0

    @property
    def forwards(self) -> int:
        return sum(self.lanes.values())

    def replay(self, lane, tok, pos, done, eos, samp) -> None:
        for static, given in ((self.lane, lane), (self.samp, samp)):
            if static is not None:
                for dst, src in zip(static, given):
                    dst.copy_(src)
        self.tok.copy_(tok)
        self.pos.copy_(pos)
        self.done.copy_(done)
        self.eos.copy_(eos)
        self.graph.replay()
        self.replays += 1


def _counters(engine):
    return dict(kernel.LAUNCHES), engine.decode_steps, dict(engine.lane_steps)


def _restore(engine, saved) -> None:
    launches, steps, lanes = saved
    kernel.LAUNCHES.update(launches)
    engine.decode_steps = steps
    engine.lane_steps.update(lanes)


def _warmup_leaves(eng, cache) -> list:
    """The cache leaves a warm-up round would leave other than the replay
    finds them: every leaf of a local (sliding-window) layer, and every
    recurrent state leaf (``transformer.STATE_KEYS``, overwritten whole at
    every step)."""
    cfg = eng.cfg
    return [t for i, c in enumerate(cache)
            for k, t in c.items()
            if k in transformer.STATE_KEYS
            or transformer.is_local(cfg, transformer.layer_spec(cfg, i))]


def _leaf_widths(tree) -> set:
    """Output widths N of every projection leaf (``w_q`` or ``w``)."""
    if isinstance(tree, dict):
        out = {tree[k].shape[-1] for k in ("w_q", "w") if k in tree}
        for v in tree.values():
            if isinstance(v, (dict, list, tuple)):
                out |= _leaf_widths(v)
        return out
    if isinstance(tree, (list, tuple)):
        return set().union(*(_leaf_widths(v) for v in tree))
    return set()


@contextlib.contextmanager
def no_gc():
    """The cyclic garbage collector off for the block, as every CUDA graph
    capture needs it: a collection inside a capture releases objects whose
    finalizers call the runtime in ways a capture forbids."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def applies(device) -> bool:
    """Rounds are graphs on the card with the kernel backend; the CPU and
    the ``ref`` backend run them eagerly."""
    return device.type == "cuda" and ops.get_backend() == "cuda"


class RoundGraphs:
    """An engine's captured rounds, by key.  It keeps no reference to the
    engine (which owns it), so dropping the engine frees its weights and
    its graphs at once."""

    def __init__(self):
        self.rounds: dict[tuple, _Round] = {}
        self.capture_s = 0.0          # warm-ups and captures, host clock
        self.replays = 0
        self._workspaces: dict[int, dict] = {}   # by batch size
        self._stream = None
        self._pool = None

    def key(self, cache, lane, tok, chunk: int, spec: bool,
            greedy: bool, tables=None) -> tuple:
        be = ops.get_backend()
        table = None
        if tables is not None:
            table = sum(((tuple(t.shape), t.data_ptr()) for t in tables
                         if t is not None), ())
        return (0 if lane is None else lane.slot.shape[0], chunk, spec,
                greedy, be, ops.variant_key(be), tok.shape[0],
                tuple(tuple(t.shape) for t in cache[0].values()), table,
                tuple(t.data_ptr() for c in cache for t in c.values()))

    def run(self, eng, cache, lane, tok, pos, done, eos, chunk: int,
            spec: bool, samp=None, tables=None):
        """Replay the round of this key of engine ``eng``, capturing it
        first when it is new: (tok, pos, done, packed), the graph's static
        buffers.  ``samp``: the sampled round's ``engine.Sampling``, None
        on a greedy round; ``tables``: a paged round's ``(Engine.table,
        Engine.ring_table)`` (the ring table None without local layers),
        read in place."""
        key = self.key(cache, lane, tok, chunk, spec, samp is None, tables)
        r = self.rounds.get(key)
        if r is None:
            r = self._capture(eng, key, cache, lane, tok, pos, done, eos,
                              chunk, spec, samp, tables)
        r.replay(lane, tok, pos, done, eos, samp)
        for name, n in r.launches.items():
            kernel.LAUNCHES[name] += n
        eng.decode_steps += r.decode_steps
        for k, n in r.lanes.items():
            eng.lane_steps[k] += n
        self.replays += 1
        return r.tok, r.pos, r.done, r.packed

    def _reserve(self, eng, batch: int, device) -> dict:
        """The workspaces of a batch size: the rows of a decode step (and
        of a verify forward, and a MoE decode step's expert capacity)
        times every leaf width of the engine."""
        ws = self._workspaces.get(batch)
        if ws is None:
            rows = {batch}
            if eng.cfg.moe is not None:
                rows.add(moe.decode_rows(eng.cfg.moe, batch))
            if eng.scfg.spec_decode:
                rows.add(batch * (eng.scfg.draft_k + 1))
            ws = kernel.reserve_workspaces(
                [(m, n) for m in rows for n in _leaf_widths(eng.params)],
                device)
            self._workspaces[batch] = ws
        return ws

    def _capture(self, eng, key, cache, lane, tok, pos, done, eos,
                 chunk: int, spec: bool, samp, tables) -> _Round:
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(tok.device)
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._stream
        saved = _counters(eng)
        try:
            with kernel.graph_workspaces(
                    self._reserve(eng, tok.shape[0], tok.device)):
                current = torch.cuda.current_stream(tok.device)
                rewound = _warmup_leaves(eng, cache)
                kept = [t.clone() for t in rewound]
                stream.wait_stream(current)
                with torch.cuda.stream(stream):
                    eng._round(cache, lane, tok, pos, done, eos, chunk,
                               spec, samp, tables)
                current.wait_stream(stream)
                for t, k in zip(rewound, kept):
                    t.copy_(k)
                del kept
                _restore(eng, saved)
                r = _Round(lane, tok, pos, done, eos, samp)
                with no_gc(), torch.cuda.graph(r.graph, pool=self._pool,
                                               stream=stream):
                    new_tok, new_pos, new_done, r.packed = eng._round(
                        cache, r.lane, r.tok, r.pos, r.done, r.eos, chunk,
                        spec, r.samp, tables)
                    r.tok.copy_(new_tok)
                    r.pos.copy_(new_pos)
                    r.done.copy_(new_done)
            r.launches = {k: n - saved[0][k]
                          for k, n in kernel.LAUNCHES.items()
                          if n != saved[0][k]}
            r.decode_steps = eng.decode_steps - saved[1]
            r.lanes = {k: n - saved[2][k] for k, n in eng.lane_steps.items()
                       if n != saved[2][k]}
        finally:
            _restore(eng, saved)
        self.rounds[key] = r
        self.capture_s += time.perf_counter() - t0
        return r
