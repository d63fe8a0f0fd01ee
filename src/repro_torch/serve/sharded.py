"""Multi-device serving (port of ``repro.serve.sharded``): tensor-parallel
LUT projections over the model axis of a (data, model) mesh, and the slots
split over its data axis.

Every quantized projection's integer codes are split across the model
axis (``dist.tp``: column-parallel with an all-gather, row-parallel with an
exact int32 all-reduce, head-parallel attention, expert-parallel MoE
banks), and the serving state (slots, positions, KV or recurrent caches,
page pools, sampling streams) across the data axis.  ``ShardedEngine`` is
the single-device ``Engine`` run inside a ``dist.tp.tp_context`` on this
rank's parameter shard, its cache shard and its block of slots; every
sharded reduction is exact (int32 sums, maxima) or a gather, so its
temperature-0 transcripts are bitwise the single-device engine's.

The host side: the reference runs one host ``Scheduler`` over the mesh.
Here every rank runs the same deterministic ``Scheduler`` (logical clock,
no wall-clock decision) over ALL slots.  A rank's engine computes its data
shard's rows, then all-gathers the round's packed result and slot state
over the data axis, so every rank's Scheduler sees every slot and takes
the same decisions; no second host protocol exists.  Rounds run eagerly:
gloo collectives cannot be captured into a CUDA graph.  Speculative rounds
run the same way, the drafter on the rank's views of its shard's planes.

``Scheduler.save`` / ``load`` are collective: every rank gathers the whole
mesh's cache into the single engine's layout (:meth:`ShardedEngine.
checkpoint_cache`), rank 0 writes and commits the step, and the others
wait at a barrier; a load reads the committed step on every rank and
keeps this rank's slices (:meth:`ShardedEngine.cache_part`).  A dense
checkpoint of a mesh therefore loads into the single-device ``Engine``,
as the reference's global arrays do.

:func:`launch` starts one process per rank (``torch.multiprocessing``
spawn, a ``FileStore`` rendezvous, a timeout on every collective), joins
them against a deadline and kills every rank when one fails or the
deadline passes.  The backend is the caller's explicit choice: ``"nccl"``
for one card per rank, ``"gloo"`` where several ranks share a card or run
on the CPU (``dist.tp`` stages device tensors through pinned host memory
for it).  Nothing switches backends on its own.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch

from repro_torch.dist import tp as tp_lib
from repro_torch.dist.mesh import ServingMesh, parse_mesh
from repro_torch.models import transformer
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.quantize import quantize_params_for_serving


class ShardedEngine(Engine):
    """Drop-in ``Engine`` for the Scheduler, executing on ``mesh``.  The
    ``slots`` given to the Scheduler must divide over the data axis;
    quantized serving codes are required (only integer-code matmuls shard
    bit-exactly; float split-head attention leaves split whole heads).
    Speculative rounds (``spec_decode``) and ``Scheduler.save`` / ``load``
    (collective: :meth:`checkpoint_cache`, :meth:`cache_part`) are served
    as on one device."""

    sharded = True

    def __init__(self, cfg, params, scfg: ServeConfig = ServeConfig(), *,
                 mesh: ServingMesh):
        if getattr(cfg, "enc_dec", False):
            raise NotImplementedError(
                "sharded serving covers decoder-only LMs")
        if not scfg.quant:
            raise ValueError(
                "ShardedEngine requires ServeConfig(quant=...): only integer "
                "weight codes shard bit-exactly (an int32 sum is "
                "associative; a float row-parallel reduction would drift)")
        self.mesh = mesh
        self.n_data, self.n_model = mesh.n_data, mesh.n_model
        # quantize (codes stay as they are), mark, then keep this rank's
        # slices; head_dim lets the marker go head-parallel on attention
        # groups when both head counts divide the model axis
        params = quantize_params_for_serving(params, mode=scfg.quant,
                                             bits_plan=scfg.bits_plan)
        params, _, self.n_tp_leaves = tp_lib.mark_tp_params(
            params, self.n_model, head_dim=cfg.head_dim)
        n_attn, n_head_marked = tp_lib.attn_group_counts(params)
        if n_head_marked not in (0, n_attn):
            # the cache layout is one choice for the whole engine
            raise ValueError(
                f"head marking must be all-or-nothing across attention "
                f"groups, got {n_head_marked}/{n_attn}")
        self.head_sharded = n_head_marked > 0
        self.experts_sharded = tp_lib.has_marker(params, "tp_exp")
        params = tp_lib.shard_params(params, mesh)
        super().__init__(cfg, params, dataclasses.replace(scfg, quant=None),
                         device=mesh.device)
        self.scfg = scfg                  # keep the quant label visible
        self.n_page_shards = self.n_data
        if self.head_sharded:             # the cache holds the local heads
            self._cache_cfg = dataclasses.replace(
                cfg, n_heads=cfg.n_heads // self.n_model,
                n_kv=cfg.n_kv // self.n_model)
        self._pos_all = None
        self._shard_shapes = None

    def _context(self):
        return tp_lib.tp_context(self.mesh.model, self.n_model,
                                 self.mesh.data)

    # -- slot bookkeeping ----------------------------------------------------

    def init_cache(self, batch: int) -> list:
        """This rank's cache: its data shard's ``batch / n_data`` slots (or
        page shard), with ``n_kv / n_model`` KV heads when head-sharded."""
        if batch % self.n_data:
            raise ValueError(
                f"slots ({batch}) must be divisible by the data-axis size "
                f"({self.n_data}): each data shard runs batch/{self.n_data} "
                "decode lanes")
        local = batch // self.n_data
        start = self.mesh.data_index * local
        self._rows = slice(start, start + local)
        cache = super().init_cache(batch)
        self._shard_shapes = [{k: tuple(t.shape) for k, t in c.items()}
                              for c in cache]
        return cache

    def place_slot_state(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a per-slot vector (the reference's
        data-sharded placement)."""
        return x[self._rows].to(self.device)

    def place_cache(self, cache: list) -> list:
        """A cache shard restored on the host, on this rank's device; its
        leaves must have the shapes of this rank's ``init_cache``."""
        out = []
        for c, live in zip(cache, self._shard_shapes):
            for k, t in c.items():
                if tuple(t.shape) != live[k]:
                    raise ValueError(
                        f"cache leaf {k} has shape {tuple(t.shape)}; this "
                        f"rank's shard is {live[k]}")
            out.append({k: t.to(self.device) for k, t in c.items()})
        return out

    # -- checkpoints (Scheduler.save / load) ----------------------------------

    def _leaf_dims(self, key: str) -> tuple:
        """(data dim, model dim or None) of a cache leaf: every leaf's dim
        0 is the data shard's slots (or its pool's pages); head-sharded,
        the K/V leaves and their scales split the head axis (dim 2) too.
        Recurrent state follows replicated (column-gathered) projections."""
        heads = self.head_sharded and key not in transformer.STATE_KEYS
        return 0, (2 if heads else None)

    def checkpoint_cache(self, cache: list, like: bool = False) -> list:
        """The whole mesh's cache in the single engine's layout: each
        leaf's model ranks concatenated along the head axis (head-sharded
        K/V), then the data shards along dim 0 (slots, or a paged pool's
        pages: every data shard's pool in data order, page ids shard-local
        as the allocator keeps them).  Collective over both axes: every
        rank calls it.  ``like`` returns meta tensors of those shapes and
        communicates nothing."""
        out = []
        for c in cache:
            leaves = {}
            for k, t in c.items():
                dd, dm = self._leaf_dims(k)
                if like:
                    shape = list(t.shape)
                    shape[dd] *= self.n_data
                    if dm is not None:
                        shape[dm] *= self.n_model
                    leaves[k] = torch.empty(shape, dtype=t.dtype,
                                            device="meta")
                    continue
                if dm is not None:
                    t = tp_lib.all_gather(t, self.mesh.model, dim=dm)
                leaves[k] = tp_lib.all_gather(t, self.mesh.data, dim=dd)
            out.append(leaves)
        return out

    def cache_part(self, cache: list) -> list:
        """This rank's slices of a checkpoint's (whole-mesh) cache: its data
        shard's rows or pages and, head-sharded, its model rank's heads;
        :meth:`place_cache` checks them against this rank's layout."""
        out = []
        for c in cache:
            leaves = {}
            for k, t in c.items():
                dd, dm = self._leaf_dims(k)
                n = t.shape[dd] // self.n_data
                t = t.narrow(dd, self.mesh.data_index * n, n)
                if dm is not None:
                    n = t.shape[dm] // self.n_model
                    t = t.narrow(dm, self.mesh.model_index * n, n)
                leaves[k] = t
            out.append(leaves)
        return self.place_cache(out)

    def _gather_slots(self, *cols: torch.Tensor) -> list:
        """Every slot's rows of per-slot results: this rank's [B/n_data,
        ...] columns concatenated and all-gathered over the data axis in
        one collective, split back into [B, ...] tensors."""
        i32 = [c.to(torch.int32).reshape(c.shape[0], -1) for c in cols]
        allc = tp_lib.all_gather(torch.cat(i32, 1), self.mesh.data, dim=0)
        out, at = [], 0
        for c, orig in zip(i32, cols):
            part = allc[:, at:at + c.shape[1]]
            at += c.shape[1]
            part = part.reshape((allc.shape[0],) + tuple(orig.shape[1:]))
            out.append(part != 0 if orig.dtype == torch.bool
                       else part.to(orig.dtype).contiguous())
        return out

    def _fault_site(self, site: str, cache, pos):
        # the plan picks its victim from every slot's position, the same on
        # every rank; the engine's poison hooks place it
        return super()._fault_site(site, cache, self._pos_all)

    def poison_row(self, slot: int):
        """The slot's local row on its data shard's model rank 0 (one
        model shard's cache takes the NaN), else None."""
        local = slot - self._rows.start
        if self.mesh.model_index or not 0 <= local < \
                self._rows.stop - self._rows.start:
            return None
        return local

    def poison_page(self, shard: int, pid: int):
        """Page ``pid`` of this rank's pool on its shard's model rank 0."""
        if self.mesh.model_index or shard != self.mesh.data_index:
            return None
        return pid

    # -- the rounds ----------------------------------------------------------

    def _enter(self, pos, greedy: bool, temperature, top_k, top_p) -> dict:
        """Keep every slot's positions for the fault sites; this rank's
        rows of the sampling vectors (none on a greedy round)."""
        self._pos_all = pos
        if greedy:
            return {}
        r = self._rows
        return dict(temperature=temperature[r], top_k=top_k[r],
                    top_p=top_p[r])

    def step(self, cache, lane, tok, pos, done, eos, chunk: int,
             spec: bool = False, *, temperature=None, top_k=None,
             top_p=None, step0=0, greedy: bool = True,
             _eager: bool = True):
        """``Engine.step`` on this rank's rows, eagerly, inside the tensor-
        parallel context; ``tok``/``pos``/``done``/``eos`` and the sampling
        vectors cover every slot, and so do the returned state and packed
        result (all-gathered over the data axis; a speculative round's
        accepted widths ride in the packed result).  With ``spec`` the
        drafter runs on the rank's views of its own shard: row-parallel
        leaves contract their K slice of the top planes and all-reduce the
        exact int32 sums, as the target's do."""
        r = self._rows
        knobs = self._enter(pos, greedy, temperature, top_k, top_p)
        with self._context():
            cache, tok_l, pos_l, done_l, packed = super().step(
                cache, lane, tok[r], pos[r], done[r], eos[r], chunk, spec,
                step0=step0, greedy=greedy, _eager=True, **knobs)
        tok, pos, done, packed = self._gather_slots(tok_l, pos_l, done_l,
                                                    packed)
        return cache, tok, pos, done, packed

    def admit_monolithic(self, cache, prompts, lengths, mask, budget_one,
                         eos, tok, pos, done, *, temperature=None,
                         top_k=None, top_p=None, step0: int = 0,
                         greedy: bool = True):
        """``Engine.admit_monolithic`` of this rank's rows (their prompts
        prefilled, stitched into its cache shard), the results gathered
        over the data axis."""
        r = self._rows
        knobs = self._enter(pos, greedy, temperature, top_k, top_p)
        with self._context():
            cache, tok_l, pos_l, done_l, packed = super().admit_monolithic(
                cache, prompts[r], lengths[r], mask[r], budget_one[r],
                eos[r], tok[r], pos[r], done[r], step0=step0, greedy=greedy,
                **knobs)
        tok, pos, done, packed = self._gather_slots(tok_l, pos_l, done_l,
                                                    packed)
        return cache, tok, pos, done, packed

    # -- figures -------------------------------------------------------------

    def kv_cache_bytes(self, batch: int) -> int:
        """PER-RANK bytes of the attention KV leaves: the data axis splits
        the slots and, head-sharded, the model axis the KV heads, so the
        figure is the single-device one over ``n_data * n_model`` (over
        ``n_data`` with replicated heads).  A paged engine reports the
        busiest shard's peak in-use pages times this rank's page bytes."""
        cfg, sc = self._cache_cfg, self.scfg
        if self.paged and self.pool is not None:
            return self.pool.peak_pages_per_shard * sc.page_size \
                * transformer.kv_bytes_per_position(cfg)
        return transformer.dense_cache_bytes(cfg, batch // self.n_data,
                                             sc.max_len)

    def generate(self, *a, **kw):
        raise NotImplementedError(
            "ShardedEngine serves through serve.scheduler.Scheduler; use "
            "the single-device Engine for the static-batch generate() "
            "oracle")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, mesh_shape, backend: str,
               store: str, out: str, timeout_s: float, device, args) -> None:
    """One rank: join the group, build the mesh, run ``fn(mesh, *args)``,
    pickle its result to ``out``.  A failure prints its traceback and
    exits non-zero (the parent then kills the other ranks)."""
    import torch.distributed as dist
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        mesh = ServingMesh(*mesh_shape, device=device)
        result = fn(mesh, *args)
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def launch(fn, mesh_spec: str, backend: str, *, timeout_s: float,
           args: tuple = (), device=None) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``mesh_spec`` ("DxM")
    world and return the ranks' results in rank order.

    ``backend`` ("nccl" | "gloo") is the caller's choice; ``device`` is
    every rank's device (default ``cuda:{rank % device_count}``; ``"cpu"``
    for the CPU).  Ranks are spawned processes (``fn`` and ``args`` must
    pickle) meeting at a ``FileStore`` in a fresh temporary directory,
    every collective bounded by ``timeout_s``.  The parent joins them
    against ``timeout_s`` of wall time and kills every rank when one exits
    non-zero or the deadline passes, then raises."""
    import torch.multiprocessing as mp
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    shape = parse_mesh(mesh_spec)
    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_launch_")
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, shape, backend, store, outs[r], timeout_s, device,
        args), daemon=True) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = ", ".join(f"rank {r} (code {c})" for r, c in bad)
                raise RuntimeError(f"{failed} of {mesh_spec} exited; every "
                                   "rank was stopped")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{mesh_spec} world ran past its {timeout_s} s limit; "
                    "every rank was stopped")
            time.sleep(0.05)
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
