"""Batched serving engine (port of ``repro.serve.engine``: dense or paged
KV, float or int8, one device, chunked prefill, monolithic admission,
per-slot sampling, bitplane self-speculative decoding, fault injection and
the invariant guards).

``Engine.step`` is one unified serving round: a chunk lane of prompt-token
iterations (each a full-batch ``decode_step`` with the target slot's
(token, position) substituted in, sampling a request's first output token
when its last prompt token lands) followed by ``chunk`` decode iterations
over every slot.  As in the reference, the chunk lane arrives as device
vectors (:class:`ChunkLane`) and the round reads nothing back from the
device: whether an entry fires is a ``torch.where``, and the round's
results come back packed into one int32 tensor (:func:`pack_round`), so a
round costs the caller one device-to-host read.  The pad entries of a short
chunk lane — full-batch no-ops whose only effect is rewriting every row's
held KV with the same bits — are not passed: the lane holds the ``n_real``
real entries.  With ``spec_decode`` a round's decode lane can instead be a
speculative one: ``draft_k`` drafter steps on the top-plane view of the
tmac weights, one ``verify_step`` over the drafts, the longest matching
prefix accepted.

Sampling is on the device with per-slot temperature / top-k / top-p
vectors and the port's own threefry stream (``core.prng``): draw ``n`` of a
round uses ``fold_in(PRNGKey(seed), step0 + n)``, numbered as the
reference numbers them — chunk entry ``i`` is ``n = i``, decode or draft
step ``j`` is ``C + j`` and verify column ``i`` is ``C + draft_k + i``,
where ``C`` is ``prefill_chunk`` on a round with a chunk lane (pads
included, though the port never runs them) and 0 otherwise.  A round whose
every slot is greedy takes the argmax-only variant (``greedy=True``): no
key, sort or softmax in it.

On the card with the kernel backend, a round is one captured CUDA graph
per round key, replayed (``serve.graphs``, the counterpart of the
reference's one compiled dispatch per key); on the CPU and with the
``ref`` backend it runs eagerly, op by op.

With ``ServeConfig(paged=True)`` the cache is per-layer page pools and
``init_cache`` makes a fresh host-side ``serve.paged.PagePool`` under
``engine.pool``, which the Scheduler drives (admission, growth, trim,
release).  The engine owns one int32 ``[slots, E]`` device table at a
fixed address; every round first copies the pool's numpy table into it
(through pinned memory on the card), and the round, replayed or eager,
reads its pages through it.

Where prompt state cannot be built one token at a time — a recurrent
state (Mamba2, RWKV6), which the prefill's chunked scan builds at the
prompt's exact length, MoE routing, an int8 KV cache, whose codes the
reference quantizes from the batched prefill's K/V, or a prompt longer
than a sliding window, whose ring the chunk lane would read in ring order
where the oracle's prefill reads it in time order — the Scheduler admits
through :meth:`Engine.admit_monolithic` instead of the chunk lane: one
batched prefill of the admitted prompts, its K/V (quantized when the
cache is int8, arranged into the ring on a local layer) and recurrent
state stitched into the masked slots of the live cache in place, the
first tokens drawn, the slot state merged, and the results packed for one
host read.  It runs eagerly; the decode rounds
after it are the same replayed graphs (the stitch moves no cache tensor).

Faults and guards (``serve.faults``): an installed ``FaultPlan``
(:meth:`Engine.set_fault_plan`) fires at every dispatch site before the
round touches the device — ``admit`` for an admission or a round with a
chunk lane, then ``decode`` — and a paged engine audits its pool there
(``PagePool.validate``) before the table is copied to the card.  Every round ANDs a sweep of the float cache leaves
(:func:`_cache_finite`) into its packed finite-logits column, so a NaN
that integer-code matmuls launder into finite logits is still caught, in
the same host read.

``generate`` is the static-batch oracle: prefill, then a per-token loop
that draws token ``i`` with ``fold_in(PRNGKey(seed), i)`` under the
ServeConfig's scalars.  It is the only way an encoder-decoder model
(whisper, ``models.encdec``) is served, as in the reference:
``generate(prompts, n, frames=)`` encodes the frames in its prefill, and
the Scheduler, ``step``, ``admit_monolithic``, a paged engine and
speculative decoding refuse enc-dec with the reference's errors.
Positions are per-sequence ``pos: [B]`` int32; a negative position is the
free-slot sentinel (every key of the row masked, writes inside its row).
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.dist import tp as tp_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import encdec, transformer
from repro_torch.serve import graphs
from repro_torch.serve.faults import CacheCorruption
from repro_torch.serve.request import check_sampling

NEG_INF = -1e30


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    # the default sampling of every request that sets none of its own
    temperature: float = 0.0      # <= 0: greedy
    top_k: int = 0                # 0 disables top-k filtering
    top_p: float = 1.0            # >= 1.0 disables nucleus filtering
    seed: int = 0                 # the PRNGKey every draw is folded from
    quant: Optional[str] = None   # convert weights to serving codes at load
    # optional per-leaf mixed bit widths: {param path -> mode string}, the
    # output of roofline.analysis.plan_mixed_bits (keys match the
    # serve.quantize walk paths); leaves not in the plan follow `quant`
    bits_plan: Optional[dict] = None
    # paged KV cache (serve.paged): per-layer page pools + per-slot page
    # tables instead of dense [slots, max_len] buffers
    paged: bool = False
    page_size: int = 4            # tokens per page; must divide max_len
    num_pages: int = 0            # total pool pages incl. the null page;
                                  # 0 = worst-case auto-size
    prefix_reuse: bool = True     # share identical prompt-prefix pages
    # prompt tokens processed per unified round; a multiple of page_size on
    # paged engines (None = 2 pages when paged, else 8)
    prefill_chunk: Optional[int] = None
    # bitplane-truncated self-speculative decoding (greedy): draft
    # ``draft_k`` tokens per round with the top-``draft_planes``-plane view
    # of the tmac weight codes (no extra weight memory), verify them in one
    # (draft_k+1)-token target forward, accept the longest matching prefix.
    # Transcripts equal the non-speculative engine's at temperature 0; above
    # it, drafts and verify columns are sampled with their own keys and
    # still matched token for token.
    spec_decode: bool = False
    draft_planes: int = 2         # top planes the drafter keeps (>= 2)
    draft_k: int = 3              # tokens drafted per verify round

    def __post_init__(self):
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        check_sampling(self.temperature, self.top_k, self.top_p)
        if not isinstance(self.seed, numbers.Integral) \
                or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an int, got {self.seed!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.paged and self.max_len % self.page_size:
            raise ValueError(
                f"page_size ({self.page_size}) must divide max_len "
                f"({self.max_len}) — pick a power-of-two page size or pad "
                f"max_len up to a multiple")
        if self.num_pages < 0:
            raise ValueError(f"num_pages must be >= 0 (0 = auto-size), got "
                             f"{self.num_pages}")
        if self.prefill_chunk is not None:
            if self.prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{self.prefill_chunk}")
            if self.prefill_chunk > self.max_len:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) cannot exceed "
                    f"max_len ({self.max_len}) — no prompt is longer")
            if self.paged and self.prefill_chunk % self.page_size:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a "
                    f"multiple of page_size ({self.page_size}) so chunk "
                    f"boundaries align with page boundaries")
        if self.spec_decode:
            if self.draft_k < 1:
                raise ValueError(
                    f"draft_k must be >= 1, got {self.draft_k}")
            if self.draft_planes < 2:
                raise ValueError(
                    f"draft_planes must be >= 2 (the drafter keeps the sign "
                    f"plane plus at least one magnitude plane), got "
                    f"{self.draft_planes}")
            if self.draft_k + 1 > self.max_len:
                raise ValueError(
                    f"draft_k ({self.draft_k}) needs max_len >= draft_k + 1 "
                    f"({self.draft_k + 1}), got {self.max_len}")

    @property
    def chunk_tokens(self) -> int:
        """The resolved prefill chunk budget (auto when unset)."""
        if self.prefill_chunk is not None:
            return self.prefill_chunk
        return 2 * self.page_size if self.paged else 8


def paged_layout(cfg, scfg: ServeConfig):
    """The engine's page geometry (validated against cfg and scfg)."""
    from repro_torch.serve.paged import PagedLayout
    return PagedLayout.build(cfg, scfg.max_len, scfg.page_size)


def resolve_pages_per_shard(cfg, scfg: ServeConfig, batch: int,
                            n_shards: int) -> int:
    """Pool pages per shard: ``scfg.num_pages / n_shards`` when set (must
    divide), else the exhaustion-free worst case for ``batch`` slots."""
    lay = paged_layout(cfg, scfg)
    if scfg.num_pages:
        if scfg.num_pages % n_shards:
            raise ValueError(f"num_pages ({scfg.num_pages}) must divide "
                             f"over the data axis ({n_shards})")
        return scfg.num_pages // n_shards
    if batch % n_shards:
        raise ValueError(f"slots ({batch}) must divide over the data axis "
                         f"({n_shards})")
    return lay.auto_pages_per_shard(batch // n_shards)


_FLOAT_KV_KEYS = ("k", "v", "shared_k", "shared_v", "k_scale", "v_scale")
_ENCDEC_ROUNDS = ("continuous batching serves decoder-only LMs; enc-dec "
                  "uses Engine.generate")


def _cache_finite(cache) -> torch.Tensor:
    """Scalar AND of ``isfinite`` over every floating cache leaf among K,
    V, the shared block's K/V and the int8 cache's scales (the reference's
    sweep: no recurrent state).  The finite-logits guard sees only what
    reaches a live row's logits: a NaN whose score the position mask drops,
    or one an integer-code path quantizes into finite codes, slips past
    it, so every round audits the cache itself.  Integer leaves (int8 KV
    codes) are skipped: the codes of a NaN row are whatever the cast makes
    of it, and the row's scale is NaN anyway.

    One pass over all leaves of a dtype: a leaf's max-abs norm is finite
    exactly when the leaf is (NaN propagates, +-Inf gives Inf, and a max
    cannot overflow), so a round adds a few graph nodes, not two a leaf.
    A cache without such leaves (RWKV6 holds only recurrent state) is
    finite: True."""
    groups: dict = {}
    for layer in cache:
        for key in _FLOAT_KV_KEYS:
            leaf = layer.get(key)
            if leaf is not None and leaf.is_floating_point():
                groups.setdefault(leaf.dtype, []).append(leaf)
    ok = None
    for leaves in groups.values():
        norms = torch._foreach_norm(leaves, float("inf"))
        fin = torch.isfinite(torch.stack(norms)).all()
        ok = fin if ok is None else ok & fin
    return True if ok is None else ok


def _per_row(x, dtype, B: int, device) -> torch.Tensor:
    """A scalar or [B] sampling knob as a [B] tensor of ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).reshape(-1).expand(B)
    return torch.full((B,), x, dtype=dtype, device=device)


def sample_logits(logits: torch.Tensor, key: Optional[torch.Tensor] = None,
                  temperature=0.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """Per-row sampling, as the reference's ``sample_logits``: the argmax
    (first index on ties) where temperature <= 0, otherwise a draw under
    ``key`` from the temperature softmax restricted by top-k and/or top-p.

    logits: [B, V] ([..., V] when greedy); temperature / top_k / top_p:
    Python scalars or [B] tensors.  Python scalars short-circuit:
    all-greedy is the argmax alone (``key`` unused), unfiltered sampling
    skips the vocabulary sort.  The general path computes both and selects
    per row.  Temperatures divide as device tensors (CUDA turns a division
    by a Python number into a reciprocal multiply)."""
    logits = logits.to(torch.float32)
    static = all(isinstance(x, (int, float))
                 for x in (temperature, top_k, top_p))
    if static and temperature <= 0.0:       # any leading shape
        return torch.argmax(logits, dim=-1).to(torch.int32)
    B, V = logits.shape
    dev = logits.device
    if static and top_k == 0 and top_p >= 1.0:
        t = torch.full((), max(temperature, 1e-6), dtype=torch.float32,
                       device=dev)
        return prng.categorical(key, logits / t).to(torch.int32)
    temperature = _per_row(temperature, torch.float32, B, dev)
    top_k = _per_row(top_k, torch.int32, B, dev)
    top_p = _per_row(top_p, torch.float32, B, dev)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_l.gather(-1, (torch.clamp(top_k, 1, V) - 1).long()[:, None])
    keep = (logits >= kth) | (top_k <= 0)[:, None]
    t = torch.clamp_min(temperature, 1e-6)[:, None]
    scaled = sorted_l / t
    unnorm = torch.exp(scaled - scaled.amax(-1, keepdim=True))
    probs = unnorm / unnorm.sum(-1, keepdim=True)
    csum = torch.cumsum(probs, dim=-1)
    # nucleus: the smallest prefix whose mass reaches top_p (the first
    # token always in)
    n_keep = torch.clamp_min(((csum - probs) < top_p[:, None]).sum(-1), 1)
    cutoff = sorted_l.gather(-1, (n_keep - 1)[:, None])
    keep = keep & ((logits >= cutoff) | (top_p >= 1.0)[:, None])
    sampled = prng.categorical(
        key, torch.where(keep, logits, NEG_INF) / t).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


class Sampling(NamedTuple):
    """A sampled round's per-slot knobs and stream position, on the
    device."""
    temperature: torch.Tensor  # float32 [B]
    top_k: torch.Tensor        # int32 [B]
    top_p: torch.Tensor        # float32 [B]
    step0: torch.Tensor        # int32 scalar: the round's first draw index


class ChunkLane(NamedTuple):
    """A round's prompt-token entries as device vectors of length
    ``n_real`` (the reference's ``c_slot, c_tok, c_pos, c_first, c_b1``)."""
    slot: torch.Tensor        # int32 target row
    tok: torch.Tensor         # int32 prompt token
    pos: torch.Tensor         # int32 its position
    first: torch.Tensor       # bool: the prompt's last token
    budget_one: torch.Tensor  # bool: with ``first``, the whole budget


def pack_round(tok0, done0, toks, dones, ok, n_valid) -> torch.Tensor:
    """A round's per-slot results as one int32 [B, 2W + 4] tensor: tok0,
    done0, the [B, W] tokens, the [B, W] dones, ok, n_valid."""
    i32 = torch.int32
    return torch.cat([tok0[:, None], done0[:, None].to(i32), toks,
                      dones.to(i32), ok[:, None].to(i32),
                      n_valid[:, None]], 1)


def unpack_round(packed):
    """:func:`pack_round`'s inverse on a tensor or an array: (tok0, done0,
    tokens [B, W], dones [B, W], ok, n_valid), the flags as booleans."""
    W = (packed.shape[1] - 4) // 2
    return (packed[:, 0], packed[:, 1] != 0, packed[:, 2:2 + W],
            packed[:, 2 + W:2 + 2 * W] != 0, packed[:, 2 + 2 * W] != 0,
            packed[:, 3 + 2 * W])


def _ring_positions(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T] position each ring slot holds after a ``lengths``-token
    prompt is stitched (negative: the slot is empty), the addressing
    :func:`_ring_from_full` and the paged ring scatter share."""
    i = torch.arange(T, dtype=lengths.dtype, device=lengths.device)[None]
    last = lengths[:, None] - 1
    return last - torch.remainder(last - i, T)


def _ring_from_full(kv: torch.Tensor, lengths: torch.Tensor,
                    T: int) -> torch.Tensor:
    """Full-length prefill K/V [B, P, H, D] as per-row T-slot rings: slot i
    holds the token at the largest position ``p < lengths[b]`` with ``p %
    T == i``, decode's rolling addressing; a slot no token maps to (a
    prompt shorter than T) is zero, and its position stays masked."""
    B, P = kv.shape[:2]
    p = _ring_positions(lengths, T)
    idx = torch.clamp(p, 0, P - 1).long().reshape(
        (B, T) + (1,) * (kv.dim() - 2)).expand((B, T) + tuple(kv.shape[2:]))
    vals = kv.gather(1, idx)
    keep = (p >= 0).reshape((B, T) + (1,) * (kv.dim() - 2))
    return torch.where(keep, vals, torch.zeros((), dtype=kv.dtype,
                                               device=kv.device))


def _write_rows(live: torch.Tensor, part: torch.Tensor,
                mask: torch.Tensor) -> None:
    """Masked multi-slot write, in place: rows of ``live`` [B, T, ...]
    where ``mask`` [B] is set take ``part`` [B, P, ...] in their leading P
    positions (P <= T; the tail stays behind the position mask until
    decode overwrites it).  Other rows keep their bits."""
    head = live[:, :part.shape[1]]
    m = mask.reshape((-1,) + (1,) * (live.dim() - 1))
    head.copy_(torch.where(m, part.to(live.dtype), head))


def _scatter_pages(pool: torch.Tensor, table: torch.Tensor,
                   piece: torch.Tensor, valid: torch.Tensor) -> None:
    """Stitch-time page scatter, in place: token ``t`` of row ``b`` of
    ``piece`` [B, L, ...] lands in page ``table[b, t // ps]`` at offset
    ``t % ps`` of ``pool`` [P, ps, ...] where ``valid`` [B, L]; invalid
    entries (unadmitted rows, prefix-shared tokens) are routed to the null
    page 0, so one scatter covers the whole admission (valid entries
    target exclusively owned pages: duplicate indices land on page 0
    only, over values the position mask hides)."""
    ps = pool.shape[1]
    B, L = valid.shape
    t = torch.arange(L, device=pool.device)
    page = torch.where(valid, table[:, t // ps], 0)
    off = (t % ps).expand(B, L)
    pool[page.reshape(-1).long(), off.reshape(-1).long()] = piece.reshape(
        (B * L,) + tuple(piece.shape[2:])).to(pool.dtype)


def _to_device(params, device):
    """Every tensor of a parameter tree on ``device``."""
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_to_device(v, device) for v in params)
    return params.to(device) if isinstance(params, torch.Tensor) else params


class Engine:
    sharded = False               # serve.sharded.ShardedEngine: True

    def __init__(self, cfg, params, scfg: ServeConfig = ServeConfig(), *,
                 device=None):
        self.is_encdec = bool(cfg.enc_dec)
        self._mod = encdec if self.is_encdec else transformer
        self._mod.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        params = _to_device(params, self.device)
        if scfg.quant:
            # quantize + pack weight codes ONCE at construction; every
            # decode step then reads integer codes
            from repro_torch.serve.quantize import quantize_params_for_serving
            params = quantize_params_for_serving(params, mode=scfg.quant,
                                                 bits_plan=scfg.bits_plan)
        self.params = params
        self.scfg = scfg
        # paged serving state: the geometry is checked here; init_cache
        # makes the PagePool and the device table (they need the slots)
        self.pool = None
        self.table = None
        self.ring_table = None        # local layers' page table (SWA)
        if scfg.paged:
            if self.is_encdec:
                raise NotImplementedError(
                    "paged serving drives decoder-only LMs through the "
                    "scheduler; enc-dec decode supports page tables at the "
                    "encdec.decode_step level only")
            paged_layout(cfg, scfg)          # raises on bad page geometry
            if scfg.num_pages and scfg.num_pages < 2:
                raise ValueError(
                    f"num_pages ({scfg.num_pages}) leaves no usable pages: "
                    f"page 0 is the null page — give the pool at least 2 "
                    f"pages")
        self.decode_steps = 0         # decode_step calls (every lane)
        # forward calls by lane: chunk-lane and decode-lane decode_steps,
        # drafter decode_steps and verify_steps
        self.lane_steps = dict.fromkeys(("chunk", "decode", "draft",
                                         "verify"), 0)
        self.prefill_steps = 0        # admit_monolithic's prefill forwards
        self.n_draftable_leaves = 0
        self.draft_params = None
        if scfg.spec_decode:
            if self.requires_monolithic_admission:
                raise ValueError(
                    "spec_decode needs prompt/decode state that builds one "
                    "token at a time — recurrent layers, MoE routing, "
                    "int8-KV and enc-dec models cannot run draft/verify "
                    "rounds")
            if self.chunk_window_limit is not None:
                raise ValueError(
                    "spec_decode does not support sliding-window attention: "
                    "a draft_k+1-token speculative block would wrap the "
                    "window ring before the verify pass could roll it back")
            if any(spec.shared_attn for spec in cfg.pattern):
                raise ValueError(
                    "spec_decode does not support shared-attention patterns")
            from repro_torch.serve.quantize import (count_draftable_leaves,
                                                    draft_params_view)
            self.n_draftable_leaves = count_draftable_leaves(
                params, scfg.draft_planes)
            if self.n_draftable_leaves == 0:
                raise ValueError(
                    f"spec_decode found no draftable weight leaves: the "
                    f"drafter truncates tmac bitplane stacks wider than "
                    f"draft_planes={scfg.draft_planes} — quantize with a "
                    f"w3/w4 tmac mode (e.g. quant='w4a4_tmac')")
            # views of the target's plane bytes (a zeroing of the target's
            # planes in place shows through)
            self.draft_params = draft_params_view(params, scfg.draft_planes)
        # every draw of a round is folded from this key (a constant of the
        # engine, so a captured round reads it at a fixed address)
        self.key = prng.prng_key(scfg.seed, self.device)
        self.graphs = graphs.RoundGraphs()
        self.faults = None            # a serve.faults.FaultPlan, or None
        # the slots this device computes: all of them here; a data shard's
        # block on serve.sharded.ShardedEngine, which also splits the pages
        # over its data shards and the KV heads over its model axis
        self._rows = slice(None)
        self.n_page_shards = 1
        self._cache_cfg = cfg

    # -- scheduler-facing API ------------------------------------------------

    @property
    def paged(self) -> bool:
        return bool(self.scfg.paged)

    @property
    def prefill_chunk(self) -> int:
        """Prompt tokens carried by the chunk lane of one unified round."""
        return self.scfg.chunk_tokens

    @property
    def has_recurrent_state(self) -> bool:
        """Mamba2 / RWKV6 layers: their state integrates every token it is
        given, pads too, so their prompts are prefilled at exact length."""
        return not self.is_encdec and any(spec.kind != "attn"
                                          for spec in self.cfg.pattern)

    @property
    def requires_monolithic_admission(self) -> bool:
        """True when prompt state cannot be built one token at a time and
        the Scheduler admits through :meth:`admit_monolithic` (in runs of
        equal-length prompts, so no row is padded): recurrent layers, whose
        state the prefill's chunked scan builds, not a token at a time; an
        int8 KV cache, whose codes the reference quantizes from the batched
        prefill's K/V; and MoE routing, whose capacity (and under grouped
        dispatch the groups) depend on the whole batched prompt, so a chunk
        lane would keep and drop other routes than the prefill the oracle
        runs; and enc-dec, whose prompt needs the encoder (served by
        ``generate`` only)."""
        return self.is_encdec or self.has_recurrent_state \
            or self.cfg.kv_quant == "int8" \
            or any(spec.mlp == "moe" for spec in self.cfg.pattern)

    @property
    def chunk_window_limit(self) -> Optional[int]:
        """The longest prompt the chunk lane may admit on a model with
        local (sliding-window) layers: the window.  A longer prompt's ring
        wraps while the chunk lane fills it, so decode reads its keys in
        ring order where the oracle's prefill reads them in time order,
        and float sums in another order differ in the last ulp.  None
        without local layers."""
        if any(transformer.is_local(self.cfg, spec)
               for spec in self.cfg.pattern):
            return int(self.cfg.window)
        return None

    def chunk_eligible(self, seq_len: int) -> bool:
        """Can a ``seq_len``-token prompt be admitted through the chunk
        lane (else the monolithic admission)?"""
        if self.requires_monolithic_admission:
            return False
        limit = self.chunk_window_limit
        return limit is None or seq_len <= limit

    def init_cache(self, batch: int) -> list:
        """Zero decode buffers for ``batch`` slots.  Paged: page pools, a
        fresh ``PagePool`` under ``self.pool`` and the zeroed device table
        ``self.table`` (made once per batch size), with the ring table
        ``self.ring_table`` beside it on a model with local layers.  An
        enc-dec engine's is ``encdec.init_cache``'s.  The buffers hold the
        rows of ``self._rows`` (every slot on one device) and, paged, one
        data shard's pages."""
        rows = len(range(batch)[self._rows])
        if not self.paged:
            return self._mod.init_cache(self._cache_cfg, rows,
                                        self.scfg.max_len, self.device)
        from repro_torch.serve.paged import PagePool
        pages = resolve_pages_per_shard(self.cfg, self.scfg, batch,
                                        self.n_page_shards)
        self.pool = PagePool(batch, paged_layout(self.cfg, self.scfg),
                             pages_per_shard=pages,
                             n_shards=self.n_page_shards,
                             prefix_reuse=self.scfg.prefix_reuse)
        self.table = self._zeroed(self.table,
                                  self.pool.table[self._rows].shape)
        if self.chunk_window_limit is not None:
            self.ring_table = self._zeroed(self.ring_table,
                                           self.pool.ring[self._rows].shape)
        return transformer.init_paged_cache(
            self._cache_cfg, rows, self.scfg.max_len, pages,
            self.scfg.page_size, self.device)

    def _zeroed(self, table, shape) -> torch.Tensor:
        """A zero int32 device table of ``shape``: ``table`` zeroed in place
        when it has that shape (one address per engine: its graphs stay
        valid), else a new one."""
        if table is None or tuple(table.shape) != tuple(shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)
        return table.zero_()

    # -- fault injection + invariant guards (serve.faults) -------------------

    def set_fault_plan(self, plan) -> None:
        """Install a ``FaultPlan`` applied at every dispatch (None clears)."""
        self.faults = plan

    def _fault_site(self, site: str, cache, pos):
        """Apply due injected faults, then (paged) audit the page pool, so
        a corrupted table is caught on the host BEFORE it is copied to the
        device, where a gather or scatter would silently use it.  Runs
        before the round touches the device."""
        if self.faults is not None:
            cache = self.faults.apply(site, self, cache, pos)
        if self.paged and self.pool is not None:
            errs = self.pool.validate()
            if errs:
                raise CacheCorruption(
                    "page pool audit failed: " + "; ".join(errs[:3]))
        return cache

    def poison_row(self, slot: int) -> Optional[int]:
        """The dense cache row of ``slot`` that a NaN fault poisons on this
        device (None: none here)."""
        return slot

    def poison_page(self, shard: int, pid: int) -> Optional[int]:
        """The device page of shard-local page ``pid`` of page shard
        ``shard`` that a NaN fault poisons here (the pools lay shards out
        page-major; None: none here)."""
        return shard * self.pool.pages_per_shard + pid

    def _device_tables(self) -> tuple:
        """The pool's full and ring tables copied into the fixed device
        tables (through pinned memory on the card, asynchronously: the host
        allocator keeps the pinned block until the copy has run), as the
        ``(full, ring)`` pair the model takes (ring None without local
        layers)."""
        for dev, host in ((self.table, self.pool.table),
                          (self.ring_table, self.pool.ring)):
            if dev is not None:
                t = torch.from_numpy(host[self._rows])
                if self.device.type == "cuda":
                    dev.copy_(t.pin_memory(), non_blocking=True)
                else:
                    dev.copy_(t)
        return self.table, self.ring_table

    def _kv_leaf_bytes(self, batch: int) -> int:
        """Bytes of every layer's KV leaves (K and V, the shared block's
        K and V, and an int8 cache's scales): the pools when paged, else the
        dense buffers (a local layer's ring included).  Recurrent state is
        ``transformer.state_bytes``, as the reference counts KV bytes."""
        cfg, sc = self.cfg, self.scfg
        if self.is_encdec:             # self and cross K/V (never paged)
            return encdec.cache_bytes(cfg, batch, sc.max_len)
        if not self.paged:
            return transformer.dense_cache_bytes(cfg, batch, sc.max_len)
        rows = resolve_pages_per_shard(cfg, sc, batch, 1) * sc.page_size
        return rows * transformer.kv_bytes_per_position(cfg)

    def page_bytes(self, batch: int = 1) -> int:
        """Bytes ONE page occupies summed over every layer's KV leaves."""
        if not self.paged:
            raise ValueError("page_bytes is a paged-engine figure")
        return self._kv_leaf_bytes(batch) // resolve_pages_per_shard(
            self.cfg, self.scfg, batch, 1)

    def kv_cache_bytes(self, batch: int) -> int:
        """KV memory: a dense engine reports its ``max_len`` capacity, a
        paged one the peak of its in-use pages times the page bytes (the
        pool is larger, but the allocated figure is what scales with the
        traffic)."""
        if self.paged and self.pool is not None:
            return self.pool.peak_pages * self.page_bytes(batch)
        return self._kv_leaf_bytes(batch)

    def checkpoint_cache(self, cache: list, like: bool = False) -> list:
        """The cache as ``Scheduler.save`` writes it: the engine's own leaves
        (``ShardedEngine`` gathers the whole mesh's into this layout)."""
        return cache

    def cache_part(self, cache: list) -> list:
        """This engine's part of a checkpoint's cache: all of it here."""
        return cache

    def _decode(self, tok, cache, pos, lane: str = "decode", tables=None):
        self.decode_steps += 1
        self.lane_steps[lane] += 1
        params = self.draft_params if lane == "draft" else self.params
        return self._mod.decode_step(params, self.cfg, tok, cache, pos,
                                     tables)

    def _verify(self, toks, cache, pos, tables=None):
        self.lane_steps["verify"] += 1
        return transformer.verify_step(self.params, self.cfg, toks, cache,
                                       pos, tables)

    def step(self, cache, lane: Optional[ChunkLane], tok, pos, done, eos,
             chunk: int, spec: bool = False, *, temperature=None,
             top_k=None, top_p=None, step0=0, greedy: bool = True,
             _eager: bool = False):
        """ONE unified serving round: the chunk lane (when ``lane`` is not
        None) then ``chunk`` (>= 1) decode iterations over every slot, or
        with ``spec`` (needs ``scfg.spec_decode``) one speculative round:
        ``draft_k`` drafter steps, one verify over ``[tok, d_1 .. d_K]``,
        the longest prefix where the target reproduces the drafts accepted
        (up to ``draft_k + 1`` tokens per slot, cut after an EOS).

        ``lane``: the round's ``n_real`` prompt-token entries as device
        vectors — ``slot`` (target row), ``tok``/``pos`` (prompt token and
        its position), ``first`` (the prompt's last token: sample the first
        output) and ``budget_one`` (with ``first``: that token is the whole
        budget).  Non-target rows re-run their held (token, position);
        finished and free slots (done=True) hold token and position
        throughout.

        ``greedy`` (every slot at temperature 0 with no filter; the caller
        knows it from its host mirrors) runs the argmax-only round.
        Otherwise ``temperature``, ``top_k`` and ``top_p`` are the per-slot
        [B] device vectors and ``step0`` (an int or a device int32 scalar)
        the round's first draw index; draw ``n`` of the round uses
        ``fold_in(self.key, step0 + n)`` (the module docstring numbers
        them), so a round advances the stream by ``C + chunk``, or ``C +
        2 * draft_k + 1`` under ``spec``.

        Precondition of ``spec``: every occupied slot holds a position
        ``<= max_len - (draft_k + 1)`` (the scheduler's headroom guard).
        Rows done at round entry (parked mid-prefill, free) hold token and
        position; the drafter's write at their held slot is rewritten with
        the target's bits by the verify.

        Returns (cache, tok, pos, done, packed): the new state and the
        per-slot results in one int32 tensor (:func:`unpack_round` gives
        tok0, done0, tokens [B, W], dones [B, W], ok, n_valid with W =
        chunk, or draft_k + 1 under ``spec``) — tok0/done0 are the first
        tokens and immediately-finished flags of rows whose ``first`` entry
        fired; ok is the per-slot finite-logits guard; only the first
        ``n_valid[b]`` columns of row b are real (all W on a plain round).
        On the card with the kernel backend the round is a replayed CUDA
        graph and tok, pos, done and packed are its static buffers, valid
        until the next round; ``_eager`` forces the op-by-op round.  A
        paged engine's ``cache`` is the page pools of its ``init_cache``,
        addressed through ``self.pool``'s table as it stands at the call.
        """
        if self.is_encdec:
            raise NotImplementedError(_ENCDEC_ROUNDS)
        if spec and not self.scfg.spec_decode:
            raise ValueError(
                "spec=True requires ServeConfig(spec_decode=True)")
        samp = None
        if not greedy:
            if temperature is None or top_k is None or top_p is None:
                raise ValueError("a sampled round (greedy=False) needs the "
                                 "temperature, top_k and top_p vectors")
            if not isinstance(step0, torch.Tensor):
                step0 = torch.full((), step0, dtype=torch.int32,
                                   device=tok.device)
            samp = Sampling(temperature, top_k, top_p, step0)
        if lane is not None:
            cache = self._fault_site("admit", cache, pos)
        cache = self._fault_site("decode", cache, pos)
        tables = self._device_tables() if self.paged else None
        if not _eager and graphs.applies(self.device):
            tok, pos, done, packed = self.graphs.run(
                self, cache, lane, tok, pos, done, eos, chunk, spec, samp,
                tables)
        else:
            tok, pos, done, packed = self._round(
                cache, lane, tok, pos, done, eos, chunk, spec, samp, tables)
        return cache, tok, pos, done, packed

    @staticmethod
    def _sample(logits, samp: Optional[Sampling], keys, n: int):
        """Draw ``n`` of the round (the argmax on a greedy round)."""
        if samp is None:
            return sample_logits(logits)
        return sample_logits(logits, keys[n], samp.temperature, samp.top_k,
                             samp.top_p)

    def _round(self, cache, lane, tok, pos, done, eos, chunk: int,
               spec: bool, samp: Optional[Sampling] = None, tables=None):
        """The round op by op, as the reference's ``_make_step_impl``
        (``fill`` for each entry, then the decode or speculative lane):
        (tok, pos, done, packed), the cache written in place (through
        ``tables`` when paged)."""
        C = 0 if lane is None else self.prefill_chunk
        keys = None
        if samp is not None:
            # the keys of the round's draws, [n, 2], in one vectorized
            # fold-in, after the data shard's own fold-in (the identity on
            # one device)
            n = C + (2 * self.scfg.draft_k + 1 if spec else chunk)
            keys = prng.fold_in(tp_lib.fold_in_data(self.key),
                                samp.step0 + torch.arange(
                                    n, dtype=torch.int32,
                                    device=samp.step0.device))
        ok = torch.ones_like(done)
        tok0, done0 = tok, done
        if lane is not None:
            # the lane targets GLOBAL slot ids: a data shard owns a
            # contiguous block of slots
            rows = torch.arange(tok.shape[0], dtype=torch.int32,
                                device=tok.device)
            data = tp_lib.data_axis()
            if data is not None:
                rows = rows + data.index * tok.shape[0]
            for i in range(lane.slot.shape[0]):
                target = rows == lane.slot[i]
                tok_in = torch.where(target, lane.tok[i], tok)
                pos_in = torch.where(target, lane.pos[i], pos)
                logits, cache = self._decode(tok_in, cache, pos_in, "chunk",
                                             tables)
                # fire: the row becomes a decoder at (sampled, p + 1);
                # otherwise the target parks on this entry's (t, p)
                fire = target & lane.first[i]
                ok = ok & (torch.isfinite(logits).all(-1) | ~fire)
                nxt = self._sample(logits, samp, keys, i)
                nd = ((nxt == eos) & (eos >= 0)) | lane.budget_one[i]
                tok = torch.where(fire, nxt, tok_in)
                pos = torch.where(fire, lane.pos[i] + 1, pos_in)
                done = torch.where(fire, nd, done)
                tok0 = torch.where(fire, nxt, tok0)
                done0 = torch.where(fire, nd, done0)
        if spec:
            cache, tok, pos, done, toks, dones, ok, n_valid = \
                self._spec_lane(cache, tok, pos, done, eos, ok, samp,
                                keys, C, tables)
        else:
            toks, dones = [], []
            for j in range(chunk):
                logits, cache = self._decode(tok, cache, pos, tables=tables)
                # rows done before this step never sample these logits
                ok = ok & (torch.isfinite(logits).all(-1) | done)
                nxt = self._sample(logits, samp, keys, C + j)
                nxt = torch.where(done, tok, nxt)
                pos = torch.where(done, pos, pos + 1)
                done = done | ((nxt == eos) & (eos >= 0))
                tok = nxt
                toks.append(nxt)
                dones.append(done)
            toks, dones = torch.stack(toks, 1), torch.stack(dones, 1)
            n_valid = torch.full_like(tok, chunk)
        # the cache sweep, once a round: a non-finite value anywhere fails
        # every slot (recovery replays the whole batch from the snapshot).
        # Under tensor parallelism each rank holds a head slice, so the
        # verdict is min-reduced over the model axis: a miss on the clean
        # ranks must not mask the poisoned one
        cache_ok = _cache_finite(cache)
        axis = tp_lib.model_axis()
        if axis is not None:
            cache_ok = tp_lib.all_reduce_min(torch.as_tensor(
                cache_ok, device=ok.device).to(torch.int32).reshape(1),
                axis)[0] != 0
        ok = ok & cache_ok
        return tok, pos, done, pack_round(tok0, done0, toks, dones, ok,
                                          n_valid)

    def _spec_lane(self, cache, tok, pos, done, eos, ok, samp, keys,
                   C: int, tables=None):
        """Draft ``draft_k`` / verify once / accept the longest prefix.
        Draft ``j`` is draw ``C + j``, verify column ``i`` draw ``C + K +
        i``: at temperature > 0 the drafter and the target draw different
        noise, and the tokens are still matched as they are."""
        K = self.scfg.draft_k
        S = K + 1
        dtok, dpos, drafts = tok, pos, []
        for j in range(K):
            logits, cache = self._decode(dtok, cache, dpos, "draft", tables)
            nxt = torch.where(done, dtok,
                              self._sample(logits, samp, keys, C + j))
            dpos = torch.where(done, dpos, dpos + 1)
            dtok = nxt
            drafts.append(nxt)
        drafts = torch.stack(drafts, 1)                            # [B, K]
        logits, cache = self._verify(torch.cat([tok[:, None], drafts], 1),
                                     cache, pos, tables)
        ok = ok & (torch.isfinite(logits).all(-1).all(-1) | done)
        if samp is None:
            v = sample_logits(logits)                              # [B, S]
        else:
            # each column its own [B, V] draw with its own key
            v = torch.stack([self._sample(logits[:, i], samp, keys,
                                          C + K + i) for i in range(S)], 1)
        # accept the longest prefix where the target reproduces the draft;
        # the target's token after it (correction or bonus) comes free
        match = (v[:, :K] == drafts).to(torch.int32)
        m = torch.cumprod(match, dim=1).sum(dim=1)                 # 0..K
        cols = torch.arange(S, device=v.device)[None]
        is_eos = (eos[:, None] >= 0) & (v == eos[:, None])
        eos_in = is_eos & (cols <= m[:, None])
        any_eos = eos_in.any(dim=1)
        first_eos = torch.argmax(eos_in.to(torch.int32), dim=1)
        n_valid = torch.where(any_eos, first_eos + 1, m + 1)
        n_valid = torch.where(done, 0, n_valid).to(torch.int32)
        newtok = torch.gather(
            v, 1, torch.clamp_min(n_valid - 1, 0)[:, None].long())[:, 0]
        tok = torch.where(done, tok, newtok)
        pos = pos + n_valid
        done = done | (any_eos & (n_valid > 0))
        dones = is_eos & (cols < n_valid[:, None])
        return cache, tok, pos, done, v, dones, ok, n_valid

    # -- monolithic admission ------------------------------------------------

    def _stitch(self, cache: list, pcache: list, lengths: torch.Tensor,
                mask: torch.Tensor, paged=None) -> list:
        """Write freshly prefilled rows into the masked slots of the live
        cache IN PLACE (the decode graphs hold its addresses), as the
        reference's ``_stitch_impl``: row b of ``pcache`` fills slot b
        where ``mask[b]``; an int8 cache takes the K/V quantized here,
        codes and scales; a local layer takes its full-length K/V arranged
        into the ring from the true length (:func:`_ring_from_full`); the
        shared block's K/V are written as a global layer's; recurrent state
        is a dense masked row write, paged or not (an RWKV6 prefill without
        the channel mix leaves ``xc`` zero).  ``paged`` = (device table,
        ring table, start_tok [B]): tokens [start_tok, length) of masked
        rows scatter into their pages (tokens below start_tok live in
        prefix-shared pages an earlier admission filled); a local layer's
        ring scatters whole through the ring table (ring pages are never
        shared)."""
        cfg = self.cfg
        valid = None                  # paged: the tokens to write
        if paged is not None:
            table, ring, start = paged
            if ring is not None:
                Tr = ring.shape[1] * self.scfg.page_size
                ring_valid = mask[:, None] & (_ring_positions(lengths, Tr)
                                              >= 0)
        for i, (live, part) in enumerate(zip(cache, pcache)):
            local = transformer.is_local(cfg, transformer.layer_spec(cfg, i))
            for key in transformer.STATE_KEYS:
                if key in live:
                    piece = part.get(key)
                    if piece is None:
                        piece = torch.zeros_like(live[key])
                    _write_rows(live[key], piece, mask)
            for key in ("k", "v") + transformer.SHARED_KEYS:
                if key not in part:
                    continue
                piece = part[key]
                ring_leaf = local and key in ("k", "v")
                if ring_leaf:
                    T = Tr if paged is not None else live[key].shape[1]
                    piece = _ring_from_full(piece, lengths, T)
                leaves = {key: piece}
                if "k_scale" in live and key in ("k", "v"):
                    leaves[key], leaves[key + "_scale"] = \
                        attn_lib.quantize_kv(piece)
                for name, val in leaves.items():
                    if paged is None:
                        _write_rows(live[name], val, mask)
                    elif ring_leaf:
                        _scatter_pages(live[name], ring, val, ring_valid)
                    else:
                        if valid is None:
                            t = torch.arange(val.shape[1],
                                             device=lengths.device)[None]
                            valid = (mask[:, None] & (t >= start[:, None])
                                     & (t < lengths[:, None]))
                        _scatter_pages(live[name], table, val, valid)
        return cache

    def admit_monolithic(self, cache, prompts, lengths, mask, budget_one,
                         eos, tok, pos, done, *, temperature=None,
                         top_k=None, top_p=None, step0: int = 0,
                         greedy: bool = True):
        """The reference's fallback admission (``admit_monolithic`` /
        ``_admit_impl``): one batched prefill of the admitted prompts, the
        stitch of their K/V into the masked slots, first-token sampling
        and the slot-state merge.

        ``prompts`` [slots, P] int (host; dummy rows for slots that stay
        empty), ``lengths`` / ``mask`` / ``budget_one`` per-slot host
        vectors (``budget_one``: the first token is the request's whole
        budget).  ``eos``, ``tok``, ``pos``, ``done`` and, on a sampled
        admission (``greedy`` False), ``temperature``, ``top_k`` and
        ``top_p`` are the per-slot device vectors; the first tokens are
        draw ``fold_in(self.key, step0)``.  A paged engine reads its
        pool's table and ``start`` as the Scheduler's block accounting
        left them.  Runs eagerly, on any backend.

        Returns (cache, tok, pos, done, packed): the new slot state —
        admitted rows decode from (tok0, length), rows finished at once
        take the free sentinel — and one int32 [slots, 3] tensor of
        (tok0, done0, ok0) for the caller's one host read (ok0: finite
        logits on the admitted rows)."""
        if self.is_encdec:
            raise NotImplementedError(_ENCDEC_ROUNDS)
        if not greedy and (temperature is None or top_k is None
                           or top_p is None):
            raise ValueError("a sampled admission (greedy=False) needs the "
                             "temperature, top_k and top_p vectors")
        cache = self._fault_site("admit", cache, pos)
        prompts = np.asarray(prompts, dtype=np.int32)
        R, P = prompts.shape
        start = (self.pool.start[self._rows] if self.paged
                 else np.zeros(R, np.int32))
        host = torch.from_numpy(np.concatenate(
            [prompts, np.stack([np.asarray(lengths), np.asarray(mask),
                                np.asarray(budget_one), start],
                               1).astype(np.int32)], 1))
        if self.device.type == "cuda":
            dev = host.pin_memory().to(self.device, non_blocking=True)
        else:
            dev = host
        lengths, mask = dev[:, P], dev[:, P + 1] != 0
        budget_one, start = dev[:, P + 2] != 0, dev[:, P + 3]
        paged = (*self._device_tables(), start) if self.paged else None
        self.prefill_steps += 1
        logits, pcache = transformer.prefill(self.params, self.cfg,
                                             dev[:, :P], length=lengths)
        self._stitch(cache, pcache, lengths, mask, paged)
        if greedy:
            tok0 = sample_logits(logits)
        else:
            tok0 = sample_logits(
                logits, prng.fold_in(tp_lib.fold_in_data(self.key),
                                     int(step0)),
                temperature, top_k, top_p)
        # finite-logits guard on the sampled rows (free rows report healthy)
        ok0 = torch.isfinite(logits).all(-1) | ~mask
        done0 = ((eos >= 0) & (tok0 == eos)) | budget_one
        active = mask & ~done0
        tok = torch.where(mask, tok0, tok)
        pos = torch.where(mask, torch.where(active, lengths, -1), pos)
        done = torch.where(mask, ~active, done)
        packed = torch.stack([tok0, done0.to(torch.int32),
                              ok0.to(torch.int32)], 1)
        return cache, tok, pos, done, packed

    # -- static-batch oracle -------------------------------------------------

    def _grow_cache(self, cache: list, S: int) -> list:
        """Prefill caches (length S) as decode buffers, as the reference's
        prefill + ``_grow_cache``: K/V zero-padded to ``max_len`` (the
        shared block's too), or on a local layer to its ring, which a
        prompt longer than the window fills rolled
        (``transformer._roll_local``); recurrent state has no sequence axis
        and is taken as it is.  Enc-dec: the self-attention K/V grow to
        ``max_len``, the cross K/V keep the encoder's length."""
        cfg, M = self.cfg, self.scfg.max_len
        out = []
        if self.is_encdec:
            for c in cache:
                g = dict(c)
                for key in ("k", "v"):
                    t = c[key]
                    g[key] = torch.zeros((t.shape[0], M) + tuple(t.shape[2:]),
                                         dtype=t.dtype, device=t.device)
                    g[key][:, :t.shape[1]] = t
                out.append(g)
            return out
        for i, c in enumerate(cache):
            spec = transformer.layer_spec(cfg, i)
            g = {}
            for key, t in c.items():
                if key in transformer.STATE_KEYS:
                    g[key] = t
                    continue
                shared = key in transformer.SHARED_KEYS
                if not shared and transformer.is_local(cfg, spec) \
                        and S > cfg.window:
                    g[key] = transformer._roll_local(t, S, cfg.window)
                    continue
                T = M if shared else transformer.cache_len(cfg, spec, M)
                buf = torch.zeros((t.shape[0], T) + tuple(t.shape[2:]),
                                  dtype=t.dtype, device=t.device)
                buf[:, :t.shape[1]] = t
                g[key] = buf
            out.append(g)
        return out

    def generate(self, prompts: torch.Tensor, max_new_tokens: int,
                 frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """prompts [B, S] int -> [B, S + max_new_tokens]: the static-batch
        oracle (prefill, then a per-token loop, token ``i`` drawn with
        ``fold_in(self.key, i)`` under the ServeConfig's sampling), as the
        reference's ``generate(use_scan=False)``; over a dense cache on a
        paged engine too.  An enc-dec engine prefills through
        ``encdec.prefill(params, cfg, frames, prompts)``: ``frames`` [B,
        enc_seq, d_model], the stub frontend's frame embeddings."""
        sc = self.scfg
        greedy = sc.temperature <= 0.0

        def draw(logits, i):
            key = None if greedy else prng.fold_in(self.key, i)
            return sample_logits(logits, key, sc.temperature, sc.top_k,
                                 sc.top_p)

        prompts = torch.as_tensor(prompts, device=self.device)
        B, S = prompts.shape
        if self.is_encdec:
            if frames is None:
                raise ValueError("an enc-dec engine's generate needs the "
                                 "frames [B, enc_seq, d_model]")
            logits, cache = encdec.prefill(
                self.params, self.cfg,
                torch.as_tensor(frames, device=self.device), prompts)
        else:
            logits, cache = transformer.prefill(self.params, self.cfg,
                                                prompts)
        cache = self._grow_cache(cache, S)
        tok = draw(logits, 0)
        pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        toks = [tok]
        for i in range(1, max_new_tokens):
            logits, cache = self._decode(tok, cache, pos)
            tok = draw(logits, i)
            toks.append(tok)
            pos = pos + 1
        return torch.cat([prompts, torch.stack(toks, 1).to(prompts.dtype)],
                         1)
