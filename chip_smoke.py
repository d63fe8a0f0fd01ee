#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero):

1. device + build: the ``nvidia-smi`` name/power-limit line and the SM
   clock's maximum, then the five
   CUDA sources compiled for sm_90a (one ``nvcc`` each, in parallel), and
   the int8 tensor-core instructions (``IMMA``) counted in the SASS of
   every ``lutmul.cu``, ``int_matmul.cu`` and ``lutmul_tmac.cu`` kernel.
2. kernels: the entry points at the shapes the served models give them
   (M = 8 decode slots; M = 32 for the speculative verify forward), held
   against their plain versions on the card — int32 outputs exactly, fused
   bf16 outputs bitwise — and timed with CUDA events (median; L2 flushed
   before each launch, as a decode step finds the weights cold), beside one
   library call on the same codes where one computes the same sums exactly
   (``torch._int_mm`` where M > 16; else the float32 cuBLAS GEMM with TF32
   off where float32 is exact; else ``torch._int_mm`` on the rows
   zero-padded to 32).  Shape groups: qwen2-7b's 7 inner projections through
   the LUT kernel, the gather baseline and the T-MAC kernel (target P = 4,
   drafter P = 2, verify M = 32; the layer under the mixed plans of 3.2
   and 2.0 bits, a plane count a projection; wi at P = 3 and wg at P = 1,
   the binary kind, alone), gemma2-2b's and minicpm-2b's through the
   LUT kernel, bitnet-3b's through the T-MAC kernel (ternary, g = 1), the
   int8 heads of qwen2-7b, bitnet-3b, rwkv6-1.6b and zamba2-2.7b,
   qwen2-moe-a2.7b's experts through the LUT kernel: one expert of each
   bank shape at M = 1 (decode's capacity at 8 slots) and M = 42 (an
   admission of 8 rows of 64), and the shared expert's three projections
   at M = 8; zamba2-2.7b's mamba layer (in_proj's 10,448 columns end in a
   ragged tile) and shared block, and rwkv6-1.6b's layer through the LUT
   kernel; whisper-large-v3's decoder layer at M = 8 (8 projections), its
   encoder layer and cross K/V at an encoder prefill's M = 12,000,
   qwen2-vl-72b's layer (M = 8), phi3-medium-14b's layer (M = 8) and
   mixtral-8x22b's attention (M = 8) through the LUT kernel; mixtral's
   expert banks (8 experts each) at decode's M = 3 through
   ``lutmul_experts``; the 152,064-, 100,352- and 32,768-column int8
   heads of qwen2-vl-72b, phi3-medium-14b and mixtral-8x22b; one 2x2
   rank's shapes (column leaves at N / 2, row leaves at K / 2): the LUT
   layer and the head at a data shard's M = 4, the T-MAC layer at M = 4
   (target P = 4, drafter P = 2) and at its verify block's M = 16 (P = 4),
   and the head at M = 16.
3. serving qwen2-7b (28 layers, full width, random weights from a seeded
   generator, built a layer at a time) through ``make_engine`` +
   ``Scheduler(slots=8, chunk=8)``: w4a4_lut fused (8 requests) and a
   profile.  Every other qwen2-7b run is on the ``CUT_LAYERS`` model
   below: the sampled mix (``SAMPLED_MIX``: per-request temperature /
   top-k / top-p, greedy rows among them, ``ServeConfig(seed=
   SAMPLE_SEED)``), lut fused over the 8 prompts (its greedy rows equal
   the all-greedy run, a sampled row leaves it), then over the first 4:
   lut fused and tmac fused, equal; the SAME float weights quantized to
   w4a4_tmac: fused (8, transcripts equal to the LUT run's: w4 bitplanes
   decode to the nibble codes) and unfused (4); bitplane self-speculative
   decoding (8, equal to the fused tmac run's) and speculation after
   zeroing the low two planes in place (4; every draft accepted); the lut
   unfused runs (4, greedy and sampled), the plain lut runs (1, greedy
   and sampled), the plain tmac run (1), the int8 KV stage and
   speculative sampling over one request (graph == plain backend, its
   accept rate printed).  A sampled transcript
   depends on the batch's global draw counter, so only runs over the same
   requests are compared.  On the kernel backend every
   round is a replayed CUDA graph, one captured per round key
   (``serve/graphs.py``); the plain backend runs op by op.  Each run's
   launch counters must be exactly 7 per layer per forward for the inner
   kernel and 1 head launch per forward, by lane, a replay counting the
   launches its capture recorded, and every key replayed must have
   captured exactly that for its own forwards.  Short profiles give the
   device-busy share of eager decode steps, a drafter step and a verify
   forward, and of a replayed round of each engine (8 decode iterations,
   or a speculative round); the eager LUT decode step's profile also lists
   every device row (the activation quantizer's kernels among them).  The
   sampling ops: a replayed sampled decode round against the greedy round
   from the same state (their device time's difference), and one
   ``sample_logits`` draw at [8, vocab] alone, every device row listed.
   Then the paged KV cache (``ServeConfig(paged=True, page_size=4)``,
   engines built from the quantized codes, no second copy of the
   weights): lut fused over the 8 prompts (== the dense lut run) at 7
   layers (see below) with the rest of the paged stage:
   the sampled mix over the first 4 (== the dense sampled 4, no prefix
   hit), the plain backend over the first one (no graph), a shared 32-token
   prefix before each of the 8 prompts (== a dense run over the same
   requests; prefix hits, and fewer peak pages than a run without
   reuse), a contended pool of max(half the uncontended peak, the
   longest request's pages) + 1 pages (preemptions, == the dense lut
   run), and after the speculative runs tmac speculative over the first
   4 (== the tmac run, pages trimmed).  Every paged run drains with no
   page allocated or leaked and reports peak pages, resident KV bytes
   against the dense capacity, hit rate and preemptions (``paged runs:``);
   ``paged round[qwen lut]:`` gives a replayed paged decode round's
   device ms against the dense round's from one state.  Then the int8 KV
   cache (``kv_quant="int8"``, max_len 256) on the same lut codes, every
   request admitted by the monolithic admission (one eager prefill + stitch
   dispatch per leading run of equal-length requests) and every decode
   round a replayed graph: lut fused over the 8 prompts, paged (== dense),
   8 prompts of 32 tokens (numpy seed 2) that one admission dispatch puts
   into all 8 slots, dense and paged (equal), the plain backend over the
   first one (== fused), and after the tmac run tmac fused over the first 4
   (== lut).  ``int8 runs:`` gives the KV and page bytes against bf16's,
   peak pages, ms per decode step against the bf16 lut run's, the
   admissions (dispatches, median host ms) and the share of int8 greedy
   tokens equal to the bf16 run's; ``int8 round[qwen lut]:`` a replayed
   int8 decode round's device ms against the bf16 round's from one state.
   The sampled, tmac, paged, int8 KV, speculative, faults and QoS stages
   run on a qwen2-7b of full width and ``CUT_LAYERS`` (4) layers, seed-0
   weights of its own, after the 28-layer lut run, with that depth's lut
   fused (8), the sampled mix (4) and int8 KV (8) as the transcripts they
   equal; before them, at that depth, lut unfused (4, greedy and
   sampled), plain (1, greedy and sampled), and on w4a4_tmac codes of the
   same float weights fused (8) == lut, sampled (4) == lut, unfused (4) ==
   plain (1) == fused, int8 KV (4), speculation greedy (8), paged (4),
   sampled graph == plain (1) and with the low planes zeroed (4).
   Then faults and recovery (``FAULT_CASES``) on fresh engines over the
   same lut codes, each through ``Scheduler(slots=8, chunk=8,
   snapshot_interval=1, max_retries=3)`` over the first 4 requests, first
   fault-free, then under a ``FaultPlan``: dense greedy (a NaN poisoning,
   an admission dispatch failure, a page-table fault the dense engine
   skips, a stall), paged (a page-table corruption the pool audit catches,
   a NaN poisoning), int8 KV dense (an admission dispatch failure, a NaN
   in ``k_scale``) and the sampled mix (a NaN poisoning; the draw counter
   restored).  Each run equals its configuration's fault-free transcripts
   (lut, lut, int8 lut, sampled lut over 4), recovers, consumes every
   fault, and captures as many graph keys as its fault-free twin (restore
   copies in place); ``faults[...]`` lines give recoveries, dispatch
   retries, the rounds a restore threw away, snapshots and the median host
   ms of a snapshot and a restore (synchronized), tokens/s and, paged, the
   pool audit's host ms a dispatch; ``cache sweep[qwen lut]:`` the device
   ms of the in-round cache-finiteness sweep alone (captured in a graph of
   its own, and eager) on the dense bf16, paged and int8 caches beside a
   replayed round of each.  Then the Scheduler's logical clock and QoS
   policies (``run_qos``): ``benchmarks/serving_bench.py``'s overload trace
   scaled to 8 slots (96 requests of 16 tokens, ten arrivals a tick,
   priorities and deadlines) on a paged engine of 15 pages through
   ``Scheduler(shed_watermark=0.6, overload_queue=12)``, one logical tick
   a step: twice (equal outcomes and counts, shed, timed-out and
   preemption counts > 0, each run capturing its own keys) and under two
   NaN faults with a snapshot every round (>= 2 recoveries); every
   request with tokens against an uncontended dense run (served: equal;
   timed out or shed: a prefix); ``qos[...]`` lines give served, shed,
   timed out, preemptions, p50/p99 latency in ticks, mean occupancy and
   tokens/s.  Then save/load (``SAVE_LOAD_CASES``): dense bf16 greedy (8),
   the sampled mix (4) and paged int8 (8), each saved after 3 rounds and
   loaded in place into a Scheduler whose graphs a warm run captured (==
   lut, lut sampled, int8 lut; no key captured after the load);
   ``checkpoint[...]`` lines give bytes on disk and raw, the codec, the
   save and load host ms and whether msgpack and zstandard import.
   Then the mixed phase (``run_mixed``): the paper's analytic model printed
   once (``paper model``: the Fig. 5 INIT words for (+1, -3) asserted
   equal to the paper's, Eq. 3's LUTs a 4-bit multiply, the U280's DSP and
   LUTMUL peaks, ``balance_folding`` of MobileNetV2 at the paper's 529,242
   LUTs: analytic U280 figures, not measurements of the card); qwen2-7b's
   plans at 4.0, 3.2 and 2.0 bits from its full-width shapes alone
   (``init_params`` on the meta device), each asserted (``MIXED_MLP``;
   attention w4); then at ``MIXED_LAYERS`` (8) of its 28 layers, each
   tree built a layer at a time
   under its plan: uniform w4a4_tmac (the 4.0 plan) fused over the 8
   requests, and at 3.2 and 2.0 bits fused (8) == the plain backend (the
   first request, ``PLAIN_TOKENS``), every served leaf's
   plane count equal to the plan and the tree's code bytes equal to the
   count from the shapes, each engine's replayed round profiled (``mixed
   runs[...]`` puts them side by side); the all-w4 plan on layers
   otherwise quantized to nibbles at ``CUT_LAYERS`` over 4 requests == the
   w4a4_tmac run there; last, with autotuning on, ``pick_formulation``
   times the T-MAC against the one-hot LUT kernel at M = 256 at qwen2-7b's
   four inner shapes at w2, w3 and w4 (``formulation picker[...]``), and a
   suffix-free ``w2a4`` model at ``CUT_LAYERS``, under the timed choice
   and with the other formulation forced at every shape (so the LUT
   kernel runs on w2 codes as nibbles), each over 4 requests == the
   ``w2a4_tmac`` run.
4. serving bitnet-3b (13 of its 26 layers, full width) in ternary_a8_tmac:
   fused (8 requests) and plain (first 1), equal transcripts.  Then gemma2-2b
   (6 of its 26 layers, full width: local and global layers, window
   4,096, soft-caps, GeGLU, the tied 256,000-row head) in w4a4_lut at
   max_len 4,352: 8
   requests (``gemma_requests``) in the order long pair, short pair, long
   pair, short pair, the long prompts past the window (monolithic admission,
   its rings wrapped), the short ones on the chunk lane; a monolithic
   dispatch of two requests must have a chunk admission after it in its
   step.  Fused graphs == ``Engine.generate`` on the long requests and ==
   ``chunked_generate`` (the chunk lane's arithmetic as a static batch) on
   the short ones, both batches padded to 8 rows; ``generate`` on the short
   ones is reported (a prefill reduces at other shapes than decode on CUDA),
   and where the two part ``flip_report`` gives both paths' logits at that
   token and the first activation that differs (at most ``FLIP_ULPS`` bf16
   ulps, then A4 codes flip); a decode step and a replayed round profiled at
   positions past the window; the tied head timed (``tied head[gemma2]``);
   paged (64-token pages, the first long pair), unfused (4) and the plain
   backend (one short request), each equal to the fused run.  Then its int8
   KV cache on the same codes (``run_gemma2_int8``: the global layers
   int8, the local rings bf16, ``kv_cache_bytes`` checked layer by
   layer): fused over the first 4 requests (the first long pair, then the
   first short pair), every admission monolithic; paged over the long pair
   and the plain backend over one short request, each equal to the fused
   rows; ``int8 runs[gemma2]`` gives the bytes, the runs and the share of
   greedy tokens equal to the bf16 run's.  Then minicpm-2b (20 of its 40
   layers, full width, tied 122,753-row head) in w4a4_lut: fused over the
   first 4 contract requests, profiled, its head timed, and the plain
   backend over the first (8 new tokens) equal.  Then phi3-medium-14b (10
   of its 40 layers, full width, GQA 40/10, the untied 100,352-row head;
   its served tree built a layer at a time) in w4a4_lut (``run_phi3``):
   fused over the
   8 requests (7 LUT launches a layer and the head kernel once a forward),
   profiled, and the plain backend over the first (8 new tokens) equal. Then
   qwen2-moe-a2.7b (8 of its 24 layers, full width: 60 routed experts
   top-4 under global dispatch, capacity factor 1.25, the shared expert
   behind its sigmoid gate, qkv bias, the untied 151,936-row head) in w4a4_lut, its
   served tree built a layer at a time (``init_served_params``): every
   admission monolithic (one eager prefill a distinct prompt length, the 7
   dummy rows routed with the live one), every decode round a replayed graph
   whose steps route at the deterministic capacity C = 1.  Fused over the 8
   requests; the same requests again op by op (equal), counting the routes
   the capacity keeps in decode and in the admissions
   (``routes[qwen2moe]``); fused over the first 4 == unfused over the first
   4; fused over the first one == the plain backend over it (8 new tokens);
   one decode step and one replayed round profiled.  Every forward launches
   the LUT kernel 4 + 3 + 3 * 60 = 187 times a layer (attention, the shared
   expert, one launch per expert of each bank) and the head kernel
   once.  Then its int8 KV cache on the same codes (every layer int8): fused
   over the 8, dense == paged over 4 equal prompts whose budgets do not grow
   with the slot (``moe_paged_requests``: a freed slot in front of a live
   one routes other garbage dense and paged, in the reference too), over the
   first one == the plain backend (``int8 runs[qwen2moe]``). Then
   mixtral-8x22b at full width and ``MIXTRAL_LAYERS`` (8) of its 56 layers
   (``run_mixtral``; 1.21 GB of expert nibbles a layer, every layer local
   with window 4,096 > max_len): the same runs as qwen2-moe's (``run_moe``,
   ``routes[mixtral]``), each forward launching the LUT kernel 4 + 3 * 8 =
   28 times a layer (decode's experts at C = 3) and the untied head
   once.  Then the recurrent families at full width and depth in w4a4_lut
   (``run_recurrent``), every admission monolithic at the prompt's exact
   length: rwkv6-1.6b (12 of its 24 layers: RWKV6 time and channel mix,
   layer norms, the untied 65,536-row head; 8 LUT launches a layer) and
   zamba2-2.7b (12 of its 54 Mamba2 layers, the shared attention + SwiGLU
   block before every sixth; 2 LUT launches a mamba layer, 7 a shared block;
   the untied 32,000-row head).  Each: fused over the 8 requests; the first
   replay of a newly captured round against the op-by-op round from one
   admitted state, tokens and every cache leaf bitwise (``first
   replay[...]``: the warm-up must leave the recurrent state as it found
   it); unfused over the first 4 and the plain backend over the first one (8
   new tokens), equal to the fused run; zamba2 also one sampled request
   fused == plain backend, and paged (shared K/V in pages of 4, mamba state
   dense per slot) over the first 4 == dense, and its int8 KV engine over
   the first 4 (no leaf changes: the bytes and transcripts equal bf16's);
   one decode step and one replayed round profiled.  Then whisper-large-v3
   (8 of its 32 encoder and 32 decoder layers, full width, enc_seq 1500) in
   w4a4_lut through ``Engine.generate(frames=)`` (``run_whisper``): 8
   requests of 4-token prompts over one batch of stub frames, 64 new tokens,
   fused; unfused over the first 2 and the plain backend over the first one
   (8 tokens), in batches padded to 8 rows, each equal to the fused
   transcripts; 288 LUT launches a prefill (16 x 6 encoder, 16 x 10 decoder,
   16 x 2 for the second cross K/V pass) and 128 a decode step; the
   prefill's parts timed (encode, decoder, the second cross-K/V pass); 8
   decode steps through a page table == dense, logits and K/V bitwise. Then
   qwen2-vl-72b (8 of its 80 layers, full width; its served codes
   built a layer at a time) in w4a4_lut (``run_qwen2vl``): the Scheduler
   over the 8 requests fused, the plain backend over the first one (4
   tokens) equal; the stub vision frontend (embeddings [2, 272, 8192] at a
   16 x 16 patch grid's M-RoPE positions, then 8 decode steps) fused ==
   plain bitwise; a text prefill under M-RoPE == ``rope_mode="rope"``
   bitwise; a replayed round profiled.  Then multi-GPU serving on the one
   card (``run_sharded``): ``serve.sharded.launch(..., backend="gloo")``
   spawns one process a rank, every rank on ``cuda:0`` and every
   collective staged through pinned host memory (NCCL refuses two ranks
   on one card), each rank building the served tree with
   ``init_served_params(seed=0)`` and keeping its shard
   (``ShardedEngine``): qwen2-7b at ``SHARDED_QWEN_LAYERS`` (2) on a 2x2 mesh
   (head-parallel: 28 and 4 heads split 2 ways, 4 of the 8 slots a data
   shard) and qwen2-moe-a2.7b at ``SHARDED_MOE_LAYERS`` (4) on 1x2
   (expert-parallel, 30 of 60 experts a rank), each over the 8 contract
   requests through ``Scheduler(slots=8, chunk=8)`` with staggered
   admission (two requests, a round, the other six), eager rounds.  Every
   rank's transcripts must equal the single-card engine's at the same seed
   and depth bitwise, all ranks must agree on ``Scheduler.stats``, the
   mesh must be head- (2x2) or expert-sharded (1x2), the KV bytes a rank
   the total over n_data * n_model, and each rank's launches exactly its
   shard's: the fused LUT kernel for the column, head and expert leaves,
   the unfused one for the two row leaves a layer, the fused int8 head
   kernel once a forward; then a 2x2 fault run over the first 2 requests
   (a NaN in one model rank's cache, found by the min-reduced cache sweep)
   recovers with the single card's transcripts.  In the same 2x2 world:
   ``Scheduler.save`` after the second round of a run over the first
   ``SHARDED_SAVE_REQUESTS`` requests (collective; rank 0 writes), a fresh
   Scheduler on the same ranks loads it and serves to the end, with the
   uninterrupted run's and the single card's transcripts and stats;
   at ``CUT_LAYERS``, split-head attention (``split_head_params``, float
   3D leaves split by head, ``wo3`` behind an all-gather) over the first
   ``SHARDED_NEW_REQUESTS``, against a single-card split-head engine, the
   cache holding n_kv / 2 heads and no LUT launch in attention; and
   speculative w4a4_tmac (``draft_k=3``, ``draft_planes=2``, paged) on
   weights whose low planes are zeroed, against the single card's
   NON-speculative engine on the same tree, with ``spec_rounds > 0`` and
   its accept rate.  ``sharded[...]`` lines give tokens/s (of the
   processes sharing one card: not a scaling figure) and each rank's peak
   memory.
5. the paper's CNN: full-width MobileNetV2 (224x224, width 1.0, 1000
   classes, random weights from seed 0) at batch 32 in float and QAT mode
   (cuDNN, TF32 off), the float logits of the first 4 images held against
   the port's CPU forward; then its 34 pointwise convolutions streamlined
   into integer stages (``core.streamline``) on the uint4 codes of their
   float inputs: an integer pass through the LUT kernel and the threshold
   kernel (34 + 34 launches), codes equal to the plain versions and within
   one code of the float reference, and a gather pass through the gather
   baseline (34 launches, the same codes); the threshold, gather and LUT
   kernels timed at every stage's shape; each gather group also records
   its products and its gather floor (one shared-memory table read per
   product at 32 a clock per SM, at the card's maximum SM clock).
6. training: minicpm-2b in QAT at full width and depth (40 layers, remat
   "full", the WSD schedule, the W4 projection after every update) for 6
   steps of 4 x 512 tokens through ``train.step.make_train_step``: finite
   losses and gradient norms, the last loss below the first, peak memory
   under 75 GB, each step's forward+backward and optimizer+projection
   timed by CUDA events; the trained model evaluated as deployed
   (``train.loop.make_eval_fn``, 2 held-out batches) in w4a4_mxu and
   w4a4_lut: every projection through the fused int8 or LUT kernel (7 x 40
   launches a batch), no plain version called, the weight quantizations
   the same for 1 batch as for 2; MobileNetV2's full config in QAT for 4
   steps of 32 images at 224 x 224; then ``train.loop.run`` on it twice
   (8 steps, a checkpoint every 3), uninterrupted and with one injected
   failure at step 5, under deterministic algorithms: one restart and
   the same loss history.  The kernels phase holds the two fused kernels
   at the eval's shapes (minicpm-2b's projections at M = 2,048).
7. long sequences (``run_long``): the fused LUT kernel on qwen2-7b's 7
   projections at the 32k prefill's M = 32,768, every row bitwise against
   its plain version, timed beside ``torch._int_mm``; qwen2-7b w4a4_lut at
   full width and depth, ``Engine.generate`` on one prompt of 32,768
   tokens (the reference's ``prefill_32k`` length) and 8 new tokens: the
   prefill runs ``attention.blocked_attention`` in every layer (counted),
   its host ms, peak bytes and the blocked attention's share are printed,
   the launches are exactly 7 a layer and 1 head a forward, and layer 0's
   blocked output at 64 query rows spread over the prompt (the last among
   them) is held against a float64 softmax over all their keys, each
   element within (2^-8 + 2^-12) x sum_k p_k |v_k| of it (``ATTN_P_REL``,
   ``ATTN_F32_REL``: each probability is rounded to bf16, as the
   reference rounds it); then, on qwen2-7b cut to ``LONG_CHUNK_LAYERS``
   layer(s) (the chunk lane runs a decode step a prompt token), the same
   prompt through ``generate`` and through a ``Scheduler(slots=1)``'s
   chunk-lane admission, which keeps its own layer-0 q and attention
   output at the 64 rows (``LaneProbe``): both paths' outputs within that
   bound of float64, and the tokens equal or the paths parting no earlier
   than layer 0's attention output (its q, K and V equal the prefill's
   bitwise; ``check_long_chunk_lane`` says why ``FLIP_ULPS`` cannot hold
   there); gemma2-2b at ``SERVED_LAYERS`` depth serving the gemma2
   phase's long pairs (4,104 and 4,152 tokens, past the 4,096 window,
   soft-cap 50) through the Scheduler's monolithic admission, blocked,
   against the same codes with kv_block raised past S (the full attention
   of earlier slices): layer 0's attention outputs of both within that
   bound of float64 at every row, and the transcripts equal or layer 0's
   attention inputs equal, the admission's host ms and peak printed;
   minicpm-2b QAT at full width and depth, one step of 1 x 4,096 tokens
   (the reference's ``train_4k`` length, blocked forward and backward
   under remat): its ms and peak, its loss and gradient norm against the
   same batch with kv_block raised past S, and layer 0's attention output
   of both forwards within that bound of float64 at every row.
8. FSDP training (``run_fsdp``): ``train.fsdp`` on a 4x1 mesh, four
   ranks on ``cuda:0`` over gloo, minicpm-2b at full width and 4 layers,
   2 steps of 4 x 512 tokens, each rank holding its share of the leaves
   ``dist.partitioning`` shards over "data" and of their AdamW moments:
   after every step each rank's shares (digests of their bits), loss and
   gradient norm equal the single-card ``make_train_step`` with
   ``n_microbatches=4``, both under deterministic algorithms; each rank's
   ms a step, ms in collectives and resident bytes against the
   unsharded state's are printed.
9. the script's total time, the ``kernels`` JSON line, the ``nvidia-smi``
   line, and last the ``{"ok": true, ...}`` line.

Where ``SERVED_LAYERS`` names a model, the script serves it at that
depth (full width): mixtral-8x22b because one card holds only part of
its codes, the earlier slices' bitnet-3b, minicpm-2b, rwkv6-1.6b,
zamba2-2.7b, whisper-large-v3, qwen2-vl-72b, gemma2-2b, phi3-medium-14b
and qwen2-moe-a2.7b to keep the run inside half its time limit.  Options cut the run for debugging (``--layers``
cuts every LM's depth further, ``--reps``, ``--profile``, ``--phases``);
the contract run takes none.
Every log line begins with the seconds since the script started.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
# cuBLAS's deterministic workspace, which the train phase's deterministic
# loop needs, is read when CUDA first creates a handle: set it before
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
INT8_OPS_PER_S = 1979e12          # H100 SXM dense int8 tensor-core peak
SLOTS = 8
VERIFY_M = SLOTS * 4              # draft_k + 1 = 4 tokens per slot
QWEN_INNER = {"wq": (3584, 3584), "wk": (3584, 512), "wv": (3584, 512),
              "wo": (3584, 3584), "wi": (3584, 18944), "wg": (3584, 18944),
              "mlp.wo": (18944, 3584)}
BITNET_INNER = {"wq": (3200, 3200), "wk": (3200, 3200), "wv": (3200, 3200),
                "wo": (3200, 3200), "wi": (3200, 8640), "wg": (3200, 8640),
                "mlp.wo": (8640, 3200)}
GEMMA_INNER = {"wq": (2304, 2048), "wk": (2304, 1024), "wv": (2304, 1024),
               "wo": (2048, 2304), "wi": (2304, 9216), "wg": (2304, 9216),
               "mlp.wo": (9216, 2304)}
MINICPM_INNER = {"wq": (2304, 2304), "wk": (2304, 2304), "wv": (2304, 2304),
                 "wo": (2304, 2304), "wi": (2304, 5760), "wg": (2304, 5760),
                 "mlp.wo": (5760, 2304)}
# qwen2-moe-a2.7b: its 60 experts and one expert's bank shapes (wi, wg,
# wo), the shared expert's (wi, wg, wo), and expert capacities its path
# launches at: a decode step's 1, and an admission's at its shortest
# prompt (8 rows of 8 tokens: int(64 * 4 / 60 * 1.25) = 5) and its
# longest (8 rows of 64: int(512 * 4 / 60 * 1.25) = 42)
QWEN2MOE_EXPERTS = 60
QWEN2MOE_EXPERT = {"wi": (2048, 1408), "wg": (2048, 1408),
                   "wo": (1408, 2048)}
QWEN2MOE_SHARED = {"wi": (2048, 5632), "wg": (2048, 5632),
                   "wo": (5632, 2048)}
QWEN2MOE_BANK_C = (1, 5, 42)
# zamba2-2.7b: a mamba layer's in_proj (N = 2 * 5120 + 2 * 64 + 80 =
# 10,448, not a multiple of the kernel's column tile) and out_proj; the
# shared block's attention and SwiGLU.  rwkv6-1.6b: a layer's time mix (r,
# k, v, g, o) and channel mix (r, k, v)
ZAMBA2_MAMBA = {"in_proj": (2560, 10448), "out_proj": (5120, 2560)}
ZAMBA2_SHARED = {"wq": (2560, 2560), "wk": (2560, 2560), "wv": (2560, 2560),
                 "wo": (2560, 2560), "wi": (2560, 10240), "wg": (2560, 10240),
                 "mlp.wo": (10240, 2560)}
RWKV6_INNER = {"wr": (2048, 2048), "wk": (2048, 2048), "wv": (2048, 2048),
               "wg": (2048, 2048), "wo": (2048, 2048), "cm.wr": (2048, 2048),
               "cm.wk": (2048, 7168), "cm.wv": (7168, 2048)}
# whisper-large-v3: a decoder layer's 8 projections of a decode step
# (self-attention q, k, v, o; cross-attention q, o; the GELU MLP), an
# encoder layer's 6 and the cross K/V projections (``precompute_cross_kv``)
# at the whisper phase's prefill rows (8 requests x 1,500 frames); the
# decoder layer's 8 again at its prompt forward's rows (8 requests x
# WHISPER_PROMPT tokens); qwen2-vl-72b's layer (877,658,112 weights) and
# head
WHISPER_DEC = {"wq": (1280, 1280), "wk": (1280, 1280), "wv": (1280, 1280),
               "wo": (1280, 1280), "x.wq": (1280, 1280),
               "x.wo": (1280, 1280), "wi": (1280, 5120),
               "mlp.wo": (5120, 1280)}
WHISPER_ENC = {"wq": (1280, 1280), "wk": (1280, 1280), "wv": (1280, 1280),
               "wo": (1280, 1280), "wi": (1280, 5120),
               "mlp.wo": (5120, 1280)}
WHISPER_XKV = {"x.wk": (1280, 1280), "x.wv": (1280, 1280)}
WHISPER_ENC_M = SLOTS * 1500
QWEN2VL_INNER = {"wq": (8192, 8192), "wk": (8192, 1024), "wv": (8192, 1024),
                 "wo": (8192, 8192), "wi": (8192, 29568),
                 "wg": (8192, 29568), "mlp.wo": (29568, 8192)}
QWEN2VL_HEAD = (8192, 152064)
# phi3-medium-14b's layer and head; mixtral-8x22b's attention, its 8
# experts' bank shapes at decode's capacity of 3 rows at 8 slots (max(1,
# int(8 * 2 / 8 * 1.25) + 1)), its head, and the depth its phase serves
# (8 of 56 layers: ~10 GB of codes; the whole model's ~70 GB of nibbles
# needs the expert-parallel path across cards)
PHI3_INNER = {"wq": (5120, 5120), "wk": (5120, 1280), "wv": (5120, 1280),
              "wo": (5120, 5120), "wi": (5120, 17920), "wg": (5120, 17920),
              "mlp.wo": (17920, 5120)}
PHI3_HEAD = (5120, 100352)
MIXTRAL_ATTN = {"wq": (6144, 6144), "wk": (6144, 1024), "wv": (6144, 1024),
                "wo": (6144, 6144)}
MIXTRAL_EXPERTS = 8
MIXTRAL_EXPERT = {"wi": (6144, 16384), "wg": (6144, 16384),
                  "wo": (16384, 6144)}
MIXTRAL_BANK_C = (3,)
MIXTRAL_HEAD = (6144, 32768)
MIXTRAL_LAYERS = 8
QWEN_HEAD = (3584, 152064)
# the sharded phase: qwen2-7b on a 2x2 mesh (head-parallel, 4 of the 8
# slots a data shard) and qwen2-moe-a2.7b on 1x2 (30 of 60 experts a
# rank, heads split too); one model rank's projections at a data shard's
# rows (the row-parallel wo leaves contract half of K), and its half of
# the vocab-column-parallel head
SHARDED_QWEN = "2x2"
SHARDED_MOE = "1x2"
# the lut, fault and save / load runs at 2 layers and qwen2-moe at 4 (cut
# from 4 and 8 to pay for the split-head and speculative cases, which run
# at CUT_LAYERS)
SHARDED_QWEN_LAYERS = 2
SHARDED_MOE_LAYERS = 4
SHARDED_S = 600                   # a sharded world's deadline, seconds
# the fault run: the first 2 contract requests, a NaN at the 4th decode
# dispatch in the second active slot (slot 1, decoding since the first
# round; with 8 requests slot 0 would be a fresh admission there, whose
# chunk lane writes over a NaN at its position 0), so data shard 0's model
# rank 0 holds the NaN and its model-axis peer must learn of it
SHARDED_FAULT_REQUESTS = 2
SHARDED_FAULT_INDEX = 3
SHARDED_FAULT_SLOT = 1
# the 2x2 world's other cases: save / load over the first 2 requests
# (saved after the second round), split-head attention and paged
# speculation (low planes zeroed) over the first 4; a data shard's verify
# block is 4 slots x (draft_k + 1) rows
SHARDED_SAVE_REQUESTS = 2
SHARDED_SAVE_ROUNDS = 2
SHARDED_NEW_REQUESTS = 4
SHARD_VERIFY_M = SLOTS // 2 * 4
QWEN_SHARD = {"wq": (3584, 1792), "wk": (3584, 256), "wv": (3584, 256),
              "wo": (1792, 3584), "wi": (3584, 9472), "wg": (3584, 9472),
              "mlp.wo": (9472, 3584)}
QWEN_SHARD_HEAD = (3584, 76032)
QWEN2MOE_SHARD = {"wq": (2048, 1024), "wk": (2048, 1024),
                  "wv": (2048, 1024), "wo": (1024, 2048),
                  "shared.wi": (2048, 2816), "shared.wg": (2048, 2816),
                  "shared.wo": (2816, 2048)}
QWEN2MOE_SHARD_HEAD = (2048, 75968)
BITNET_HEAD = (3200, 32000)
RWKV6_HEAD = (2048, 65536)
ZAMBA2_HEAD = (2560, 32000)
F32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
SAMPLE_SEED = 1234
# per-request (temperature, top_k, top_p) of the sampled mix, by prompt:
# unfiltered, top-k, greedy, top-p, top-k + top-p, greedy, top-k, top-p
SAMPLED_MIX = [(0.7, 0, 1.0), (1.0, 40, 1.0), (0.0, 0, 1.0), (0.8, 0, 0.9),
               (1.0, 50, 0.95), (0.0, 0, 1.0), (1.2, 8, 1.0), (0.5, 0, 0.8)]
MB_BATCH = 32
MB_CHECK = 4                      # images held against the CPU forward
MB_FLOAT_RTOL = 1e-3              # of max |logit|; see run_mobilenet
MB_GROUP = "mobilenetv2 34 pointwise stages, batch 32"
# the train phase: minicpm-2b QAT at full width and depth, B x S tokens a
# step, then the trained model evaluated as deployed over 2 held-out
# batches; MobileNetV2's full config at 224 x 224, and the fault-tolerant
# loop (8 steps, a checkpoint every 3, one failure at step 5)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 6
TRAIN_PEAK_LIMIT = 75e9
TRAIN_M = TRAIN_B * TRAIN_S
TRAIN_GROUP = f"minicpm-2b layer, M={TRAIN_M} (train eval)"
MB_TRAIN_STEPS = 4
LOOP_STEPS, LOOP_CKPT, LOOP_FAIL = 8, 3, 5
LOOP_RTOL = 1e-6                  # the reference's own loop test's
# the mixed phase: qwen2-7b's planned MLP widths (attention stays w4) at
# each target of roofline.analysis.plan_mixed_bits on its full-width shapes,
# the same leaves as kernel-group specs, the paper's analytic U280
# operating point (the LUTs of its MobileNetV2 design, the overhead a
# multiplier, the unfolded first layers) and the shapes the formulation
# picker times
MIXED_TARGETS = (3.2, 2.0)
# the mixed phase's depth (full width; 8 of 28 layers, cut for the long
# and fsdp phases' time)
MIXED_LAYERS = 8
MIXED_MLP = {3.2: {"wg": 2, "wi": 3, "wo": 4},
             2.0: {"wg": 1, "wi": 2, "wo": 2}}
MIXED_SPECS = {t: {"wi": m["wi"], "wg": m["wg"], "mlp.wo": m["wo"]}
               for t, m in MIXED_MLP.items()}
PAPER_LUT_BUDGET, PAPER_OVERHEAD, PAPER_PREFIX = 529_242, 3.24, 15
PICKER_SHAPES = {"wq/wo": (3584, 3584), "wk/wv": (3584, 512),
                 "wi/wg": (3584, 18944), "mlp.wo": (18944, 3584)}
PHASES = ("kernels", "qwen", "mixed", "bitnet", "gemma2", "minicpm", "phi3",
          "qwen2moe", "mixtral", "rwkv6", "zamba2", "whisper", "qwen2vl",
          "sharded", "mobilenetv2", "train", "long", "fsdp")
# the long phase: qwen2-7b w4a4_lut at full width and depth over one prompt
# of the reference's prefill_32k length (Engine.generate, LONG_NEW new
# tokens); the chunk-lane cross-check of the same prompt at
# LONG_CHUNK_LAYERS (the chunk lane runs one decode step a prompt token,
# LONG_S of them: ~4 ms each at one layer); the fused LUT kernel at the
# prefill's M; gemma2-2b's long pairs admitted blocked and with kv_block
# raised past S; minicpm-2b QAT at train_4k's length, full depth
LONG_S = 32768
LONG_NEW = 8
LONG_CHUNK_LAYERS = 1
LONG_CHUNK = 128                  # prompt tokens a chunk-lane round
LONG_CHECK_ROWS = 64
LONG_GROUP = f"qwen2-7b layer, M={LONG_S} (32k prefill)"
LONG_KERNEL_REPS = 5
# blocked or full, each probability is rounded to bf16 before the value
# product (relative error <= 2^-8, bf16's unit roundoff; the full path
# rounds normalized probabilities, the blocked path unnormalized ones over
# an unrounded float32 sum), so each output element is within ATTN_P_REL x
# sum_k p_k |v_k,d| of the exact softmax (p exact), plus ATTN_F32_REL x
# that sum for the float32 scores, exponentials and sums
ATTN_P_REL = 2.0 ** -8
ATTN_F32_REL = 2.0 ** -12
LONG_TRAIN_S = 4096
LONG_TRAIN_LAYERS = 40
# blocked vs full attention in a QAT step: an A4 code can round the other
# way where the two attentions' outputs differ (tests/test_torch_train.py
# measured 1.2e-5 on the loss and 0.8 % on a gradient leaf for such flips)
LONG_TRAIN_LOSS_RTOL = 1e-3
LONG_TRAIN_NORM_RTOL = 2e-2
FULL_KV_BLOCK = 1 << 16           # kv_block past every S: full attention
# the fsdp phase: FSDP_MESH ranks on the one card, minicpm-2b at full
# width and FSDP_LAYERS layers, FSDP_STEPS steps of FSDP_B x FSDP_S tokens
FSDP_MESH = "4x1"
FSDP_LAYERS = 4
FSDP_B, FSDP_S, FSDP_STEPS = 4, 512, 2
FSDP_WORLD_S = 600
# the sampled, tmac, paged, int8 KV, speculative, faults and QoS stages
# run on qwen2-7b at this depth (full width)
CUT_LAYERS = 4
# the depth (full width always) at which the script serves a model, where
# it is cut to keep the run inside its time limit: mixtral-8x22b because
# one card holds ~10 GB of its expert codes, not ~70; the others (earlier
# slices' paths) for time, gemma2-2b, phi3-medium-14b, qwen2-moe-a2.7b
# and qwen2-vl-72b also to pay for the sharded phase, qwen2-vl-72b (24 ->
# 16) for the train phase, qwen2-vl-72b (16 -> 8), phi3-medium-14b
# (20 -> 10) and gemma2-2b (14 -> 10) for the sharded phase's save /
# load, split-head and speculative cases, gemma2-2b (10 -> 6), qwen2-moe
# (12 -> 8), whisper-large-v3 (16 -> 8) and zamba2-2.7b (24 -> 12) for the
# long and fsdp phases
SERVED_LAYERS = {"mixtral-8x22b": MIXTRAL_LAYERS, "qwen2-vl-72b": 8,
                 "whisper-large-v3": 8, "bitnet-3b": 13, "minicpm-2b": 20,
                 "rwkv6-1.6b": 12, "zamba2-2.7b": 12, "gemma2-2b": 6,
                 "phi3-medium-14b": 10, "qwen2-moe-a2.7b": 8}
# gemma2-2b: the window is 4096; two pairs of long prompts past it, two
# pairs of short ones inside it; pages of 64 divide the ring and max_len
GEMMA_LONG = (4104, 4152)
GEMMA_SHORT = (24, 40)
GEMMA_MAX_LEN = 4352
GEMMA_PAGE = 64
# the paged run serves the first long pair (monolithic admission, wrapped
# rings through the ring table): a short request's 64-token chunk lane
# takes a key a fill, each ~12 s to capture at 26 layers
GEMMA_PAGED_REQUESTS = 2
# new tokens of a plain-backend run (minicpm, qwen2moe, rwkv6, zamba2,
# whisper)
PLAIN_TOKENS = 8
# whisper-large-v3 through Engine.generate: 8 requests of 4-token prompts
# and 64 new tokens over one batch of stub frames; the unfused run serves
# all 8 with 64 tokens, the plain run all 8 with PLAIN_TOKENS
WHISPER_PROMPT = 4
WHISPER_NEW = 64
WHISPER_MAX_LEN = 448
WHISPER_PAGE = 16
# qwen2-vl-72b: the vision stub's rows (8 text tokens, a 16 x 16 patch
# grid, 8 text tokens) and decode steps; the plain Scheduler run's tokens
QWEN2VL_TEXT = 8
QWEN2VL_GRID = 16
QWEN2VL_STUB_ROWS = 2
QWEN2VL_STUB_STEPS = 8
QWEN2VL_PLAIN_TOKENS = 4
# where generate and the chunk lane part, the first activation that
# differs between them may differ by at most this many bf16 ulps (a float
# reduction run at another shape); the A4 codes amplify it from there
FLIP_ULPS = 16
CSRC = "src/repro_torch/csrc/"
KPY = "src/repro/kernels/lutmul/kernel.py"
# entry point: (source, TPU kernel it replaces, its main group)
KERNELS = {
    "lutmul_fused": ("lutmul.cu", f"{KPY}:380", "qwen2-7b layer, M=8"),
    "lutmul": ("lutmul.cu", f"{KPY}:178", "qwen2-7b layer, M=8"),
    "int_matmul_fused": ("int_matmul.cu", f"{KPY}:483",
                         "qwen2-7b head, M=8"),
    "int_matmul": ("int_matmul.cu", f"{KPY}:332", "qwen2-7b head, M=8"),
    "lutmul_tmac_fused": ("lutmul_tmac.cu", f"{KPY}:430",
                          "qwen2-7b target layer, P=4 g=2 M=8"),
    "lutmul_tmac": ("lutmul_tmac.cu", f"{KPY}:289",
                    "qwen2-7b target layer, P=4 g=2 M=8"),
    "lutmul_gather": ("lutmul_gather.cu", f"{KPY}:153", MB_GROUP),
    "threshold": ("thresholds.cu", "src/repro/kernels/thresholds/kernel.py:31",
                  MB_GROUP),
}
# the run whose launch count each entry point reports
MAIN_RUN = {"lutmul_fused": "qwen lut fused",
            "lutmul": f"qwen{CUT_LAYERS} lut unfused",
            "int_matmul_fused": "qwen lut fused",
            "int_matmul": f"qwen{CUT_LAYERS} lut unfused",
            "lutmul_tmac_fused": f"qwen{CUT_LAYERS} tmac spec",
            "lutmul_tmac": f"qwen{CUT_LAYERS} tmac unfused",
            "lutmul_gather": "mobilenetv2 gather pass",
            "threshold": "mobilenetv2 integer pass"}


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script began."""
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi`` clocks.max.sm)."""
    return float(smi_line("clocks.max.sm").split()[0]) * 1e6


def gather_floor_ms(products: int, sm_hz: float) -> float:
    """Least time of ``products`` table reads from shared memory: 32 words
    a clock on each SM."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return products / (sms * 32 * sm_hz) * 1e3


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    """Tensors of one dtype and shape equal bit for bit."""
    import torch
    view = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(view.get(a.dtype, a.dtype)), b.view(view.get(b.dtype,
                                                             b.dtype)))


def _time(fn, reps: int, flush) -> float:
    """Median ms of ``reps`` launches, each after an L2 flush, timed with
    CUDA events around the launch alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _library_bmm_ms(a8, w8, want, flush, reps):
    """The library yardstick of a stack of expert products, held to the
    plain int32 result ``want``: one float32 cuBLAS batched GEMM of the
    decoded codes (TF32 is off), exact where |acc| < 2^24 (ATen has no
    batched int8 GEMM).  Returns (ms, note)."""
    import torch
    bound = int(a8.abs().max()) * int(w8.abs().max()) * a8.shape[-1]
    if bound >= 2 ** 24:
        raise AssertionError(f"float32 sums are not exact here (|acc| up to "
                             f"{bound})")
    af, wf = a8.float(), w8.float()
    fn = lambda: torch.bmm(af, wf)                          # noqa: E731
    if not torch.equal(fn().to(torch.int32), want):
        raise AssertionError("library yardstick (torch.bmm) disagrees with "
                             "the plain version")
    return _time(fn, reps, flush), (
        f"torch.bmm, float32 cuBLAS batched GEMM of the decoded codes, TF32 "
        f"off, exact (|acc| <= {bound} < 2^24), no epilogue")


def _library_ms(a8, w8, want, flush, reps):
    """The library yardstick on the same int8 operands, held to the plain
    int32 result ``want``: torch._int_mm; where it refuses the shape, the
    float32 cuBLAS GEMM of the same codes (TF32 is off) if float32 sums
    are exact (|acc| < 2^24), else torch._int_mm on the rows zero-padded to
    32 (it takes M > 16), checked on the real rows.  Returns (ms or None,
    note)."""
    import torch
    M, K = a8.shape
    try:
        got = torch._int_mm(a8, w8)
        fn, note = (lambda: torch._int_mm(a8, w8)), "torch._int_mm"
    except RuntimeError as err:
        why = str(err).splitlines()[0][:160]
        bound = int(a8.abs().max()) * int(w8.abs().max()) * K
        if bound < 2 ** 24:
            af, wf = a8.float(), w8.float()
            fn = lambda: torch.matmul(af, wf)               # noqa: E731
            got = fn().to(torch.int32)
            note = ("float32 cuBLAS GEMM of the decoded codes, TF32 off, "
                    f"exact (|acc| <= {bound} < 2^24), no epilogue; "
                    f"torch._int_mm refuses ({why})")
        elif M < 32:
            ap = torch.zeros((32, K), dtype=a8.dtype, device=a8.device)
            ap[:M] = a8
            fn = lambda: torch._int_mm(ap, w8)              # noqa: E731
            got = fn()[:M]
            note = (f"torch._int_mm (rows padded to 32): its M > 16 rule "
                    f"refuses M = {M} ({why}), float32 is inexact here "
                    f"(|acc| up to {bound} >= 2^24)")
        else:
            return None, (f"torch._int_mm refuses ({why}); float32 is not "
                          f"exact here (|acc| up to {bound} >= 2^24)")
    torch.cuda.synchronize()
    if not torch.equal(got.to(torch.int32), want):
        raise AssertionError(f"library yardstick ({note}) disagrees with "
                             "the plain version")
    return _time(fn, reps, flush), note


class Bench:
    """Kernel records: each entry point's shape groups, every shape held
    against its plain version (int32 exactly, floats bitwise) and timed."""

    def __init__(self, reps: int, sm_hz: float):
        import torch
        self.reps = reps
        self.sm_hz = sm_hz
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.recs = {name: {"name": name, "route": "cuda",
                            "source": CSRC + src, "replaces": rep,
                            "main_group": group, "groups": {}}
                     for name, (src, rep, group) in KERNELS.items()}

    def one(self, name, group, fn, plain, lib, shape: dict, nbytes: float,
            ops: float, ops_rate: float = INT8_OPS_PER_S) -> None:
        """``nbytes`` (each input read once, each output written once) and
        ``ops`` at ``ops_rate`` give the bound."""
        import torch
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {shape}: {got.dtype}"
                                 f"{tuple(got.shape)} vs plain {want.dtype}"
                                 f"{tuple(want.shape)}")
        # int32 exactly; fused outputs bitwise (compare the raw bits)
        same = _bits_equal(got, want)
        err = float((got.to(torch.float64) - want.to(torch.float64))
                    .abs().max())
        if not same:
            raise AssertionError(f"{name} [{group}] {shape} disagrees with "
                                 f"its plain version: max |diff| = {err}")
        lib_ms, why = lib
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
        self.recs[name]["groups"].setdefault(group, {"shapes": []})[
            "shapes"].append({
                **shape, "max_abs_err": err,
                "ms": _time(fn, self.reps, self.flush),
                "plain_ms": _time(plain, max(3, self.reps // 8), self.flush),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms, "library_note": why})

    def lut(self, name, group, fn, plain, lib, M, K, N, extra_in=0,
            out_bytes=None) -> None:
        """A LUT-kernel shape: 4-bit codes, nibble-packed weights, the
        table (lutmul.cu's 16 selection words, the gather kernel's [16, 16]
        products); int32 out unless ``out_bytes`` says otherwise."""
        table = 256 * 4 if name == "lutmul_gather" else 16 * 4
        self.one(name, group, fn, plain, lib, {"M": M, "K": K, "N": N},
                 M * K + K * N // 2 + table + extra_in
                 + (M * N * 4 if out_bytes is None else out_bytes),
                 2.0 * M * K * N)

    def summarize(self) -> dict:
        """Sum each group over its shapes (the 7 projections of one layer,
        one head call, or the 34 stages of one CNN pass); the main group is
        the record's.  Records never measured (a cut debugging run) go."""
        for r in self.recs.values():
            for group, gr in r["groups"].items():
                sh = gr["shapes"]
                gr["max_abs_err"] = max(s["max_abs_err"] for s in sh)
                for key in ("ms", "plain_ms", "bound_ms"):
                    gr[key] = sum(s[key] for s in sh)
                libs = [s["library_ms"] for s in sh]
                gr["library_ms"] = None if None in libs else sum(libs)
                gr["library_note"] = next((s["library_note"] for s in sh
                                           if s["library_note"]), None)
                gr["bound_by"] = "bytes" if all(s["bound_by"] == "bytes"
                                                for s in sh) else "operations"
                floor = ""
                if r["name"] == "lutmul_gather":
                    gr["products"] = sum(s["M"] * s["K"] * s["N"]
                                         for s in sh)
                    gr["gather_floor_ms"] = gather_floor_ms(gr["products"],
                                                            self.sm_hz)
                    floor = (f" products {gr['products']} gather floor "
                             f"{gr['gather_floor_ms']:.4f}")
                log(f"kernel {r['name']} [{group}]: max|diff| "
                    f"{gr['max_abs_err']} ms {gr['ms']:.4f} plain "
                    f"{gr['plain_ms']:.3f} bound {gr['bound_ms']:.4f} "
                    f"library {gr['library_ms']}{floor}")
            main = r["groups"].get(r["main_group"])
            if main is None:
                continue
            for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "library_note", "products",
                        "gather_floor_ms"):
                if key in main:
                    r[key] = main[key]
            r["max_abs_err"] = max(gr["max_abs_err"]
                                   for gr in r["groups"].values())
        return {n: r for n, r in self.recs.items() if "ms" in r}


def check_kernels(bench: Bench) -> None:
    import torch
    from repro_torch.core.lut import plane_decomposition, unpack_bitplanes
    from repro_torch.kernels.lutmul import kernel, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    reps, flush = bench.reps, bench.flush

    def scales(M, N):
        a_s = torch.rand((M, 1), generator=gen, device=dev) * 0.1 + 1e-3
        w_s = torch.rand((1, N), generator=gen, device=dev) * 0.1 + 1e-3
        return a_s, w_s

    # the LUT kernels at M = 8: qwen2-7b's inner projections (and the
    # gather baseline), gemma2-2b's, minicpm-2b's and qwen2-moe-a2.7b's
    # shared expert (each a grid and K split of its own)
    def at(M, shapes):
        return [(M, K, N) for K, N in shapes.values()]
    lut_groups = [(KERNELS["lutmul"][2], at(SLOTS, QWEN_INNER), True),
                  ("gemma2-2b layer, M=8", at(SLOTS, GEMMA_INNER), False),
                  ("minicpm-2b layer, M=8", at(SLOTS, MINICPM_INNER), False),
                  ("qwen2-moe shared expert, M=8", at(SLOTS, QWEN2MOE_SHARED),
                   False),
                  ("zamba2-2.7b mamba layer, M=8", at(SLOTS, ZAMBA2_MAMBA),
                   False),
                  ("zamba2-2.7b shared block, M=8", at(SLOTS, ZAMBA2_SHARED),
                   False),
                  ("rwkv6-1.6b layer, M=8", at(SLOTS, RWKV6_INNER), False),
                  ("whisper-large-v3 decoder layer, M=8",
                   at(SLOTS, WHISPER_DEC), False),
                  (f"whisper-large-v3 decoder layer, "
                   f"M={SLOTS * WHISPER_PROMPT}",
                   at(SLOTS * WHISPER_PROMPT, WHISPER_DEC), False),
                  (f"whisper-large-v3 encoder layer, M={WHISPER_ENC_M}",
                   at(WHISPER_ENC_M, WHISPER_ENC), False),
                  (f"whisper-large-v3 cross K/V, M={WHISPER_ENC_M}",
                   at(WHISPER_ENC_M, WHISPER_XKV), False),
                  ("qwen2-vl-72b layer, M=8", at(SLOTS, QWEN2VL_INNER),
                   False),
                  ("phi3-medium-14b layer, M=8", at(SLOTS, PHI3_INNER),
                   False),
                  ("mixtral-8x22b attention, M=8", at(SLOTS, MIXTRAL_ATTN),
                   False),
                  (f"qwen2-7b {SHARDED_QWEN} shard layer, M=4",
                   at(SLOTS // 2, QWEN_SHARD), False),
                  (f"qwen2-moe {SHARDED_MOE} shard attention + shared "
                   "expert, M=8", at(SLOTS, QWEN2MOE_SHARD), False)]
    for group, shapes, gather in lut_groups:
        for M, K, N in shapes:
            a = torch.randint(0, 16, (M, K), generator=gen, device=dev,
                              dtype=torch.uint8)
            w = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                              dtype=torch.uint8)
            a_s, w_s = scales(M, N)
            a8 = ref.decode_codes(a).to(torch.int8)
            w8 = ref.decode_codes(ref.unpack_int4(w.T).T, 4) \
                .to(torch.int8).contiguous()
            lib = _library_ms(a8, w8, ref.lutmul_ref(a, w), flush, reps)
            bench.lut("lutmul", group, lambda: kernel.lutmul(a, w),
                      lambda: ref.lutmul_ref(a, w), lib, M, K, N)
            if gather:
                bench.lut("lutmul_gather", group,
                          lambda: kernel.lutmul_gather(a, w),
                          lambda: ref.lutmul_ref(a, w), lib, M, K, N)
            bench.lut("lutmul_fused", group,
                      lambda: kernel.lutmul_fused(a, w, a_s, w_s,
                                                  out_dtype=torch.bfloat16),
                      lambda: ref.scaled_lutmul_ref(a, w, a_s, w_s,
                                                    out_dtype=torch.bfloat16),
                      lib, M, K, N, extra_in=4 * (M + N), out_bytes=M * N * 2)
            del a, w, a8, w8
    check_expert_banks(bench, gen)
    check_train_eval_shapes(bench, gen, scales)

    # the T-MAC kernel: target, drafter and verify of qwen2-7b in
    # w4a4_tmac, bitnet-3b's ternary_a8_tmac projections, and qwen2-7b's
    # layer under the mixed plans (a spec a projection, w4 where the plan
    # names none), wi at P = 3 and wg at P = 1 (the binary kind) alone
    tmac_groups = [
        ("qwen2-7b target layer, P=4 g=2 M=8", QWEN_INNER, 4, 4, SLOTS),
        ("qwen2-7b drafter layer, P=2 g=2 M=8", QWEN_INNER, 2, 4, SLOTS),
        ("qwen2-7b verify layer, P=4 g=2 M=32", QWEN_INNER, 4, 4, VERIFY_M),
        ("bitnet-3b layer, ternary g=1 M=8", BITNET_INNER, "ternary", 8,
         SLOTS),
        ("qwen2-7b mixed layer, 3.2 bits, g=2 M=8", QWEN_INNER,
         MIXED_SPECS[3.2], 4, SLOTS),
        ("qwen2-7b mixed layer, 2.0 bits, g=2 M=8", QWEN_INNER,
         MIXED_SPECS[2.0], 4, SLOTS),
        ("qwen2-7b wi, P=3 g=2 M=8", {"wi": QWEN_INNER["wi"]}, 3, 4, SLOTS),
        ("qwen2-7b wg, P=1 (binary) g=2 M=8", {"wg": QWEN_INNER["wg"]}, 1,
         4, SLOTS),
        (f"qwen2-7b {SHARDED_QWEN} shard target layer, P=4 g=2 M=4",
         QWEN_SHARD, 4, 4, SLOTS // 2),
        (f"qwen2-7b {SHARDED_QWEN} shard drafter layer, P=2 g=2 M=4",
         QWEN_SHARD, 2, 4, SLOTS // 2),
        (f"qwen2-7b {SHARDED_QWEN} shard verify layer, P=4 g=2 "
         f"M={SHARD_VERIFY_M}", QWEN_SHARD, 4, 4, SHARD_VERIFY_M)]
    for group, shapes, group_spec, abits, M in tmac_groups:
        g = 1 if abits == 8 else 2
        for name, (K, N) in shapes.items():
            spec = group_spec.get(name, 4) if isinstance(group_spec, dict) \
                else group_spec
            P = plane_decomposition(spec)[0]
            lo = -(1 << (abits - 1))
            a = torch.randint(lo, -lo, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            if spec == "ternary":      # valid ternary: no code is +1 and -1
                pos = torch.randint(0, 256, (K // 8, N), generator=gen,
                                    device=dev, dtype=torch.uint8)
                neg = torch.randint(0, 256, (K // 8, N), generator=gen,
                                    device=dev, dtype=torch.uint8) & ~pos
                planes = torch.stack([pos, neg])
            else:
                planes = torch.randint(0, 256, (P, K // 8, N), generator=gen,
                                       device=dev, dtype=torch.uint8)
            a_s, w_s = scales(M, N)
            w8 = ref.decode_planes(unpack_bitplanes(planes), spec) \
                .to(torch.int8).contiguous()
            lib = _library_ms(a, w8, ref.tmac_ref(a, planes, spec), flush,
                              reps)
            in_bytes = M * K + P * K * N // 8
            shape = {"M": M, "K": K, "N": N, "P": P}
            bench.one("lutmul_tmac", group,
                      lambda: kernel.lutmul_tmac(a, planes, spec, g=g),
                      lambda: ref.tmac_ref(a, planes, spec), lib, shape,
                      in_bytes + M * N * 4, 2.0 * M * K * N)
            bench.one("lutmul_tmac_fused", group,
                      lambda: kernel.lutmul_tmac_fused(a, planes, spec, a_s,
                                                       w_s, g=g),
                      lambda: ref.scaled_tmac_ref(a, planes, spec, a_s, w_s,
                                                  out_dtype=torch.bfloat16),
                      lib, shape, in_bytes + 4 * (M + N) + M * N * 2,
                      2.0 * M * K * N)
            del a, planes, w8

    # the int8 heads: qwen2-7b at M = 8 and at M = 32 (verify), bitnet-3b,
    # rwkv6-1.6b, zamba2-2.7b, qwen2-vl-72b, phi3-medium-14b and
    # mixtral-8x22b
    for group, (K, N), M in (("qwen2-7b head, M=8", QWEN_HEAD, SLOTS),
                             ("qwen2-7b verify head, M=32", QWEN_HEAD,
                              VERIFY_M),
                             ("bitnet-3b head, M=8", BITNET_HEAD, SLOTS),
                             ("rwkv6-1.6b head, M=8", RWKV6_HEAD, SLOTS),
                             ("zamba2-2.7b head, M=8", ZAMBA2_HEAD, SLOTS),
                             ("qwen2-vl-72b head, M=8", QWEN2VL_HEAD,
                              SLOTS),
                             ("phi3-medium-14b head, M=8", PHI3_HEAD, SLOTS),
                             ("mixtral-8x22b head, M=8", MIXTRAL_HEAD,
                              SLOTS),
                             (f"qwen2-7b {SHARDED_QWEN} shard head, M=4",
                              QWEN_SHARD_HEAD, SLOTS // 2),
                             (f"qwen2-7b {SHARDED_QWEN} shard verify head, "
                              f"M={SHARD_VERIFY_M}", QWEN_SHARD_HEAD,
                              SHARD_VERIFY_M),
                             (f"qwen2-moe {SHARDED_MOE} shard head, M=8",
                              QWEN2MOE_SHARD_HEAD, SLOTS)):
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        a_s, w_s = scales(M, N)
        lib = _library_ms(a, w, ref.int_matmul_ref(a, w), flush, reps)
        shape = {"M": M, "K": K, "N": N}
        bench.one("int_matmul", group, lambda: kernel.int_matmul(a, w),
                  lambda: ref.int_matmul_ref(a, w), lib, shape,
                  M * K + K * N + M * N * 4, 2.0 * M * K * N)
        bench.one("int_matmul_fused", group,
                  lambda: kernel.int_matmul_fused(a, w, a_s, w_s,
                                                  out_dtype=torch.bfloat16),
                  lambda: ref.scaled_int_matmul_ref(
                      a, w, a_s, w_s, out_dtype=torch.bfloat16),
                  lib, shape, M * K + K * N + 4 * (M + N) + M * N * 2,
                  2.0 * M * K * N)
        del a, w
    torch.cuda.empty_cache()


def check_train_eval_shapes(bench: Bench, gen, scales) -> None:
    """minicpm-2b's 7 projections at the train phase's eval shape (M = B x
    S rows): the fused LUT kernel (``w4a4_lut``) and the fused int8 kernel
    on the unpacked 4-bit codes (``w4a4_mxu``), each held bitwise against
    its plain version."""
    import torch
    from repro_torch.kernels.lutmul import kernel, ref
    dev = torch.device("cuda")
    M = TRAIN_M
    for K, N in MINICPM_INNER.values():
        a = torch.randint(0, 16, (M, K), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                          dtype=torch.uint8)
        a_s, w_s = scales(M, N)
        a8 = ref.decode_codes(a).to(torch.int8)
        w8 = ref.decode_codes(ref.unpack_int4(w.T).T, 4) \
            .to(torch.int8).contiguous()
        lib = _library_ms(a8, w8, ref.lutmul_ref(a, w), bench.flush,
                          bench.reps)
        bench.lut("lutmul_fused", TRAIN_GROUP,
                  lambda: kernel.lutmul_fused(a, w, a_s, w_s,
                                              out_dtype=torch.bfloat16),
                  lambda: ref.scaled_lutmul_ref(a, w, a_s, w_s,
                                                out_dtype=torch.bfloat16),
                  lib, M, K, N, extra_in=4 * (M + N), out_bytes=M * N * 2)
        bench.one("int_matmul_fused", TRAIN_GROUP,
                  lambda: kernel.int_matmul_fused(a8, w8, a_s, w_s,
                                                  out_dtype=torch.bfloat16),
                  lambda: ref.scaled_int_matmul_ref(
                      a8, w8, a_s, w_s, out_dtype=torch.bfloat16),
                  lib, {"M": M, "K": K, "N": N},
                  M * K + K * N + 4 * (M + N) + M * N * 2, 2.0 * M * K * N)
        del a, w, a8, w8


def check_expert_banks(bench: Bench, gen) -> None:
    """The expert banks as the MoE path launches them: one
    ``lutmul_experts`` call on [E, C, K] codes and an [E, K//2, N] bank (E
    launches at per-expert offsets), int32 and fused, each held bitwise
    against its plain version on all E experts; a group is one layer's
    three banks at one capacity C: qwen2-moe-a2.7b's 60 experts at C = 1,
    5 and 42, mixtral-8x22b's 8 at decode's C = 3."""
    import torch
    dev = torch.device("cuda")
    for model, E, shapes, caps in (
            ("qwen2-moe", QWEN2MOE_EXPERTS, QWEN2MOE_EXPERT,
             QWEN2MOE_BANK_C),
            ("mixtral-8x22b", MIXTRAL_EXPERTS, MIXTRAL_EXPERT,
             MIXTRAL_BANK_C)):
        for C in caps:
            _expert_group(bench, gen, dev, f"{model} expert banks, E={E} "
                          f"M={C}", E, C, shapes)
        torch.cuda.empty_cache()


def _expert_group(bench: Bench, gen, dev, group: str, E: int, C: int,
                  shapes: dict) -> None:
    """One group of :func:`check_expert_banks`: E experts at capacity C,
    each bank shape in ``shapes``."""
    import torch
    from repro_torch.kernels.lutmul import kernel, ref
    from repro_torch.models import moe
    for K, N in shapes.values():
        a = torch.randint(0, 16, (E, C, K), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(0, 256, (E, K // 2, N), generator=gen,
                          device=dev, dtype=torch.uint8)
        a_s = torch.rand((E, C, 1), generator=gen, device=dev) * 0.1 \
            + 1e-3
        w_s = torch.rand((E, 1, N), generator=gen, device=dev) * 0.1 \
            + 1e-3
        a8 = ref.decode_codes(a).to(torch.int8)
        bank = {"w_q": w, "w_scale": w_s}

        def plain():
            return torch.stack([ref.lutmul_ref(a[e], w[e])
                                for e in range(E)])
        lib = _library_bmm_ms(a8, moe._bank_codes(bank), plain(),
                              bench.flush, bench.reps)
        shape = {"E": E, "M": C, "K": K, "N": N}
        in_bytes = E * (C * K + K * N // 2) + 16 * 4
        ops = 2.0 * E * C * K * N
        bench.one("lutmul", group, lambda: kernel.lutmul_experts(a, w),
                  plain, lib, shape, in_bytes + E * C * N * 4, ops)
        bench.one("lutmul_fused", group,
                  lambda: kernel.lutmul_experts(
                      a, w, a_s, w_s, out_dtype=torch.bfloat16),
                  lambda: moe.expert_matmul_ref(a8, a_s, bank,
                                                torch.bfloat16),
                  lib, shape, in_bytes + 4 * E * (C + N) + E * C * N * 2,
                  ops)
        del a, w, a8, bank


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------

def make_requests(vocab: int, seed: int = 0, sampled: bool = False):
    """8 requests, prompts of 8, 16, ..., 64 tokens; ``sampled`` gives
    each its ``SAMPLED_MIX`` knobs."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(range(8, 65, 8)):
        t, k, p = SAMPLED_MIX[i] if sampled else (None, None, None)
        out.append(Request(prompt=rng.integers(0, vocab, L).tolist(),
                           max_new_tokens=int(rng.integers(16, 33)),
                           temperature=t, top_k=k, top_p=p))
    return out


RUNS: dict = {}
TRAIN: dict = {}
LONG: dict = {}
FSDP: dict = {}
TRANSCRIPTS: dict = {}         # runs a later phase holds its own against


def reset_launches() -> None:
    from repro_torch.kernels.lutmul import kernel
    from repro_torch.kernels.thresholds import kernel as tkernel
    kernel.reset_launches()
    tkernel.reset_launches()


def all_launches() -> dict:
    """Every wrapper's launch count, by entry point."""
    from repro_torch.kernels.lutmul import kernel
    from repro_torch.kernels.thresholds import kernel as tkernel
    return {**kernel.LAUNCHES, **tkernel.LAUNCHES}


def _graph_state(engine) -> tuple:
    g = engine.graphs
    return ({id(r): r.replays for r in g.rounds.values()}, len(g.rounds),
            g.capture_s, g.replays)


def _graph_stats(engine, before: tuple, label: str, rounds: int,
                 inner: str = None, fused: bool = True) -> dict:
    """The run's captured and replayed rounds.  On the kernel backend every
    round must be a replayed graph, and every key replayed must have
    captured 7 launches per layer per forward of the inner kernel and one
    head launch per forward; on the plain backend no round is a graph."""
    seen, n_keys, capture_s, replays = before
    g = engine.graphs
    ran = [(k, r) for k, r in g.rounds.items()
           if r.replays > seen.get(id(r), 0)]
    st = {"keys_captured": len(g.rounds) - n_keys, "keys_replayed": len(ran),
          "capture_s": g.capture_s - capture_s,
          "replays": g.replays - replays,
          "keys": [{"n_real": k[0], "chunk": k[1], "spec": k[2],
                    "greedy": k[3], "variant": k[5], "forwards": r.forwards,
                    "replays": r.replays - seen.get(id(r), 0),
                    "launches": r.launches} for k, r in ran]}
    if inner is None:
        if st["replays"] or st["keys_captured"]:
            raise AssertionError(f"{label}: the plain backend replayed "
                                 f"graphs: {st}")
        return st
    if st["replays"] != rounds or not ran:
        raise AssertionError(f"{label}: {st['replays']} of {rounds} rounds "
                             "were replayed graphs")
    for k, r in ran:
        want = _want_launches(engine, inner, fused, r.forwards)
        if not r.forwards or r.launches != want:
            raise AssertionError(f"{label}: graph {k[:6]} captured launches "
                                 f"{r.launches} != {want} for forwards "
                                 f"{r.lanes}")
    return st


def inner_per_forward(cfg) -> int:
    """The inner kernel's launches in one forward, by layer: 4 attention
    projections, 2 a Mamba2 mixer (in_proj, out_proj), 5 an RWKV6 time mix
    (r, k, v, g, o); then 3 an MLP or an RWKV6 channel mix, 3 * n_experts
    (+ 3 with a shared expert) a MoE FFN (one launch per expert of each
    bank), none without; and 7 where the shared block runs first
    (zamba2)."""
    n = 0
    for i in range(cfg.n_layers):
        spec = cfg.pattern[i % len(cfg.pattern)]
        n += {"attn": 4, "mamba2": 2, "rwkv6": 5}[spec.kind]
        n += 7 if spec.shared_attn else 0
        if spec.mlp == "moe":
            n += 3 * cfg.moe.n_experts + (3 if cfg.moe.shared_ff else 0)
        elif spec.mlp != "none":
            n += 3
    return n


def _want_launches(engine, inner, fused: bool, forwards: int) -> dict:
    """The launches ``forwards`` forwards make: :func:`inner_per_forward`
    of the inner kernel (``inner`` a dict: these launches of each kernel a
    forward), and one of the int8 head kernel where the model has an
    untied head (a tied head is a plain matrix product, as in the
    reference)."""
    sfx = "_fused" if fused else ""
    per = inner if isinstance(inner, dict) else {
        inner: inner_per_forward(engine.cfg)}
    want = {k + sfx: n * forwards for k, n in per.items()}
    if "lm_head" in engine.params:
        want["int_matmul" + sfx] = forwards
    return want


def prefix_requests(vocab: int) -> list:
    """The contract's 8 requests, each prompt after one shared 32-token
    prefix (8 pages of 4; numpy seed 1)."""
    import numpy as np
    prefix = np.random.default_rng(1).integers(0, vocab, 32).tolist()
    reqs = make_requests(vocab)
    for r in reqs:
        r.prompt = prefix + list(r.prompt)
    return reqs


def equal_requests(vocab: int) -> list:
    """8 prompts of 32 tokens (numpy seed 2), 16-32 new tokens each: one
    monolithic admission dispatch fills all 8 slots."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(2)
    return [Request(prompt=rng.integers(0, vocab, 32).tolist(),
                    max_new_tokens=int(rng.integers(16, 33)))
            for _ in range(SLOTS)]


def dense_kv_bytes(engine) -> int:
    """The dense cache's capacity at SLOTS slots: K and V of every layer,
    [SLOTS, T, n_kv, head_dim] each, T = max_len (a local layer's ring:
    min(max_len, window))."""
    from repro_torch.models import transformer
    return transformer.dense_cache_bytes(engine.cfg, SLOTS,
                                         engine.scfg.max_len)


def _median(xs: list):
    return sorted(xs)[len(xs) // 2] if xs else None


def reset_peak(empty: bool = False) -> None:
    """Collect the garbage that earlier runs left (the wrappers ``serve``
    and ``gemma_drive`` set on a Scheduler or a page pool close a reference
    cycle over it, and so over its cache and graph pools), with ``empty``
    give the freed blocks back to the card, then reset the peak-memory
    counter, so a peak counts what is alive, not what waits for the
    collector."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    if empty:
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def serve(engine, vocab: int, label: str, n_requests: int,
          inner=None, fused: bool = True,
          sampled: bool = False, reqs: list = None, plan=None,
          sched_kw: dict = None, hold: list = None, drive=None) -> list:
    """Drain ``n_requests`` requests (``sampled``: with the sampled mix's
    knobs; ``reqs``: these instead) through a fresh Scheduler, with the
    launch counters zeroed just before and read just after; ``inner`` names
    the projection kernel every forward must launch 7 times per layer (the
    head kernel once; a dict: each kernel's launches a forward), None for
    the plain backend (no launches at all).  A
    replayed round counts the launches its capture recorded, and on the
    kernel backend every round the engine ran must be a replayed graph.  A
    paged engine's run also reports its pool (peak pages, resident KV bytes
    against the dense capacity, prefix hits, preemptions, pages trimmed,
    host ms of the pool audit a dispatch) and ends with ``check_drained``.
    On an engine that admits monolithically every prefill forward counts
    as a forward of its own lane, and the run reports its admission
    dispatches (requests each, host ms from the call to the read of its
    results).  ``sched_kw`` goes to the Scheduler (with snapshots on, the
    run reports each snapshot's and restore's host ms, synchronized with
    the card before and after); ``plan`` is a ``FaultPlan`` installed for
    the run, whose recoveries the run reports; ``hold`` keeps the
    Scheduler (and so its cache's addresses) alive after the run;
    ``drive(sched, reqs)`` serves the requests instead of ``sched.run``
    (then no request has to end by its length: the caller checks them)."""
    import torch
    from repro_torch.serve import Scheduler
    if reqs is None:
        reqs = make_requests(vocab, sampled=sampled)
    reqs = reqs[:n_requests]
    sched = Scheduler(engine, slots=SLOTS, chunk=8, **(sched_kw or {}))
    if hold is not None:
        hold.append(sched)
    timed_ms = {"snapshot": [], "restore": []}
    if sched.snapshot_interval:
        for name, into in timed_ms.items():
            def timed(*a, _fn=getattr(sched, name), _into=into):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a)
                torch.cuda.synchronize()
                _into.append(1e3 * (time.perf_counter() - t0))
                return out
            setattr(sched, name, timed)
    admissions = []
    if engine.requires_monolithic_admission or \
            engine.chunk_window_limit is not None:
        admit = sched._admit

        def timed(*a, **k):
            t0 = time.perf_counter()
            n = admit(*a, **k)
            if n:
                admissions.append((n, 1e3 * (time.perf_counter() - t0)))
            return n
        sched._admit = timed
    trimmed = [0]
    validate_ms = []
    if engine.paged:
        trim, validate = engine.pool.trim, engine.pool.validate

        def counted(slot, keep):
            n = trim(slot, keep)
            trimmed[0] += n
            return n

        def audited():
            t0 = time.perf_counter()
            errs = validate()
            validate_ms.append(1e3 * (time.perf_counter() - t0))
            return errs
        engine.pool.trim = counted
        engine.pool.validate = audited
    step, dispatched = engine.step, [0]

    def dispatch(*a, **k):
        out = step(*a, **k)
        dispatched[0] += 1
        return out
    engine.decode_steps = 0
    engine.prefill_steps = 0
    engine.lane_steps = dict.fromkeys(engine.lane_steps, 0)
    graphs0 = _graph_state(engine)
    reset_peak()
    reset_launches()
    engine.step = dispatch
    engine.set_fault_plan(plan)
    t0 = time.perf_counter()
    try:
        if drive is None:
            sched.run(reqs)
        else:
            drive(sched, reqs)
        torch.cuda.synchronize()
    finally:
        del engine.step
        engine.set_fault_plan(None)
    dt = time.perf_counter() - t0
    launches = all_launches()
    for r in reqs if drive is None else ():
        if not (r.finish_reason == "length"
                and len(r.tokens) == r.max_new_tokens):
            raise AssertionError(f"{label}: request ended {r.finish_reason} "
                                 f"with {len(r.tokens)}/{r.max_new_tokens}")
    lanes = dict(engine.lane_steps)
    if engine.prefill_steps:
        lanes["prefill"] = engine.prefill_steps
    forwards = sum(lanes.values())
    want = dict.fromkeys(launches, 0)
    if inner is not None:
        want.update(_want_launches(engine, inner, fused, forwards))
    if launches != want or not forwards:
        raise AssertionError(f"{label}: launches {launches} != {want} for "
                             f"forwards by lane {lanes}")
    if plan is None and dispatched[0] != sched.stats["rounds"]:
        raise AssertionError(f"{label}: {dispatched[0]} rounds dispatched, "
                             f"the Scheduler counts {sched.stats['rounds']}")
    graphs = _graph_stats(engine, graphs0, label, dispatched[0], inner,
                          fused)
    emitted = sum(len(r.tokens) for r in reqs)
    served = dt - graphs["capture_s"]      # without warm-ups and captures
    st = {"label": label, "requests": n_requests, "seconds": dt,
          "rounds": sched.stats["rounds"], "emitted_tokens": emitted,
          "tokens_per_s": emitted / dt, "forwards_by_lane": lanes,
          "ms_per_decode_step": 1e3 * dt / engine.decode_steps,
          "ms_per_forward": 1e3 * dt / forwards,
          "tokens_per_s_after_capture": emitted / served,
          "ms_per_decode_step_after_capture":
              1e3 * served / engine.decode_steps,
          "graphs": graphs, "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if engine.scfg.spec_decode:
        st["ms_per_round"] = 1e3 * dt / sched.stats["rounds"]
        st["ms_per_round_after_capture"] = \
            1e3 * served / sched.stats["rounds"]
        for k in ("spec_rounds", "spec_drafted", "spec_accepted"):
            st[k] = sched.stats[k]
        st["accept_rate"] = (st["spec_accepted"] / st["spec_drafted"]
                             if st["spec_drafted"] else None)
    st["prefill_entries"] = sched.stats["admitted_tokens"]
    if admissions:
        ms = sorted(a[1] for a in admissions)
        st["admission"] = {
            "dispatches": len(admissions),
            "requests": [a[0] for a in admissions],
            "host_ms": [a[1] for a in admissions],
            "median_host_ms": ms[len(ms) // 2],
            "prefill_rows": sched.stats["prefill_tokens"]}
        # the decode rounds alone: without captures and admissions
        st["ms_per_decode_step_after_capture_and_admissions"] = (
            1e3 * served - sum(ms)) / engine.decode_steps
        if plan is None and engine.requires_monolithic_admission and \
                len(admissions) != sched.stats["admission_rounds"]:
            raise AssertionError(f"{label}: {len(admissions)} admission "
                                 f"dispatches timed, the Scheduler counts "
                                 f"{sched.stats['admission_rounds']}")
    if engine.paged:
        pool = engine.pool
        st["paged"] = {
            "page_size": engine.scfg.page_size,
            "pool_pages": pool.pages_per_shard,
            "peak_pages": pool.peak_pages,
            "kv_cache_bytes": engine.kv_cache_bytes(SLOTS),
            "dense_kv_bytes": dense_kv_bytes(engine),
            "pool_bytes": engine.page_bytes(SLOTS) * pool.pages_per_shard,
            "prefix_hits": pool.prefix_hits,
            "prefix_fresh": pool.prefix_fresh,
            "prefix_hit_rate": pool.prefix_hit_rate,
            "preemptions": sched.stats["preemptions"],
            "pages_trimmed": trimmed[0],
            "allocated_at_drain": pool.allocated_pages,
            "leaked_at_drain": len(pool.leaked_pages()),
            "validate_calls": len(validate_ms),
            "validate_median_host_ms": _median(validate_ms)}
        if pool.preemptions != sched.stats["preemptions"] \
                or pool.allocated_pages or pool.leaked_pages():
            raise AssertionError(f"{label}: pool at drain {st['paged']}")
    if sched.snapshot_interval:
        st["recovery"] = {
            "recoveries": sched.stats["recoveries"],
            "dispatch_retries": sched.stats["dispatch_retries"],
            "rounds_dispatched": dispatched[0],
            # rounds a restore threw away, each run again after it
            "rounds_replayed_after_restore":
                dispatched[0] - sched.stats["rounds"],
            "snapshots": len(timed_ms["snapshot"]),
            "snapshot_median_host_ms": _median(timed_ms["snapshot"]),
            "restores": len(timed_ms["restore"]),
            "restore_median_host_ms": _median(timed_ms["restore"]),
            "snapshot_bytes": sum(t.numel() * t.element_size()
                                  for t in sched._device_state())}
    log(f"serving[{label}]: {json.dumps(st)}")
    RUNS[label] = st
    return [list(r.tokens) for r in reqs]


def same(a: list, b: list, what: str) -> None:
    if a != b[:len(a)]:
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        raise AssertionError(f"{what}: transcripts differ for requests "
                             f"{diff}")
    log(f"transcripts identical: {what} ({sum(map(len, a))} tokens)")


PROFILES: dict = {}


def profile(label: str, fn, steps: int, forwards: int = 1,
            detail: bool = False) -> None:
    """Device time by kernel over ``steps`` calls of ``fn`` (torch.profiler)
    against their host wall time: the device-busy share.  ``forwards``:
    model forwards per call; ``detail`` also logs every device row (the
    activation quantizer's kernels among them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()                                                 # warm
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, memsets, copies): the CPU ops that
    # launched them report the same time again
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {"calls": steps, "forwards_per_call": forwards,
           "wall_ms_per_call": 1e3 * wall / steps,
           "device_ms_per_call": busy_ms / steps,
           "device_busy_share": busy_ms / (1e3 * wall),
           "top": [{"kernel": k[:60], "ms_per_call": us / 1e3 / steps,
                    "launches_per_call": n / steps}
                   for us, k, n in rows[:6]]}
    log(f"profile[{label}]: " + json.dumps(out))
    if detail:
        log(f"profile rows[{label}]: " + json.dumps(
            [{"kernel": k[:240], "ms_per_call": us / 1e3 / steps,
              "launches_per_call": n / steps} for us, k, n in rows]))
    PROFILES[label] = out


def round_calls(steps: int) -> int:
    """Calls a replayed round's profile reads: half of ``steps`` (rounded
    up).  A round is 8 forwards (a speculative one 4) of tens of thousands
    of kernels whose device time is steady from call to call; reading the
    profiler's trace of each takes seconds."""
    return (steps + 1) // 2


def profile_engine(engine, label: str, steps: int,
                   detail: bool = False, pos0: int = 16,
                   eager: bool = True) -> None:
    """At 8 slots, positions pos0..pos0 + 7, op by op (unless ``eager`` is
    False): a full-batch decode step (``detail``: every device row), or
    for a spec engine a drafter step and a verify forward; then one
    replayed round from the same state: 8 decode iterations, or for a spec
    engine a speculative round."""
    import torch
    if not steps:
        return
    spec = engine.scfg.spec_decode
    cache = engine.init_cache(SLOTS)
    tok = torch.zeros((SLOTS,), dtype=torch.int32, device="cuda")
    pos = torch.arange(SLOTS, dtype=torch.int32, device="cuda") + pos0
    if eager and not spec:
        profile(f"{label} decode step",
                lambda: engine._decode(tok, cache, pos), steps,
                detail=detail)
    elif eager:
        toks = torch.zeros((SLOTS, engine.scfg.draft_k + 1),
                           dtype=torch.int32, device="cuda")
        profile(f"{label} drafter step",
                lambda: engine._decode(tok, cache, pos, "draft"), steps)
        profile(f"{label} verify forward",
                lambda: engine._verify(toks, cache, pos), steps)
    done = torch.zeros((SLOTS,), dtype=torch.bool, device="cuda")
    eos = torch.full((SLOTS,), -1, dtype=torch.int32, device="cuda")
    kind = "speculative" if spec else "decode"
    profile(f"{label} {kind} round, replayed",
            lambda: engine.step(cache, None, tok, pos, done, eos, 8,
                                spec=spec), round_calls(steps),
            forwards=engine.scfg.draft_k + 1 if spec else 8)
    del cache


def sampling_knobs(step0: int = 0) -> dict:
    """``Engine.step``'s sampling arguments for 8 slots of the mix."""
    import torch
    t, k, p = zip(*SAMPLED_MIX)
    return dict(
        temperature=torch.tensor(t, dtype=torch.float32, device="cuda"),
        top_k=torch.tensor(k, dtype=torch.int32, device="cuda"),
        top_p=torch.tensor(p, dtype=torch.float32, device="cuda"),
        step0=step0, greedy=False)


SAMPLING: dict = {}


def profile_sampling(engine, label: str, steps: int) -> None:
    """What the sampling ops cost a replayed decode round (8 iterations,
    8 draws): the device time of the sampled round less the greedy round's
    from the same state (torch.profiler), both rounds' wall ms per step
    without the profiler (interleaved, 3 each), and one ``sample_logits``
    draw at [8, vocab] alone with every device row."""
    import torch
    from repro_torch.core import prng
    from repro_torch.serve import sample_logits
    if not steps:
        return
    cache = engine.init_cache(SLOTS)
    tok = torch.zeros((SLOTS,), dtype=torch.int32, device="cuda")
    pos = torch.arange(SLOTS, dtype=torch.int32, device="cuda") + 16
    done = torch.zeros((SLOTS,), dtype=torch.bool, device="cuda")
    eos = torch.full((SLOTS,), -1, dtype=torch.int32, device="cuda")
    knobs = sampling_knobs(step0=5)
    rounds = {
        "greedy": lambda: engine.step(cache, None, tok, pos, done, eos, 8),
        "sampled": lambda: engine.step(cache, None, tok, pos, done, eos, 8,
                                       **knobs)}
    for kind, fn in rounds.items():
        profile(f"{label} {kind} decode round, replayed", fn,
                round_calls(steps), forwards=8)
    wall = {kind: [] for kind in rounds}
    for _ in range(3):
        for kind, fn in rounds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[kind].append(1e3 * (time.perf_counter() - t0) / 8)
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = 3.0 * torch.randn((SLOTS, engine.cfg.vocab), generator=g,
                               device="cuda")
    key = prng.fold_in(engine.key, 0)
    draw = f"{label} sample_logits [8, vocab] draw"
    profile(draw, lambda: sample_logits(logits, key, knobs["temperature"],
                                        knobs["top_k"], knobs["top_p"]),
            steps, forwards=0, detail=True)
    dev = {kind: PROFILES[f"{label} {kind} decode round, replayed"]
           ["device_ms_per_call"] for kind in rounds}
    extra = dev["sampled"] - dev["greedy"]
    SAMPLING.update({
        "device_ms_per_round": dev,
        "sampling_ops_device_ms_per_round": extra,
        "sampling_ops_share_of_sampled_round": extra / dev["sampled"],
        "draw_device_ms": PROFILES[draw]["device_ms_per_call"],
        "replayed_wall_ms_per_step": {k: sorted(v)[1]
                                      for k, v in wall.items()},
        "replayed_wall_ms_per_step_all": wall})
    log(f"sampling ops[{label}]: {json.dumps(SAMPLING)}")
    del cache, logits


def check_mix(sampled: list, greedy: list, what: str) -> None:
    """The mix's greedy rows equal the all-greedy run's transcripts, and a
    sampled row leaves its greedy transcript."""
    rows = [i for i, (t, _, _) in enumerate(SAMPLED_MIX[:len(sampled)])
            if t <= 0.0]
    same([sampled[i] for i in rows], [greedy[i] for i in rows],
         f"{what}: greedy rows == the all-greedy run")
    moved = [i for i in range(len(sampled))
             if i not in rows and sampled[i] != greedy[i]]
    if not moved:
        raise AssertionError(f"{what}: no sampled request left its greedy "
                             "transcript")
    log(f"{what}: sampled requests {moved} differ from their greedy "
        "transcripts")


def zero_low_planes(params, draft_planes: int = 2) -> int:
    """Zero the low planes of every draftable leaf IN PLACE: a leaf whose
    low planes are zero decodes to exactly 2^(B-p) x its top-plane code,
    so the drafter's logits equal the target's."""
    n = 0
    if isinstance(params, dict):
        q = params.get("w_q")
        if ("w_tmac" in params and "w_tern" not in params and q.dim() >= 3
                and q.shape[-3] > draft_planes):
            q[..., :q.shape[-3] - draft_planes, :, :].zero_()
            return 1
        return sum(zero_low_planes(v, draft_planes) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(zero_low_planes(v, draft_planes) for v in params)
    return 0


def profile_paged_round(dense, paged, steps: int) -> None:
    """One replayed 8-iteration decode round from one state (8 slots at
    positions 16..23) on the dense engine and on the paged one (each row on
    its own pages): their device time's difference is what the page gathers
    and scatters cost a round."""
    import torch
    if not steps:
        return
    tok = torch.zeros((SLOTS,), dtype=torch.int32, device="cuda")
    pos = torch.arange(SLOTS, dtype=torch.int32, device="cuda") + 16
    done = torch.zeros((SLOTS,), dtype=torch.bool, device="cuda")
    eos = torch.full((SLOTS,), -1, dtype=torch.int32, device="cuda")
    dev = {}
    for eng, kind in ((dense, "dense"), (paged, "paged")):
        cache = eng.init_cache(SLOTS)
        if eng.paged:
            for s in range(SLOTS):
                eng.pool.admit(s, [1000 * s + i for i in range(24)])
                eng.pool.ensure(s, 40)
        label = f"qwen lut {kind} decode round, replayed"
        profile(label, lambda: eng.step(cache, None, tok, pos, done, eos, 8),
                round_calls(steps), forwards=8)
        dev[kind] = PROFILES[label]["device_ms_per_call"]
        del cache
    log(f"paged round[qwen lut]: device ms per replayed 8-iteration round "
        f"{json.dumps(dev)}, paged - dense {dev['paged'] - dev['dense']}")


def paged_summary(labels: list) -> None:
    """The paged runs' figures on one line."""
    out = {}
    for label in labels:
        st = RUNS[label]
        out[label] = {k: st[k] for k in (
            "ms_per_decode_step", "ms_per_decode_step_after_capture",
            "tokens_per_s", "tokens_per_s_after_capture", "rounds",
            "prefill_entries")}
        out[label]["keys_captured"] = st["graphs"]["keys_captured"]
        out[label]["capture_s"] = st["graphs"]["capture_s"]
        out[label].update(st.get("paged", {}))
        for k in ("ms_per_round", "ms_per_round_after_capture",
                  "spec_rounds"):
            if k in st:
                out[label][k] = st[k]
    log("paged runs: " + json.dumps(out))


def run_paged_lut(engine, cfg, V: int, lut: list, lut_s: list,
                  profile_steps: int) -> None:
    """The paged KV cache (4-token pages, max_len 256) on the lut codes of
    the dense ``engine``: greedy, the sampled mix, the plain backend, a
    shared 32-token prefix (with and without prefix reuse, against the
    dense engine over the same requests) and a pool of about half the
    uncontended peak, or the longest request's own need where that is more
    (preemptions)."""
    import dataclasses
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve import ServeConfig, make_engine
    scfg = ServeConfig(max_len=256, seed=SAMPLE_SEED, paged=True,
                       page_size=4)
    paged = make_engine(engine.params, cfg, scfg)
    log(f"paged engine: pool of {paged.scfg.num_pages or 'auto'} pages of "
        f"{scfg.page_size} tokens, prefill chunk {paged.prefill_chunk}")
    same(serve(paged, V, "qwen lut fused paged", 8, "lutmul"), lut,
         "lut fused paged == lut fused")
    peak = RUNS["qwen lut fused paged"]["paged"]["peak_pages"]
    profile_paged_round(engine, paged, profile_steps)
    same(serve(paged, V, "qwen lut fused paged sampled, 4", 4, "lutmul",
               sampled=True), lut_s,
         "lut fused paged sampled == lut fused sampled")
    if RUNS["qwen lut fused paged sampled, 4"]["paged"]["prefix_hits"]:
        raise AssertionError("the sampled paged run shared prefix pages: its "
                             "rounds would differ from the dense run's")
    ops.set_backend("ref")
    same(serve(paged, V, "qwen lut paged plain", 1), lut,
         "lut paged plain == lut fused")
    ops.set_backend("cuda")
    # a shared prefix: paged with and without reuse against dense
    shared = serve(engine, V, "qwen lut fused, shared prefix", 8, "lutmul",
                   reqs=prefix_requests(V))
    same(serve(paged, V, "qwen lut fused paged, shared prefix", 8, "lutmul",
               reqs=prefix_requests(V)), shared,
         "lut fused paged, shared prefix == lut fused, shared prefix")
    plain = make_engine(engine.params, cfg,
                        dataclasses.replace(scfg, prefix_reuse=False))
    same(serve(plain, V, "qwen lut fused paged, shared prefix, no reuse", 8,
               "lutmul", reqs=prefix_requests(V)), shared,
         "lut fused paged, no reuse == lut fused, shared prefix")
    del plain
    reuse = RUNS["qwen lut fused paged, shared prefix"]
    no_reuse = RUNS["qwen lut fused paged, shared prefix, no reuse"]
    if not (reuse["paged"]["prefix_hits"] > 0
            and no_reuse["paged"]["prefix_hits"] == 0
            and reuse["paged"]["peak_pages"]
            < no_reuse["paged"]["peak_pages"]):
        raise AssertionError(f"prefix reuse: {reuse['paged']} against "
                             f"{no_reuse['paged']} without")
    log(f"prefix reuse: hit rate {reuse['paged']['prefix_hit_rate']}, peak "
        f"pages {reuse['paged']['peak_pages']} (no reuse "
        f"{no_reuse['paged']['peak_pages']}), prefill entries "
        f"{reuse['prefill_entries']} (no reuse "
        f"{no_reuse['prefill_entries']}, dense "
        f"{RUNS['qwen lut fused, shared prefix']['prefill_entries']})")
    # a pool of about half the uncontended run's peak, but never below what
    # the longest request needs alone with its round ahead: preemptions
    longest = max(len(r.prompt) + r.max_new_tokens for r in make_requests(V))
    alone = -(-(longest + 8 - 1) // scfg.page_size)
    tight = make_engine(engine.params, cfg, dataclasses.replace(
        scfg, num_pages=max(peak // 2, alone) + 1))
    same(serve(tight, V, "qwen lut fused paged, contended", 8, "lutmul"),
         lut, "lut fused paged, contended == lut fused")
    if RUNS["qwen lut fused paged, contended"]["paged"]["preemptions"] < 1:
        raise AssertionError("the contended paged run preempted nothing")
    del tight, paged


INT8: dict = {}


def profile_int8_round(bf16, int8, steps: int) -> None:
    """One replayed 8-iteration decode round from one state (8 slots at
    positions 16..23) on the bf16-KV engine and on the int8 one: their
    device time's difference is what the int8 attention costs a round."""
    import torch
    if not steps:
        return
    tok = torch.zeros((SLOTS,), dtype=torch.int32, device="cuda")
    pos = torch.arange(SLOTS, dtype=torch.int32, device="cuda") + 16
    done = torch.zeros((SLOTS,), dtype=torch.bool, device="cuda")
    eos = torch.full((SLOTS,), -1, dtype=torch.int32, device="cuda")
    dev = {}
    for eng, kind in ((bf16, "bf16"), (int8, "int8")):
        cache = eng.init_cache(SLOTS)
        label = f"qwen lut {kind} KV decode round, replayed"
        profile(label, lambda: eng.step(cache, None, tok, pos, done, eos, 8),
                round_calls(steps), forwards=8)
        dev[kind] = PROFILES[label]["device_ms_per_call"]
        del cache
    INT8["round_device_ms"] = dev
    log(f"int8 round[qwen lut]: device ms per replayed 8-iteration round "
        f"{json.dumps(dev)}, int8 - bf16 {dev['int8'] - dev['bf16']}")


def int8_summary(cfg, int8, paged, lut8: list, lut: list,
                 bf16_label: str) -> None:
    """The int8 runs' figures on one line, beside the bf16 run's."""
    from repro_torch.models import transformer
    bf16 = dict(RUNS[bf16_label])
    toks = [(a, b) for x, y in zip(lut8, lut) for a, b in zip(x, y)]
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                  len(x)) for x, y in zip(lut8, lut)]
    INT8.update({
        "kv_cache_bytes": {"int8": int8.kv_cache_bytes(SLOTS),
                           "bf16": dense_kv_bytes(int8)},
        "page_bytes": {"int8": paged.page_bytes(SLOTS),
                       "bf16": paged.scfg.page_size
                       * transformer.kv_bytes_per_position(cfg)},
        "ms_per_decode_step_after_capture": {
            "bf16": bf16["ms_per_decode_step_after_capture"],
            **{label: RUNS[label]["ms_per_decode_step_after_capture"]
               for label in RUNS if "int8" in label}},
        "runs": {label: {k: st.get(k) for k in (
            "ms_per_decode_step", "ms_per_decode_step_after_capture",
            "tokens_per_s_after_capture", "rounds", "admission")}
            | ({"peak_pages": st["paged"]["peak_pages"],
                "kv_cache_bytes": st["paged"]["kv_cache_bytes"]}
               if "paged" in st else {})
            for label, st in RUNS.items() if "int8" in label},
        "greedy_tokens_equal_to_bf16": sum(a == b for a, b in toks)
        / len(toks),
        "first_divergence_by_request": first})
    log("int8 runs: " + json.dumps(INT8))


def run_int8_lut(engine, cfg, V: int, lut: list, profile_steps: int,
                 bf16_label: str) -> list:
    """The int8 KV cache (``kv_quant="int8"``, max_len 256) on the lut
    codes of the bf16 ``engine``, every request admitted monolithically:
    the 8 contract requests dense and paged (equal), 8 equal-length prompts
    filling all 8 slots in one admission dispatch (dense == paged), the
    plain backend over the first one (== fused).  ``bf16_label`` names the
    bf16 run of ``lut``.  Returns the int8 lut transcripts."""
    import dataclasses
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve import ServeConfig, make_engine
    cfg8 = dataclasses.replace(cfg, kv_quant="int8")
    scfg = ServeConfig(max_len=256, seed=SAMPLE_SEED)
    int8 = make_engine(engine.params, cfg8, scfg)
    check_int8_bytes(int8, engine)
    lut8 = serve(int8, V, "qwen lut fused int8", 8, "lutmul")
    paged = make_engine(engine.params, cfg8, dataclasses.replace(
        scfg, paged=True, page_size=4))
    same(serve(paged, V, "qwen lut fused int8 paged", 8, "lutmul"), lut8,
         "lut fused int8 paged == lut fused int8")
    eq = serve(int8, V, "qwen lut int8, equal lengths", 8, "lutmul",
               reqs=equal_requests(V))
    adm = RUNS["qwen lut int8, equal lengths"]["admission"]
    if adm["requests"] != [SLOTS]:
        raise AssertionError(f"equal lengths: admissions {adm['requests']}, "
                             f"expected one dispatch of {SLOTS}")
    same(serve(paged, V, "qwen lut int8 paged, equal lengths", 8, "lutmul",
               reqs=equal_requests(V)), eq,
         "lut int8 paged, equal lengths == lut int8, equal lengths")
    profile_int8_round(engine, int8, profile_steps)
    ops.set_backend("ref")
    same(serve(int8, V, "qwen lut int8 plain", 1), lut8,
         "lut int8 plain == lut fused int8")
    ops.set_backend("cuda")
    int8_summary(cfg, int8, paged, lut8, lut, bf16_label)
    del int8, paged
    return lut8


def _event_ms(fn, reps: int) -> float:
    """Median ms of ``reps`` calls of ``fn``, each timed with CUDA events
    around the call alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return _median(times)


def _graph_ms(fn, reps: int) -> float:
    """Median ms of ``reps`` replays of ``fn`` captured alone in a CUDA
    graph (as it runs inside a round: no host gaps between its kernels),
    timed with CUDA events around each replay."""
    import torch
    from repro_torch.serve.graphs import no_gc
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                             # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with no_gc(), torch.cuda.graph(g, stream=stream):
        fn()
    return _event_ms(g.replay, reps)


# the faults stage: (name, ServeConfig extras, int8 KV, faults as
# (site, index, kind, duration), the fault-free transcripts it must equal,
# sampled)
FAULT_CASES = [
    ("dense", {}, False, [("decode", 1, "nan_logits", 0.01),
                          ("admit", 2, "dispatch", 0.01),
                          ("decode", 3, "page_table", 0.01),
                          ("decode", 5, "stall", 0.01)], "lut", False),
    ("paged", {"paged": True, "page_size": 4}, False,
     [("decode", 1, "page_table", 0.01), ("decode", 3, "nan_logits", 0.01)],
     "lut", False),
    ("int8", {}, True, [("admit", 1, "dispatch", 0.01),
                        ("decode", 1, "nan_logits", 0.01)], "lut8", False),
    ("sampled", {}, False, [("decode", 2, "nan_logits", 0.01)], "lut_s",
     True),
]
FAULT_REQUESTS = 4


def run_faults(engine, cfg, V: int, lut: list, lut_s: list,
               lut8: list) -> None:
    """Fault injection and snapshot/restore recovery at full width on the
    lut codes of ``engine``: for each ``FAULT_CASES`` configuration a fresh
    engine serves the first 4 contract requests through ``Scheduler(slots=8,
    chunk=8, snapshot_interval=1, max_retries=3)``, fault-free, then (with
    that Scheduler kept alive, so the faulted run's cache has addresses of
    its own) under the case's ``FaultPlan``.  Both equal the configuration's
    fault-free transcripts; no fault stays pending, the dense page-table
    fault is skipped, every dispatch fault is one dispatch retry, at least
    one recovery, every round a replayed graph, and the faulted run
    captures as many graph keys as its fault-free twin (a restore moves no
    tensor).  Then, on each cache, the sweep's verdict (clean, then one
    NaN, +Inf or -Inf planted), its device ms alone beside its replayed
    round, and the pool audit's host ms a dispatch."""
    import dataclasses
    from repro_torch.serve import Fault, FaultPlan, ServeConfig, make_engine
    from repro_torch.serve.engine import _cache_finite
    t0 = time.perf_counter()
    want = {"lut": lut, "lut_s": lut_s, "lut8": lut8}
    kw = dict(snapshot_interval=1, max_retries=3)
    held, out = {}, {}
    for name, extra, int8, faults, ref, sampled in FAULT_CASES:
        c = dataclasses.replace(cfg, kv_quant="int8") if int8 else cfg
        eng = make_engine(engine.params, c, ServeConfig(
            max_len=256, seed=SAMPLE_SEED, **extra))
        label = f"qwen lut faults[{name}]"
        hold = []
        same(serve(eng, V, label + " fault-free", FAULT_REQUESTS, "lutmul",
                   sampled=sampled, sched_kw=kw, hold=hold), want[ref],
             f"{label} fault-free == {ref}")
        plan = FaultPlan([Fault(site, i, kind, duration=d)
                          for site, i, kind, d in faults])
        same(serve(eng, V, label, FAULT_REQUESTS, "lutmul", sampled=sampled,
                   plan=plan, sched_kw=kw, hold=hold), want[ref],
             f"{label} == {ref}")
        st, twin = RUNS[label], RUNS[label + " fault-free"]
        rec = st["recovery"]
        n_dispatch = sum(f.kind == "dispatch" for f in plan.faults)
        skipped = [f.kind for f in plan.faults if f.skipped]
        keys, twin_keys = (st["graphs"]["keys_captured"],
                           twin["graphs"]["keys_captured"])
        if (plan.pending or rec["recoveries"] < 1
                or rec["dispatch_retries"] != n_dispatch
                or skipped != (["page_table"] if name == "dense" else [])
                or keys != twin_keys or twin["recovery"]["recoveries"]):
            raise AssertionError(
                f"{label}: pending {plan.pending}, skipped {skipped}, "
                f"{rec}, keys captured {keys} (fault-free {twin_keys})")
        out[name] = {**rec, "rounds": st["rounds"],
                     "tokens_per_s": st["tokens_per_s"],
                     "tokens_per_s_after_capture":
                         st["tokens_per_s_after_capture"],
                     "keys_captured": keys,
                     "fault_free_keys_captured": twin_keys,
                     "fault_free_tokens_per_s": twin["tokens_per_s"],
                     "fault_free_snapshot_median_host_ms":
                         twin["recovery"]["snapshot_median_host_ms"],
                     "faults": [[f.site, f.index, f.kind, f.fired,
                                 f.skipped] for f in plan.faults]}
        if "paged" in st:
            out[name]["validate_median_host_ms"] = \
                st["paged"]["validate_median_host_ms"]
            out[name]["validate_calls"] = st["paged"]["validate_calls"]
        log(f"faults[{label}]: " + json.dumps(out[name]))
        held[name] = (eng, hold[-1])
    # the sweep alone on each full-width cache, beside a replayed round of
    # that cache (the round includes its sweep)
    rounds = {"dense": "qwen lut decode round, replayed",
              "paged": "qwen lut paged decode round, replayed",
              "int8": "qwen lut int8 KV decode round, replayed"}
    sweep = {}
    for name, label in rounds.items():
        cache = held[name][1].cache
        leaves = [t for c in cache for t in c.values()
                  if t.is_floating_point()]
        # the verdict on the card: clean, then one NaN, +Inf or -Inf in the
        # middle of the last float leaf (put back after)
        flat = leaves[-1].view(-1)
        at = flat.numel() // 2 + 3
        kept = flat[at].clone()
        verdicts = [bool(_cache_finite(cache))]
        for value in (float("nan"), float("inf"), float("-inf")):
            flat[at] = value
            verdicts.append(bool(_cache_finite(cache)))
            flat[at] = kept
        if verdicts != [True, False, False, False]:
            raise AssertionError(f"cache sweep[{name}]: verdicts {verdicts} "
                                 "for clean, NaN, +Inf, -Inf")
        sweep[name] = {
            "sweep_device_ms": _graph_ms(lambda: _cache_finite(cache), 20),
            "sweep_eager_ms": _event_ms(lambda: _cache_finite(cache), 20),
            "float_leaves": len(leaves),
            "bytes_swept": sum(t.numel() * t.element_size()
                               for t in leaves),
            "replayed_round_device_ms":
                PROFILES.get(label, {}).get("device_ms_per_call")}
    log("cache sweep[qwen lut]: " + json.dumps(sweep))
    FAULTS.update(runs=out, sweep=sweep)
    del held
    log(f"faults stage: {time.perf_counter() - t0:.1f}s")


FAULTS: dict = {}

# the QoS stage's overload trace: ``benchmarks/serving_bench.py``'s
# ``_overload_rows`` scaled from 2 slots to 8 (prompts of 16, budgets 8-32,
# ten arrivals a tick, deadlines arrival + 4 on half the priority-0
# requests, ``random.Random(0)``), on a pool of 15 pages of 4 (PERF.md §4:
# at 97 the 8-token chunk lane admits too slowly for the pool to fill)
QOS_N, QOS_PROMPT, QOS_RATE, QOS_MAX_LEN, QOS_PAGES = 96, 16, 10.0, 64, 15
QOS_SCHED = dict(shed_watermark=0.6, overload_queue=12)
QOS_FAULTS = [("decode", 3, "nan_logits"), ("decode", 9, "nan_logits")]
# the save/load cases: (name, ServeConfig extras, int8 KV, requests,
# sampled, the transcripts the loaded run must equal, requests of the warm
# run: every round key the loaded run needs — a sampled mix can end on an
# all-greedy round, so its warm run is the same requests)
SAVE_LOAD_CASES = [
    ("dense bf16", {}, False, 8, False, "lut", 1),
    ("sampled", {}, False, 4, True, "lut_s", 4),
    ("paged int8", {"paged": True, "page_size": 4}, True, 8, False, "lut8",
     1),
]
SAVE_LOAD_ROUNDS = 3


def qos_trace(vocab: int) -> tuple:
    """The overload trace's (prompts, budgets, priorities, arrivals,
    deadlines), drawn in ``_overload_rows``' order."""
    import random
    rng = random.Random(0)
    n = QOS_N
    prompts = [[rng.randrange(vocab) for _ in range(QOS_PROMPT)]
               for _ in range(n)]
    budgets = [rng.randint(8, 32) for _ in range(n)]
    prios = [rng.randint(0, 1) for _ in range(n)]
    arrivals = [i / QOS_RATE for i in range(n)]
    deadlines = [arrivals[i] + 4.0 if prios[i] == 0 and rng.random() < 0.5
                 else None for i in range(n)]
    return prompts, budgets, prios, arrivals, deadlines


def _latency_ticks(reqs: list) -> dict:
    lats = sorted(r.finish_time - r.arrival_time for r in reqs
                  if r.finish_reason in ("eos", "length"))
    return {"p50_latency_ticks": lats[len(lats) // 2],
            "p99_latency_ticks":
                lats[min(len(lats) - 1, int(len(lats) * 0.99))]}


def run_qos(engine, cfg, V: int, lut: list, lut_s: list,
            lut8: list) -> None:
    """The Scheduler's logical clock and QoS policies, then save/load, at
    full width on the lut codes of ``engine``.

    The overload trace (``qos_trace``) on a paged engine (max_len 64, 15
    pages of 4) through ``Scheduler(slots=8, chunk=8, shed_watermark=0.6,
    overload_queue=12)``, one logical tick a step: twice (the first
    Scheduler kept alive, so the second captures its own keys: as many),
    every request's outcome and the shed, timed-out and preemption counts
    equal across the two and each count > 0; then under two NaN faults
    with a snapshot every round (>= 2 recoveries, no page leak).  Every
    request that emitted tokens is held against an uncontended dense run
    of the same prompts and budgets (max_len 64): a served transcript
    equal, a timed-out or shed one a prefix.

    Save/load (``SAVE_LOAD_CASES``), each on a fresh engine: Scheduler A
    serves 3 rounds and saves into a temporary directory; Scheduler B on
    the same engine drains a warm run (its round keys captured), loads A's
    checkpoint in place and drains: its transcripts equal the contract's
    (lut, lut_s, lut8) and it captures no key after the load.  Prints
    ``qos[...]`` and ``checkpoint[...]`` lines."""
    import dataclasses
    import importlib.util
    import shutil
    import tempfile
    import torch
    from repro_torch.ckpt import checkpoint as ckpt_lib
    from repro_torch.serve import (Fault, FaultPlan, Request, Scheduler,
                                   ServeConfig, make_engine)
    t0 = time.perf_counter()
    prompts, budgets, prios, arrivals, deadlines = qos_trace(V)

    def trace():
        return [Request(prompt=p, max_new_tokens=b, priority=pr, deadline=d)
                for p, b, pr, d in zip(prompts, budgets, prios, deadlines)]

    def drive(sched, reqs):
        idx, t = 0, 0.0
        while idx < len(reqs) or sched.has_work:
            while idx < len(reqs) and arrivals[idx] <= t:
                sched.submit(reqs[idx], now=t)
                idx += 1
            sched.step(now=t)
            t += 1.0
            if t > 4096:
                raise AssertionError("the overload trace did not drain")
        sched.check_drained()

    qeng = make_engine(engine.params, cfg, ServeConfig(
        max_len=QOS_MAX_LEN, paged=True, page_size=4, num_pages=QOS_PAGES,
        seed=SAMPLE_SEED))
    hold, runs = [], {}
    for name, plan, kw in (
            ("run 1", None, {}), ("run 2", None, {}),
            ("faulted", FaultPlan([Fault(site, i, kind)
                                   for site, i, kind in QOS_FAULTS]),
             dict(snapshot_interval=1, max_retries=4))):
        label = f"qwen lut qos overload, {name}"
        reqs = trace()
        serve(qeng, V, label, QOS_N, "lutmul", reqs=reqs, plan=plan,
              sched_kw={**QOS_SCHED, **kw}, hold=hold, drive=drive)
        sched, st = hold[-1], RUNS[label]
        runs[name] = (reqs, sched, st, plan)
        for r in reqs:
            if r.finish_reason == "length" and \
                    len(r.tokens) != r.max_new_tokens:
                raise AssertionError(f"{label}: served {len(r.tokens)} of "
                                     f"{r.max_new_tokens}")
    r1, s1, st1, _ = runs["run 1"]
    r2, s2, st2, _ = runs["run 2"]
    counts = ("shed", "timed_out", "preemptions")
    deterministic = ([r.finish_reason for r in r1]
                     == [r.finish_reason for r in r2]
                     and all(s1.stats[k] == s2.stats[k] for k in counts))
    if not deterministic or not all(s1.stats[k] > 0 for k in counts):
        raise AssertionError(f"qos overload: deterministic {deterministic}, "
                             f"run 1 {[s1.stats[k] for k in counts]}, "
                             f"run 2 {[s2.stats[k] for k in counts]}")
    if st2["graphs"]["keys_captured"] != st1["graphs"]["keys_captured"]:
        raise AssertionError(f"qos overload: run 2 captured "
                             f"{st2['graphs']['keys_captured']} keys, run 1 "
                             f"{st1['graphs']['keys_captured']}")
    rf, sf, stf, plan = runs["faulted"]
    if plan.pending or sf.stats["recoveries"] < 2:
        raise AssertionError(f"qos faulted: pending {plan.pending}, "
                             f"recoveries {sf.stats['recoveries']}")
    # the uncontended reference: every request that emitted tokens in any
    # run, with its whole budget, on a dense engine of the same max_len
    emitted = sorted({i for reqs in (r1, r2, rf)
                      for i, r in enumerate(reqs) if r.tokens})
    deng = make_engine(engine.params, cfg, ServeConfig(
        max_len=QOS_MAX_LEN, seed=SAMPLE_SEED))
    free = serve(deng, V, "qwen lut qos uncontended", len(emitted),
                 "lutmul", reqs=[Request(prompt=prompts[i],
                                         max_new_tokens=budgets[i])
                                 for i in emitted])
    want = dict(zip(emitted, free))
    for name, (reqs, sched, st, _) in runs.items():
        for i, r in enumerate(reqs):
            full = want.get(i, [])
            if r.finish_reason == "length" and r.tokens != full:
                raise AssertionError(f"qos {name}: request {i} served "
                                     "!= uncontended")
            if r.tokens != full[:len(r.tokens)]:
                raise AssertionError(f"qos {name}: request {i} "
                                     f"({r.finish_reason}) is not a prefix "
                                     "of the uncontended transcript")
        served = [r for r in reqs if r.finish_reason == "length"]
        out = {"requests": len(reqs), "served": len(served),
               **{k: sched.stats[k] for k in counts},
               "shed_after_preemption": sum(
                   1 for r in reqs if r.finish_reason == "shed" and r.tokens),
               "recoveries": sched.stats["recoveries"],
               "rounds": sched.stats["rounds"],
               "ticks": sched._ticks,
               **_latency_ticks(reqs),
               "mean_occupancy": sched.mean_occupancy,
               "tokens_per_s": st["tokens_per_s"],
               "tokens_per_s_after_capture":
                   st["tokens_per_s_after_capture"],
               "ms_per_decode_step_after_capture":
                   st["ms_per_decode_step_after_capture"],
               "keys_captured": st["graphs"]["keys_captured"],
               "capture_s": st["graphs"]["capture_s"],
               "seconds": st["seconds"],
               "peak_pages": st["paged"]["peak_pages"],
               "deterministic": deterministic}
        if name == "faulted":
            out["faults"] = [[f.site, f.index, f.kind, f.fired, f.skipped]
                             for f in plan.faults]
            out["recovery"] = st["recovery"]
        log(f"qos[{name}]: " + json.dumps(out))
    log(f"transcripts: qos served == uncontended, partial == prefix "
        f"({len(emitted)} requests with tokens)")
    del hold, runs, qeng, deng
    t_qos = time.perf_counter() - t0

    # save / load
    t1 = time.perf_counter()
    want = {"lut": lut, "lut_s": lut_s, "lut8": lut8}
    for name, extra, int8, n, sampled, ref, n_warm in SAVE_LOAD_CASES:
        c = dataclasses.replace(cfg, kv_quant="int8") if int8 else cfg
        eng = make_engine(engine.params, c, ServeConfig(
            max_len=256, seed=SAMPLE_SEED, **extra))
        reqs = make_requests(V, sampled=sampled)[:n]
        a = Scheduler(eng, slots=SLOTS, chunk=8)
        for r in reqs:
            a.submit(r)
        for _ in range(SAVE_LOAD_ROUNDS):
            a.step()
        if not a.has_work:
            raise AssertionError(f"checkpoint[{name}]: drained before save")
        d = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        try:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            a.save(d)
            save_ms = 1e3 * (time.perf_counter() - ts)
            step_dir = os.path.join(d, f"step_{a._ticks:08d}")
            on_disk = sum(os.path.getsize(os.path.join(step_dir, f))
                          for f in os.listdir(step_dir))
            raw = sum(t.numel() * t.element_size()
                      for t in a._device_state())
            codec = ckpt_lib.manifest(d)["codec"]
            step_a = a._step
            del a
            b = Scheduler(eng, slots=SLOTS, chunk=8)
            b.run(make_requests(V, sampled=sampled)[:n_warm])
            keys = len(eng.graphs.rounds)
            torch.cuda.synchronize()
            tl = time.perf_counter()
            b.load(d)
            torch.cuda.synchronize()
            load_ms = 1e3 * (time.perf_counter() - tl)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        if b._step != step_a:
            raise AssertionError(f"checkpoint[{name}]: draw counter "
                                 f"{b._step} != {step_a}")
        b.run()
        got = {tuple(r.prompt): list(r.tokens) for r in b.finished}
        same([got[tuple(r.prompt)] for r in reqs], want[ref],
             f"checkpoint[{name}] loaded == {ref}")
        new_keys = len(eng.graphs.rounds) - keys
        if new_keys:
            raise AssertionError(f"checkpoint[{name}]: {new_keys} keys "
                                 "captured after the load")
        out = {"requests": n, "rounds_before_save": SAVE_LOAD_ROUNDS,
               "bytes_on_disk": on_disk, "raw_bytes": raw, "codec": codec,
               "save_host_ms": save_ms, "load_host_ms": load_ms,
               "keys_before_load": keys,
               "keys_captured_after_load": new_keys,
               "msgpack_importable":
                   importlib.util.find_spec("msgpack") is not None,
               "zstandard_importable":
                   importlib.util.find_spec("zstandard") is not None}
        log(f"checkpoint[{name}]: " + json.dumps(out))
        del b, eng
    log(f"qos stage: {time.perf_counter() - t0:.1f}s (overload "
        f"{t_qos:.1f}s, save/load {time.perf_counter() - t1:.1f}s)")


def run_qwen(n_layers: int, profile_steps: int) -> None:
    """qwen2-7b at its own depth (28 layers): w4a4_lut fused over the 8
    contract requests and a profile; every other qwen2-7b run is on the
    ``CUT_LAYERS`` model (``run_cut_depth``)."""
    import torch
    from repro_torch.configs import qwen2_7b
    from repro_torch.kernels.lutmul import ops

    cfg = depth(qwen2_7b.config(quant="w4a4_lut"), n_layers)
    engine = new_engine(cfg, 256, "qwen2-7b")
    ops.set_backend("cuda")
    ops.set_variant(None)
    serve(engine, cfg.vocab, "qwen lut fused", 8, "lutmul")
    profile_engine(engine, "qwen lut", profile_steps, detail=True)
    del engine
    torch.cuda.empty_cache()
    run_cut_depth(n_layers, profile_steps)


def depth(cfg, n_layers):
    """``cfg`` cut to ``SERVED_LAYERS`` (where it names the model) and to
    ``n_layers`` layers (None: no further cut), an encoder's too."""
    import dataclasses
    n_layers = min(n_layers or cfg.n_layers,
                   SERVED_LAYERS.get(cfg.name, cfg.n_layers))
    if n_layers >= cfg.n_layers:
        return cfg
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        n_enc_layers=min(cfg.n_enc_layers, n_layers))


def new_engine(cfg, max_len: int, label: str, bits_plan: dict = None,
               mode: str = None):
    """Seeded random weights (seed 0) on the card, each layer quantized to
    ``mode`` (default ``cfg.quant``; ``bits_plan``: a leaf's own mode) as
    it is made (``serve.quantize.init_served_params``: the codes of
    quantizing ``init_params``' tree, which is never whole on the card; a
    tied embedding stays float, as the head reads it), served by
    ``make_engine`` under ``cfg.quant`` and the plan.  Logs the init and
    the peak device memory in it."""
    import torch
    from repro_torch.serve import ServeConfig, make_engine
    from repro_torch.serve.quantize import init_served_params
    reset_peak(empty=True)
    held_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = init_served_params(cfg, mode or cfg.quant, seed=0,
                                device="cuda", bits_plan=bits_plan)
    engine = make_engine(params, cfg, ServeConfig(
        quant=cfg.quant, max_len=max_len, seed=SAMPLE_SEED,
        bits_plan=bits_plan))
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"model: {label} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.quant}; init + quantize "
        f"{time.perf_counter() - t0:.1f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while the "
        f"served tree was made ({held_gib:.2f} held before it); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    return engine


def run_cut_depth(n_layers, profile_steps: int) -> None:
    """qwen2-7b at full width and ``CUT_LAYERS`` layers (fewer under
    ``--layers``): lut fused over the 8 requests, the sampled mix over the
    8 (its greedy rows equal the lut run's; the sampling ops profiled) and
    over 4, the int8 KV stage (``run_int8_lut``); the lut unfused runs (4,
    greedy and sampled) and the plain lut runs (1, greedy and sampled)
    against them; w4a4_tmac codes of the same float weights and the
    speculative stage (``run_cut_tmac``); then the paged, faults and QoS
    stages (``run_paged_lut``, ``run_faults``, ``run_qos``)."""
    import dataclasses
    from repro_torch.configs import qwen2_7b
    from repro_torch.kernels.lutmul import ops
    layers = min(CUT_LAYERS, n_layers or CUT_LAYERS)
    cfg = dataclasses.replace(qwen2_7b.config(quant="w4a4_lut"),
                              n_layers=layers)
    V = cfg.vocab
    q = f"qwen{layers}"
    engine = new_engine(cfg, 256, "qwen2-7b (paged, faults and QoS stages)")
    ops.set_backend("cuda")
    ops.set_variant(None)
    lut = serve(engine, V, f"{q} lut fused", 8, "lutmul")
    check_mix(serve(engine, V, f"{q} lut fused sampled", 8, "lutmul",
                    sampled=True), lut, f"{q} lut fused sampled")
    profile_sampling(engine, f"{q} lut", profile_steps)
    lut_s = serve(engine, V, f"{q} lut fused sampled, 4", 4,
                  "lutmul", sampled=True)
    lut8 = run_int8_lut(engine, cfg, V, lut, profile_steps, f"{q} lut fused")
    ops.set_variant("unfused")
    same(serve(engine, V, f"{q} lut unfused", 4, "lutmul", fused=False),
         lut, f"{q} lut unfused == {q} lut fused")
    same(serve(engine, V, f"{q} lut unfused sampled", 4, "lutmul",
               fused=False, sampled=True), lut_s,
         f"{q} lut unfused sampled == {q} lut fused sampled")
    ops.set_variant(None)
    # a sampled transcript depends on the batch: the plain backend's
    # sampled request is held against a fused run of the same one
    lut_s1 = serve(engine, V, f"{q} lut fused sampled, 1", 1, "lutmul",
                   sampled=True)
    ops.set_backend("ref")
    same(serve(engine, V, f"{q} lut plain", 1), lut,
         f"{q} lut plain == {q} lut fused")
    same(serve(engine, V, f"{q} lut plain sampled", 1, sampled=True), lut_s1,
         f"{q} lut plain sampled == {q} lut fused sampled")
    ops.set_backend("cuda")
    run_cut_tmac(cfg, V, q, lut, lut_s, lut8, profile_steps)
    run_paged_lut(engine, cfg, V, lut, lut_s, profile_steps)
    run_faults(engine, cfg, V, lut, lut_s, lut8)
    run_qos(engine, cfg, V, lut, lut_s, lut8)
    paged_summary([k for k in RUNS if "paged" in RUNS[k]])


def run_cut_tmac(cfg, V: int, q: str, lut: list, lut_s: list, lut8: list,
                 profile_steps: int) -> None:
    """w4a4_tmac bitplanes of the cut model's float weights (seed 0, made a
    layer at a time): fused over the 8 requests (== the lut run ``lut``: w4
    bitplanes decode to the nibble codes), the sampled mix over 4 (== the
    lut run ``lut_s``), unfused over 4 and the plain backend over the
    first (== fused), a decode step and round profiled; int8 KV over 4
    (== the int8 lut run ``lut8``); bitplane
    self-speculative decoding on the same codes, greedy over the 8 (== the
    fused run, with a drafter step, a verify forward and a speculative
    round profiled) and paged over 4 (rejected blocks trimmed), and at
    temperature > 0 over one request, graph and plain (drafts and verify
    columns draw their own keys, so the accept rate is reported, not
    asserted); last, speculation after zeroing the low two planes in place
    (4 requests, every draft accepted)."""
    import dataclasses
    import torch
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve import ServeConfig, make_engine
    tmac = new_engine(dataclasses.replace(cfg, quant="w4a4_tmac"), 256,
                      "qwen2-7b (cut, w4a4_tmac)")
    fused = serve(tmac, V, f"{q} tmac fused", 8, "lutmul_tmac")
    TRANSCRIPTS["tmac cut"] = (cfg.n_layers, fused)
    same(fused, lut, f"{q} tmac fused == {q} lut fused")
    same(serve(tmac, V, f"{q} tmac fused sampled", 4, "lutmul_tmac",
               sampled=True), lut_s,
         f"{q} tmac fused sampled == {q} lut fused sampled")
    profile_engine(tmac, f"{q} tmac", profile_steps)
    ops.set_variant("unfused")
    same(serve(tmac, V, f"{q} tmac unfused", 4, "lutmul_tmac", fused=False),
         fused, f"{q} tmac unfused == {q} tmac fused")
    ops.set_variant(None)
    ops.set_backend("ref")
    same(serve(tmac, V, f"{q} tmac plain", 1), fused,
         f"{q} tmac plain == {q} tmac fused")
    ops.set_backend("cuda")
    tmac8 = make_engine(tmac.params, dataclasses.replace(
        tmac.cfg, kv_quant="int8"), ServeConfig(max_len=256,
                                                seed=SAMPLE_SEED))
    same(serve(tmac8, V, f"{q} tmac fused int8", 4, "lutmul_tmac"), lut8,
         f"{q} tmac fused int8 == {q} lut fused int8")
    del tmac8
    spec = make_engine(tmac.params, tmac.cfg, ServeConfig(
        max_len=256, spec_decode=True, draft_planes=2, draft_k=3,
        seed=SAMPLE_SEED))
    log(f"spec engine: {spec.n_draftable_leaves} draftable leaves")
    same(serve(spec, V, f"{q} tmac spec", 8, "lutmul_tmac"), fused,
         f"{q} tmac spec == {q} tmac fused")
    if RUNS[f"{q} tmac spec"]["spec_rounds"] < 1:
        raise AssertionError("the spec run made no speculative round")
    profile_engine(spec, f"{q} tmac", profile_steps)
    pspec = make_engine(tmac.params, tmac.cfg, dataclasses.replace(
        spec.scfg, paged=True, page_size=4))
    same(serve(pspec, V, f"{q} tmac spec paged", 4, "lutmul_tmac"), fused,
         f"{q} tmac spec paged == {q} tmac fused")
    st = RUNS[f"{q} tmac spec paged"]
    if st["spec_rounds"] < 1 or st["paged"]["pages_trimmed"] < 1:
        raise AssertionError(f"tmac spec paged: {st['spec_rounds']} spec "
                             f"rounds, {st['paged']['pages_trimmed']} pages "
                             "trimmed")
    del pspec
    label = f"{q} tmac spec sampled"
    spec_s = serve(spec, V, label, 1, "lutmul_tmac", sampled=True)
    st = RUNS[label]
    if st["spec_rounds"] < 1:
        raise AssertionError("the sampled spec run made no speculative round")
    log(f"tmac spec sampled: accept rate {st['accept_rate']} "
        f"({st['spec_accepted']} of {st['spec_drafted']} drafts)")
    ops.set_backend("ref")
    same(serve(spec, V, f"{label} plain", 1, sampled=True), spec_s,
         f"{label} plain == {label} graph")
    ops.set_backend("cuda")
    n = zero_low_planes(tmac.params)
    log(f"zeroed the low 2 planes of {n} leaves in place")
    label = f"{q} tmac spec, low planes zeroed"
    serve(spec, V, label, 4, "lutmul_tmac")
    st = RUNS[label]
    if not st["spec_drafted"] or st["spec_accepted"] != st["spec_drafted"]:
        raise AssertionError(f"low planes zeroed: accepted "
                             f"{st['spec_accepted']} of {st['spec_drafted']}"
                             " drafts, expected all")
    del spec, tmac
    torch.cuda.empty_cache()


def gemma_requests(vocab: int) -> list:
    """The gemma2 phase's 8 requests (numpy seed 3), 24-32 new tokens each,
    in queue order: a pair of GEMMA_LONG[0]-token prompts, two of
    GEMMA_SHORT[0], a pair of GEMMA_LONG[1], two of GEMMA_SHORT[1].  A long
    pair (past the window) is one monolithic admission dispatch; the short
    prompt behind it takes the chunk lane in the same step."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(3)
    lens = [GEMMA_LONG[0]] * 2 + [GEMMA_SHORT[0]] * 2 + \
        [GEMMA_LONG[1]] * 2 + [GEMMA_SHORT[1]] * 2
    return [Request(prompt=rng.integers(0, vocab, L).tolist(),
                    max_new_tokens=int(rng.integers(24, 33))) for L in lens]


def gemma_drive(events: list):
    """A ``serve`` driver that submits every request, then steps to the end,
    recording each step's admissions in ``events`` as (step, kind,
    requests): ``"monolithic"`` from ``Scheduler._admit``, ``"chunk"`` for
    fresh chunk-lane admissions."""
    def drive(sched, reqs):
        step = [0]
        admit, assemble = sched._admit, sched._assemble_chunk

        def monolithic(*a, **k):
            n = admit(*a, **k)
            if n:
                events.append((step[0], "monolithic", n))
            return n

        def chunk(*a, **k):
            out = assemble(*a, **k)
            if out[2]:
                events.append((step[0], "chunk", len(out[2])))
            return out
        sched._admit, sched._assemble_chunk = monolithic, chunk
        for r in reqs:
            sched.submit(r)
        while sched.has_work:
            sched.step()
            step[0] += 1
        sched.check_drained()
        for r in reqs:
            if len(r.tokens) != r.max_new_tokens:
                raise AssertionError(f"request ended {r.finish_reason} with "
                                     f"{len(r.tokens)}/{r.max_new_tokens}")
    return drive


def run_gemma2(n_layers, profile_steps: int) -> None:
    """gemma2-2b at full width (GeGLU, soft-caps, gemma norms, local and
    global layers, tied head) in w4a4_lut through the Scheduler, prompts
    inside and past the window."""
    import torch
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve import ServeConfig, make_engine
    cfg = depth(gemma2_2b.config(quant="w4a4_lut"), n_layers)
    V = cfg.vocab
    engine = new_engine(cfg, GEMMA_MAX_LEN, "gemma2-2b")
    ops.set_backend("cuda")
    ops.set_variant(None)
    reqs = gemma_requests(V)
    if not all(len(r.prompt) > cfg.window for r in reqs[:2] + reqs[4:6]):
        raise AssertionError("the long prompts do not pass the window")
    log(f"gemma2 rings: prompts {sorted({len(r.prompt) for r in reqs})}, "
        f"window {cfg.window}, max_len {GEMMA_MAX_LEN}: the long prompts "
        "stitch wrapped rings and decode writes at pos % window")
    events = []
    fused = serve(engine, V, "gemma2 lut fused", 8, "lutmul", reqs=reqs,
                  drive=gemma_drive(events))
    RUNS["gemma2 lut fused"]["admissions_by_step"] = events
    log(f"gemma2 admissions (step, kind, requests): {json.dumps(events)}")
    pairs = [s for s, kind, n in events if kind == "monolithic" and n == 2]
    chunk_after = [s for s in pairs if any(
        e[0] == s and e[1] == "chunk" for e in events)]
    if not chunk_after or not RUNS["gemma2 lut fused"]["launches"][
            "lutmul_fused"]:
        raise AssertionError(f"gemma2: no monolithic pair with a chunk "
                             f"admission after it in its step ({events}), "
                             "or no lutmul_fused launch")
    log(f"gemma2: lutmul_fused launches "
        f"{RUNS['gemma2 lut fused']['launches']['lutmul_fused']}; "
        f"monolithic pairs at steps {pairs}, a chunk admission after it "
        f"in steps {chunk_after}")
    check_gemma_generate(engine, reqs, fused)
    profile_engine(engine, "gemma2 lut", profile_steps, pos0=GEMMA_LONG[1])
    time_tied_head(engine, "gemma2")

    paged = make_engine(engine.params, cfg, ServeConfig(
        max_len=GEMMA_MAX_LEN, seed=SAMPLE_SEED, paged=True,
        page_size=GEMMA_PAGE, prefill_chunk=GEMMA_PAGE))
    same(serve(paged, V, "gemma2 lut fused paged", GEMMA_PAGED_REQUESTS,
               "lutmul", reqs=gemma_requests(V), drive=gemma_drive([])),
         fused, "gemma2 paged == gemma2 dense")
    del paged
    torch.cuda.empty_cache()
    ops.set_variant("unfused")
    same(serve(engine, V, "gemma2 lut unfused", 4, "lutmul", fused=False,
               reqs=gemma_requests(V)), fused,
         "gemma2 unfused == gemma2 fused")
    ops.set_variant(None)
    ops.set_backend("ref")
    short = gemma_requests(V)[2:3]
    same(serve(engine, V, "gemma2 lut plain", 1, reqs=short), fused[2:3],
         "gemma2 plain == gemma2 fused (a short request)")
    ops.set_backend("cuda")
    run_gemma2_int8(engine, V, fused)
    del engine
    torch.cuda.empty_cache()


def run_gemma2_int8(engine, V: int, fused: list) -> None:
    """gemma2-2b with the int8 KV cache on the bf16 ``engine``'s codes:
    the global layers hold int8 codes and scales, the local rings stay
    bf16.  Fused over the first 4 requests (the first long pair past the
    window, then the first short pair), every admission monolithic; paged
    over the long pair and the plain backend over one short request, each
    equal to the fused rows; the KV bytes exact, and the share of greedy
    tokens equal to the bf16 run's (``fused``)."""
    import dataclasses
    import torch
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve import ServeConfig, make_engine
    cfg8 = dataclasses.replace(engine.cfg, kv_quant="int8")
    scfg = ServeConfig(max_len=GEMMA_MAX_LEN, seed=SAMPLE_SEED)
    int8 = make_engine(engine.params, cfg8, scfg)
    check_int8_bytes(int8, engine)
    events = []
    f8 = serve(int8, V, "gemma2 lut fused int8", 4, "lutmul",
               reqs=gemma_requests(V), drive=gemma_drive(events))
    kinds = {kind for _, kind, _ in events}
    if kinds != {"monolithic"}:
        raise AssertionError(f"gemma2 int8: admissions {events}, expected "
                             "every one monolithic")
    log(f"gemma2 int8 admissions (step, kind, requests): "
        f"{json.dumps(events)}")
    paged = make_engine(engine.params, cfg8, dataclasses.replace(
        scfg, paged=True, page_size=GEMMA_PAGE, prefill_chunk=GEMMA_PAGE))
    same(serve(paged, V, "gemma2 lut fused int8 paged",
               GEMMA_PAGED_REQUESTS, "lutmul", reqs=gemma_requests(V),
               drive=gemma_drive([])), f8,
         "gemma2 int8 paged == gemma2 int8 dense")
    del paged
    torch.cuda.empty_cache()
    ops.set_backend("ref")
    same(serve(int8, V, "gemma2 lut int8 plain", 1,
               reqs=gemma_requests(V)[2:3]), f8[2:3],
         "gemma2 int8 plain == gemma2 int8 fused (a short request)")
    ops.set_backend("cuda")
    int8_family_summary("gemma2", int8, engine, f8, fused)
    del int8
    torch.cuda.empty_cache()


def check_int8_bytes(int8, bf16) -> None:
    """An int8 engine's dense KV bytes at SLOTS slots, layer by layer as
    the reference lays them out: a global attention layer's K and V as
    int8 codes and a float32 scale a head and position, every other leaf
    (a local ring, the shared block's K/V) as the bf16 engine's."""
    from repro_torch.models import transformer
    cfg, M = int8.cfg, int8.scfg.max_len
    kv = 2 * cfg.n_kv * cfg.head_dim
    want = bf16.kv_cache_bytes(SLOTS)
    for i in range(cfg.n_layers):
        spec = transformer.layer_spec(cfg, i)
        if spec.kind == "attn" and not transformer.is_local(cfg, spec):
            want += SLOTS * M * (2 * cfg.n_kv * (cfg.head_dim + 4)
                                 - kv * cfg.cdtype.itemsize)
    got = int8.kv_cache_bytes(SLOTS)
    if got != want:
        raise AssertionError(f"{cfg.name} int8 kv_cache_bytes {got} != "
                             f"{want}")
    log(f"int8 KV bytes[{cfg.name}]: {got} at {SLOTS} slots, max_len {M}, "
        f"against {bf16.kv_cache_bytes(SLOTS)} for bf16")


def int8_family_summary(name: str, int8, bf16, toks8: list,
                        toks: list) -> None:
    """A family's int8 KV runs on one line: the KV bytes beside bf16's,
    each run's ms per decode step and tokens/s after capture, its
    admissions, and the share of the int8 run's greedy tokens equal to the
    bf16 run's over the same requests, position by position."""
    pairs = [(a, b) for x, y in zip(toks8, toks) for a, b in zip(x, y)]
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                  len(x)) for x, y in zip(toks8, toks)]
    out = {"kv_cache_bytes": {"int8": int8.kv_cache_bytes(SLOTS),
                              "bf16": bf16.kv_cache_bytes(SLOTS)},
           "runs": {label: {k: st.get(k) for k in (
               "ms_per_decode_step", "ms_per_decode_step_after_capture",
               "tokens_per_s_after_capture", "rounds", "admission")}
               for label, st in RUNS.items()
               if label.startswith(name + " ") and "int8" in label},
           "greedy_tokens_equal_to_bf16": sum(a == b for a, b in pairs)
           / len(pairs),
           "first_divergence_by_request": first}
    log(f"int8 runs[{name}]: " + json.dumps(out))


def chunked_generate(engine, prompts, new: int) -> list:
    """The chunk lane's arithmetic as a static batch: every prompt token
    through ``decode_step`` at its position over a fresh dense cache, the
    first token drawn from the last one's logits, then ``new - 1`` decode
    steps (greedy).  [B, new] token lists."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve.engine import sample_logits
    B, L = prompts.shape
    cache = engine.init_cache(B)
    i32 = dict(dtype=torch.int32, device=engine.device)
    for p in range(L):
        logits, cache = transformer.decode_step(
            engine.params, engine.cfg, prompts[:, p].to(torch.int32), cache,
            torch.full((B,), p, **i32))
    tok = sample_logits(logits)
    toks = [tok]
    for i in range(1, new):
        logits, cache = transformer.decode_step(
            engine.params, engine.cfg, tok, cache,
            torch.full((B,), L + i - 1, **i32))
        tok = sample_logits(logits)
        toks.append(tok)
    return torch.stack(toks, 1).tolist()


def _bf16_ulps(a, b):
    """|a - b| in bf16 ulps of the larger magnitude, elementwise."""
    import torch
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)


def flip_report(engine, prompts, forced: list, flips: dict) -> list:
    """Where ``generate`` and the chunk lane part on a short prompt: for
    each row j of ``flips`` {row: first token k that differs}, both static
    paths teacher-forced on ``forced`` (each row's fused transcript):
    ``generate``'s (a prefill, then ``decode_step``) and
    ``chunked_generate``'s (every token through ``decode_step``).  Each
    path's argmax must give its own transcript's token, and the first
    activation that differs may differ by at most ``FLIP_ULPS``.  The
    report gives the logits of token k (both top-2 margins, the largest
    |logit difference|, the bf16 ulp at the largest logit: the logits are
    bf16) and, from every activation quantizer's float input and A4 codes
    over positions 0 .. L + k - 1 (``ops.quantize_activations`` tapped, 7
    calls a layer), where the paths part first: the first call whose float
    input differs (its largest difference in bf16 ulps), the first whose
    codes differ, and the share of codes that differ in the last layer."""
    import torch
    from repro_torch.kernels.lutmul import ops
    from repro_torch.models import transformer
    params, cfg = engine.params, engine.cfg
    B, L = prompts.shape
    K = max(flips.values())
    rows = sorted(flips)
    i32 = dict(dtype=torch.int32, device=engine.device)
    seq = torch.cat([prompts.to(torch.int32), torch.tensor(
        [(f + [0] * K)[:K] for f in forced], **i32)], 1)
    at = {k: {} for k in set(flips.values())}
    taps = {"generate": [], "graph": []}
    quantize = ops.quantize_activations

    def tapped(x2, bits):
        codes, scale = quantize(x2, bits)
        n = x2.shape[0] // B
        tape.append((x2.view(B, n, -1)[rows].clone(),
                     codes.view(B, n, -1)[rows].clone()))
        return codes, scale
    ops.quantize_activations = tapped
    try:
        tape = taps["generate"]
        logits, cache = transformer.prefill(params, cfg, prompts)
        cache = engine._grow_cache(cache, L)
        for i in range(K + 1):
            if i in at:
                at[i]["generate"] = logits.float()
            if i < K:
                logits, cache = transformer.decode_step(
                    params, cfg, seq[:, L + i], cache,
                    torch.full((B,), L + i, **i32))
        tape = taps["graph"]
        cache = engine.init_cache(B)
        for p in range(L + K):
            logits, cache = transformer.decode_step(
                params, cfg, seq[:, p], cache, torch.full((B,), p, **i32))
            if p - L + 1 in at:
                at[p - L + 1]["graph"] = logits.float()
    finally:
        ops.quantize_activations = quantize
    # each path's tape as one (inputs, codes) [R, L + K, K_c] pair a call
    per_fwd = len(taps["generate"]) // (K + 1)
    if per_fwd * (K + 1) != len(taps["generate"]) or \
            per_fwd * (L + K) != len(taps["graph"]):
        raise AssertionError(f"quantizer calls: {len(taps['generate'])} on "
                             f"the generate path, {len(taps['graph'])} on "
                             f"the chunk lane's")
    calls = {}
    for name, tp in taps.items():
        fwds = [tp[f * per_fwd:(f + 1) * per_fwd]
                for f in range(len(tp) // per_fwd)]
        calls[name] = [(torch.cat([fw[c][0] for fw in fwds], 1),
                        torch.cat([fw[c][1] for fw in fwds], 1))
                       for c in range(per_fwd)]
    per_layer = per_fwd // cfg.n_layers
    out = []
    for r, (j, k) in enumerate(sorted(flips.items())):
        lg, lc = at[k]["generate"][j], at[k]["graph"][j]
        rec = {"row": j, "token": k, "fused_token": forced[j][k],
               "generate_token": int(torch.argmax(lg)),
               "graph_token": int(torch.argmax(lc))}
        for name, lo in (("generate", lg), ("graph", lc)):
            v, ix = torch.topk(lo, 2)
            rec[f"{name}_top2"] = [[int(ix[0]), float(v[0])],
                                   [int(ix[1]), float(v[1])]]
            rec[f"{name}_margin"] = float(v[0] - v[1])
        d = (lg - lc).abs()
        top = float(lg.abs().max())
        rec.update(max_abs_dlogit=float(d.max()),
                   logits_differing=int((d > 0).sum()), max_abs_logit=top,
                   bf16_ulp_at_max=2.0 ** (math.floor(math.log2(top)) - 7))
        if rec["graph_token"] != rec["fused_token"] or \
                rec["generate_token"] == rec["fused_token"]:
            raise AssertionError(f"gemma2 teacher-forced logits do not give "
                                 f"the transcripts' tokens: {rec}")
        first_in = first_code = None
        for c in range(per_fwd):
            (xg, qg), (xc, qc) = calls["generate"][c], calls["graph"][c]
            xg, xc = xg[r, :L + k], xc[r, :L + k]
            qg, qc = qg[r, :L + k], qc[r, :L + k]
            where = {"layer": c // per_layer, "call": c % per_layer}
            if first_in is None and not torch.equal(xg, xc):
                diff = xg != xc
                first_in = {**where,
                            "positions": diff.any(1).nonzero()
                            .flatten().tolist(),
                            "elements": int(diff.sum()),
                            "of": xg.numel(),
                            "max_abs": float((xg - xc).abs().max()),
                            "max_bf16_ulps": float(_bf16_ulps(xg, xc).max())}
            if first_code is None and not torch.equal(qg, qc):
                first_code = {**where, "codes": int((qg != qc).sum()),
                              "of": qg.numel(),
                              "max_step": int((qg.int() - qc.int()).abs()
                                              .max())}
        last = [c for c in range(per_fwd) if c // per_layer
                == cfg.n_layers - 1]
        flipped = sum(int((calls["generate"][c][1][r, :L + k]
                           != calls["graph"][c][1][r, :L + k]).sum())
                      for c in last)
        total = sum(calls["generate"][c][1][r, :L + k].numel() for c in last)
        rec.update(first_input_diff=first_in, first_code_diff=first_code,
                   last_layer_codes_differing=flipped / total)
        if first_in is None or first_in["max_bf16_ulps"] > FLIP_ULPS:
            raise AssertionError(f"gemma2 generate and the chunk lane part "
                                 f"at more than {FLIP_ULPS} bf16 ulps of an "
                                 f"activation: {rec}")
        out.append(rec)
    return out


def check_gemma_generate(engine, reqs: list, fused: list) -> None:
    """The Scheduler's transcripts against static batches, one call per
    prompt length, each batch padded to the Scheduler's 8 rows with copies
    of its prompts (a CUDA reduction picks its strategy by the row count):
    a prompt past the window (monolithic admission: a prefill, the rings
    stitched) against ``Engine.generate`` (a prefill, the rings rolled);
    a prompt inside it (the chunk lane: the prompt a token at a time)
    against ``chunked_generate``, both exactly.  ``generate`` on a short
    prompt is reported, not held: a prefill's float reductions run at
    other shapes than a decode step's on CUDA, so their bits differ; where
    they part, ``flip_report`` gives both paths' logits at that token."""
    import torch
    t0 = time.perf_counter()
    by_len: dict = {}
    bad, prefill_agree, flips = [], {}, []
    for i, r in enumerate(reqs):
        by_len.setdefault(len(r.prompt), []).append(i)
    for L, idx in by_len.items():
        rows = [reqs[idx[j % len(idx)]].prompt for j in range(SLOTS)]
        new = max(reqs[i].max_new_tokens for i in idx)
        prompts = torch.tensor(rows, device=engine.device)
        gen = engine.generate(prompts, new)[:, L:].tolist()
        want = gen if not engine.chunk_eligible(L) else \
            chunked_generate(engine, prompts, new)
        for j, i in enumerate(idx):
            n = reqs[i].max_new_tokens
            first = next((k for k, (x, y) in enumerate(
                zip(want[j][:n], fused[i])) if x != y), None)
            if first is not None:
                bad.append((i, L, first))
            if engine.chunk_eligible(L):
                prefill_agree[i] = next((k for k, (x, y) in enumerate(
                    zip(gen[j][:n], fused[i])) if x != y), None)
        parted = {j: prefill_agree[i] for j, i in enumerate(idx)
                  if prefill_agree.get(i) is not None}
        if parted and not bad:
            forced = [fused[idx[j % len(idx)]] for j in range(SLOTS)]
            for rec in flip_report(engine, prompts, forced, parted):
                flips.append({"request": idx[rec.pop("row")], **rec})
    if bad:
        raise AssertionError(f"gemma2 static batch != fused graphs for "
                             f"(request, prompt, first token that differs) "
                             f"{bad}")
    log(f"transcripts identical: gemma2 fused graphs == Engine.generate "
        f"(the 4 prompts past the window) and == chunked_generate (the 4 "
        f"inside it) ({len(by_len)} lengths, "
        f"{time.perf_counter() - t0:.1f}s)")
    log("gemma2 Engine.generate on the chunk-lane requests (request: first "
        "token that differs, None: all equal): " + json.dumps(prefill_agree))
    log("gemma2 generate vs chunk lane at the token where they part: "
        + json.dumps(flips))
    RUNS["gemma2 lut fused"]["generate_first_diff_chunk_lane"] = \
        prefill_agree
    RUNS["gemma2 lut fused"]["generate_flips"] = flips


def time_tied_head(engine, label: str) -> None:
    """The tied head at the decode shape ([8, d_model] @ emb.T): the whole
    call as ``transformer._lm_head`` runs it (the float32 embedding cast to
    bf16 every call, then the product), the cast alone and the product
    alone on a pre-cast copy, CUDA events (median of 20)."""
    import torch
    from repro_torch.models import transformer
    cfg = engine.cfg
    emb = engine.params["embed"]["emb"]
    x = torch.randn((SLOTS, cfg.d_model), device=engine.device).to(
        cfg.cdtype)
    wb = emb.T.to(cfg.cdtype)
    out = {"head": f"[{SLOTS}, {cfg.d_model}] @ [{cfg.d_model}, "
                   f"{cfg.vocab}]",
           "lm_head_ms": _event_ms(
               lambda: transformer._lm_head(engine.params, cfg, x), 20),
           "cast_ms": _event_ms(lambda: emb.T.to(cfg.cdtype), 20),
           "matmul_ms": _event_ms(lambda: x @ wb, 20),
           "float32_embedding_bytes": emb.numel() * emb.element_size()}
    out["decode_step_device_ms"] = PROFILES.get(
        f"{label} lut decode step", {}).get("device_ms_per_call")
    log(f"tied head[{label}]: " + json.dumps(out))
    del wb


def run_minicpm(n_layers, profile_steps: int) -> None:
    """minicpm-2b at full width (tied head, vocab 122,753) in w4a4_lut:
    fused over the first 4 contract requests, and the plain backend over
    the first one (8 new tokens) equal to it."""
    import torch
    from repro_torch.configs import minicpm_2b
    from repro_torch.kernels.lutmul import ops
    cfg = depth(minicpm_2b.config(quant="w4a4_lut"), n_layers)
    V = cfg.vocab
    engine = new_engine(cfg, 256, "minicpm-2b")
    ops.set_backend("cuda")
    ops.set_variant(None)
    fused = serve(engine, V, "minicpm lut fused", 4, "lutmul")
    profile_engine(engine, "minicpm lut", profile_steps)
    time_tied_head(engine, "minicpm")
    ops.set_backend("ref")
    reqs = make_requests(V)[:1]
    reqs[0].max_new_tokens = PLAIN_TOKENS
    same(serve(engine, V, "minicpm lut plain", 1, reqs=reqs),
         [fused[0][:PLAIN_TOKENS]], "minicpm plain == minicpm fused")
    ops.set_backend("cuda")
    del engine
    torch.cuda.empty_cache()


def route_shares(engine, V: int, fused: list, name: str) -> None:
    """The contract's 8 requests again, every round op by op
    (``Engine.step(_eager=True)``), transcripts equal to the replayed
    graphs' ``fused``; ``moe.route`` wrapped to count the routes each call
    keeps under the capacity, summed on the card and read once at the end:
    decode steps (8 rows) and admission prefills (8 rows of P tokens)
    apart."""
    import functools
    import torch
    from repro_torch.models import moe
    from repro_torch.serve import Scheduler
    counts = {"decode": [], "admission": []}
    routed = dict.fromkeys(counts, 0)
    route = moe.route

    def counting(p, xf, cfg, C):
        out = route(p, xf, cfg, C)
        site = "decode" if xf.shape[1] == SLOTS else "admission"
        counts[site].append(out[3].sum())
        routed[site] += out[3].numel()
        return out
    reqs = make_requests(V)
    sched = Scheduler(engine, slots=SLOTS, chunk=8)
    engine.step = functools.partial(engine.step, _eager=True)
    moe.route = counting
    t0 = time.perf_counter()
    try:
        sched.run(reqs)
        torch.cuda.synchronize()
    finally:
        moe.route = route
        del engine.step
    dt = time.perf_counter() - t0
    same([list(r.tokens) for r in reqs], fused,
         f"{name} op by op == {name} replayed graphs")
    if not all(counts.values()):
        raise AssertionError(f"routes counted: {routed}")
    out = {"seconds": dt}
    for site, c in counts.items():
        kept = int(torch.stack(c).sum())
        out[site] = {"calls": len(c), "routes": routed[site], "kept": kept,
                     "kept_share": kept / routed[site]}
    log(f"routes[{name}]: {json.dumps(out)}")


def run_qwen2moe(n_layers, profile_steps: int) -> None:
    """qwen2-moe-a2.7b at full width in w4a4_lut (the served tree built a
    layer at a time): :func:`run_moe`, then the int8 KV cache on the same
    codes (every layer's K/V int8): fused over the 8 contract requests,
    dense == paged over ``moe_paged_requests``, fused over the first one
    == the plain backend."""
    import dataclasses
    import torch
    from repro_torch.configs import qwen2_moe_a2p7b
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve import ServeConfig, make_engine
    cfg = depth(qwen2_moe_a2p7b.config(quant="w4a4_lut"), n_layers)
    V = cfg.vocab
    engine = new_engine(cfg, 256, "qwen2-moe-a2.7b")
    fused = run_moe(engine, "qwen2moe", profile_steps)
    cfg8 = dataclasses.replace(cfg, kv_quant="int8")
    scfg = ServeConfig(max_len=256, seed=SAMPLE_SEED)
    int8 = make_engine(engine.params, cfg8, scfg)
    check_int8_bytes(int8, engine)
    f8 = serve(int8, V, "qwen2moe lut fused int8", 8, "lutmul")
    f8_4 = serve(int8, V, "qwen2moe lut fused int8, 4", 4, "lutmul",
                 reqs=moe_paged_requests(V))
    paged = make_engine(engine.params, cfg8, dataclasses.replace(
        scfg, paged=True, page_size=4))
    same(serve(paged, V, "qwen2moe lut fused int8 paged", 4, "lutmul",
               reqs=moe_paged_requests(V)), f8_4,
         "qwen2moe int8 paged == qwen2moe int8 dense (4)")
    del paged
    f8_1 = serve(int8, V, "qwen2moe lut fused int8, 1", 1, "lutmul",
                 reqs=first_request(V))
    ops.set_backend("ref")
    same(serve(int8, V, "qwen2moe lut int8 plain", 1,
               reqs=first_request(V)), f8_1,
         "qwen2moe int8 plain == qwen2moe int8 fused (1)")
    ops.set_backend("cuda")
    int8_family_summary("qwen2moe", int8, engine, f8, fused)
    del engine, int8
    torch.cuda.empty_cache()


def moe_paged_requests(V: int) -> list:
    """4 of ``equal_requests``, budgets in non-increasing order: one
    admission dispatch puts them into slots 0-3, and a slot frees only
    after every slot behind it.  An MoE decode step routes every slot's
    row, a free one's too, and capacity goes in slot order; a free row
    attends over its own stale row when dense but over the null page when
    paged (in the reference as in the port), so a freed slot in front of
    a live one may take that row's routes in one layout and not the
    other.  With no freed slot in front of a live one, paged == dense."""
    reqs = equal_requests(V)[:4]
    for r, b in zip(reqs, sorted((r.max_new_tokens for r in reqs),
                                 reverse=True)):
        r.max_new_tokens = b
    return reqs


def first_request(V: int) -> list:
    """The first contract request with PLAIN_TOKENS new tokens."""
    reqs = make_requests(V)[:1]
    reqs[0].max_new_tokens = PLAIN_TOKENS
    return reqs


def run_moe(engine, name: str, profile_steps: int) -> list:
    """An MoE model's runs in w4a4_lut: fused over the 8 contract requests
    and again op by op (``route_shares``), fused over the first 4 ==
    unfused over them, fused over the first one == the plain backend (8
    new tokens), and a profile.  Capacity couples the rows of a forward,
    so only runs over the same requests are compared.  Returns the fused
    transcripts of the 8."""
    from repro_torch.kernels.lutmul import ops
    V = engine.cfg.vocab
    ops.set_backend("cuda")
    ops.set_variant(None)
    fused = serve(engine, V, f"{name} lut fused", 8, "lutmul")
    route_shares(engine, V, fused, name)
    fused4 = serve(engine, V, f"{name} lut fused, 4", 4, "lutmul")
    ops.set_variant("unfused")
    same(serve(engine, V, f"{name} lut unfused", 4, "lutmul", fused=False),
         fused4, f"{name} unfused == {name} fused (4)")
    ops.set_variant(None)
    fused1 = serve(engine, V, f"{name} lut fused, 1", 1, "lutmul",
                   reqs=first_request(V))
    ops.set_backend("ref")
    same(serve(engine, V, f"{name} lut plain", 1, reqs=first_request(V)),
         fused1, f"{name} plain == {name} fused (1)")
    ops.set_backend("cuda")
    # one call of each: a replayed round is tens of thousands of kernels,
    # and the profiler's trace of four is slow to read
    profile_engine(engine, f"{name} lut", min(profile_steps, 1))
    return fused


def sharded_drive(engine, reqs: list, save=None, **sched_kw) -> tuple:
    """The reference's staggered admission through the contract's
    Scheduler (slots 8, chunk 8): two requests, a round, the others
    mid-flight.  ``save`` (a directory) saves the Scheduler after round
    ``SHARDED_SAVE_ROUNDS`` (timed apart, the card synchronized).  Returns
    (transcripts, stats, seconds, save seconds)."""
    import torch
    from repro_torch.serve import Scheduler
    sched = Scheduler(engine, slots=SLOTS, chunk=8, **sched_kw)
    torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    save_s = 0.0
    if save is not None:
        for _ in range(SHARDED_SAVE_ROUNDS - 1):
            sched.step()
        if not sched.has_work:
            raise AssertionError("the save run drained before its save")
        torch.cuda.synchronize(engine.device)
        ts = time.perf_counter()
        sched.save(save)
        save_s = time.perf_counter() - ts
    while sched.has_work:
        sched.step()
    torch.cuda.synchronize(engine.device)
    return ([list(r.tokens) for r in reqs], dict(sched.stats),
            time.perf_counter() - t0 - save_s, save_s)


def sharded_load(engine, ckpt: str) -> tuple:
    """A fresh Scheduler on ``engine`` loads ``ckpt`` and serves to the
    end: (transcripts in prompt order, stats, load seconds, seconds)."""
    import torch
    from repro_torch.serve import Scheduler
    sched = Scheduler(engine, slots=SLOTS, chunk=8)
    torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    sched.load(ckpt)
    torch.cuda.synchronize(engine.device)
    load_s = time.perf_counter() - t0
    while sched.has_work:
        sched.step()
    torch.cuda.synchronize(engine.device)
    reqs = sorted(sched.finished, key=lambda r: len(r.prompt))
    return ([list(r.tokens) for r in reqs], dict(sched.stats), load_s,
            time.perf_counter() - t0 - load_s)


def sharded_config(arch: str, n_layers: int, **over):
    import dataclasses
    from repro_torch import configs
    cfg = depth(configs.get_config(arch, quant="w4a4_lut"), n_layers)
    return dataclasses.replace(cfg, **over) if over else cfg


def spec_config(n_layers: int):
    """The speculative case's qwen2-7b: w4a4_tmac codes, paged."""
    from repro_torch.serve import ServeConfig
    return (sharded_config("qwen2-7b", n_layers, quant="w4a4_tmac"),
            ServeConfig(quant="w4a4_tmac", max_len=256, seed=SAMPLE_SEED,
                        spec_decode=True, draft_k=3, draft_planes=2,
                        paged=True, page_size=4))


def sharded_launches(cfg, n_model: int, forwards: int) -> dict:
    """One rank's launches in ``forwards`` forwards: the fused LUT kernel
    for the Q/K/V (head or column; none for split-head float leaves), MLP
    wi/wg (column) and expert leaves (its E / n_model experts of each
    bank, the shared expert's wi/wg), the unfused LUT kernel for the
    row-parallel leaves (attention wo unless split-head, MLP or
    shared-expert wo), the fused int8 kernel for its half of the head.
    Under w4a4_tmac the T-MAC kernels take the LUT kernels' places."""
    split = cfg.split_head_params
    fused = (0 if split else 3) \
        + (3 * cfg.moe.n_experts // n_model + 2 if cfg.moe else 2)
    row = 1 if split else 2
    L = cfg.n_layers
    fused_k, row_k = (("lutmul_tmac_fused", "lutmul_tmac")
                      if cfg.quant.endswith("_tmac")
                      else ("lutmul_fused", "lutmul"))
    return {fused_k: fused * L * forwards, row_k: row * L * forwards,
            "int_matmul_fused": forwards}


def _shard_case(mesh, cfg, scfg, reqs, zero: bool = False) -> dict:
    """One rank's engine over ``reqs``: the served tree made on the card
    (``zero``: the low planes zeroed first), cut to the rank's shard,
    served from zeroed counts."""
    import torch
    from repro_torch.serve import Engine
    from repro_torch.serve.quantize import init_served_params
    from repro_torch.serve.sharded import ShardedEngine
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_served_params(cfg, scfg.quant, seed=0, device=dev)
    if zero:
        zero_low_planes(params, scfg.draft_planes)
    engine = ShardedEngine(cfg, params, scfg, mesh=mesh)
    del params
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    reset_launches()
    engine.decode_steps = engine.prefill_steps = 0
    engine.lane_steps = dict.fromkeys(engine.lane_steps, 0)
    toks, stats, dt, _ = sharded_drive(engine, reqs)
    return dict(toks=toks, stats=stats, seconds=dt, init_s=init_s,
                launches=all_launches(),
                # a verify forward counts apart from the decode steps
                forwards=engine.decode_steps + engine.prefill_steps
                + engine.lane_steps["verify"],
                lanes=dict(engine.lane_steps),
                head_sharded=engine.head_sharded,
                experts_sharded=engine.experts_sharded,
                tp_leaves=engine.n_tp_leaves, paged=engine.paged,
                cache_heads=engine_cache_shapes(engine),
                kv_bytes=engine.kv_cache_bytes(SLOTS),
                kv_total=Engine.kv_cache_bytes(engine, SLOTS),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                engine=engine)


def engine_cache_shapes(engine):
    """KV heads of each attention layer of the rank's cache layout."""
    return [shape["k"][2] for shape in engine._shard_shapes if "k" in shape]


def sharded_rank(mesh, arch: str, n_layers: int, fault: bool,
                 ckpt=None, new_layers=None) -> dict:
    """One rank of a sharded run: the served tree built on the rank's
    card (``init_served_params``, seed 0) and cut to its shard, the 8
    contract requests; with ``fault`` the first ``SHARDED_FAULT_REQUESTS``
    again under a NaN fault with a snapshot every round; with ``ckpt`` (a
    directory all ranks see) the save / load case and, at ``new_layers``,
    the split-head and speculative cases of the 2x2 world."""
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.faults import Fault, FaultPlan
    ops.set_backend("cuda")
    ops.set_variant(None)
    cfg = sharded_config(arch, n_layers)
    out = _shard_case(mesh, cfg, ServeConfig(
        quant=cfg.quant, max_len=256, seed=SAMPLE_SEED), make_requests(
            cfg.vocab))
    engine = out.pop("engine")
    out.update(rank=mesh.rank, backend=mesh.backend, device=str(mesh.device))
    if fault:
        plan = FaultPlan([Fault(site="decode", index=SHARDED_FAULT_INDEX,
                                kind="nan_logits", slot=SHARDED_FAULT_SLOT)])
        engine.set_fault_plan(plan)
        ftoks, fstats, fdt, _ = sharded_drive(
            engine, make_requests(cfg.vocab)[:SHARDED_FAULT_REQUESTS],
            snapshot_interval=1)
        out["fault"] = dict(toks=ftoks, recoveries=fstats["recoveries"],
                            pending=len(plan.pending), seconds=fdt)
        engine.set_fault_plan(None)
    if ckpt is None:
        return out
    toks, stats, dt, save_s = sharded_drive(
        engine, make_requests(cfg.vocab)[:SHARDED_SAVE_REQUESTS], save=ckpt)
    ltoks, lstats, load_s, ldt = sharded_load(engine, ckpt)
    out["save"] = dict(toks=toks, stats=stats, seconds=dt, save_ms=save_s
                       * 1e3, loaded=ltoks, loaded_stats=lstats,
                       load_ms=load_s * 1e3, loaded_seconds=ldt)
    del engine
    split = _shard_case(mesh, sharded_config(arch, new_layers,
                                             split_head_params=True),
                        ServeConfig(quant="w4a4_lut", max_len=256,
                                    seed=SAMPLE_SEED),
                        make_requests(cfg.vocab)[:SHARDED_NEW_REQUESTS])
    del split["engine"]
    out["split"] = split
    spec = _shard_case(mesh, *spec_config(new_layers),
                       make_requests(cfg.vocab)[:SHARDED_NEW_REQUESTS],
                       zero=True)
    del spec["engine"]
    out["spec"] = spec
    return out


def _check_rank_case(where: str, r: dict, cfg, n_data: int, n_model: int,
                     want: list, wstats) -> None:
    """A rank's transcripts (and, unless ``wstats`` is None, stats) against
    the single card's; its sharding, cache heads, KV bytes and launches."""
    if r["toks"] != want:
        bad = [i for i, (a, b) in enumerate(zip(r["toks"], want)) if a != b]
        raise AssertionError(f"{where}: transcripts of requests {bad} "
                             "differ from the single card's")
    if wstats is not None and r["stats"] != wstats:
        raise AssertionError(f"{where}: Scheduler.stats {r['stats']} != "
                             f"{wstats}")
    if cfg.moe is None and not r["head_sharded"]:
        raise AssertionError(f"{where}: not head-sharded")
    if cfg.moe is not None and not r["experts_sharded"]:
        raise AssertionError(f"{where}: experts not sharded")
    shrink = n_data * (n_model if r["head_sharded"] else 1)
    if not r["paged"] and r["kv_bytes"] * shrink != r["kv_total"]:
        raise AssertionError(f"{where}: KV bytes {r['kv_bytes']} != "
                             f"{r['kv_total']} / {shrink}")
    heads = cfg.n_kv // n_model if r["head_sharded"] else cfg.n_kv
    if set(r["cache_heads"]) != {heads}:
        raise AssertionError(f"{where}: cache heads {r['cache_heads']}, "
                             f"want {heads}")
    want_l = dict.fromkeys(r["launches"], 0)
    want_l.update(sharded_launches(cfg, n_model, r["forwards"]))
    if r["launches"] != want_l:
        raise AssertionError(f"{where}: launches {r['launches']} != "
                             f"{want_l}")


def _rank_line(label: str, r: dict, tokens: int, n: int) -> str:
    rate = tokens / r["seconds"]
    return (f"sharded[{label}] rank {r['rank']}: init {r['init_s']:.1f}s, "
            f"{tokens} tokens in {r['seconds']:.2f}s ({rate:.2f} tokens/s, "
            f"eager rounds, {n} processes on one card), "
            f"{r['forwards']} forwards, launches "
            f"{json.dumps({k: v for k, v in r['launches'].items() if v})}, "
            f"peak {r['peak_gib']:.2f} GiB")


def single_reference(cfg, label: str, reqs: list, zero_planes: int = 0):
    """The single card's engine at the same seed and depth (replayed
    rounds; ``zero_planes``: the low planes zeroed first) over ``reqs``:
    (transcripts, stats, seconds, tokens)."""
    engine = new_engine(cfg, 256, label)
    if zero_planes:
        zero_low_planes(engine.params, zero_planes)
    toks, stats, dt, _ = sharded_drive(engine, reqs)
    del engine
    reset_peak(empty=True)
    return toks, stats, dt, sum(len(t) for t in toks)


def run_sharded(n_layers) -> None:
    """Multi-GPU serving on the one card: qwen2-7b 2x2 (head-parallel; its
    save / load, split-head and speculative cases in the same world) and
    qwen2-moe-a2.7b 1x2 (expert-parallel) against the single-card engine
    at the same seed and depth (see the module docstring)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve.sharded import launch
    log(f"sharded: {torch.cuda.device_count()} card, so every rank runs on "
        "cuda:0 and the collectives are gloo, staged through pinned host "
        "memory (NCCL refuses two ranks on one card); tokens/s below are "
        "of the ranks sharing that card, not a scaling figure")
    for arch, spec, layers, fault in (
            ("qwen2-7b", SHARDED_QWEN, SHARDED_QWEN_LAYERS, True),
            ("qwen2-moe-a2.7b", SHARDED_MOE, SHARDED_MOE_LAYERS, False)):
        layers = min(layers, n_layers or layers)
        cfg = sharded_config(arch, layers)
        n_data, n_model = (int(x) for x in spec.split("x"))
        label = f"{arch} {spec}"
        ops.set_backend("cuda")
        ops.set_variant(None)
        engine = new_engine(cfg, 256, f"{arch} single card")
        want, wstats, wdt, _ = sharded_drive(engine,
                                             make_requests(cfg.vocab))
        if fault:
            want_fault = sharded_drive(
                engine, make_requests(cfg.vocab)[:SHARDED_FAULT_REQUESTS])[0]
            save_want = sharded_drive(
                engine, make_requests(cfg.vocab)[:SHARDED_SAVE_REQUESTS])[:2]
        tokens = sum(len(t) for t in want)
        log(f"sharded[{label}]: single card {layers} layers, {tokens} "
            f"tokens in {wdt:.2f}s ({tokens / wdt:.2f} tokens/s, replayed "
            "rounds)")
        del engine
        reset_peak(empty=True)
        ckpt = None
        new_layers = min(CUT_LAYERS, n_layers or CUT_LAYERS)
        if fault:
            split_cfg = sharded_config(arch, new_layers,
                                       split_head_params=True)
            split_want = single_reference(split_cfg, f"{arch} split-head "
                                          "single card", make_requests(
                                              cfg.vocab)[:SHARDED_NEW_REQUESTS])
            tcfg, tscfg = spec_config(new_layers)
            spec_want = single_reference(tcfg, f"{arch} tmac single card, "
                                         "low planes zeroed", make_requests(
                                             cfg.vocab)[:SHARDED_NEW_REQUESTS],
                                         tscfg.draft_planes)
            os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
            ckpt = tempfile.mkdtemp(prefix="sharded_ckpt_",
                                    dir=os.path.join(REPO, "build"))
        t0 = time.perf_counter()
        try:
            ranks = launch(sharded_rank, spec, "gloo", timeout_s=SHARDED_S,
                           args=(arch, layers, fault, ckpt, new_layers))
        finally:
            if ckpt is not None:
                shutil.rmtree(ckpt, ignore_errors=True)
        world_s = time.perf_counter() - t0
        for r in ranks:
            where = f"sharded[{label}] rank {r['rank']}"
            _check_rank_case(where, r, cfg, n_data, n_model, want, wstats)
            if r["stats"] != ranks[0]["stats"]:
                raise AssertionError(f"{where}: stats differ from rank 0's")
            if r["backend"] != "gloo":
                raise AssertionError(f"{where}: backend {r['backend']}")
            if fault:
                f = r["fault"]
                if f["toks"] != want_fault or f["recoveries"] < 1 \
                        or f["pending"]:
                    raise AssertionError(f"{where}: the fault run did not "
                                         f"recover to the same transcripts "
                                         f"({f['recoveries']} recoveries)")
        RUNS[f"sharded {label} rank 0"] = {
            "seconds": ranks[0]["seconds"], "launches": ranks[0]["launches"],
            "forwards_by_lane": None}
        log(f"sharded[{label}]: {len(ranks)} ranks on "
            f"{sorted({r['device'] for r in ranks})}, gloo; head-sharded "
            f"{ranks[0]['head_sharded']}, experts sharded "
            f"{ranks[0]['experts_sharded']}, {ranks[0]['tp_leaves']} leaves "
            f"marked a rank; transcripts of every rank == the single card's "
            f"bitwise, stats equal; KV bytes a rank {ranks[0]['kv_bytes']} "
            f"of {ranks[0]['kv_total']}; world {world_s:.1f}s")
        for r in ranks:
            line = _rank_line(label, r, tokens, len(ranks))
            if fault:
                f = r["fault"]
                line += (f"; fault run ({SHARDED_FAULT_REQUESTS} requests): "
                         f"NaN at decode dispatch {SHARDED_FAULT_INDEX}, "
                         f"{f['recoveries']} recoveries, transcripts equal "
                         f"to the single card's, {f['seconds']:.2f}s")
            log(line)
        if fault:
            check_sharded_cases(ranks, arch, new_layers, n_data, n_model,
                                save_want, split_want, spec_want)
    log(f"sharded: {smi_line()}")


def check_sharded_cases(ranks: list, arch: str, layers: int, n_data: int,
                        n_model: int, save_want: tuple, split_want: tuple,
                        spec_want: tuple) -> None:
    """The 2x2 world's save / load, split-head and speculative cases on
    every rank against the single card's runs."""
    smi = smi_line()
    spec = SHARDED_QWEN
    toks, stats = save_want
    for r in ranks:
        where = f"sharded[{arch} {spec} save/load] rank {r['rank']}"
        sv = r["save"]
        for what, t, st in (("uninterrupted", sv["toks"], sv["stats"]),
                            ("loaded", sv["loaded"], sv["loaded_stats"])):
            if t != toks or st != stats:
                raise AssertionError(f"{where}: the {what} run's transcripts "
                                     "or stats differ from the single card's")
        log(f"{where}: saved after round {SHARDED_SAVE_ROUNDS} of "
            f"{SHARDED_SAVE_REQUESTS} requests, a fresh Scheduler loaded it "
            f"and served to the end; transcripts and stats == the "
            f"uninterrupted run's == the single card's; save "
            f"{sv['save_ms']:.1f} ms, load {sv['load_ms']:.1f} ms "
            f"(host, the card synchronized), uninterrupted "
            f"{sv['seconds']:.2f}s, after the load {sv['loaded_seconds']:.2f}"
            f"s | {smi}")
    for case, (want, wstats, wdt, wtok), cfg in (
            ("split-head", split_want,
             sharded_config(arch, layers, split_head_params=True)),
            ("spec", spec_want, spec_config(layers)[0])):
        label = f"{arch} {spec} {case}"
        log(f"sharded[{label}]: single card {layers} layers, {wtok} tokens "
            f"in {wdt:.2f}s "
            f"({wtok / wdt:.2f} tokens/s, replayed rounds"
            + (", NOT speculative" if case == "spec" else "") + f") | {smi}")
        for r in ranks:
            c = r[case.split("-")[0]]
            c["rank"] = r["rank"]
            where = f"sharded[{label}] rank {r['rank']}"
            # the spec case's single card is NOT speculative: equal
            # transcripts, other round counts; every rank agrees on its stats
            if case == "spec" and (c["stats"] != ranks[0]["spec"]["stats"]
                                   or c["stats"]["spec_rounds"] <= 0):
                raise AssertionError(f"{where}: spec stats {c['stats']}")
            _check_rank_case(where, c, cfg, n_data, n_model, want,
                             None if case == "spec" else wstats)
            line = _rank_line(label, c, wtok, len(ranks))
            if case == "spec":
                st = c["stats"]
                acc = st["spec_accepted"] / max(1, st["spec_drafted"])
                line += (f"; {st['spec_rounds']} speculative rounds, accept "
                         f"rate {acc:.4f} ({st['spec_accepted']} of "
                         f"{st['spec_drafted']} "
                         f"drafts), forwards by lane {json.dumps(c['lanes'])}")
            else:
                line += (f"; cache heads a layer {c['cache_heads'][0]}, KV "
                         f"bytes a rank {c['kv_bytes']} of {c['kv_total']}")
            log(line + f" | {smi}")
        RUNS[f"sharded {label} rank 0"] = {
            "seconds": ranks[0][case.split("-")[0]]["seconds"],
            "launches": ranks[0][case.split("-")[0]]["launches"],
            "forwards_by_lane": ranks[0][case.split("-")[0]]["lanes"]}


def run_mixtral(n_layers, profile_steps: int) -> None:
    """mixtral-8x22b at full width and MIXTRAL_LAYERS of its 56 layers
    (fewer under ``--layers``) in w4a4_lut, the served tree built a layer
    at a time (1.21 GB of expert nibbles a layer): :func:`run_moe`.  Every
    layer is local (window 4,096 > max_len 256), its cache float; a decode
    forward launches the LUT kernel 4 + 3 x 8 times a layer (the experts
    at decode's capacity of 3 rows) and the untied head once."""
    import torch
    from repro_torch.configs import mixtral_8x22b
    from repro_torch.models import moe
    cfg = depth(mixtral_8x22b.config(quant="w4a4_lut"), n_layers)
    engine = new_engine(cfg, 256, "mixtral-8x22b")
    log(f"mixtral: decode capacity {moe.decode_capacity(cfg.moe, SLOTS)} "
        f"at {SLOTS} slots; {inner_per_forward(cfg)} LUT launches a "
        f"forward; served tree {json.dumps(served_bytes(engine.params))}")
    run_moe(engine, "mixtral", profile_steps)
    del engine
    torch.cuda.empty_cache()


def served_bytes(params) -> dict:
    """Bytes of a served tree by kind: the nibble and int8 codes, their
    scales, and every float leaf."""
    import torch
    out = {"uint8 codes": 0, "int8 codes": 0, "float": 0}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            key = {torch.uint8: "uint8 codes", torch.int8: "int8 codes"}.get(
                t.dtype, "float")
            out[key] += t.numel() * t.element_size()
    walk(params)
    return out


def run_phi3(n_layers, profile_steps: int) -> None:
    """phi3-medium-14b at full width (``SERVED_LAYERS`` of 40, GQA 40/10,
    SwiGLU 17,920, the untied 100,352-row head) in w4a4_lut, its served
    tree built a layer at a time: fused over the 8 contract requests, a
    decode step and a replayed round profiled, and the plain backend over
    the first one (8 new tokens) equal to its fused row."""
    import torch
    from repro_torch.configs import phi3_medium_14b
    from repro_torch.kernels.lutmul import ops
    cfg = depth(phi3_medium_14b.config(quant="w4a4_lut"), n_layers)
    V = cfg.vocab
    engine = new_engine(cfg, 256, "phi3-medium-14b")
    log(f"phi3: served tree {json.dumps(served_bytes(engine.params))}")
    ops.set_backend("cuda")
    ops.set_variant(None)
    fused = serve(engine, V, "phi3 lut fused", 8, "lutmul")
    profile_engine(engine, "phi3 lut", profile_steps)
    ops.set_backend("ref")
    same(serve(engine, V, "phi3 lut plain", 1, reqs=first_request(V)),
         [fused[0][:PLAIN_TOKENS]], "phi3 plain == phi3 fused")
    ops.set_backend("cuda")
    del engine
    torch.cuda.empty_cache()


def check_first_replay(engine, V: int, label: str) -> None:
    """From one state (8 equal-length prompts admitted by
    ``admit_monolithic``), an 8-iteration round op by op and the first
    replay of a key captured for this cache (its warm-up round ran just
    before) give the same tokens, packed results and cache bits: the
    capture puts back the recurrent state its warm-up advanced."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    cache = engine.init_cache(SLOTS)
    dev = engine.device
    prompts = np.random.default_rng(5).integers(0, V, (SLOTS, 16))
    eos = torch.full((SLOTS,), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
    _, tok, pos, done, _ = engine.admit_monolithic(
        cache, prompts, np.full(SLOTS, 16), np.ones(SLOTS, bool),
        np.zeros(SLOTS, bool), eos, zeros, zeros.clone(),
        torch.zeros((SLOTS,), dtype=torch.bool, device=dev))
    leaves = [t for c in cache for t in c.values()]
    start = [t.clone() for t in leaves]
    results = {}
    for mode in ("op by op", "first replay"):
        for t, s0 in zip(leaves, start):
            t.copy_(s0)
        keys = len(engine.graphs.rounds)
        out = engine.step(cache, None, tok.clone(), pos.clone(),
                          done.clone(), eos, 8, _eager=mode == "op by op")
        torch.cuda.synchronize()
        if mode == "first replay" and len(engine.graphs.rounds) != keys + 1:
            raise AssertionError(f"{label}: the replayed round captured no "
                                 "key of its own")
        results[mode] = [t.clone() for t in out[1:]] + [
            t.clone() for t in leaves]
    for i, (a, b) in enumerate(zip(*results.values())):
        if not _bits_equal(a, b):
            raise AssertionError(f"{label}: the first replayed round differs "
                                 f"from the op-by-op round at output {i}")
    log(f"first replay[{label}]: the op-by-op round and the first replay "
        f"of a new key are bitwise equal ({len(leaves)} cache leaves, "
        f"{transformer.state_bytes(engine.cfg, SLOTS) / 2**20:.1f} MiB of "
        "recurrent state)")
    del cache, leaves, start, results


def run_recurrent(arch: str, n_layers, profile_steps: int) -> None:
    """rwkv6-1.6b or zamba2-2.7b at full width in w4a4_lut (the served
    tree built a layer at a time), every admission monolithic at the
    prompt's exact length: fused over the 8 contract requests; the first
    replayed round against the op-by-op round from one state
    (``check_first_replay``); unfused over the first 4 and the plain
    backend over the first one (8 new tokens), each equal to the fused
    run; zamba2 also a sampled request fused == plain backend, and paged
    (shared-attention K/V in pages of 4, mamba state dense) over the first
    4 == dense; one decode step (every device row listed) and one replayed
    round profiled; zamba2 also its int8 KV engine over the first 4 (==
    bf16: no leaf changes)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.lutmul import ops
    from repro_torch.models import transformer
    from repro_torch.serve import ServeConfig, make_engine
    name = arch.split("-")[0]
    cfg = depth(get_config(arch, quant="w4a4_lut"), n_layers)
    V = cfg.vocab
    engine = new_engine(cfg, 256, arch)
    log(f"{name} state: {transformer.state_bytes(cfg, SLOTS)} B of "
        f"recurrent state and {engine.kv_cache_bytes(SLOTS)} B of K/V at "
        f"{SLOTS} slots, max_len 256; {inner_per_forward(cfg)} LUT launches "
        "a forward")
    ops.set_backend("cuda")
    ops.set_variant(None)
    fused = serve(engine, V, f"{name} lut fused", 8, "lutmul")
    check_first_replay(engine, V, name)
    ops.set_variant("unfused")
    same(serve(engine, V, f"{name} lut unfused", 4, "lutmul", fused=False),
         fused, f"{name} unfused == {name} fused")
    ops.set_variant(None)

    def first(sampled=False):
        reqs = make_requests(V, sampled=sampled)[:1]
        reqs[0].max_new_tokens = PLAIN_TOKENS
        return reqs
    ops.set_backend("ref")
    same(serve(engine, V, f"{name} lut plain", 1, reqs=first()),
         [fused[0][:PLAIN_TOKENS]], f"{name} plain == {name} fused")
    ops.set_backend("cuda")
    if cfg.family == "hybrid":
        sampled = serve(engine, V, f"{name} lut fused sampled, 1", 1,
                        "lutmul", reqs=first(sampled=True))
        ops.set_backend("ref")
        same(serve(engine, V, f"{name} lut plain sampled", 1,
                   reqs=first(sampled=True)), sampled,
             f"{name} plain sampled == {name} fused sampled")
        ops.set_backend("cuda")
        paged = make_engine(engine.params, cfg, ServeConfig(
            max_len=256, seed=SAMPLE_SEED, paged=True, page_size=4))
        same(serve(paged, V, f"{name} lut fused paged", 4, "lutmul"), fused,
             f"{name} paged == {name} dense")
        del paged
        # int8 KV changes no leaf of zamba2 (its one attention is the
        # shared block, whose K/V stay float, as the reference's)
        int8 = make_engine(engine.params, dataclasses.replace(
            cfg, kv_quant="int8"), ServeConfig(max_len=256,
                                               seed=SAMPLE_SEED))
        check_int8_bytes(int8, engine)
        f8 = serve(int8, V, f"{name} lut fused int8", 4, "lutmul")
        same(f8, fused, f"{name} int8 == {name} bf16")
        int8_family_summary(name, int8, engine, f8, fused)
        del int8
    # one call of each: a replayed round is tens of thousands of kernels;
    # the decode step lists every device row (the scan's ATen ops)
    profile_engine(engine, f"{name} lut", min(profile_steps, 1), detail=True)
    del engine
    torch.cuda.empty_cache()


def whisper_generate(engine, prompts, frames, new: int, label: str,
                     inner: str = None) -> list:
    """``Engine.generate(frames=)`` over every request, ``new`` tokens
    each, the launch counters zeroed just before and read just after;
    ``inner`` names the LUT entry point every forward launches (None: the
    plain backend, no launch).  Returns the transcripts."""
    import torch
    cfg = engine.cfg
    reset_peak()
    engine.decode_steps = 0
    reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(prompts, new, frames=frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    per_prefill = 6 * cfg.n_enc_layers + 12 * cfg.n_layers
    want = dict.fromkeys(launches, 0)
    if inner is not None:
        want[inner] = per_prefill + 8 * cfg.n_layers * (new - 1)
    if launches != want or engine.decode_steps != new - 1:
        raise AssertionError(f"{label}: launches {launches} != {want} "
                             f"({engine.decode_steps} decode steps)")
    toks = out[:, prompts.shape[1]:].tolist()
    n = len(toks)
    st = {"label": label, "requests": n, "seconds": dt,
          "new_tokens": new, "emitted_tokens": n * new,
          "tokens_per_s": n * new / dt,
          "decode_steps": engine.decode_steps, "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"serving[{label}]: {json.dumps(st)}")
    RUNS[label] = st
    return toks


def whisper_prefill_parts(engine, prompts, frames,
                          profile_steps: int) -> dict:
    """CUDA-event ms of a full-batch prefill and of its parts: the encoder,
    the decoder forward (whose cross-attention projects the encoder output
    a layer at a time), ``precompute_cross_kv`` (the reference's second
    projection of the same K/V) and one decode step; the LUT launches of a
    prefill and of a decode step; the eager decode step profiled (its
    device-busy share)."""
    import torch
    from repro_torch.models import encdec
    p, cfg = engine.params, engine.cfg
    enc = encdec.encode(p, cfg, frames)
    logits, cache = encdec.prefill(p, cfg, frames, prompts)
    cache = engine._grow_cache(cache, prompts.shape[1])
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((SLOTS,), prompts.shape[1], dtype=torch.int32,
                     device="cuda")
    counts = {}
    for name, fn in (("prefill", lambda: encdec.prefill(p, cfg, frames,
                                                        prompts)),
                     ("decode step", lambda: encdec.decode_step(
                         p, cfg, tok, cache, pos))):
        reset_launches()
        fn()
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in all_launches().items() if v}
    out = {"launches": counts,
           "prefill_ms": _event_ms(lambda: encdec.prefill(p, cfg, frames,
                                                          prompts), 3),
           "encode_ms": _event_ms(lambda: encdec.encode(p, cfg, frames), 3),
           "decoder_forward_ms": _event_ms(lambda: encdec.dec_forward(
               p, cfg, prompts, enc), 3),
           "cross_kv_second_pass_ms": _event_ms(
               lambda: encdec.precompute_cross_kv(
                   p, cfg, enc, [{} for _ in range(cfg.n_layers)]), 3),
           "decode_step_ms": _event_ms(lambda: encdec.decode_step(
               p, cfg, tok, cache, pos), 5)}
    out["cross_kv_second_pass_share"] = (out["cross_kv_second_pass_ms"]
                                         / out["prefill_ms"])
    if profile_steps:
        profile("whisper lut decode step", lambda: encdec.decode_step(
            p, cfg, tok, cache, pos), profile_steps)
    del enc, cache
    return out


def whisper_paged_check(engine, prompts, frames) -> None:
    """8 ``encdec.decode_step``s from one prefill, over the dense cache and
    through a page table (pages of WHISPER_PAGE tokens, each slot its own
    run of pages): logits and every layer's self-attention K/V bitwise
    equal."""
    import torch
    from repro_torch.models import attention, encdec
    p, cfg = engine.params, engine.cfg
    M = engine.scfg.max_len
    logits, cache = encdec.prefill(p, cfg, frames, prompts)
    dense = engine._grow_cache(cache, prompts.shape[1])
    E = M // WHISPER_PAGE
    table = (torch.arange(SLOTS * E, dtype=torch.int32, device="cuda")
             .reshape(SLOTS, E) + 1)
    pools = encdec.init_paged_cache(cfg, SLOTS, M, SLOTS * E + 1,
                                    WHISPER_PAGE, "cuda")
    for d, pc in zip(dense, pools):
        for key in ("k", "v"):
            pc[key][table.reshape(-1).long()] = d[key].reshape(
                (SLOTS * E, WHISPER_PAGE) + tuple(d[key].shape[2:]))
        pc["xk"].copy_(d["xk"])
        pc["xv"].copy_(d["xv"])
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((SLOTS,), prompts.shape[1], dtype=torch.int32,
                     device="cuda")
    for step in range(8):
        ld, dense = encdec.decode_step(p, cfg, tok, dense, pos)
        lp, pools = encdec.decode_step(p, cfg, tok, pools, pos, (table, None))
        if not _bits_equal(ld, lp):
            raise AssertionError(f"whisper paged decode step {step}: logits "
                                 "differ from the dense step's")
        tok = ld.argmax(-1).to(torch.int32)
        pos = pos + 1
    for i, (d, pc) in enumerate(zip(dense, pools)):
        for key in ("k", "v"):
            if not _bits_equal(attention.paged_gather(pc[key], table),
                               d[key]):
                raise AssertionError(f"whisper paged K/V differ: layer {i} "
                                     f"{key}")
    log(f"whisper paged: 8 decode steps through a page table of "
        f"{WHISPER_PAGE}-token pages ({SLOTS * E + 1} pages) == dense, "
        f"logits and {2 * cfg.n_layers} K/V leaves bitwise")
    del dense, pools


def run_whisper(n_layers, profile_steps: int) -> None:
    """whisper-large-v3 at full width (d 1280, enc_seq 1500; encoder and
    decoder at ``SERVED_LAYERS`` of their 32 layers) in w4a4_lut through
    ``Engine.generate(frames=)``: 8 requests of 4-token prompts over stub
    frames [8, 1500, 1280] (seed 0), 64 new tokens, fused; unfused (64 new
    tokens) and the plain backend (PLAIN_TOKENS) over all 8, every transcript
    equal to the fused one; the prefill's parts timed (the second cross-K/V
    pass apart), its launches and a decode step's counted, the decode step
    profiled; 8 decode steps through a page table == dense, bitwise."""
    import numpy as np
    import torch
    from repro_torch.configs import whisper_large_v3
    from repro_torch.kernels.lutmul import ops
    cfg = depth(whisper_large_v3.config(quant="w4a4_lut"), n_layers)
    engine = new_engine(cfg, WHISPER_MAX_LEN, "whisper-large-v3")
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn((SLOTS, cfg.enc_seq, cfg.d_model), generator=gen,
                         device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SLOTS, WHISPER_PROMPT)).astype(np.int32)).cuda()
    ops.set_backend("cuda")
    ops.set_variant(None)
    fused = whisper_generate(engine, prompts, frames, WHISPER_NEW,
                             "whisper lut fused", "lutmul_fused")
    parts = whisper_prefill_parts(engine, prompts, frames,
                                  min(profile_steps, 1))
    log(f"whisper prefill: {json.dumps(parts)}")
    ops.set_variant("unfused")
    same(whisper_generate(engine, prompts, frames, WHISPER_NEW,
                          "whisper lut unfused", "lutmul"),
         fused, "whisper unfused == whisper fused")
    ops.set_variant(None)
    ops.set_backend("ref")
    same(whisper_generate(engine, prompts, frames, PLAIN_TOKENS,
                          "whisper lut plain"),
         [t[:PLAIN_TOKENS] for t in fused], "whisper plain == whisper fused")
    ops.set_backend("cuda")
    whisper_paged_check(engine, prompts, frames)
    del engine, frames
    torch.cuda.empty_cache()


def vision_positions(B: int, text: int, grid: int):
    """[B, 2 * text + grid^2, 3] int32 M-RoPE ids on the card: ``text``
    tokens, a ``grid`` x ``grid`` patch grid (t fixed, h the row, w the
    column, offset by the text before it), then ``text`` tokens from the
    grid's max + 1."""
    import torch
    ids = [[i] * 3 for i in range(text)]
    ids += [[text, text + r, text + c] for r in range(grid)
            for c in range(grid)]
    ids += [[text + grid + i] * 3 for i in range(text)]
    return torch.tensor(ids, dtype=torch.int32, device="cuda")[None].expand(
        B, len(ids), 3).contiguous()


def vision_stub(engine, emb, mpos) -> list:
    """At model level on the served tree: a prefill of the stub frontend's
    embeddings at their 3-D positions, then QWEN2VL_STUB_STEPS greedy
    decode steps (positions ``pos``, as the reference's decode); returns
    every logits tensor and the final K/V."""
    import torch
    from repro_torch.models import transformer
    p, cfg = engine.params, engine.cfg
    B, S = emb.shape[:2]
    logits, pre = transformer.prefill(p, cfg, embeddings=emb,
                                      mrope_positions=mpos)
    T = S + QWEN2VL_STUB_STEPS
    cache = transformer.init_cache(cfg, B, T, "cuda")
    for c, q in zip(cache, pre):
        c["k"][:, :S] = q["k"]
        c["v"][:, :S] = q["v"]
    del pre
    outs = [logits]
    pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for _ in range(QWEN2VL_STUB_STEPS):
        tok = outs[-1].argmax(-1).to(torch.int32)
        logits, cache = transformer.decode_step(p, cfg, tok, cache, pos)
        outs.append(logits)
        pos = pos + 1
    return outs, cache


def run_qwen2vl(n_layers, profile_steps: int) -> None:
    """qwen2-vl-72b at full width (d 8192, 64 / 8 heads, d_ff 29568, vocab
    152064; ``SERVED_LAYERS`` of its 80 layers) in w4a4_lut, its served
    tree built a layer at a time: the Scheduler over the 8 contract
    requests (text: M-RoPE at t = h = w),
    fused; the plain backend over the first one (4 new tokens) equal to
    it; the vision stub (``vision_stub``: embeddings [2, 272, 8192] at a
    16 x 16 patch grid's positions, then 8 decode steps) fused == plain,
    every logit and the K/V bitwise; a text prefill under M-RoPE == the
    same under ``rope_mode="rope"`` bitwise; a profile."""
    import dataclasses
    import torch
    from repro_torch.configs import qwen2_vl_72b
    from repro_torch.kernels.lutmul import ops
    from repro_torch.models import transformer
    cfg = depth(qwen2_vl_72b.config(quant="w4a4_lut"), n_layers)
    V = cfg.vocab
    engine = new_engine(cfg, 256, "qwen2-vl-72b")
    log(f"qwen2vl KV: {engine.kv_cache_bytes(SLOTS)} B at {SLOTS} slots, "
        f"max_len 256; {inner_per_forward(cfg)} LUT launches a forward")
    ops.set_backend("cuda")
    ops.set_variant(None)
    fused = serve(engine, V, "qwen2vl lut fused", 8, "lutmul")
    ops.set_backend("ref")
    reqs = make_requests(V)[:1]
    reqs[0].max_new_tokens = QWEN2VL_PLAIN_TOKENS
    same(serve(engine, V, "qwen2vl lut plain", 1, reqs=reqs),
         [fused[0][:QWEN2VL_PLAIN_TOKENS]], "qwen2vl plain == qwen2vl fused")
    ops.set_backend("cuda")
    # the vision stub, fused and plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    mpos = vision_positions(QWEN2VL_STUB_ROWS, QWEN2VL_TEXT, QWEN2VL_GRID)
    emb = torch.randn((QWEN2VL_STUB_ROWS, mpos.shape[1], cfg.d_model),
                      generator=gen, device="cuda") * 0.02
    reset_launches()
    t0 = time.perf_counter()
    f_logits, f_cache = vision_stub(engine, emb, mpos)
    torch.cuda.synchronize()
    f_s = time.perf_counter() - t0
    launches = {k: v for k, v in all_launches().items() if v}
    want = {"lutmul_fused": inner_per_forward(cfg) * (
        1 + QWEN2VL_STUB_STEPS), "int_matmul_fused": 1 + QWEN2VL_STUB_STEPS}
    if launches != want:
        raise AssertionError(f"qwen2vl vision stub: launches {launches} != "
                             f"{want}")
    ops.set_backend("ref")
    t0 = time.perf_counter()
    p_logits, p_cache = vision_stub(engine, emb, mpos)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    ops.set_backend("cuda")
    for i, (a, b) in enumerate(zip(f_logits, p_logits)):
        if not _bits_equal(a, b):
            raise AssertionError(f"qwen2vl vision stub: logits {i} fused != "
                                 "plain")
    for i, (a, b) in enumerate(zip(f_cache, p_cache)):
        if not (_bits_equal(a["k"], b["k"]) and _bits_equal(a["v"],
                                                            b["v"])):
            raise AssertionError(f"qwen2vl vision stub: layer {i} K/V fused "
                                 "!= plain")
    log(f"qwen2vl vision stub: prefill of embeddings {list(emb.shape)} at "
        f"a {QWEN2VL_GRID}x{QWEN2VL_GRID} patch grid's 3-D positions + "
        f"{QWEN2VL_STUB_STEPS} decode steps, fused == plain bitwise (every "
        f"logit, {2 * cfg.n_layers} K/V leaves); launches {launches}; "
        f"fused {f_s:.2f}s, plain {p_s:.2f}s; greedy tokens "
        f"{[t.argmax(-1).tolist() for t in f_logits]}")
    del f_logits, f_cache, p_logits, p_cache, emb
    # M-RoPE at t = h = w is RoPE, bitwise
    toks = torch.tensor([r.prompt[:8] for r in make_requests(V)],
                        dtype=torch.int32, device="cuda")
    lm, cm = transformer.prefill(engine.params, cfg, toks)
    lr, cr = transformer.prefill(engine.params,
                                 dataclasses.replace(cfg, rope_mode="rope"),
                                 toks)
    if not _bits_equal(lm, lr) or not all(
            _bits_equal(a["k"], b["k"]) for a, b in zip(cm, cr)):
        raise AssertionError("qwen2vl: a text prefill under M-RoPE differs "
                             "from rope_mode='rope'")
    log(f"qwen2vl text prefill {list(toks.shape)}: M-RoPE == rope bitwise "
        f"(logits and {cfg.n_layers} rotated K leaves)")
    del lm, cm, lr, cr
    # the replayed round alone: the profiler's trace of an eager 80-layer
    # step takes ~20 s to read
    profile_engine(engine, "qwen2vl lut", min(profile_steps, 1), eager=False)
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the mixed phase: the paper's analytic model, planned mixed widths, the
# timed formulation picker
# ---------------------------------------------------------------------------

def paper_model() -> None:
    """The paper's own figures from ``core.lut`` and ``core.fpga_model``:
    analytic numbers for an AMD Alveo U280 at 333 MHz, not measurements of
    this card (nothing here runs on it)."""
    from repro_torch.core import fpga_model as fm
    from repro_torch.core.lut import (PAPER_FIG5_INIT_WORDS,
                                      lut6_2_init_words, luts_per_multiply,
                                      luts_per_multiply_general)
    from repro_torch.models.mobilenet import (MobileNetConfig,
                                              fpga_layer_table)
    words = tuple(lut6_2_init_words(1, -3))
    if words != PAPER_FIG5_INIT_WORDS:
        raise AssertionError(f"Fig. 5 INIT words {words} != the paper's")
    peaks = {"dsp_gops": fm.dsp_peak_ops(fm.U280, 4) / 1e9,
             "lutmul_gops_by_overhead": {
                 ovh: fm.lutmul_peak_ops(fm.U280, 4, lut_overhead=ovh) / 1e9
                 for ovh in (1.0, 2.0, PAPER_OVERHEAD)}}
    layers = fpga_layer_table(MobileNetConfig())
    bal = fm.balance_folding(layers, PAPER_LUT_BUDGET, fm.U280.freq_hz,
                             PAPER_OVERHEAD,
                             full_parallel_prefix=PAPER_PREFIX)
    gops = bal["fps"] * sum(lyr.ops for lyr in layers) / 1e9
    log(f"paper model (analytic: AMD Alveo U280 at 333 MHz, not measured "
        f"on any chip): Fig. 5 INIT words for (+1, -3) "
        f"{[hex(w) for w in words]} == the paper's; LUT6 a 4-bit multiply "
        f"{luts_per_multiply(4)} (a general multiplier "
        f"{luts_per_multiply_general(4)}); 4-bit peaks "
        f"{json.dumps(peaks)}; MobileNetV2 folded into {PAPER_LUT_BUDGET} "
        f"LUTs at overhead {PAPER_OVERHEAD}, the first {PAPER_PREFIX} layers "
        f"unfolded: fps {bal['fps']} ({gops} GOPS), total LUTs "
        f"{bal['total_luts']}, folds {bal['folds']}")


def _path_get(tree, path: str):
    """The subtree at a walk path (``"['blocks'][3]['mlp']['wi']"``)."""
    import re
    for key, idx in re.findall(r"\['([^']+)'\]|\[(\d+)\]", path):
        tree = tree[key] if key else tree[int(idx)]
    return tree


def plan_code_bytes(shapes: dict, plan: dict) -> int:
    """Code bytes a plan's served tree holds, from the float tree's shapes:
    P x K/8 x N a planned bitplane leaf, K x N the int8 head."""
    from repro_torch.core.lut import plane_decomposition
    from repro_torch.kernels.lutmul import ops
    n = 0
    for path, mode in plan.items():
        K, N = _path_get(shapes, path).shape
        n += plane_decomposition(ops.parse_mode(mode)[1])[0] * K // 8 * N
    K, N = shapes["lm_head"]["w"].shape
    return n + K * N


def check_planes(engine, plan: dict) -> None:
    """Every planned leaf is served as bitplanes at its plan's width."""
    from repro_torch.core.lut import plane_decomposition
    from repro_torch.kernels.lutmul import ops
    for path, mode in plan.items():
        leaf = _path_get(engine.params, path[:-len("['w']")])
        want = plane_decomposition(ops.parse_mode(mode)[1])[0]
        if "w_tmac" not in leaf or leaf["w_q"].shape[0] != want:
            raise AssertionError(f"{path}: served {tuple(leaf['w_q'].shape)}"
                                 f", the plan says {mode}")


def mixed_plans(cfg) -> tuple:
    """``plan_mixed_bits`` of full-width qwen2-7b at 4.0 and each
    ``MIXED_TARGETS`` from its shapes alone (``init_params`` on the meta
    device: no float weight anywhere), checked against ``MIXED_MLP``
    (attention w4), and the shape tree."""
    from repro_torch.models import transformer
    from repro_torch.roofline.analysis import count_params, plan_mixed_bits
    t0 = time.perf_counter()
    shapes = transformer.init_params(cfg, device="meta")
    plans = {t: plan_mixed_bits(shapes, t, cfg) for t in
             (4.0,) + MIXED_TARGETS}
    for t, plan in plans.items():
        mlp = MIXED_MLP.get(t, dict.fromkeys(("wg", "wi", "wo"), 4))
        want = {}
        for i in range(cfg.n_layers):
            for leaf in ("wq", "wk", "wv", "wo"):
                want[f"['blocks'][{i}]['attn']['{leaf}']['w']"] = "w4a4_tmac"
            for leaf, bits in mlp.items():
                want[f"['blocks'][{i}]['mlp']['{leaf}']['w']"] = \
                    f"w{bits}a4_tmac"
        if plan != want:
            raise AssertionError(f"plan at {t} bits: {plan}")
        first = {k.split("]", 1)[1]: v for k, v in plan.items()
                 if k.startswith("['blocks'][0]")}
        log(f"plan[qwen2-7b, {t} bits]: every one of {cfg.n_layers} layers "
            f"{json.dumps(first)}; codes {plan_code_bytes(shapes, plan)} B "
            "with the int8 head")
    log(f"plans: {count_params(shapes)['total']} parameters, planned from "
        f"shapes in {time.perf_counter() - t0:.1f}s")
    return shapes, plans


def formulation_launches(params) -> dict:
    """Kernel launches a forward of a suffix-free sub-4-bit model: the
    T-MAC kernel for each bitplane leaf, the LUT kernel for each nibble
    leaf (``ops.lut_leaf``), by the formulation each leaf was stored in."""
    out = {}
    for blk in params["blocks"]:
        for grp in blk.values():
            for leaf in (grp.values() if isinstance(grp, dict) else ()):
                if isinstance(leaf, dict) and "w_q" in leaf:
                    k = "lutmul_tmac" if "w_tmac" in leaf else "lutmul"
                    out[k] = out.get(k, 0) + 1
    return out


def run_mixed(n_layers, profile_steps: int) -> None:
    """The paper's analytic model (printed), then qwen2-7b at full width
    and ``MIXED_LAYERS`` layers under its planned mixed widths (planned
    on the full 28-layer shapes, cut to the served layers): uniform
    w4a4_tmac (the plan at 4.0) fused over the 8 requests, then each
    ``MIXED_TARGETS`` plan fused (8) == the plain backend (the first
    request, ``PLAIN_TOKENS``; the unfused runs were cut for the sharded
    phase's time), plane counts and code bytes checked, a replayed round
    profiled; the all-w4 plan over nibble-mode float layers at the cut
    depth == the w4a4_tmac run there; then the timed formulation picker."""
    import dataclasses
    import torch
    from repro_torch.configs import qwen2_7b
    from repro_torch.kernels.lutmul import ops
    paper_model()
    full = qwen2_7b.config(quant="w4a4_tmac")
    shapes, plans = mixed_plans(full)
    cfg = depth(full, min(n_layers or MIXED_LAYERS, MIXED_LAYERS))
    V = cfg.vocab

    def cut(plan, layers):
        return {k: v for k, v in plan.items()
                if int(k.split("][")[1]) < layers}

    ops.set_backend("cuda")
    ops.set_variant(None)
    summary = {}
    for t in (4.0,) + MIXED_TARGETS:
        plan = cut(plans[t], cfg.n_layers)
        name = "w4a4_tmac" if t == 4.0 else f"mixed {t}"
        engine = new_engine(cfg, 256, f"qwen2-7b {name}", bits_plan=plan)
        check_planes(engine, plan)
        kinds = served_bytes(engine.params)
        got = kinds["uint8 codes"] + kinds["int8 codes"]
        want = plan_code_bytes(shapes, plan)
        if got != want:
            raise AssertionError(f"{name}: {got} code bytes, the shapes "
                                 f"give {want}")
        fused = serve(engine, V, f"qwen {name} fused", 8, "lutmul_tmac")
        if t != 4.0:
            ops.set_backend("ref")
            same(serve(engine, V, f"qwen {name} plain", 1,
                       reqs=first_request(V)), [fused[0][:PLAIN_TOKENS]],
                 f"qwen {name} plain == qwen {name} fused")
            ops.set_backend("cuda")
        profile_engine(engine, f"qwen {name}", min(profile_steps, 1),
                       eager=False)
        st = RUNS[f"qwen {name} fused"]
        summary[name] = {
            "code_bytes": got, "ms_per_decode_step": st["ms_per_decode_step"],
            "ms_per_decode_step_after_capture":
                st["ms_per_decode_step_after_capture"],
            "tokens_per_s": st["tokens_per_s"],
            "tokens_per_s_after_capture": st["tokens_per_s_after_capture"],
            "keys": st["graphs"]["keys_captured"],
            "capture_s": st["graphs"]["capture_s"],
            "peak_gib": st["peak_gib"],
            "round_device_ms": PROFILES.get(
                f"qwen {name} decode round, replayed", {}).get(
                "device_ms_per_call")}
        del engine
        torch.cuda.empty_cache()
    log(f"mixed runs[{cfg.n_layers} layers]: {json.dumps(summary)}")
    layers = min(CUT_LAYERS, n_layers or CUT_LAYERS)
    ccfg = dataclasses.replace(full, n_layers=layers)
    plan4 = cut(plans[4.0], layers)
    # the plan alone makes these leaves bitplanes: the layers quantize
    # under w4a4_lut (nibbles) but for the plan
    engine = new_engine(ccfg, 256, "qwen2-7b all-w4 plan (cut)",
                        bits_plan=plan4, mode="w4a4_lut")
    check_planes(engine, plan4)
    got = serve(engine, V, f"qwen{layers} all-w4 plan fused", 4,
                "lutmul_tmac")
    del engine
    if TRANSCRIPTS.get("tmac cut", (None,))[0] != layers:
        tmac = new_engine(ccfg, 256, "qwen2-7b (cut, w4a4_tmac)")
        TRANSCRIPTS["tmac cut"] = (layers, serve(
            tmac, V, f"qwen{layers} tmac fused, 4", 4, "lutmul_tmac"))
        del tmac
    same(got, TRANSCRIPTS["tmac cut"][1],
         f"qwen{layers} all-w4 plan == qwen{layers} tmac fused")
    run_picker(ccfg, V)
    torch.cuda.empty_cache()


def run_picker(ccfg, V: int) -> None:
    """With autotuning on, ``pick_formulation`` times the T-MAC kernel
    against the one-hot LUT kernel at qwen2-7b's four inner shapes at w2,
    w3 and w4 (a4); then a suffix-free ``w2a4`` model at the cut depth,
    under the timed choice and with the other formulation forced at every
    shape, each over 4 requests == the explicit ``w2a4_tmac`` run (the
    same integer sums, the same epilogue), every leaf launching the kernel
    of the format it was stored in."""
    import dataclasses
    from repro_torch.kernels.lutmul import ops
    layers = ccfg.n_layers
    keys = {}
    ops.set_autotune(True)
    try:
        table = {}
        for wbits in (2, 3, 4):
            for name, (K, N) in PICKER_SHAPES.items():
                key = (wbits, 4, K, N, "cuda")
                ops._FORMULATION_CACHE.pop(key, None)
                win = ops.pick_formulation(wbits, 4, K, N, "cuda")
                table[f"w{wbits} {name} {K}x{N}"] = {
                    **ops.FORMULATION_TIMES[key], "winner": win}
                if wbits == 2:
                    keys[key] = win
    finally:
        ops.set_autotune(None)
    log(f"formulation picker[M={ops.PROBE_M}, ms]: {json.dumps(table)}")
    tm = new_engine(dataclasses.replace(ccfg, quant="w2a4_tmac"), 256,
                    "qwen2-7b (cut, w2a4_tmac)")
    want = serve(tm, V, f"qwen{layers} w2a4_tmac fused", 4, "lutmul_tmac")
    del tm
    lut_runs = 0
    try:
        for forced in (False, True):
            if forced:
                for key, win in keys.items():
                    ops._FORMULATION_CACHE[key] = ("onehot" if win == "tmac"
                                                   else "tmac")
            label = f"qwen{layers} w2a4 " + ("forced the other way" if forced
                                             else "timed")
            eng = new_engine(dataclasses.replace(ccfg, quant="w2a4"), 256,
                             f"qwen2-7b (cut, {label})")
            per = formulation_launches(eng.params)
            log(f"{label}: launches a forward {json.dumps(per)}")
            same(serve(eng, V, label, 4, per), want,
                 f"{label} == qwen{layers} w2a4_tmac fused")
            lut_runs += RUNS[label]["launches"].get("lutmul_fused", 0) > 0
            del eng
    finally:
        for key in keys:
            ops._FORMULATION_CACHE.pop(key, None)
    if not lut_runs:
        raise AssertionError("no w2a4 run launched lutmul_fused")


def run_bitnet(n_layers: int, profile_steps: int) -> None:
    import dataclasses
    import torch
    from repro_torch.configs import bitnet_3b
    from repro_torch.kernels.lutmul import ops
    from repro_torch.models import transformer
    from repro_torch.serve import ServeConfig, make_engine

    cfg = depth(bitnet_3b.config(), n_layers)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    engine = make_engine(params, cfg,
                         ServeConfig(quant="ternary_a8_tmac", max_len=256))
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"model: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.quant}; init + quantize "
        f"{time.perf_counter() - t0:.1f}s")
    fused = serve(engine, cfg.vocab, "bitnet tmac fused", 8, "lutmul_tmac")
    profile_engine(engine, "bitnet tmac", profile_steps)
    ops.set_backend("ref")
    same(serve(engine, cfg.vocab, "bitnet tmac plain", 1), fused,
         "bitnet plain == bitnet fused")
    ops.set_backend(None)
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the paper's CNN
# ---------------------------------------------------------------------------

def pointwise_codes(params, cfg, x, scale):
    """Walk ``_conv_shapes`` with the port's own layer functions in float
    mode: the uint4 codes (``quantize(h, scale, 0, A4)``, int8 [rows, C])
    of the activation entering each 1x1 convolution, and the logits."""
    import torch
    from repro_torch.core.quantization import A4, quantize
    from repro_torch.models.mobilenet import (_bn_only, _bn_relu6, _conv,
                                              _conv_shapes)
    codes = {}
    h, inp, block = x, None, None
    for name, _, _, k, s, dw, _ in _conv_shapes(cfg)[0]:
        p = params[name]
        if name not in ("stem", "head") and name.rsplit("_", 1)[0] != block:
            block, inp = name.rsplit("_", 1)[0], h      # a block's input
        if k == 1:
            codes[name] = quantize(h.reshape(-1, h.shape[-1]), scale, 0, A4)
        y = _conv(p, h, k, s, dw, None, False)
        if name.endswith("project"):
            y = _bn_only(p, y)
            if inp.shape == y.shape:                    # inverted residual
                y = y + inp
        else:
            y = _bn_relu6(p, y, None, False)
        h = y
    return codes, torch.mean(h, dim=(1, 2)) @ params["fc"]["w"] \
        + params["fc"]["b"]


def run_mobilenet(bench: Bench) -> None:
    """Full-width MobileNetV2 at batch 32: float and QAT forwards, then its
    34 pointwise convolutions as integer stages (LUT + threshold kernels,
    then the gather baseline + threshold kernel)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lut import pack_int4
    from repro_torch.core.streamline import (float_stage_reference,
                                             integer_stage_forward,
                                             streamline_stage)
    from repro_torch.core.thresholds import BNParams
    from repro_torch.kernels.lutmul import kernel, ops, ref
    from repro_torch.kernels.thresholds import kernel as tkernel
    from repro_torch.kernels.thresholds import ops as tops
    from repro_torch.kernels.thresholds import ref as tref
    from repro_torch.models import mobilenet

    cfg = get_config("mobilenetv2")
    params = mobilenet.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cuda")
    images = np.random.default_rng(0).standard_normal(
        (MB_BATCH, cfg.resolution, cfg.resolution, 3)).astype(np.float32)
    x = torch.from_numpy(images).cuda()
    log(f"model: {cfg.name} width {cfg.width}, {cfg.resolution}x"
        f"{cfg.resolution}, {cfg.n_classes} classes, "
        f"{len(mobilenet._conv_shapes(cfg)[0])} convolutions, batch "
        f"{MB_BATCH}")

    # float and QAT forwards on the card; the first MB_CHECK images again
    # on the CPU.  Float logits are held to MB_FLOAT_RTOL of their largest
    # magnitude: 52 float32 convolutions sum in other orders on cuDNN
    # (which may pick Winograd or FFT algorithms) than on the CPU.
    cpu_params = {k: {n: v.cpu() for n, v in p.items()}
                  for k, p in params.items()}
    xc = torch.from_numpy(images[:MB_CHECK])
    st = {"batch": MB_BATCH}
    with torch.no_grad():
        for mode, qat in (("float", False), ("qat", True)):
            ms = _time(lambda: mobilenet.forward(params, cfg, x,
                                                 train_qat=qat), 5,
                       bench.flush)
            out = mobilenet.forward(params, cfg, x, train_qat=qat)
            if out.shape != (MB_BATCH, cfg.n_classes) \
                    or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"mobilenetv2 {mode}: logits "
                                     f"{tuple(out.shape)} not all finite")
            small = out[:MB_CHECK] if not qat else mobilenet.forward(
                params, cfg, x[:MB_CHECK], train_qat=True)
            cpu = mobilenet.forward(cpu_params, cfg, xc, train_qat=qat)
            err = float((small.cpu() - cpu).abs().max())
            amax = float(cpu.abs().max())
            top1 = float((small.cpu().argmax(-1) == cpu.argmax(-1))
                         .float().mean())
            st[mode] = {"ms_per_batch": ms,
                        "images_per_s": MB_BATCH / ms * 1e3,
                        "max_abs_dlogit_vs_cpu": err,
                        "max_abs_logit": amax, "top1_agree_vs_cpu": top1}
            if mode == "float":
                float_logits = out
                if err > MB_FLOAT_RTOL * amax:
                    raise AssertionError(
                        f"mobilenetv2 float: |dlogit| {err} > "
                        f"{MB_FLOAT_RTOL} x {amax} against the CPU")
        log(f"mobilenetv2 forwards: {json.dumps(st)}")

        # the integer pass: the 34 pointwise convolutions as streamlined
        # stages on the uint4 codes of their float inputs
        scale = torch.tensor(6.0 / 15, device="cuda")
        codes, walk = pointwise_codes(params, cfg, x, scale)
        werr = float((walk - float_logits).abs().max())
        if werr > MB_FLOAT_RTOL * float(float_logits.abs().max()):
            raise AssertionError(f"the pointwise walk's logits differ from "
                                 f"the forward's by {werr}")
        stages = {}
        for name, a in codes.items():
            p = params[name]
            bn = BNParams(p["bn_gamma"], p["bn_beta"], p["bn_mean"],
                          p["bn_var"])
            stages[name] = (streamline_stage(p["w"][0, 0], bn, scale), bn)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs = {name: integer_stage_forward(stages[name][0], a)
                for name, a in codes.items()}
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = len(codes)
        want = dict.fromkeys(all_launches(), 0)
        want.update(lutmul=n, threshold=n)
        RUNS["mobilenetv2 integer pass"] = {
            "seconds": dt, "stages": n, "launches": all_launches(),
            "forwards_by_lane": None}
        if all_launches() != want:
            raise AssertionError(f"integer pass: launches {all_launches()} "
                                 f"!= {want}")

        # every stage against its plain versions, the direct kernel stage
        # and the float reference (none of these launches count)
        equal = total = 0
        inputs = {}
        for name, a in codes.items():
            stage, bn = stages[name]
            au = a.to(torch.uint8) & 0xF
            wp = pack_int4(stage.w_codes.T).T.contiguous()
            inputs[name] = (au, wp)
            cap = stage.relu6_cap_code[None, :]
            q = tref.threshold_ref(ref.lutmul_ref(au, wp, a_signed=False),
                                   stage.thresholds, stage.sign)
            if not torch.equal(torch.minimum(q.clamp_min(0), cap),
                               outs[name]):
                raise AssertionError(f"{name}: integer stage != plain")
            direct = tops.lutmul_threshold_stage(au, wp, stage.thresholds,
                                                 stage.sign)
            if not torch.equal(direct, q):
                raise AssertionError(f"{name}: lutmul_threshold_stage != "
                                     "plain")
            fref = float_stage_reference(params[name]["w"][0, 0], bn, scale,
                                         a)
            d = (outs[name] - fref).abs()
            if int(d.max()) > 1:
                raise AssertionError(f"{name}: integer codes differ from "
                                     f"the float reference by {int(d.max())}")
            equal += int((d == 0).sum())
            total += d.numel()
        log(f"integer pass: {n} stages, {total} codes, {dt * 1e3:.1f} ms "
            f"(host clock), launches "
            f"{json.dumps(RUNS['mobilenetv2 integer pass']['launches'])}; "
            f"equal to "
            f"the plain versions; share equal to the float reference "
            f"{equal / total:.9f} ({total - equal} codes off by one)")

        # the gather pass: the same stages through the serial baseline
        reset_launches()
        t0 = time.perf_counter()
        gathered = {}
        for name, (au, wp) in inputs.items():
            stage = stages[name][0]
            acc = ops.lutmul_gather(au, wp, a_signed=False)
            q = tops.threshold(acc, stage.thresholds, stage.sign)
            gathered[name] = torch.minimum(q.clamp_min(0),
                                           stage.relu6_cap_code[None, :])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = dict.fromkeys(all_launches(), 0)
        want.update(lutmul_gather=n, threshold=n)
        RUNS["mobilenetv2 gather pass"] = {
            "seconds": dt, "stages": n, "launches": all_launches(),
            "forwards_by_lane": None}
        if all_launches() != want:
            raise AssertionError(f"gather pass: launches {all_launches()} "
                                 f"!= {want}")
        for name in inputs:
            if not torch.equal(gathered[name], outs[name]):
                raise AssertionError(f"{name}: gather codes != integer "
                                     "pass codes")
        log(f"gather pass: {n} stages, {dt * 1e3:.1f} ms (host clock), "
            f"codes identical to the integer pass")
        del gathered, outs

        # the kernels at every stage's shape
        group = MB_GROUP
        for name, (au, wp) in inputs.items():
            stage = stages[name][0]
            M, K = au.shape
            N = wp.shape[1]
            L = stage.thresholds.shape[1]
            a8 = au.to(torch.int8)
            w8 = stage.w_codes.contiguous()
            acc = ref.lutmul_ref(au, wp, a_signed=False)
            lib = _library_ms(a8, w8, acc, bench.flush, bench.reps)
            bench.lut("lutmul", group,
                      lambda: kernel.lutmul(au, wp, a_signed=False),
                      lambda: ref.lutmul_ref(au, wp, a_signed=False), lib,
                      M, K, N)
            bench.lut("lutmul_gather", group,
                      lambda: kernel.lutmul_gather(au, wp, a_signed=False),
                      lambda: ref.lutmul_ref(au, wp, a_signed=False), lib,
                      M, K, N)
            thr, sign = stage.thresholds, stage.sign
            want = tref.threshold_ref(acc, thr, sign)
            lib = _searchsorted_ms(acc, thr, sign, want, bench)
            bench.one("threshold", group,
                      lambda: tkernel.threshold(acc, thr, sign),
                      lambda: tref.threshold_ref(acc, thr, sign), lib,
                      {"M": M, "N": N, "L": L},
                      8 * M * N + 4 * N * (L + 1), M * N * (L + 1),
                      F32_OPS_PER_S)
            del acc, want
        log("threshold stages (M x N: ms, bound_ms / ms): " + "; ".join(
            f"{s['M']}x{s['N']}: {s['ms']:.4f} {s['bound_ms'] / s['ms']:.3f}"
            for s in bench.recs["threshold"]["groups"][group]["shapes"]))
    del params, codes, inputs
    torch.cuda.empty_cache()


PLAIN_FNS = ("lutmul_ref", "int_matmul_ref", "tmac_ref", "scaled_lutmul_ref",
             "scaled_int_matmul_ref", "scaled_tmac_ref", "dequant_epilogue")


class PlainCalls:
    """Counts the calls of the LUT family's plain versions
    (``kernels.lutmul.ref``) inside a ``with`` block."""

    def __enter__(self):
        from repro_torch.kernels.lutmul import ref
        self.ref, self.saved, self.calls = ref, {}, 0
        for name in PLAIN_FNS:
            fn = self.saved[name] = getattr(ref, name)

            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)
            setattr(ref, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ref, name, fn)
        return False


def _train_steps(step_fn, state, batches: list, label: str) -> tuple:
    """Run ``step_fn`` over ``batches``: (state, per-step metrics with the
    CUDA-event spans ``grads_s``, ``update_s`` and ``step_s``)."""
    from repro_torch.train.loop import StepTimer
    hist = []
    for i, batch in enumerate(batches):
        timer = StepTimer("cuda")
        timer.start()
        state, m = step_fn(state, batch, mark=timer.mark)
        sp = timer.seconds()
        m = {k: float(v) for k, v in m.items()}
        m.update(step=i, grads_s=sp["grads"], update_s=sp["update"],
                 step_s=sp["total"])
        hist.append(m)
        log(f"{label} step {i}: loss {m['loss']!r} grad_norm "
            f"{m['grad_norm']!r} lr {m['lr']!r} fwd+bwd {sp['grads'] * 1e3:.1f}"
            f" ms opt+proj {sp['update'] * 1e3:.1f} ms")
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"{label} step {i}: non-finite {m}")
    return state, hist


def _step_summary(hist: list, items: int) -> dict:
    """Median spans over the steps (ms) and items a second."""
    med = {k: _median([h[k] for h in hist])
           for k in ("grads_s", "update_s", "step_s")}
    return {"fwd_bwd_ms": med["grads_s"] * 1e3,
            "opt_proj_ms": med["update_s"] * 1e3,
            "step_ms": med["step_s"] * 1e3,
            "per_s": items / med["step_s"]}


def run_train() -> None:
    """Training on the card: (a) minicpm-2b QAT at full width and depth
    (40 layers, remat "full", WSD, the W4 projection after each update)
    for TRAIN_STEPS steps of B x S tokens, finite and falling loss, peak
    memory under TRAIN_PEAK_LIMIT; (b) the trained model evaluated as
    deployed (``loop.make_eval_fn``) in w4a4_mxu and w4a4_lut: every
    projection through the fused int8 or LUT kernel (7 x 40 launches a
    batch), no plain version called, the weight quantizations the same for
    1 batch as for 2; (c) MobileNetV2's full config in QAT for
    MB_TRAIN_STEPS steps of 32 images at 224 x 224, then ``loop.run``
    uninterrupted and with one injected failure, under deterministic
    algorithms, the two loss histories compared."""
    import tempfile
    import torch
    from repro_torch.configs import minicpm_2b, mobilenetv2
    from repro_torch.core.tree import flatten
    from repro_torch.data import pipeline
    from repro_torch.kernels.lutmul import ops
    from repro_torch.models import mobilenet, transformer
    from repro_torch.train import loop as tloop
    from repro_torch.train import step as tstep

    # (a) minicpm-2b QAT, full width and depth
    cfg = minicpm_2b.config(quant="qat")
    if cfg.n_layers != 40 or cfg.remat != "full":
        raise AssertionError(f"train: minicpm-2b is {cfg.n_layers} layers, "
                             f"remat {cfg.remat!r}")
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                               global_batch=TRAIN_B)
    tcfg = tstep.TrainConfig(schedule="wsd", qat_project=True, peak_lr=1e-3,
                             warmup=2, total_steps=8)
    reset_peak(empty=True)
    base = torch.cuda.memory_allocated()
    state = tstep.init_state(transformer.init_params(cfg, seed=0))
    n_params = sum(p.numel() for p in flatten(state["params"])[1])
    step_fn = tstep.make_train_step(cfg, tcfg, donate=True)
    state, hist = _train_steps(
        step_fn, state, [pipeline.lm_batch(dcfg, i)
                         for i in range(TRAIN_STEPS)], "minicpm-2b qat")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    summ = _step_summary(hist, TRAIN_M)
    log(f"minicpm-2b qat train: {n_params} parameters, {cfg.n_layers} layers"
        f", B {TRAIN_B} S {TRAIN_S}; median step {summ['step_ms']:.1f} ms "
        f"(CUDA events): fwd+bwd {summ['fwd_bwd_ms']:.1f} ms, opt+proj "
        f"{summ['opt_proj_ms']:.1f} ms; {summ['per_s']:.1f} tokens/s; peak "
        f"{peak} bytes; losses {[h['loss'] for h in hist]}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"minicpm-2b qat: the loss did not fall: "
                             f"{[h['loss'] for h in hist]}")
    if peak >= TRAIN_PEAK_LIMIT:
        raise AssertionError(f"minicpm-2b qat: peak {peak} bytes >= "
                             f"{TRAIN_PEAK_LIMIT}")
    TRAIN["minicpm"] = {**summ, "peak_bytes": peak, "params": n_params,
                        "losses": [h["loss"] for h in hist],
                        "grad_norms": [h["grad_norm"] for h in hist]}

    # (b) the trained model as deployed, through the fused kernels
    ebatches = [pipeline.lm_batch(dcfg, 10 ** 6 + i) for i in range(2)]
    ops.set_backend("cuda")
    ops.set_variant(None)
    per_batch = 7 * cfg.n_layers
    for mode, kern in (("w4a4_mxu", "int_matmul_fused"),
                       ("w4a4_lut", "lutmul_fused")):
        evaluate = tloop.make_eval_fn(cfg, mode)
        deltas, losses = [], []
        with PlainCalls() as plain:
            for n in (1, 2):
                c0 = ops.WEIGHT_QUANT_COUNT
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(evaluate(state["params"], ebatches[:n]))
                dt = time.perf_counter() - t0
                deltas.append(ops.WEIGHT_QUANT_COUNT - c0)
                got = all_launches()
                want = dict.fromkeys(got, 0)
                want[kern] = per_batch * n
                if got != want:
                    raise AssertionError(f"eval {mode} over {n} batches: "
                                         f"launches {got} != {want}")
        if plain.calls:
            raise AssertionError(f"eval {mode}: {plain.calls} plain-version "
                                 "calls")
        if not (deltas[0] == deltas[1] > 0):
            raise AssertionError(f"eval {mode}: WEIGHT_QUANT_COUNT moved "
                                 f"{deltas} for 1 and 2 batches")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"eval {mode}: losses {losses}")
        RUNS[f"train eval {mode}"] = {"seconds": dt, "launches": got,
                                      "forwards_by_lane": None}
        TRAIN[f"eval {mode}"] = {"loss": losses[1], "seconds": dt,
                                 "weight_quant_events": deltas[1],
                                 "launches": {kern: got[kern]}}
        log(f"minicpm-2b eval {mode} (2 held-out batches): loss "
            f"{losses[1]!r} (1 batch {losses[0]!r}) beside the last QAT "
            f"training loss {hist[-1]['loss']!r}; {kern} launches "
            f"{got[kern]} (7 x {cfg.n_layers} a batch), plain versions 0, "
            f"weight quantizations {deltas} for 1 and 2 batches; "
            f"{dt:.2f} s (host clock)")
    del state, step_fn, hist
    reset_peak(empty=True)

    # (c) MobileNetV2 QAT at the paper's resolution, then the loop
    mcfg = mobilenetv2.config(quant="qat")

    def mb_params():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return mobilenet.init_params(mcfg, gen)
    mt = tstep.TrainConfig(qat_project=True, peak_lr=1e-3, warmup=1,
                           total_steps=LOOP_STEPS)
    idata = pipeline.DataConfig(global_batch=MB_BATCH)
    state = tstep.init_state(mb_params())
    state, mhist = _train_steps(
        tstep.make_train_step(mcfg, mt, donate=True), state,
        [pipeline.image_batch(idata, i, resolution=mcfg.resolution,
                              n_classes=mcfg.n_classes)
         for i in range(MB_TRAIN_STEPS)], "mobilenetv2 qat")
    msumm = _step_summary(mhist, MB_BATCH)
    TRAIN["mobilenetv2"] = {**msumm, "losses": [h["loss"] for h in mhist]}
    log(f"mobilenetv2 qat train (width {mcfg.width}, {mcfg.n_classes} "
        f"classes, {mcfg.resolution}x{mcfg.resolution}, batch {MB_BATCH}): "
        f"median step {msumm['step_ms']:.1f} ms (fwd+bwd "
        f"{msumm['fwd_bwd_ms']:.1f}, opt+proj {msumm['opt_proj_ms']:.1f}); "
        f"{msumm['per_s']:.1f} images/s")
    del state

    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    runs = {}
    try:
        for label, fail in (("uninterrupted", None), ("failure", LOOP_FAIL)):
            with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
                t0 = time.perf_counter()
                runs[label] = tloop.run(
                    mcfg, mb_params, idata, mt,
                    tloop.RunConfig(steps=LOOP_STEPS, ckpt_every=LOOP_CKPT,
                                    ckpt_dir=d, fail_at_step=fail),
                    batch_kind="image")
                runs[label]["seconds"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = runs["uninterrupted"], runs["failure"]
    if a["restarts"] != 0 or b["restarts"] != 1:
        raise AssertionError(f"loop restarts {a['restarts']}, "
                             f"{b['restarts']}")
    la = {m["step"]: m["loss"] for m in a["history"]}
    lb = {m["step"]: m["loss"] for m in b["history"]}
    if not sorted(la) == sorted(lb) == list(range(LOOP_STEPS)):
        raise AssertionError(f"loop steps {sorted(la)} vs {sorted(lb)}")
    bitwise = all(la[s] == lb[s] for s in la)
    worst = max(abs(la[s] - lb[s]) / abs(la[s]) for s in la)
    if not bitwise and worst > LOOP_RTOL:
        raise AssertionError(f"loop histories differ: {la} vs {lb}")
    TRAIN["loop"] = {k: {"seconds": r["seconds"], "restarts": r["restarts"],
                         "losses": [la, lb][i],
                         "straggler": r["straggler"]}
                     for i, (k, r) in enumerate(runs.items())}
    TRAIN["loop"]["bitwise_equal"] = bitwise
    log(f"loop.run mobilenetv2 qat ({LOOP_STEPS} steps, checkpoint every "
        f"{LOOP_CKPT}, deterministic algorithms): uninterrupted "
        f"{a['seconds']:.1f} s, with a failure at step {LOOP_FAIL} "
        f"{b['seconds']:.1f} s, restarts {b['restarts']}; histories bitwise "
        f"equal: {bitwise} (max relative difference {worst!r}, tolerance "
        f"{LOOP_RTOL})")
    log("train: " + json.dumps(TRAIN))
    reset_peak(empty=True)


# ---------------------------------------------------------------------------
# the long phase: prompts and training sequences past 2 x kv_block
# ---------------------------------------------------------------------------

class AttnProbe:
    """Inside a ``with`` block: ``transformer.prefill``'s host seconds
    (synchronized before and after) and the peak device bytes during it;
    ``attention.blocked_attention``'s calls and host seconds (synchronized
    around each); and the first prefill-shaped attention call's q, k, v,
    positions, mask options and float32 output, detached (a call with
    more than one query row, through ``blocked_attention`` or
    ``full_attention``: layer 0 of the first prefill or forward)."""

    def __enter__(self):
        import torch
        from repro_torch.models import attention, transformer
        self.mods = attention, transformer
        self.saved = (attention.blocked_attention, attention.full_attention,
                      transformer.prefill)
        real_blocked, real_full, real_prefill = self.saved
        self.blocked_calls, self.attn_s = 0, 0.0
        self.prefill_s, self.prefill_peak, self.first = [], [], None

        def keep_first(q, k, v, q_pos, k_pos, out, causal, window, cap):
            if self.first is None and q.shape[1] > 1:
                self.first = dict(
                    q=q.detach(), k=k.detach(), v=v.detach(), q_pos=q_pos,
                    k_pos=k_pos, out=out.detach(), causal=causal,
                    window=window, softcap=cap)

        def blocked(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                    logit_softcap=None, kv_block=1024):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_blocked(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, logit_softcap=logit_softcap,
                               kv_block=kv_block)
            torch.cuda.synchronize()
            self.attn_s += time.perf_counter() - t0
            self.blocked_calls += 1
            keep_first(q, k, v, q_pos, k_pos, out, causal, window,
                       logit_softcap)
            return out

        def full(q, k, v, q_pos, k_pos, window=None, logit_softcap=None,
                 causal=True):
            out = real_full(q, k, v, q_pos, k_pos, window, logit_softcap,
                            causal)
            keep_first(q, k, v, q_pos, k_pos, out, causal, window,
                       logit_softcap)
            return out

        def prefill(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = real_prefill(*a, **k)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t0)
            self.prefill_peak.append(torch.cuda.max_memory_allocated())
            return out
        attention.blocked_attention, attention.full_attention = blocked, full
        transformer.prefill = prefill
        return self

    def __exit__(self, *exc):
        attention, transformer = self.mods
        (attention.blocked_attention, attention.full_attention,
         transformer.prefill) = self.saved
        return False


class LaneProbe:
    """Inside a ``with`` block, every decode-shaped ``full_attention``
    call (one query position a row) at a position in ``rows`` writes its
    q and float32 output into ``q`` / ``out`` [len(rows), Hq, D] (in the
    order of ``rows``) and marks ``seen``, by device-side index copies, so
    a captured round that is replayed writes them too.  For a model of one
    layer, whose every call is layer 0's; each position's last call wins
    (a lane entry re-run at its held position gives the same bits)."""

    def __init__(self, rows: list, max_len: int, Hq: int, D: int, dtype,
                 device="cuda"):
        import torch
        dev = torch.device(device)
        self.R, self.max_len = len(rows), max_len
        self.lookup = torch.full((max_len,), self.R, dtype=torch.int64,
                                 device=dev)
        self.lookup[torch.tensor(rows, device=dev)] = torch.arange(
            self.R, device=dev)
        self.q_buf = torch.zeros((self.R + 1, Hq, D), dtype=dtype,
                                 device=dev)
        self.out_buf = torch.zeros((self.R + 1, Hq, D), dtype=torch.float32,
                                   device=dev)
        self.seen_buf = torch.zeros(self.R + 1, dtype=torch.int32,
                                    device=dev)

    def __enter__(self):
        import torch
        from repro_torch.models import attention
        self.mod, self.saved = attention, attention.full_attention
        real = self.saved

        def full(q, k, v, q_pos, k_pos, window=None, logit_softcap=None,
                 causal=True):
            out = real(q, k, v, q_pos, k_pos, window, logit_softcap, causal)
            if q.shape[1] == 1:
                pos = q_pos[:, 0].long()
                idx = torch.where(pos >= 0, self.lookup[pos.clamp(
                    0, self.max_len - 1)], self.R)
                self.q_buf.index_copy_(0, idx, q[:, 0])
                self.out_buf.index_copy_(0, idx, out[:, 0])
                self.seen_buf.index_fill_(0, idx, 1)
            return out
        attention.full_attention = full
        return self

    def __exit__(self, *exc):
        self.mod.full_attention = self.saved
        return False

    @property
    def q(self):
        return self.q_buf[:self.R]

    @property
    def out(self):
        return self.out_buf[:self.R]

    @property
    def all_seen(self) -> bool:
        return bool(self.seen_buf[:self.R].all())


def long_rows(S: int) -> list:
    """LONG_CHECK_ROWS query rows spread over a prompt of S, the last
    among them."""
    return sorted({round(i * (S - 1) / (LONG_CHECK_ROWS - 1))
                   for i in range(LONG_CHECK_ROWS)})


def f64_attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                  softcap=None):
    """Attention in float64 of query rows q [R, Hq, D] at positions q_pos
    [R] over keys k/v [T, Hkv, D] at k_pos [T] (negative: masked), the
    model's mask, soft-cap and GQA (q scaled in its dtype first, as the
    model does): the exact output [R, Hq, D] and ``mass``, sum_k p_k
    |v_k,d| [R, Hq, D], the scale of each element's bf16-probability
    error.  Rows in chunks of about 2^25 scores."""
    import torch
    D, Hq, Hkv, T = q.shape[-1], q.shape[1], k.shape[1], k.shape[0]
    G = Hq // Hkv
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)
    kd, vd = k.double(), v.double()
    va = vd.abs()
    kp = k_pos.to(kd.device).long()
    step = max(1, (1 << 25) // (Hq * T))
    exact, mass = [], []
    for i in range(0, q.shape[0], step):
        qg = (q[i:i + step] * scale).double().reshape(-1, Hkv, G, D)
        s = torch.einsum("rhgd,khd->rhgk", qg, kd)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        d = q_pos[i:i + step].to(kd.device).long()[:, None] - kp[None]
        keep = (kp >= 0)[None]
        if causal:
            keep = keep & (d >= 0)
        if window is not None:
            keep = keep & (d < window)
        s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
        p = torch.softmax(s, -1)
        exact.append(torch.einsum("rhgk,khd->rhgd", p, vd).reshape(-1, Hq, D))
        mass.append(torch.einsum("rhgk,khd->rhgd", p, va).reshape(-1, Hq, D))
    return torch.cat(exact), torch.cat(mass)


def attn_error(got, exact, mass, vmax: float) -> dict:
    """``got`` against float64: ``err_over_mass``, the largest |got -
    exact| / sum_k p_k |v_k,d| over the elements (limit ATTN_P_REL +
    ATTN_F32_REL), ``err_over_max_v``, the largest |got - exact| / max |v|
    (``vmax``), and ``within``, every element inside the limit."""
    err = (got.double() - exact).abs()
    lim = ATTN_P_REL + ATTN_F32_REL
    return {"err_over_mass": float((err / mass.clamp_min(1e-300)).max()),
            "err_over_max_v": float(err.max()) / vmax,
            "within": bool((err <= lim * mass).all())}


def first_error(f: dict, rows=None) -> dict:
    """``attn_error`` of ``AttnProbe.first``'s batch row 0 at query
    ``rows`` (every row when None) against float64 over its own inputs."""
    rows = list(range(f["q"].shape[1])) if rows is None else rows
    exact, mass = f64_attention(
        f["q"][0, rows], f["k"][0], f["v"][0], f["q_pos"][0, rows],
        f["k_pos"][0], causal=f["causal"], window=f["window"],
        softcap=f["softcap"])
    return attn_error(f["out"][0, rows], exact, mass,
                      float(f["v"][0].abs().max()))


def check_long_kernel(bench: Bench) -> None:
    """The fused LUT kernel at the 32k prefill's M: qwen2-7b's 7
    projections at M = LONG_S rows, each held bitwise against its plain
    version over every row, timed (LONG_KERNEL_REPS launches), beside
    ``torch._int_mm`` on the same codes."""
    import torch
    from repro_torch.kernels.lutmul import kernel, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    reps, bench.reps = bench.reps, LONG_KERNEL_REPS
    M = LONG_S
    try:
        for K, N in QWEN_INNER.values():
            a = torch.randint(0, 16, (M, K), generator=gen, device=dev,
                              dtype=torch.uint8)
            w = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                              dtype=torch.uint8)
            a_s = torch.rand((M, 1), generator=gen, device=dev) * 0.1 + 1e-3
            w_s = torch.rand((1, N), generator=gen, device=dev) * 0.1 + 1e-3
            a8 = ref.decode_codes(a).to(torch.int8)
            w8 = ref.decode_codes(ref.unpack_int4(w.T).T, 4) \
                .to(torch.int8).contiguous()
            lib = _library_ms(a8, w8, ref.lutmul_ref(a, w), bench.flush,
                              LONG_KERNEL_REPS)
            del a8, w8
            bench.lut("lutmul_fused", LONG_GROUP,
                      lambda: kernel.lutmul_fused(a, w, a_s, w_s,
                                                  out_dtype=torch.bfloat16),
                      lambda: ref.scaled_lutmul_ref(a, w, a_s, w_s,
                                                    out_dtype=torch.bfloat16),
                      lib, M, K, N, extra_in=4 * (M + N), out_bytes=M * N * 2)
            del a, w
            torch.cuda.empty_cache()
    finally:
        bench.reps = reps
    log(f"long: lutmul_fused at M={M} bitwise == its plain version on the 7 "
        "projections of a qwen2-7b layer, every row")


def run_long(n_layers, bench: Bench) -> None:
    """Prompts and training sequences past 2 x kv_block (see the module
    docstring): the LUT kernel at the prefill's M, qwen2-7b's 32k prompt,
    the chunk-lane cross-check, gemma2-2b's long pairs and minicpm-2b's
    train_4k step."""
    check_long_kernel(bench)
    run_long_qwen(n_layers)
    run_long_gemma2(n_layers)
    run_long_train(n_layers)
    log("long: " + json.dumps(LONG))


def _long_prompt(vocab: int):
    import numpy as np
    import torch
    return torch.tensor(np.random.default_rng(36).integers(
        0, vocab, (1, LONG_S)), device="cuda")


def run_long_qwen(n_layers) -> None:
    """qwen2-7b w4a4_lut at full width and depth: ``Engine.generate`` on
    one prompt of LONG_S tokens, LONG_NEW new tokens; its prefill's ms,
    peak bytes and attention share; every blocked call a layer; the launch
    counts; layer 0's blocked output at LONG_CHECK_ROWS rows against a
    float64 softmax over all their keys.  Then the chunk-lane cross-check
    on the same prompt at LONG_CHUNK_LAYERS layers."""
    import dataclasses
    import torch
    from repro_torch.configs import qwen2_7b
    from repro_torch.kernels.lutmul import ops
    cfg = depth(qwen2_7b.config(quant="w4a4_lut"), n_layers)
    prompt = _long_prompt(cfg.vocab)
    ops.set_backend("cuda")
    ops.set_variant(None)
    engine = new_engine(cfg, LONG_S + LONG_NEW, "qwen2-7b long")
    held = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    with AttnProbe() as probe:
        engine.generate(prompt, LONG_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = all_launches()
    want = dict.fromkeys(launches, 0)
    want.update(lutmul_fused=7 * cfg.n_layers * LONG_NEW,
                int_matmul_fused=LONG_NEW)
    if launches != want or probe.blocked_calls != cfg.n_layers:
        raise AssertionError(f"qwen long: launches {launches} != {want}, or "
                             f"{probe.blocked_calls} blocked calls for "
                             f"{cfg.n_layers} layers")
    RUNS["qwen long generate"] = {
        "seconds": gen_s, "launches": launches,
        "forwards_by_lane": {"prefill": 1, "decode": LONG_NEW - 1}}
    rows = long_rows(LONG_S)
    f64 = first_error(probe.first, rows)
    if not f64["within"]:
        raise AssertionError(f"qwen long: layer 0's blocked output differs "
                             f"from float64 by {f64}, past "
                             f"{ATTN_P_REL + ATTN_F32_REL!r} x "
                             f"sum_k p_k |v_k|")
    prefill_ms = probe.prefill_s[0] * 1e3
    LONG["qwen"] = {
        "layers": cfg.n_layers, "tokens": LONG_S, "new_tokens": LONG_NEW,
        "prefill_ms": prefill_ms, "prefill_peak_bytes": probe.prefill_peak[0],
        "held_bytes_before": held, "attention_ms": probe.attn_s * 1e3,
        "attention_share": probe.attn_s / probe.prefill_s[0],
        "generate_s": gen_s, "launches": launches,
        "layer0_vs_f64": f64, "f64_rows": len(rows)}
    log(f"qwen long[{cfg.n_layers} layers, {LONG_S} tokens]: prefill "
        f"{prefill_ms:.1f} ms (host clock, synchronized), peak "
        f"{probe.prefill_peak[0]} bytes ({held} held before), blocked "
        f"attention {probe.attn_s * 1e3:.1f} ms = "
        f"{probe.attn_s / probe.prefill_s[0]:.3f} of it ({cfg.n_layers} "
        f"calls); generate {gen_s:.2f} s; launches {launches}; layer 0 at "
        f"{len(rows)} rows vs float64: {json.dumps(f64)} (limit "
        f"{ATTN_P_REL + ATTN_F32_REL!r} x sum_k p_k |v_k|: each probability "
        f"rounded to bf16)")
    del engine, probe
    reset_peak(empty=True)
    check_long_chunk_lane(dataclasses.replace(
        cfg, n_layers=min(LONG_CHUNK_LAYERS, cfg.n_layers)), prompt)


def check_long_chunk_lane(cfg, prompt) -> None:
    """``Engine.generate`` (a blocked prefill) against the Scheduler's
    chunk-lane admission (every prompt token through a decode step over
    the cache) of the same LONG_S-token prompt, on qwen2-7b cut to one
    layer.  The lane keeps its own layer-0 q and attention output at
    LONG_CHECK_ROWS rows spread over the prompt (``LaneProbe``, from its
    decode steps, replayed rounds included).  At those rows both paths'
    outputs must be within (ATTN_P_REL + ATTN_F32_REL) x sum_k p_k |v_k,d|
    of a float64 softmax over each path's own q, K and V; and the tokens
    must be equal, or the paths must part no earlier than layer 0's
    attention output: the lane's q at the rows and its K and V equal the
    prefill's bitwise.  ``FLIP_ULPS`` cannot hold here: the blocked path
    rounds the unnormalized probabilities to bf16 where decode rounds the
    normalized ones (as the reference's two paths do), which moves an
    output by up to 2^-8 x sum_k p_k |v_k,d|: hundreds of bf16 ulps of an
    output near zero (the largest ulps at the sample rows are printed).
    Its LONG_S decode steps make it the long phase's longest part."""
    import torch
    from repro_torch.serve import Request, Scheduler, ServeConfig, make_engine
    from repro_torch.serve.quantize import init_served_params
    if cfg.n_layers != 1:
        raise ValueError("the chunk-lane probe reads layer 0 of a one-layer "
                         f"model, not of {cfg.n_layers} layers")
    params = init_served_params(cfg, cfg.quant, seed=0, device="cuda")
    max_len = LONG_S + LONG_NEW
    engine = make_engine(params, cfg, ServeConfig(
        quant=cfg.quant, max_len=max_len, seed=SAMPLE_SEED,
        prefill_chunk=LONG_CHUNK))
    del params
    with AttnProbe() as probe:
        gen = engine.generate(prompt, LONG_NEW)[0, LONG_S:].tolist()
    f = probe.first
    rows = long_rows(LONG_S)
    lane = LaneProbe(rows, max_len, cfg.n_heads, cfg.head_dim, f["q"].dtype)
    req = Request(prompt=prompt[0].tolist(), max_new_tokens=LONG_NEW)
    sched = Scheduler(engine, slots=1, chunk=1)
    engine.lane_steps = dict.fromkeys(engine.lane_steps, 0)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with lane:
        sched.run([req])
    torch.cuda.synchronize()
    lane_s = time.perf_counter() - t0
    lanes = dict(engine.lane_steps)
    if (lanes.get("chunk") != LONG_S or len(req.tokens) != LONG_NEW
            or not lane.all_seen):
        raise AssertionError(f"chunk lane: lanes {lanes}, tokens "
                             f"{req.tokens}, every sample row probed: "
                             f"{lane.all_seen}")
    ck, cv = (sched.cache[0][key][0] for key in ("k", "v"))
    kv_equal = torch.equal(ck[:LONG_S], f["k"][0].to(ck.dtype)) and \
        torch.equal(cv[:LONG_S], f["v"][0].to(cv.dtype))
    q_equal = torch.equal(lane.q, f["q"][0, rows])
    exact, mass = f64_attention(
        lane.q, ck, cv, torch.tensor(rows, device=ck.device),
        torch.arange(ck.shape[0], device=ck.device))
    f64 = {"chunk_lane": attn_error(lane.out, exact, mass,
                                    float(cv[:LONG_S].abs().max())),
           "blocked": first_error(f, rows)}
    ulps = float(_bf16_ulps(lane.out.to(torch.bfloat16).float(),
                            f["out"][0, rows].to(torch.bfloat16).float())
                 .max())
    rec = {"layers": cfg.n_layers, "generate": gen, "chunk_lane": req.tokens,
           "equal": gen == req.tokens, "layer0_kv_equal": kv_equal,
           "layer0_q_equal_at_rows": q_equal,
           "chunk_lane_s": lane_s, "forwards_by_lane": lanes,
           "layer0_vs_f64": f64,
           "layer0_sample_rows_max_bf16_ulps": ulps,
           "launches": all_launches()}
    LONG["chunk_lane"] = rec
    log(f"qwen long chunk lane[{cfg.n_layers} layer]: generate {gen} vs "
        f"the Scheduler's chunk-lane admission {req.tokens} (equal: "
        f"{gen == req.tokens}); layer 0 K/V equal to the prefill's: "
        f"{kv_equal}, the lane's own q at the {len(rows)} rows: {q_equal}; "
        f"layer 0's attention at the rows vs float64 (limit "
        f"{ATTN_P_REL + ATTN_F32_REL!r} x sum_k p_k |v_k|), the lane's own "
        f"output and the blocked prefill's: {json.dumps(f64)}; chunk lane "
        f"vs blocked {ulps} bf16 ulps at most; chunk lane {lane_s:.1f} s "
        f"for {LONG_S} prompt tokens ({lanes}); launches {rec['launches']}")
    if not all(x["within"] for x in f64.values()) or (
            gen != req.tokens and not (kv_equal and q_equal)):
        raise AssertionError(f"chunk lane: {rec}")
    del engine, sched, probe, f, lane
    reset_peak(empty=True)


def attention_parting(a: dict, b: dict) -> dict:
    """Two forwards' layer-0 attention (``AttnProbe.first``, full
    attention ``a`` and blocked ``b``): whether their inputs are equal
    bitwise, their outputs' largest difference over the largest |v| and
    in bf16 ulps, and each output against float64 at every row
    (``first_error``)."""
    import torch
    same_in = all(torch.equal(a[k], b[k]) for k in ("q", "k", "v"))
    d = (a["out"] - b["out"]).abs().max()
    return {"inputs_equal": same_in,
            "max_diff_over_max_v": float(d / a["v"].float().abs().max()),
            "max_bf16_ulps": float(_bf16_ulps(
                a["out"].to(torch.bfloat16).float(),
                b["out"].to(torch.bfloat16).float()).max()),
            "vs_f64": {"full": first_error(a), "blocked": first_error(b)}}


def parting_within(parting: dict) -> bool:
    """Both outputs of ``attention_parting`` within the float64 bound."""
    return all(x["within"] for x in parting["vs_f64"].values())


def run_long_gemma2(n_layers) -> None:
    """gemma2-2b at ``SERVED_LAYERS`` depth: the gemma2 phase's long pairs
    (past the 4,096 window, soft-cap 50) through the Scheduler's
    monolithic admission, blocked (kv_block 1,024) against the same
    engine's codes with kv_block raised past S (full attention, the
    earlier admission): layer 0's attention outputs of both within
    (ATTN_P_REL + ATTN_F32_REL) x sum_k p_k |v_k,d| of float64 at every
    row (each path rounds its probabilities to bf16, the full one
    normalized, the blocked one not), and the transcripts equal or layer
    0's attention inputs equal.
    Admission host ms and peak bytes of each."""
    import dataclasses
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels.lutmul import ops
    from repro_torch.serve import ServeConfig, make_engine
    cfg = depth(gemma2_2b.config(quant="w4a4_lut"), n_layers)
    V = cfg.vocab
    ops.set_backend("cuda")
    ops.set_variant(None)
    blocked = new_engine(cfg, GEMMA_MAX_LEN, "gemma2-2b long")
    full = make_engine(blocked.params, dataclasses.replace(
        cfg, kv_block=FULL_KV_BLOCK), ServeConfig(
            quant=cfg.quant, max_len=GEMMA_MAX_LEN, seed=SAMPLE_SEED))
    long_idx = [i for i, L in enumerate(len(r.prompt) for r in
                                        gemma_requests(V)) if L > 2 * 1024]
    out, firsts = {}, {}
    for label, eng in (("gemma2 long full", full),
                       ("gemma2 long blocked", blocked)):
        reqs = [gemma_requests(V)[i] for i in long_idx]
        with AttnProbe() as probe:
            out[label] = serve(eng, V, label, len(reqs), "lutmul", reqs=reqs,
                               drive=gemma_drive([]))
        if (probe.blocked_calls == 0) != (eng is full):
            raise AssertionError(f"{label}: {probe.blocked_calls} blocked "
                                 "calls")
        firsts[label] = probe.first
    parting = attention_parting(firsts["gemma2 long full"],
                                firsts["gemma2 long blocked"])
    equal = out["gemma2 long full"] == out["gemma2 long blocked"]
    if not parting_within(parting) or not (equal
                                           or parting["inputs_equal"]):
        raise AssertionError(f"gemma2 long: blocked transcripts differ from "
                             f"full attention's and layer 0 parts by "
                             f"{parting}")
    rec = {}
    for label in out:
        st = RUNS[label]
        rec[label] = {"admission_host_ms": st["admission"]["host_ms"],
                      "peak_gib": st["peak_gib"],
                      "ms_per_decode_step_after_capture_and_admissions":
                          st["ms_per_decode_step_after_capture_and_"
                             "admissions"]}
    LONG["gemma2"] = {"layers": cfg.n_layers, "transcripts_equal": equal,
                      "first_tokens_differing": None if equal else [
                          next((k for k, (x, y) in enumerate(zip(a, b))
                                if x != y), None) for a, b in zip(
                              out["gemma2 long full"],
                              out["gemma2 long blocked"])],
                      "layer0": parting, **rec}
    log(f"gemma2 long[{cfg.n_layers} layers, prompts "
        f"{[len(gemma_requests(V)[i].prompt) for i in long_idx]}]: blocked "
        f"admission == full-attention admission: transcripts equal {equal}; "
        f"layer 0 {json.dumps(parting)}; " + json.dumps(rec)
        + " (PERF.md before this slice: 2.51 s a long pair, 32.83-34.60 "
        "GiB peak)")
    del blocked, full, firsts
    reset_peak(empty=True)


def run_long_train(n_layers) -> None:
    """minicpm-2b QAT at full width, depth ``LONG_TRAIN_LAYERS`` (cut by
    ``--layers``), one step of 1 x LONG_TRAIN_S tokens (train_4k's
    length: the blocked path forward and backward, under remat "full"):
    its ms and peak bytes, its loss and gradient norm against the same
    batch's loss and gradient norm with kv_block raised past S (full
    attention), within LONG_TRAIN_LOSS_RTOL and LONG_TRAIN_NORM_RTOL; and
    the two forwards' layer-0 attention (``attention_parting``): each
    output within (ATTN_P_REL + ATTN_F32_REL) x sum_k p_k |v_k,d| of a
    float64 softmax over its own inputs at every row (the loss, about
    ln V on random weights, says little of the attention by itself).
    """
    import dataclasses
    import torch
    from repro_torch.configs import minicpm_2b
    from repro_torch.data import pipeline
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    cfg = dataclasses.replace(minicpm_2b.config(quant="qat"), n_layers=min(
        LONG_TRAIN_LAYERS, n_layers or LONG_TRAIN_LAYERS))
    batch = pipeline.lm_batch(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=LONG_TRAIN_S, global_batch=1), 0)
    reset_peak(empty=True)
    base = torch.cuda.memory_allocated()
    state = tstep.init_state(transformer.init_params(cfg, seed=0))
    full_cfg = dataclasses.replace(cfg, kv_block=FULL_KV_BLOCK)
    with AttnProbe() as full_probe:
        loss_f, grads = tstep.value_and_grad(
            tstep.loss_for(full_cfg), state["params"],
            tstep.to_device(batch, "cuda"))
    norm_f = adamw.global_norm(grads)
    del grads
    torch.cuda.synchronize()
    full_peak = torch.cuda.max_memory_allocated() - base
    reset_peak()
    with AttnProbe() as probe:
        state, hist = _train_steps(
            tstep.make_train_step(cfg, tstep.TrainConfig(
                schedule="wsd", qat_project=True, peak_lr=1e-3, warmup=2,
                total_steps=8), donate=True),
            state, [batch], "minicpm-2b qat 4k")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    h = hist[0]
    # remat "full": each layer's blocked attention runs in the forward and
    # again in the backward's recompute
    if probe.blocked_calls != 2 * cfg.n_layers:
        raise AssertionError(f"minicpm 4k: {probe.blocked_calls} blocked "
                             f"calls for {cfg.n_layers} layers")
    loss_err = abs(h["loss"] - float(loss_f)) / abs(float(loss_f))
    norm_err = abs(h["grad_norm"] - float(norm_f)) / float(norm_f)
    parting = attention_parting(full_probe.first, probe.first)
    del full_probe
    LONG["train"] = {"layers": cfg.n_layers, "tokens": LONG_TRAIN_S,
                     "step_ms": h["step_s"] * 1e3,
                     "fwd_bwd_ms": h["grads_s"] * 1e3,
                     "opt_proj_ms": h["update_s"] * 1e3, "peak_bytes": peak,
                     "full_attention_peak_bytes": full_peak,
                     "loss": h["loss"], "loss_full": float(loss_f),
                     "grad_norm": h["grad_norm"],
                     "grad_norm_full": float(norm_f),
                     "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
                     "layer0": parting}
    log(f"minicpm-2b qat 4k[{cfg.n_layers} layers, 1 x {LONG_TRAIN_S}]: step "
        f"{h['step_s'] * 1e3:.1f} ms (fwd+bwd {h['grads_s'] * 1e3:.1f}, "
        f"opt+proj {h['update_s'] * 1e3:.1f}; CUDA events), peak {peak} bytes "
        f"(full attention's fwd+bwd: {full_peak}); loss {h['loss']!r} vs "
        f"full {float(loss_f)!r} (rel {loss_err!r}, limit "
        f"{LONG_TRAIN_LOSS_RTOL}), grad norm {h['grad_norm']!r} vs full "
        f"{float(norm_f)!r} (rel {norm_err!r}, limit {LONG_TRAIN_NORM_RTOL}); "
        f"layer 0's attention, full vs blocked: {json.dumps(parting)}")
    if (loss_err > LONG_TRAIN_LOSS_RTOL or norm_err > LONG_TRAIN_NORM_RTOL
            or not parting_within(parting)):
        raise AssertionError(f"minicpm 4k: blocked vs full {LONG['train']}")
    del state
    reset_peak(empty=True)


# ---------------------------------------------------------------------------
# the fsdp phase: FSDP training on ranks sharing the card
# ---------------------------------------------------------------------------

def _digest(t) -> list:
    """Two integer sums of a float32 tensor's bit patterns (plain and
    position-weighted): equal tensors give equal digests."""
    import torch
    x = t.contiguous().view(torch.int32).flatten().to(torch.int64)
    w = torch.arange(x.numel(), device=x.device) % 65521 + 1
    return [int(x.sum()), int((x * w).sum())]


def fsdp_setup(n_layers):
    """(cfg, rules, batches) of the fsdp phase: minicpm-2b at full width
    and FSDP_LAYERS layers, the reference's train-cell rules (fsdp over
    "data"), FSDP_STEPS batches of FSDP_B x FSDP_S tokens."""
    import dataclasses
    from repro_torch.configs import minicpm_2b
    from repro_torch.data import pipeline
    from repro_torch.dist import sharding
    cfg = dataclasses.replace(minicpm_2b.config(), n_layers=min(
        FSDP_LAYERS, n_layers or FSDP_LAYERS))
    rules = sharding.production_rules()
    rules["fsdp"] = "data"
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=FSDP_S,
                               global_batch=FSDP_B)
    return cfg, rules, [pipeline.lm_batch(dcfg, i) for i in range(FSDP_STEPS)]


def fsdp_rank(mesh, n_layers) -> dict:
    """One rank of the fsdp world: its shares, FSDP_STEPS steps, each
    step's loss and gradient norm bits, the digests of its shares of the
    parameters and moments, ms a step and in collectives, resident
    bytes."""
    import torch
    from repro_torch.core.tree import flatten
    from repro_torch.models import transformer
    from repro_torch.train import fsdp
    torch.use_deterministic_algorithms(True)
    cfg, rules, batches = fsdp_setup(n_layers)
    n, r = mesh.data.size, mesh.data.index
    params = transformer.init_params(cfg, seed=0, device=mesh.device)
    layout = fsdp.fsdp_layout(params, rules, n)
    full_bytes = fsdp.resident_bytes(params) * 3
    state = fsdp.init_fsdp_state(params, layout, n, r)
    del params
    torch.cuda.empty_cache()
    step = fsdp.make_fsdp_train_step(cfg, mesh, rules, layout,
                                     fsdp_tcfg(), donate=True)
    steps = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        steps.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "collective_ms": m["collective_s"] * 1e3,
            "loss": _digest(m["loss"].reshape(1)),
            "grad_norm": _digest(m["grad_norm"].reshape(1)),
            "loss_value": float(m["loss"]),
            "digests": {k: [_digest(x) for x in flatten(tree)[1]]
                        for k, tree in (("params", state["params"]),
                                        ("m", state["opt"]["m"]),
                                        ("v", state["opt"]["v"]))}})
    return {"rank": mesh.rank, "device": str(mesh.device),
            "backend": mesh.backend, "steps": steps,
            "resident_bytes": fsdp.resident_bytes(state),
            "full_bytes": full_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated(mesh.device)}


def fsdp_tcfg():
    from repro_torch.train import step as tstep
    return tstep.TrainConfig(peak_lr=1e-3, warmup=1, total_steps=10)


def run_fsdp(n_layers) -> None:
    """FSDP training on the card: FSDP_MESH ranks on ``cuda:0`` over gloo
    (every collective staged through pinned host memory), minicpm-2b at
    full width and FSDP_LAYERS layers, FSDP_STEPS steps of FSDP_B x
    FSDP_S tokens, each rank holding its share of every leaf the specs
    shard and of its AdamW moments; after every step each rank's shares,
    loss and gradient norm must equal the single-card ``make_train_step``
    with ``n_microbatches`` = the rank count, bitwise (both under
    deterministic algorithms)."""
    import dataclasses
    import torch
    from repro_torch.core.tree import flatten
    from repro_torch.models import transformer
    from repro_torch.serve.sharded import launch
    from repro_torch.train import fsdp
    from repro_torch.train import step as tstep
    cfg, rules, batches = fsdp_setup(n_layers)
    n = int(FSDP_MESH.split("x")[0])
    torch.use_deterministic_algorithms(True)
    try:
        params = transformer.init_params(cfg, seed=0, device="cuda")
        layout = fsdp.fsdp_layout(params, rules, n)
        state = tstep.init_state(params)
        del params
        step = tstep.make_train_step(cfg, dataclasses.replace(
            fsdp_tcfg(), n_microbatches=n), donate=True)
        want, single_ms = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t0) * 1e3)
            dig = {}
            for key, tree in (("params", state["params"]),
                              ("m", state["opt"]["m"]),
                              ("v", state["opt"]["v"])):
                leaves = flatten(tree)[1]
                dig[key] = [[_digest(fsdp._share(x, d, n, r))
                             for x, d in zip(leaves, layout.dims)]
                            for r in range(n)]
            want.append({"loss": _digest(m["loss"].reshape(1)),
                         "grad_norm": _digest(m["grad_norm"].reshape(1)),
                         "loss_value": float(m["loss"]), "digests": dig})
        del state, step
    finally:
        torch.use_deterministic_algorithms(False)
    reset_peak(empty=True)
    t0 = time.perf_counter()
    ranks = launch(fsdp_rank, FSDP_MESH, "gloo", timeout_s=FSDP_WORLD_S,
                   args=(n_layers,))
    world_s = time.perf_counter() - t0
    for r in ranks:
        for t, (got, w) in enumerate(zip(r["steps"], want)):
            where = f"fsdp rank {r['rank']} step {t}"
            if got["loss"] != w["loss"] or got["grad_norm"] != w["grad_norm"]:
                raise AssertionError(f"{where}: loss or grad norm differs "
                                     f"from the single card's")
            for key in ("params", "m", "v"):
                if got["digests"][key] != w["digests"][key][r["rank"]]:
                    bad = [j for j, (a, b) in enumerate(zip(
                        got["digests"][key], w["digests"][key][r["rank"]]))
                        if a != b]
                    raise AssertionError(f"{where}: {key} shares differ from "
                                         f"the single card's at leaves "
                                         f"{bad[:8]}")
        if r["backend"] != "gloo":
            raise AssertionError(f"fsdp rank {r['rank']}: {r['backend']}")
    sharded = sum(d is not None for d in layout.dims)
    FSDP["world_s"] = world_s
    FSDP["single_card_ms"] = single_ms
    FSDP["ranks"] = [{k: r[k] for k in ("rank", "device", "resident_bytes",
                                        "full_bytes", "peak_bytes")}
                     | {"ms": [s["ms"] for s in r["steps"]],
                        "collective_ms": [s["collective_ms"]
                                          for s in r["steps"]]}
                     for r in ranks]
    log(f"fsdp[{FSDP_MESH}, minicpm-2b {cfg.n_layers} layers, {FSDP_STEPS} "
        f"steps of {FSDP_B} x {FSDP_S}]: {sharded} of {len(layout.dims)} "
        f"leaves sharded; every rank's shares of the parameters and both "
        f"moments, its loss and its grad norm == the single card's "
        f"n_microbatches={n} step, bitwise, after each step; losses "
        f"{[w['loss_value'] for w in want]}; single card "
        f"{[round(x, 1) for x in single_ms]} ms a step; world {world_s:.1f}s")
    for r in FSDP["ranks"]:
        log(f"fsdp rank {r['rank']} on {r['device']}: ms a step "
            f"{[round(x, 1) for x in r['ms']]}, of it in collectives "
            f"{[round(x, 1) for x in r['collective_ms']]}; resident "
            f"{r['resident_bytes']} bytes of the unsharded state's "
            f"{r['full_bytes']} (params + 2 moments); peak {r['peak_bytes']}")
    log(f"fsdp: {smi_line()}")


def _searchsorted_ms(acc, thr, sign, want, bench: Bench):
    """The library yardstick of the threshold kernel: ``torch.searchsorted``
    of each channel's values into its threshold row, which counts the
    levels at or below a value only because ``make_thresholds`` gives
    sorted rows (checked here); the float conversion, sign and transposes
    it needs are in the timed call."""
    import torch
    if not bool((thr[:, 1:] >= thr[:, :-1]).all()):
        return None, "rows not sorted: no library call counts them"

    def fn():
        vals = (acc.to(torch.float32) * sign).T.contiguous()
        return torch.searchsorted(thr, vals, right=True).T.to(torch.int32)

    if not torch.equal(fn(), want):
        raise AssertionError("searchsorted disagrees with the plain "
                             "threshold version")
    return _time(fn, bench.reps, bench.flush), (
        "torch.searchsorted(thr, (acc.float() * sign).T, right=True): "
        "valid on sorted rows, which make_thresholds gives")


def main() -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=None,
                   help="cut every LM to at most this depth (full width "
                        "always); default: each model's own depth")
    p.add_argument("--reps", type=int, default=50,
                   help="timed launches per kernel and shape")
    p.add_argument("--profile", type=int, default=1, metavar="STEPS",
                   help="calls profiled per forward kind, half of them "
                        "(rounded up) for a replayed round (0: none)")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    args = p.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        p.error(f"--phases: unknown {set(phases) - set(PHASES)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    sm_hz = sm_clock_hz()
    log(f"device: {smi} | max SM clock {sm_hz / 1e6:.0f} MHz | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s for {len(logs)} sources")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for src, kern in (("lutmul", "lutmul_kernel"),
                      ("int_matmul", "int_matmul_kernel"),
                      ("lutmul_tmac", "tmac_kernel")):
        imma = {f: n for f, n in build.sass_counts(src, "IMMA").items()
                if kern in f}
        log(f"{src}.cu SASS: IMMA instructions by kernel {json.dumps(imma)}")
        if not imma or min(imma.values()) == 0:
            raise AssertionError(f"a {src}.cu kernel has no int8 tensor-core "
                                 "instruction (IMMA) in its SASS")

    bench = Bench(args.reps, sm_hz)
    for phase, fn in (("kernels", lambda: check_kernels(bench)),
                      ("qwen", lambda: run_qwen(args.layers, args.profile)),
                      ("mixed",
                       lambda: run_mixed(args.layers, args.profile)),
                      ("bitnet",
                       lambda: run_bitnet(args.layers, args.profile)),
                      ("gemma2",
                       lambda: run_gemma2(args.layers, args.profile)),
                      ("minicpm",
                       lambda: run_minicpm(args.layers, args.profile)),
                      ("phi3", lambda: run_phi3(args.layers, args.profile)),
                      ("qwen2moe",
                       lambda: run_qwen2moe(args.layers, args.profile)),
                      ("mixtral",
                       lambda: run_mixtral(args.layers, args.profile)),
                      ("rwkv6", lambda: run_recurrent(
                          "rwkv6-1.6b", args.layers, args.profile)),
                      ("zamba2", lambda: run_recurrent(
                          "zamba2-2.7b", args.layers, args.profile)),
                      ("whisper",
                       lambda: run_whisper(args.layers, args.profile)),
                      ("qwen2vl",
                       lambda: run_qwen2vl(args.layers, args.profile)),
                      ("sharded", lambda: run_sharded(args.layers)),
                      ("mobilenetv2", lambda: run_mobilenet(bench)),
                      ("train", run_train),
                      ("long", lambda: run_long(args.layers, bench)),
                      ("fsdp", lambda: run_fsdp(args.layers))):
        if phase in phases:
            t0 = time.perf_counter()
            fn()
            log(f"{phase} phase: {time.perf_counter() - t0:.1f}s")
    recs = bench.summarize()
    if len(phases) == len(PHASES) and set(recs) != set(KERNELS):
        raise AssertionError(f"kernels never measured: "
                             f"{set(KERNELS) - set(recs)}")
    for name, r in list(recs.items()):
        run = RUNS.get(MAIN_RUN[name])
        if run is None:                   # a cut run: its phase was skipped
            del recs[name]
            continue
        r["launches"] = run["launches"][name]
        r["launches_run"] = MAIN_RUN[name]
        r["launches_by_run"] = {label: st["launches"][name]
                                for label, st in RUNS.items()}
        r["forwards_by_lane"] = run["forwards_by_lane"]
        if not r["launches"]:
            raise AssertionError(f"{name} never launched in {MAIN_RUN[name]}")
        r["kernel_ms"] = r["ms"]
        r["max_abs_diff"] = r["max_abs_err"]
    log("profiles: " + json.dumps(PROFILES))
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(recs.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
