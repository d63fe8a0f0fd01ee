#!/usr/bin/env python3
"""What blocked attention costs on one GPU, and what its query tiling buys.

    python3 scripts/blocked_costs.py [--long 32768] [--reps 3]

1. ``attention.blocked_attention`` at qwen2-7b's prefill shapes (1 row,
   28 query heads over 4 KV heads, head_dim 128, bf16 q/K/V, causal,
   kv_block 1,024): median ms (CUDA events) and the peak bytes the call
   adds, at 4,096, 8,192 and ``--long`` tokens.
2. The same call with the query rows in one tile (``_TILE_ROWS`` = S x
   7): the per-pair layout, whose B x Hkv = 4 (row, kv head) pairs are
   padded to a unit batch of 16 and which skips no block above the
   diagonal, at 4,096 and 8,192 tokens (at 32,768 its float32 scores take
   16 x 32,768 x 7 x 1,024 x 4 B = 15 GB a block).
3. ``full_attention`` (one [B, S, H, S] float32 score tensor) at 4,096
   tokens, and one library call computing causal attention on the same
   inputs, ``torch.nn.functional.scaled_dot_product_attention`` (GQA by
   repeating K/V), at every length: a yardstick, used nowhere in the port.
4. The work counted, each length: the float32 multiply-adds of the two
   products over the blocks each tile visits.
5. Two other served shapes: gemma2-2b's monolithic admission of a long
   pair (8 rows of 4,152 tokens, 8 query heads over 4 KV heads, head_dim
   256, window 4,096, soft-cap 50) and minicpm-2b's 4,096-token training
   sequence (36 heads, head_dim 64), the latter forward and forward +
   backward (the gradient of the output's sum).

Prints one line a measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

HQ, HKV, D, KV_BLOCK = 28, 4, 128, 1024


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _peak(fn) -> int:
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _visited_flops(S: int, q_block: int) -> float:
    """2 x (Q K^T and P V) multiply-adds over the blocks the tiles visit."""
    blocks = 0
    for i in range(-(-S // q_block)):
        last = min(S, (i + 1) * q_block) - 1
        blocks += last // KV_BLOCK + 1
    return 2 * 2 * blocks * q_block * HQ * KV_BLOCK * D


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--long", type=int, default=32768)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}")
    g = torch.Generator(device="cuda").manual_seed(0)
    for S in (4096, 8192, args.long):
        q, k, v = (torch.randn(s, generator=g, device="cuda")
                   .to(torch.bfloat16) for s in ((1, S, HQ, D),
                                                 (1, S, HKV, D),
                                                 (1, S, HKV, D)))
        pos = A.arange_positions(1, S, "cuda")

        def blocked():
            return A.blocked_attention(q, k, v, pos, pos, kv_block=KV_BLOCK)
        reps = args.reps if S > 8192 else 2 * args.reps
        qb = A._q_block(HQ // HKV)
        print(f"blocked S={S}: {_ms(blocked, reps):.2f} ms, peak "
              f"{_peak(blocked)} B added, {_visited_flops(S, qb):.4g}"
              f" float32 flops visited ({qb} query positions a tile)")
        if S <= 8192:
            tile = A._TILE_ROWS
            A._TILE_ROWS = S * (HQ // HKV)
            try:
                print(f"one tile (pairs padded to 16, no skip) S={S}: "
                      f"{_ms(blocked, reps):.2f} ms, peak {_peak(blocked)} B "
                      f"added, {_visited_flops(S, S) * 16 / HKV:.4g} float32 "
                      "flops with the padding")
            finally:
                A._TILE_ROWS = tile
        if S == 4096:
            def full():
                return A.full_attention(q, k, v, pos, pos)
            print(f"full S={S}: {_ms(full, reps):.2f} ms, peak "
                  f"{_peak(full)} B added")
            err = float((blocked() - full()).abs().max())
            print(f"blocked vs full S={S}: max |diff| {err:.3g}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kt = kt.repeat_interleave(HQ // HKV, 1)
        vt = vt.repeat_interleave(HQ // HKV, 1)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        print(f"library sdpa S={S}: {_ms(sdpa, reps):.2f} ms (bf16, GQA "
              "by repeat)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    for name, (B, S, Hq, Hkv, Dh), kw in (
            ("gemma2-2b admission", (8, 4152, 8, 4, 256),
             dict(window=4096, logit_softcap=50.0)),
            ("minicpm-2b train", (1, 4096, 36, 36, 64), {})):
        q, k, v = (torch.randn(s, generator=g, device="cuda")
                   .to(torch.bfloat16) for s in ((B, S, Hq, Dh),
                                                 (B, S, Hkv, Dh),
                                                 (B, S, Hkv, Dh)))
        pos = A.arange_positions(B, S, "cuda")

        def fwd():
            return A.blocked_attention(q, k, v, pos, pos, kv_block=KV_BLOCK,
                                       **kw)
        line = f"blocked {name} {(B, S, Hq, Hkv, Dh)}: {_ms(fwd, 4):.2f} ms"
        if name.endswith("train"):
            qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))

            def fwd_bwd():
                A.blocked_attention(qr, kr, vr, pos, pos,
                                    kv_block=KV_BLOCK).sum().backward()
            line += f", forward + backward {_ms(fwd_bwd, 4):.2f} ms"
        print(line)
        del q, k, v
        torch.cuda.empty_cache()
    print(f"device: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
