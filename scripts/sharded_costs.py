#!/usr/bin/env python3
"""What the sharded serving path's two new costs are on one GPU host.

    python3 scripts/sharded_costs.py

1. The float attention's bits against the rows and heads of a call: for
   decode (one query position) and prefill shapes of the served models,
   ``attention.full_attention`` on a batch's second half of rows and of
   heads against the same slice of the whole batch's result (the rows and
   heads a sharded engine's rank holds), and the batched einsums it
   replaced on the card, with each call's median ms (CUDA events).
2. The collectives of ``dist.tp`` on ranks that share the card
   (``serve.sharded.launch(..., backend="gloo")``, every rank on
   ``cuda:0``): a staged all-reduce max / int32 sum / all-gather of a
   decode step's [4, 3584] activation, a gloo all-reduce of the same host
   tensor, a device-to-host copy and a tiny kernel with a synchronize, on
   2x2 and 1x2 meshes.

Prints one line a measurement; nothing is written.
"""
from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

# (B, S, Hq, Hkv, D, T): qwen2-7b decode at max_len 256 and 512, gemma2-2b
# decode past its window, qwen2-moe decode, qwen2-vl-72b decode, and
# prefills of qwen2-moe and qwen2-7b prompts (odd lengths among them)
SHAPES = ((8, 1, 28, 4, 128, 256), (8, 1, 28, 4, 128, 512),
          (8, 1, 8, 4, 256, 4352), (8, 1, 16, 16, 128, 256),
          (8, 1, 64, 8, 128, 300), (8, 40, 16, 16, 128, 40),
          (8, 7, 16, 16, 128, 7), (8, 12, 28, 4, 128, 12),
          (8, 33, 28, 4, 128, 33))


def _ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def attention_bits() -> None:
    import torch
    from repro_torch.models import attention as A
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)

    def einsum_attention(q, k, v, qp, kp):
        B, S, Hq, D = q.shape
        Hkv = k.shape[2]
        qg = q.reshape(B, S, Hkv, Hq // Hkv, D) * torch.tensor(
            D ** -0.5, dtype=q.dtype)
        s = torch.einsum("bshgd,bkhd->bshgk", qg.float(), k.float())
        keep = A._mask(qp, kp)
        s = s.masked_fill(~keep[:, :, None, None, :], A.NEG_INF)
        p = torch.softmax(s, -1)
        return torch.einsum("bshgk,bkhd->bshgd", p.to(v.dtype).float(),
                            v.float()).reshape(B, S, Hq, D)

    for B, S, Hq, Hkv, D, T in SHAPES:
        q, k, v = (torch.randn(s, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for s in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
        if S == 1:
            qp = torch.full((B, 1), T - 3, dtype=torch.int32, device=dev)
            kp = A.decode_kv_positions(qp[:, 0], T)
        else:
            qp = kp = A.arange_positions(B, S, dev)
        r, hq, hk = B // 2, Hq // 2, Hkv // 2
        for name, fn in (("full_attention", A.full_attention),
                         ("einsums", einsum_attention)):
            whole = fn(q, k, v, qp, kp)
            rows = fn(q[r:], k[r:], v[r:], qp[r:], kp[r:])
            heads = fn(q[:, :, hq:], k[:, :, hk:], v[:, :, hk:], qp, kp)
            verdict = {
                part: "equal" if torch.equal(ref, got) else
                f"differ by {(ref - got).abs().max().item():.3g}"
                for part, ref, got in (("rows", whole[r:], rows),
                                       ("heads", whole[:, :, hq:], heads))}
            print(f"attention {(B, S, Hq, Hkv, D, T)} {name}: "
                  f"rows {verdict['rows']}, heads {verdict['heads']}, "
                  f"{_ms(lambda: fn(q, k, v, qp, kp)):.4f} ms", flush=True)


def _collectives(mesh) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.dist import tp
    dev = mesh.device
    x = torch.randn((4, 3584), device=dev)
    xi = torch.randint(0, 100, (4, 3584), dtype=torch.int32, device=dev)
    xc = x.cpu()
    out = {}

    def t(name, fn, reps=200):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e3

    t("gloo all_reduce max of a host tensor",
      lambda: dist.all_reduce(xc, op=dist.ReduceOp.MAX,
                              group=mesh.model.group))
    t("staged all_reduce_max", lambda: tp.all_reduce_max(x, mesh.model))
    t("staged all_reduce_sum int32", lambda: tp.all_reduce_sum(xi,
                                                                mesh.model))
    t("staged all_gather", lambda: tp.all_gather(x, mesh.model, -1))
    t("device-to-host copy", lambda: xc.copy_(x))
    t("a tiny kernel and a synchronize",
      lambda: (x.mul_(1.0), torch.cuda.synchronize()))
    return out


def collectives() -> None:
    from repro_torch.serve.sharded import launch
    for spec in ("2x2", "1x2"):
        res = launch(_collectives, spec, "gloo", timeout_s=300)
        for k in res[0]:
            ms = ", ".join(f"{r[k]:.3f}" for r in res)
            print(f"collectives {spec}: {k}: ms a call by rank {ms}",
                  flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sharded_costs: no CUDA device", file=sys.stderr)
        return 2
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    attention_bits()
    collectives()
    return 0


if __name__ == "__main__":
    sys.exit(main())
