#!/usr/bin/env python3
"""What the sharded serving path's two new costs are on one GPU host.

    python3 scripts/sharded_costs.py [attention] [split] [norm] [collectives]

(no argument: all four).

1. The float attention's bits against the rows and heads of a call: for
   decode (one query position) and prefill shapes of the served models,
   ``attention.full_attention`` on a batch's second half of rows and of
   heads against the same slice of the whole batch's result (the rows and
   heads a sharded engine's rank holds), and the batched einsums it
   replaced on the card, with each call's median ms (CUDA events).
2. The split-head projections' bits against the rows and heads of a
   call: ``attention.proj_stable`` / ``out_stable`` (what the card runs)
   and the einsums they replace, at
   qwen2-7b's full-width decode, verify and prefill shapes, each call's
   median ms (CUDA events).
3. The norms' row reduction against the rows of a call: ``torch.mean``
   over a 3,584-wide row (what ``rms_norm`` took before the padding) and
   ``layers.row_mean`` (what it takes now: zero rows padded to 16 on the
   card), each row of a call of R rows against the same row of a
   264-row call.
4. The collectives of ``dist.tp`` on ranks that share the card
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


# (B, S): qwen2-7b decode, verify (draft_k + 1) and an odd prefill
SPLIT_ROWS = ((8, 1), (8, 4), (8, 33))


def split_head_bits() -> None:
    import torch
    from repro_torch.models import attention as A
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    d, dh = 3584, 128
    for B, S in SPLIT_ROWS:
        x = torch.randn((B, S, d), generator=g, device=dev).to(
            torch.bfloat16)
        r = B // 2
        for H in (28, 4):
            w = (torch.randn((d, H, dh), generator=g, device=dev)
                 * d ** -0.5).to(torch.bfloat16)
            h = H // 2
            for name, fn in (("proj_stable", A.proj_stable),
                             ("einsum", lambda a, b: torch.einsum(
                                 "bsd,dhk->bshk", a, b))):
                whole = fn(x, w)
                rows, heads = fn(x[r:], w), fn(x, w[:, h:].contiguous())
                verdict = {
                    part: "equal" if torch.equal(ref, got) else
                    f"differ by {(ref - got).abs().max().item():.3g}"
                    for part, ref, got in (("rows", whole[r:], rows),
                                           ("heads", whole[:, :, h:],
                                            heads))}
                print(f"split-head projection {(B, S, d, H, dh)} {name}: "
                      f"rows {verdict['rows']}, heads {verdict['heads']}, "
                      f"{_ms(lambda: fn(x, w)):.4f} ms", flush=True)
        o = torch.randn((B, S, 28, dh), generator=g, device=dev).to(
            torch.bfloat16)
        wo = (torch.randn((28, dh, d), generator=g, device=dev)
              * (28 * dh) ** -0.5).to(torch.bfloat16)
        for name, fn in (("out_stable", A.out_stable),
                         ("einsum", lambda a, b: torch.einsum(
                             "bshk,hkd->bsd", a, b))):
            whole, rows = fn(o, wo), fn(o[r:], wo)
            verdict = "equal" if torch.equal(whole[r:], rows) else \
                f"differ by {(whole[r:] - rows).abs().max().item():.3g}"
            print(f"split-head output {(B, S, 28, dh, d)} {name}: rows "
                  f"{verdict}, {_ms(lambda: fn(o, wo)):.4f} ms", flush=True)


def norm_bits() -> None:
    import torch
    from repro_torch.models import layers as L
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((264, 3584), generator=g, device="cuda") \
        * torch.rand((264, 1), generator=g, device="cuda") * 4
    sq = x * x
    for name, fn in (("torch.mean", lambda t: torch.mean(t, -1,
                                                         keepdim=True)),
                     ("row_mean", L.row_mean)):
        full = fn(sq)
        verdict = " ".join(
            f"{R}:{'equal' if torch.equal(fn(sq[-R:].clone()), full[-R:]) else 'differ'}"
            for R in (1, 2, 3, 4, 5, 8, 12, 16, 33))
        print(f"norm rows {name}: rows of a call of R rows against a "
              f"264-row call: {verdict}", flush=True)


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
    parts = sys.argv[1:] or ["attention", "split", "norm", "collectives"]
    for part in parts:
        {"attention": attention_bits, "split": split_head_bits,
         "norm": norm_bits, "collectives": collectives}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
