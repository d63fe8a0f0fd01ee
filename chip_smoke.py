#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero):

1. device + build: the ``nvidia-smi`` name/power-limit line, then the two
   CUDA sources compiled for sm_90a (one ``nvcc`` each, in parallel).
2. kernels: the four entry points at the serving shapes (M = 8 slots; the
   qwen2-7b inner projections and the int8 head) held against their plain
   versions on the card — int32 outputs exactly, fused bf16 outputs
   bitwise — and timed with CUDA events (median; L2 flushed before each
   launch, as a decode step finds the weights cold), beside one library
   call on the same codes where one computes the same sums exactly
   (``torch._int_mm``, else the float32 cuBLAS GEMM with TF32 off).
3. serving: full-width qwen2-7b (28 layers, random weights from a seeded
   generator) through ``make_engine(..., ServeConfig(quant="w4a4_lut"))``
   and ``Scheduler(slots=8, chunk=8)`` on 8 requests; every request must
   finish with its budget and the launch counters must show 7 * 28 LUT
   launches and 1 int8 launch per ``decode_step``.  The first four
   requests are served again through the unfused epilogue (the int32 entry
   points), and all eight with the plain backend; the transcripts must be
   identical.  A short torch.profiler window gives the device-busy share.
4. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, ...}`` line.

Options cut the run for debugging (``--layers``, ``--reps``, ``--profile``);
the contract run takes none.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
INT8_OPS_PER_S = 1979e12          # H100 SXM dense int8 tensor-core peak
SLOTS = 8
INNER = {"wq": (3584, 3584), "wk": (3584, 512), "wv": (3584, 512),
         "wo": (3584, 3584), "wi": (3584, 18944), "wg": (3584, 18944),
         "mlp.wo": (18944, 3584)}
HEAD = (3584, 152064)
SOURCES = {"lutmul": "src/repro_torch/csrc/lutmul.cu",
           "int_matmul": "src/repro_torch/csrc/int_matmul.cu"}
REPLACES = {
    "lutmul_fused": "src/repro/kernels/lutmul/kernel.py:380",
    "lutmul": "src/repro/kernels/lutmul/kernel.py:178",
    "int_matmul_fused": "src/repro/kernels/lutmul/kernel.py:483",
    "int_matmul": "src/repro/kernels/lutmul/kernel.py:332",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

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


def _library_ms(a8, w8, want, flush, reps):
    """The library yardstick on the same int8 operands, held to the plain
    int32 result ``want``: torch._int_mm, or, where it refuses the shape
    and float32 sums are exact (|acc| < 2^24), the float32 cuBLAS GEMM of
    the same codes (TF32 is off).  Returns (ms or None, note)."""
    import torch
    K = a8.shape[1]
    try:
        got = torch._int_mm(a8, w8)
        fn, note = (lambda: torch._int_mm(a8, w8)), "torch._int_mm"
    except RuntimeError as err:
        why = str(err).splitlines()[0][:160]
        bound = int(a8.abs().max()) * int(w8.abs().max()) * K
        if bound >= 2 ** 24:
            return None, (f"torch._int_mm refuses ({why}); float32 is not "
                          f"exact here (|acc| up to {bound} >= 2^24)")
        af, wf = a8.float(), w8.float()
        fn = lambda: torch.matmul(af, wf)               # noqa: E731
        got = fn().to(torch.int32)
        note = ("float32 cuBLAS GEMM of the decoded codes, TF32 off, exact "
                f"(|acc| <= {bound} < 2^24), no epilogue; torch._int_mm "
                f"refuses ({why})")
    torch.cuda.synchronize()
    if not torch.equal(got.to(torch.int32), want):
        raise AssertionError(f"library yardstick ({note}) disagrees with "
                             "the plain version")
    return _time(fn, reps, flush), note


def check_kernels(reps: int) -> dict:
    import torch
    from repro_torch.kernels.lutmul import kernel, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    M = SLOTS
    recs = {name: {"name": name, "route": "cuda",
                   "source": SOURCES["lutmul" if "lut" in name
                                     else "int_matmul"],
                   "replaces": REPLACES[name], "shapes": []}
            for name in REPLACES}

    def scales(K, N):
        a_s = torch.rand((M, 1), generator=gen, device=dev) * 0.1 + 1e-3
        w_s = torch.rand((1, N), generator=gen, device=dev) * 0.1 + 1e-3
        return a_s, w_s

    def one(name, fn, plain, lib, K, N, nbytes_in, out_bytes):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {K}x{N}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        # int32 exactly; fused outputs bitwise (compare the raw bits)
        same = torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16
                           else got,
                           want.view(torch.int16) if want.dtype == torch.bfloat16
                           else want)
        err = float((got.to(torch.float64) - want.to(torch.float64))
                    .abs().max())
        if not same:
            raise AssertionError(f"{name} {K}x{N} disagrees with its plain "
                                 f"version: max |diff| = {err}")
        nbytes = nbytes_in + out_bytes
        ops = 2.0 * M * K * N
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        lib_ms, why = lib
        recs[name]["shapes"].append({
            "K": K, "N": N, "max_abs_err": err,
            "ms": _time(fn, reps, flush),
            "plain_ms": _time(plain, max(3, reps // 8), flush),
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / INT8_OPS_PER_S else "operations",
            "library_ms": lib_ms, "library_note": why})

    for K, N in INNER.values():
        a = torch.randint(0, 16, (M, K), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                          dtype=torch.uint8)
        a_s, w_s = scales(K, N)
        # the library yardstick: _int_mm on the decoded signed codes
        a8 = ref.decode_codes(a).to(torch.int8)
        w8 = ref.decode_codes(ref.unpack_int4(w.T).T, 4).to(torch.int8) \
            .contiguous()
        lib = _library_ms(a8, w8, ref.lutmul_ref(a, w), flush, reps)
        in_bytes = M * K + K * N // 2 + 256 * 4
        one("lutmul", lambda: kernel.lutmul(a, w),
            lambda: ref.lutmul_ref(a, w), lib, K, N, in_bytes, M * N * 4)
        one("lutmul_fused",
            lambda: kernel.lutmul_fused(a, w, a_s, w_s,
                                        out_dtype=torch.bfloat16),
            lambda: ref.scaled_lutmul_ref(a, w, a_s, w_s,
                                          out_dtype=torch.bfloat16),
            lib, K, N, in_bytes + 4 * (M + N), M * N * 2)
        del a, w, a8, w8
    K, N = HEAD
    a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    a_s, w_s = scales(K, N)
    lib = _library_ms(a, w, ref.int_matmul_ref(a, w), flush, reps)
    one("int_matmul", lambda: kernel.int_matmul(a, w),
        lambda: ref.int_matmul_ref(a, w), lib, K, N, M * K + K * N,
        M * N * 4)
    one("int_matmul_fused",
        lambda: kernel.int_matmul_fused(a, w, a_s, w_s,
                                        out_dtype=torch.bfloat16),
        lambda: ref.scaled_int_matmul_ref(a, w, a_s, w_s,
                                          out_dtype=torch.bfloat16),
        lib, K, N, M * K + K * N + 4 * (M + N), M * N * 2)
    del a, w, flush
    torch.cuda.empty_cache()
    # one record per kernel: the LUT kernels summed over the 7 projections
    # of one layer (one measured launch each), the int8 kernels per head call
    for r in recs.values():
        sh = r["shapes"]
        r["per"] = ("one layer: 7 launches at M=8" if "lut" in r["name"]
                    else "one lm_head launch at M=8")
        r["max_abs_err"] = max(s["max_abs_err"] for s in sh)
        for key in ("ms", "plain_ms", "bound_ms"):
            r[key] = sum(s[key] for s in sh)
        libs = [s["library_ms"] for s in sh]
        r["library_ms"] = None if None in libs else sum(libs)
        r["library_note"] = next((s["library_note"] for s in sh
                                  if s["library_note"]), None)
        r["bound_by"] = "bytes" if all(s["bound_by"] == "bytes"
                                       for s in sh) else "operations"
        log(f"kernel {r['name']}: max|diff| {r['max_abs_err']} ms "
            f"{r['ms']:.4f} plain {r['plain_ms']:.3f} bound "
            f"{r['bound_ms']:.4f} library {r['library_ms']}")
    return recs


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def make_requests(vocab: int, seed: int = 0):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(range(8, 65, 8)):
        out.append(Request(prompt=rng.integers(0, vocab, L).tolist(),
                           max_new_tokens=int(rng.integers(16, 33))))
    return out


def serve(engine, vocab: int, label: str,
          n_requests: int = 8) -> tuple[list, dict]:
    import torch
    from repro_torch.kernels.lutmul import kernel
    from repro_torch.serve import Scheduler
    reqs = make_requests(vocab)[:n_requests]
    sched = Scheduler(engine, slots=SLOTS, chunk=8)
    kernel.reset_launches()
    engine.decode_steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in reqs:
        if not (r.finish_reason == "length"
                and len(r.tokens) == r.max_new_tokens):
            raise AssertionError(f"{label}: request ended {r.finish_reason} "
                                 f"with {len(r.tokens)}/{r.max_new_tokens}")
    emitted = sum(len(r.tokens) for r in reqs)
    stats = {"label": label, "seconds": dt,
             "decode_steps": engine.decode_steps,
             "rounds": sched.stats["rounds"], "emitted_tokens": emitted,
             "tokens_per_s": emitted / dt,
             "ms_per_decode_step": 1e3 * dt / engine.decode_steps,
             "launches": dict(kernel.LAUNCHES)}
    log(f"serving[{label}]: {json.dumps(stats)}")
    return [list(r.tokens) for r in reqs], stats


def profile_decode(engine, steps: int = 8) -> dict:
    """Device time by kernel over ``steps`` full-batch decode steps
    (torch.profiler) against their host wall time: the device-busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = SLOTS
    cache = engine.init_cache(B)
    tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
    pos = torch.arange(B, dtype=torch.int32, device="cuda") + 16
    engine._decode(tok, cache, pos)                      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._decode(tok, cache, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, memsets, copies): the CPU ops that
    # launched them report the same time again
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
           "device_ms_per_step": busy_ms / steps,
           "device_busy_share": busy_ms / (1e3 * wall),
           "top": [{"kernel": k[:60], "ms_per_step": us / 1e3 / steps,
                    "calls_per_step": n / steps} for us, k, n in rows[:8]]}
    log("profile: " + json.dumps(out))
    return out


def run_serving(n_layers: int, profile_steps: int = 0) -> dict:
    import dataclasses
    import torch
    from repro_torch.configs import qwen2_7b
    from repro_torch.kernels.lutmul import ops
    from repro_torch.models import transformer
    from repro_torch.serve import ServeConfig, make_engine

    cfg = qwen2_7b.config(quant="w4a4_lut")
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    engine = make_engine(params, cfg,
                         ServeConfig(quant="w4a4_lut", max_len=256))
    del params            # the float master weights go; codes stay
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"model: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.compute_dtype}; init + "
        f"quantize {time.perf_counter() - t0:.1f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # the main path: fused epilogue on every projection
    ops.set_backend("cuda")
    ops.set_variant(None)
    fused, st_fused = serve(engine, cfg.vocab, "fused")
    prof = profile_decode(engine, profile_steps) if profile_steps else None
    steps = st_fused["decode_steps"]
    want = {"lutmul_fused": 7 * cfg.n_layers * steps,
            "int_matmul_fused": steps, "lutmul": 0, "int_matmul": 0}
    if st_fused["launches"] != want:
        raise AssertionError(f"fused launches {st_fused['launches']} != "
                             f"{want}")
    # the unfused entry points (int32 out, epilogue in PyTorch) on the
    # first four requests: they take the same slots and rounds as in the
    # full run, and every op of a decode step is row-independent at the
    # fixed batch of SLOTS rows, so their transcripts must not change
    ops.set_variant("unfused")
    unfused, st_unfused = serve(engine, cfg.vocab, "unfused", n_requests=4)
    ops.set_variant(None)
    steps = st_unfused["decode_steps"]
    want = {"lutmul": 7 * cfg.n_layers * steps, "int_matmul": steps,
            "lutmul_fused": 0, "int_matmul_fused": 0}
    if st_unfused["launches"] != want:
        raise AssertionError(f"unfused launches {st_unfused['launches']} "
                             f"!= {want}")
    if unfused != fused[:len(unfused)]:
        raise AssertionError("unfused transcripts differ from fused")
    # the plain versions on the card
    ops.set_backend("ref")
    plain, st_plain = serve(engine, cfg.vocab, "plain")
    ops.set_backend(None)
    if any(st_plain["launches"].values()):
        raise AssertionError(f"plain run launched kernels: "
                             f"{st_plain['launches']}")
    if plain != fused:
        diff = [i for i, (a, b) in enumerate(zip(plain, fused)) if a != b]
        raise AssertionError(f"plain transcripts differ from the kernels' "
                             f"for requests {diff}")
    log(f"transcripts identical: fused / plain ({sum(map(len, fused))} "
        f"tokens), unfused ({sum(map(len, unfused))} tokens)")
    return {"fused": st_fused, "unfused": st_unfused, "plain": st_plain,
            "profile": prof,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=28,
                   help="model depth (full width always); default 28")
    p.add_argument("--reps", type=int, default=50,
                   help="timed launches per kernel and shape")
    p.add_argument("--profile", type=int, default=4, metavar="STEPS",
                   help="decode steps profiled after the fused run "
                        "(0: none)")
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s for {len(logs)} sources")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    recs = check_kernels(args.reps)
    serving = run_serving(args.layers, args.profile)
    for name, r in recs.items():
        run = "unfused" if name in ("lutmul", "int_matmul") else "fused"
        r["launches"] = serving[run]["launches"][name]
        r["launches_per_decode_step"] = (
            r["launches"] / serving[run]["decode_steps"])
    log("serving: " + json.dumps(
        {k: v for k, v in serving.items() if k not in ("plain", "profile")}))
    for r in recs.values():
        r["kernel_ms"] = r["ms"]
        r["max_abs_diff"] = r["max_abs_err"]
    kernels = {"kernels": list(recs.values())}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
