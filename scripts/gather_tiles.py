#!/usr/bin/env python3
"""Time tile variants of ``csrc/lutmul_gather.cu`` at the served shapes (one GPU).

    python3 scripts/gather_tiles.py                       # the source's tiles
    python3 scripts/gather_tiles.py '{"v1": ["Tile<...>", "Tile<...>"]}'

Each variant names the ``Short`` and ``Tall`` tile types, as
``Tile<R, KG, MINB>`` (their meaning is in the source), and optionally a
third item: the index (0-3) of the tall tile's K split (1, 2, 4, 8) that
every call takes in place of the launch's choice.  The script compiles one
copy of the source per variant into ``build/lutmul_gather_tiles/``
(``nvcc`` in parallel, the flags of ``kernels/build.py``), prints each
kernel's SASS instruction mix (``cuobjdump``: the table reads ``LDS``, the
address ``PRMT`` and the adds ``IADD3`` of the inner loop), holds every
variant's sums against the plain version, and times it as ``chip_smoke.py``
does (median of CUDA events, L2 flushed before each launch): MobileNetV2's
34 pointwise stages at batch 32 (the unsigned product table) and qwen2-7b's
7 inner projections at M = 8 (signed).  Beside each group its gather
floor: one shared-memory read per product at 32 a clock per SM, at the
card's maximum SM clock.

First it times the kernel's inner step alone (``LOOP`` below: the source's
``gather_step`` of the tall tile on register-resident codes, 4 blocks of
256 threads an SM, no global traffic in the loop) and prints the table
reads it made per clock per SM: the rate the shared-memory pipe and the
instruction mix allow this loop, beside the 32 a clock of the floor.
"""
from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)


LOOP = r"""
#include "lutmul_gather.cu"
namespace {
template <bool SHARED, bool SYNC>
__global__ void __launch_bounds__(THREADS, 4)
loop_kernel(const uint32_t* __restrict__ seed, int32_t* __restrict__ out,
            int iters) {
  __shared__ __align__(16) uint32_t s_t[16 * 64];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 4;
  s_t[(tid >> 4) * 64 + (tid & 15)] = seed[tid];
  s_t[(tid >> 4) * 64 + 16 + (tid & 15)] = seed[tid];
  __syncthreads();
  // each lane its own rows' codes; each half-warp one set of columns (the
  // kernel's pattern) or, to show what conflicts cost, each lane its own
  Step<Tall> s;
  const uint32_t* p = seed + 256 + ((blockIdx.x * THREADS + tid) & 1023) * 16;
  const uint32_t* q = SHARED
      ? seed + 256 + ((blockIdx.x * 16 + (tid >> 4)) & 1023) * 16 : p;
  for (int r = 0; r < Tall::R; ++r)
    for (int h = 0; h < 2; ++h) s.x[r][h] = p[2 * r + h];
  for (int j = 0; j < 4; ++j)
    for (int h = 0; h < 2; ++h) s.y[j][h] = q[8 + 2 * j + h];
  uint32_t acc[Tall::R][COLS] = {};
  for (int it = 0; it < iters; ++it) {
    gather_step<Tall>(s, reinterpret_cast<const char*>(s_t),
                      g ? 0x40404040u : 0u, acc);
    for (int r = 0; r < Tall::R; ++r)        // new codes: an LCG per word
      for (int h = 0; h < 2; ++h) s.x[r][h] = s.x[r][h] * 1664525u + 1013904223u;
    if (SYNC && it % 2 == 1) __syncthreads();
  }
  // every sum stored as the kernel stores a 16-column tile
  const long long row = (long long)blockIdx.x * Tall::BM +
                        (tid >> 5) * 16 * Tall::R + (lane & 15);
  for (int r = 0; r < Tall::R; ++r) {
    int4* o = reinterpret_cast<int4*>(out + (row + 16 * r) * BN + g * COLS);
    o[0] = make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    o[1] = make_int4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}
}  // namespace
extern "C" int loop_launch(const void* seed, void* out, int blocks,
                           int iters, int shared, int sync) {
  auto k = shared ? (sync ? loop_kernel<true, true> : loop_kernel<true, false>)
                  : loop_kernel<false, false>;
  k<<<blocks, THREADS>>>(static_cast<const uint32_t*>(seed),
                         static_cast<int32_t*>(out), iters);
  return (int)cudaGetLastError();
}
"""


def loop_rate(sm_hz: float) -> None:
    """Table reads per clock per SM of ``LOOP`` (the module docstring):
    long blocks (2,000 steps, 32 per SM), with and without the kernel's
    barriers and with conflicting lanes; then blocks as short as the
    kernel's at two MobileNetV2 stages, 2 steps (b1_0_expand's K = 16) and
    40 steps (the head's K = 320), with their number of blocks."""
    import torch
    from chip_smoke import _time
    from repro_torch.kernels import build
    out_dir = os.path.join(REPO, "build", "lutmul_gather_tiles")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = (os.path.join(out_dir, f"loop.{x}") for x in ("cu", "so"))
    with open(cu, "w") as f:
        f.write(LOOP)
    log = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC), "-o", so, cu], capture_output=True,
                         text=True, check=True).stderr
    print("loop: " + " ".join(ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln))
    fn = ctypes.CDLL(so).loop_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed = torch.randint(0, 2 ** 31, (256 + 1024 * 16,), device=dev,
                         dtype=torch.int64).to(torch.int32)
    out = torch.empty(9408 * 256 * 16, dtype=torch.int32, device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for blocks, iters, shared, sync, what in (
            (4 * sms * 8, 2000, 1, 0, "a half-warp's lanes share their "
             "columns"),
            (4 * sms * 8, 2000, 1, 1, "the same with a barrier every 2 steps"),
            (4 * sms * 8, 2000, 0, 0, "each lane its own columns (bank "
             "conflicts)"),
            (9408, 2, 1, 1, "9,408 blocks of 2 steps (b1_0_expand)"),
            (560, 40, 1, 1, "560 blocks of 40 steps (the head)")):
        ms = _time(lambda: fn(seed.data_ptr(), out.data_ptr(), blocks, iters,
                              shared, sync), 5, flush)
        reads = blocks * 256 * iters * 128
        print(f"loop, {what}: {reads} table reads in {ms:.4f} ms: "
              f"{reads / (ms * 1e-3) / sms / sm_hz:.2f} a clock per SM at "
              f"{sm_hz / 1e6:.0f} MHz", flush=True)


PICK = re.compile(r"(cudaError_t launch_tall\(.*?\{\n).*?(\n\}\n)", re.S)


def compile_variants(variants: dict) -> dict:
    """{variant: loaded library}: the source with each variant's tiles and
    K split substituted, ``nvcc`` in parallel."""
    from repro_torch.kernels import build
    src = (build.CSRC / "lutmul_gather.cu").read_text()
    assert PICK.search(src), "the launch's K-split choice moved"
    out_dir = os.path.join(REPO, "build", "lutmul_gather_tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, spec in variants.items():
        spec = list(spec or []) + [None] * 3
        text = src
        for kind, tile in zip(("Short", "Tall"), spec[:2]):
            if tile:
                text, n = re.subn(rf"using {kind} = Tile<[^;]*>;",
                                  f"using {kind} = {tile};", text)
                assert n == 1, kind
        if spec[2] is not None:
            kg = 1 << int(spec[2])
            text = PICK.sub(
                lambda m: m.group(1) + "  (void)sms;\n  return launch<Split<"
                f"Tall, {kg}>, VEC>(a, w, table, out, M, K, N, stream);"
                + m.group(2), text)
        cu, so = (os.path.join(out_dir, f"{name}.{x}") for x in ("cu", "so"))
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = sorted({ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill stores" in ln})
        print(f"{name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def sass_mix(so: str) -> dict:
    """{kernel: {opcode: count}} of the gather kernels in ``so``."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    mix: dict = {}
    func = None
    for line in text.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            mix[func] = collections.Counter()
        elif func is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                         line)
            if m:
                mix[func][m.group(1)] += 1
    return {f: dict(c.most_common(12)) for f, c in mix.items()}


def main() -> int:
    import torch
    from chip_smoke import (MB_BATCH, QWEN_INNER, SLOTS, _time,
                            gather_floor_ms, sm_clock_hz, smi_line)
    from repro_torch.configs import get_config
    from repro_torch.kernels.lutmul import kernel, ref
    from repro_torch.models.mobilenet import _conv_shapes

    if not torch.cuda.is_available():
        print("gather_tiles: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {
        "source": None}
    reps = int(os.environ.get("REPS", "20"))
    sm_hz = sm_clock_hz()
    print(f"{smi_line()} | max SM clock {sm_hz / 1e6:.0f} MHz", flush=True)
    loop_rate(sm_hz)
    libs = compile_variants(variants)
    out_dir = os.path.join(REPO, "build", "lutmul_gather_tiles")
    fns = {}
    for name, lib in libs.items():
        for func, mix in sass_mix(os.path.join(out_dir, f"{name}.so")).items():
            print(f"{name} {func}: {json.dumps(mix)}", flush=True)
        fns[name] = lib.lutmul_gather_launch
        fns[name].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config("mobilenetv2")
    cases = [("mobilenetv2", MB_BATCH * h * h, cin, cout, False)
             for _, cin, cout, k, _, _, h in _conv_shapes(cfg)[0] if k == 1]
    cases += [("qwen", SLOTS, K, N, True) for K, N in QWEN_INNER.values()]
    if os.environ.get("PROBE"):     # long-K shapes with many blocks
        cases += [("probe", 100352, 960, 32, False),
                  ("probe", 401408, 320, 16, False)]
    stream = torch.cuda.current_stream().cuda_stream
    res = {name: collections.defaultdict(list) for name in fns}
    products = collections.Counter()
    for group, M, K, N, signed in cases:
        a = torch.randint(0, 16, (M, K), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                          dtype=torch.uint8)
        table = kernel.product_table(signed, dev)
        want = ref.lutmul_ref(a, w, signed)
        products[group] += M * K * N
        for name, fn in fns.items():
            out = torch.empty((M, N), dtype=torch.int32, device=dev)

            def call(fn=fn, out=out):
                code = fn(a.data_ptr(), w.data_ptr(), table.data_ptr(),
                          out.data_ptr(), M, K, N, stream)
                assert code == 0, code
            call()
            assert torch.equal(out, want), (name, M, K, N)
            res[name][group].append(_time(call, reps, flush))
        del a, w, want
    for group, n in products.items():
        print(f"{group}: {n} products, gather floor "
              f"{gather_floor_ms(n, sm_hz):.4f} ms", flush=True)
    for name, r in res.items():
        print(name + ": " + "; ".join(
            f"{g} {sum(v):.4f} ms [{' '.join(f'{x:.4f}' for x in v)}]"
            for g, v in r.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
