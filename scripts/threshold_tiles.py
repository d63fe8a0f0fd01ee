#!/usr/bin/env python3
"""Time variants of ``csrc/thresholds.cu`` at MobileNetV2's 34 threshold
stages (one GPU).

    python3 scripts/threshold_tiles.py                  # the default set
    python3 scripts/threshold_tiles.py '{"u8": {"U": 8}, "vec1": {"VEC": 1}}'

Each variant is a dict of changes to the source:

* ``U``: vectors in flight a thread (1, 2, 4, 8); ``WARPS``: warps a
  block; ``WAVES``: rounds of resident blocks at most; ``MINB``: blocks an
  SM that the registers must allow (``__launch_bounds__``).
* ``VEC``: 1 (one column a thread, 4-byte accesses at every N) or 2 (two
  columns, 8-byte accesses) in place of the source's 4.
* ``SEARCH``: each column's levels counted by a branchless binary search
  over its registers (``SEARCH_CODE``; exact on sorted rows only, which is
  what this script times); ``INTCOUNT``: the full count as ``FSETP``
  compares and integer adds in place of ``FSET`` and float adds.
* ``HINTS``: false for plain loads and stores of acc and codes; ``LOAD``:
  a key of ``LOADS``, the qualifiers of acc's loads; ``THRLOAD``:
  ``"ldca"`` or ``"ldcg"`` for the thresholds' reads; ``ACCFIRST``: the
  first loads of acc before the thresholds' reads.
* Probes: ``DIRECT`` (each thread reads its own thresholds from device
  memory, no staging), ``NOTHR`` (zeros staged in place of the thresholds,
  not checked), ``COPY`` (codes = acc: the kernel's traffic with no
  compare, held against acc).

The script compiles one copy of the source per variant into
``build/threshold_tiles/`` (``nvcc`` in parallel, the flags of
``kernels/build.py``), prints each variant's registers and spills and the
SASS instruction mix of its L = 15 kernels (``cuobjdump``, the opcodes of
``OPCODES``: ``LDG.128`` and ``STG.128`` are the 16-byte accesses, ``LDS``
the shared-memory reads, ``FSET``/``FSETP`` the compares, ``SEL``/``FSEL``
the selects; the code itself lands in ``<variant>.sass``), holds every
variant's codes against the plain version, and times it as
``chip_smoke.py`` does (median of CUDA events, L2 flushed before each
launch) on the stages' shapes at batch 32, L = 15, on sorted rows (what
``make_thresholds`` gives).  Beside each stage: its bound (8 bytes an
element over 3.35 TB/s) and the time of ``torch.Tensor.copy_`` of the same
int32 bytes (one read and one write of M * N * 4 bytes, under the same
flush).
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

OUT_DIR = os.path.join(REPO, "build", "threshold_tiles")
DEFAULT = {"source": {}, "search": {"SEARCH": True},
           "intcount": {"INTCOUNT": True}, "u2": {"U": 2}, "u8": {"U": 8},
           "vec1": {"VEC": 1}, "copy": {"COPY": True}}
# The count of a sorted row's levels at or below a (ascending, no NaN: the
# levels that count form a prefix): one compare a step, each step's
# threshold picked from the candidates by the decisions so far (a select
# tree, all indices known at compile time); past L the row reads as +inf,
# so the count is clamped.
SEARCH_CODE = r"""
__host__ __device__ constexpr int pow2_above(int L) {
  return L < 1 ? 1 : 2 * pow2_above(L / 2);
}
template <int L>
__device__ __forceinline__ int32_t search_count(float a, const float* t) {
  constexpr int P = pow2_above(L);       // counts 0 .. P - 1
  bool p[8];
  int32_t pos = 0;
#pragma unroll
  for (int d = 0; (P >> (d + 1)) >= 1; ++d) {
    const int s = P >> (d + 1);
    float c[P / 2 > 0 ? P / 2 : 1];
#pragma unroll
    for (int j = 0; j < P / 2; ++j)
      if (j < (1 << d)) {
        const int idx = j * 2 * s + s - 1;
        c[j] = idx < L ? t[idx] : __int_as_float(0x7f800000);
      }
#pragma unroll
    for (int e = d - 1; e >= 0; --e)
#pragma unroll
      for (int j = 0; j < P / 4; ++j)
        if (j < (1 << e)) c[j] = p[e] ? c[2 * j + 1] : c[2 * j];
    p[d] = a >= c[0];
    pos += p[d] ? s : 0;
  }
  return P - 1 > L ? min(pos, L) : pos;
}
"""
COUNT = re.compile(r"c\[k\] = count<L>\(.*?\);", re.S)
FLOAT_SUM = re.compile(
    r"  float q = 8388608.f;\n#pragma unroll\n.*?0x4B000000;", re.S)
INT_SUM = """  int32_t q = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) q += a >= t[l] ? 1 : 0;
  return q;"""
# the first step's loads of acc, issued after the thresholds' in the source
ACC_LOADS = re.compile(re.escape(
    """  // the first step's loads fly while the thresholds are staged
  I x[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (live && v + u * S < V) x[u] = __ldcs(acc + v + u * S);

"""))
# loads of acc with other qualifiers: L1 bypassed (``nc``), and an L2
# prefetch of 256 bytes a miss with the streaming hint or without L1
LOADS = {"nc": "nc.L1::no_allocate", "nc256": "nc.L1::no_allocate.L2::256B",
         "cs256": "cs.L2::256B"}
LD_ACC = r"""__device__ __forceinline__ int4 ld_acc(const int4* p) {
  int4 r;
  asm volatile("ld.global.QUAL.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}
__device__ __forceinline__ int32_t ld_acc(const int32_t* p) {
  int32_t r;
  asm volatile("ld.global.QUAL.s32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}

"""
# two columns a thread, 8-byte accesses (every stage's N is even and its
# tensors 16-byte aligned)
VEC2 = """template <> struct Vec<2> {
  using I = int2;
  using F = float2;
  static __device__ __forceinline__ int32_t at(const I& x, int k) {
    return k == 0 ? x.x : x.y;
  }
  static __device__ __forceinline__ float at(const F& x, int k) {
    return k == 0 ? x.x : x.y;
  }
  static __device__ __forceinline__ I make(const int32_t (&c)[2]) {
    return make_int2(c[0], c[1]);
  }
};

"""
# the block's reads of its thresholds, and their staging up to the
# unpacking into registers
THR_READS = re.compile(r"  // the block's groups g0.*?\n\n", re.S)
STAGING = re.compile(r"#pragma unroll\n  for \(int i = 0; i < NI; \+\+i\) {\n"
                     r"    const int c = threadIdx.x \+ i \* BLOCK;\n"
                     r"    if \(c < G \* \(L \+ 1\)\) s_grp.*?"
                     r"unpack<L, VEC>\(s_grp[^;]*;", re.S)
DIRECT = """  if (!live) return;
  float th[VEC][LR], sg[VEC];
  const long long g = p % NG;
  unpack<L, VEC>(thr + g * L, sign + g, th, sg);"""
OPCODES = ("LDG", "STG", "LDS", "FSET", "FSETP", "SEL", "FSEL", "I2F",
           "FMUL", "FADD", "IADD3", "ISETP", "LEA", "IMAD", "MOV")


def variant_source(src: str, spec: dict) -> str:
    for key in ("U", "WAVES", "WARPS"):
        if key in spec:
            src, n = re.subn(rf"(constexpr \w+ {key} = )[^;]*;",
                             rf"\g<1>{spec[key]};", src)
            assert n == 1, key
    if spec.get("VEC") == 1:
        src, n = re.subn(r"const bool vec = [^;]*;",
                         "const bool vec = false;", src)
        assert n == 1, "VEC"
    if spec.get("SEARCH"):
        src, n = COUNT.subn(
            "c[k] = search_count<L>(__fmul_rn(__int2float_rn("
            "Vec<VEC>::at(x[u], k)), sg[k]), th[k]);", src)
        assert n == 1, "SEARCH"
        at = src.index("// Lane i of block b")
        src = src[:at] + SEARCH_CODE + src[at:]
    if spec.get("MINB"):
        src, n = re.subn(r"__launch_bounds__\(BLOCK\)\nthreshold_reg",
                         f"__launch_bounds__(BLOCK, {spec['MINB']})\n"
                         "threshold_reg", src)
        assert n == 1, "MINB"
    if spec.get("INTCOUNT"):
        src, n = FLOAT_SUM.subn(INT_SUM, src)
        assert n == 1, "INTCOUNT"
    if spec.get("DIRECT"):
        src, n = THR_READS.subn("", src)
        assert n == 1, "DIRECT reads"
        src, n = STAGING.subn(DIRECT, src)
        assert n == 1, "DIRECT"
        src, n = re.subn(r"const size_t smem = \(size_t\)std::min[^;]*;",
                         "const size_t smem = 0;", src)
        assert n == 1, "DIRECT smem"
    if spec.get("ACCFIRST"):
        src, n = ACC_LOADS.subn("", src)
        assert n == 1, "ACCFIRST"
        at = src.index("  // the block's groups g0")
        src = src[:at] + ACC_LOADS.pattern.replace("\\", "") + src[at:]
    if spec.get("LOAD"):
        src = src.replace("__ldcs(", "ld_acc(")
        at = src.index("// A group is the VEC columns")
        src = src[:at] + LD_ACC.replace("QUAL", LOADS[spec["LOAD"]]) + src[at:]
    if spec.get("HINTS") is False:
        src = src.replace("__ldcs(", "__ldg(")
        src, n = re.subn(r"__stcs\(out \+ ([^,]*), ([^;]*)\);",
                         r"out[\1] = \2;", src)
        assert n == 1, "HINTS"
    if spec.get("VEC") == 2:
        at = src.index("// A group is the VEC columns")
        src = src[:at] + VEC2 + src[at:]
        src, n = re.subn(r"const bool vec = [^;]*;\n\s*return [^;]*;",
                         "return a.N % 2 == 0 ? launch_reg<L, 2>(a) : "
                         "launch_reg<L, 1>(a);", src)
        assert n == 1, "VEC2"
    if spec.get("THRLOAD"):              # "ldca" or "ldcg"
        src, n = re.subn(r"tv\[i\] = __ldg\(", f"tv[i] = __{spec['THRLOAD']}(",
                         src)
        assert n == 1, "THRLOAD"
    if spec.get("NOTHR"):
        src, n = re.subn(r"tv\[i\] = __ldg\([^;]*;", "tv[i] = F{};", src)
        assert n == 1, "NOTHR"
    if spec.get("COPY"):
        src, n = COUNT.subn("c[k] = Vec<VEC>::at(x[u], k);", src)
        assert n == 1, "COPY"
    return src


def compile_variants(variants: dict) -> dict:
    """{variant: path of its library}, ``nvcc`` in parallel."""
    from repro_torch.kernels import build
    src = (build.CSRC / "thresholds.cu").read_text()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, spec in variants.items():
        cu, so = (os.path.join(OUT_DIR, f"{name}.{x}") for x in ("cu", "so"))
        with open(cu, "w") as f:
            f.write(variant_source(src, spec))
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        spills = sorted({ln.strip() for ln in lines
                         if "spill" in ln and not ln.strip().startswith(
                             "0 bytes stack frame, 0 bytes spill stores")})
        # ptxas names a kernel on its "Compiling entry function" line
        regs = {}
        func = None
        for ln in lines:
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                func = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and func:
                regs[func] = int(m.group(1))
        l15 = {f: r for f, r in regs.items() if "ILi15E" in f}
        print(f"{name}: registers of the L = 15 kernels {json.dumps(l15)}; "
              f"max over {len(regs)} kernels {max(regs.values())}; "
              f"spill lines {spills or 'none'}", flush=True)
        paths[name] = so
    return paths


def sass_mix(so: str) -> dict:
    """{kernel: {opcode: count}} of the L = 15 kernels in ``so``."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    mix: dict = {}
    func = None
    with open(so[:-3] + ".sass", "w") as dump:   # the L = 15 kernels' code
        for line in text.splitlines():
            if "Function :" in line:
                name = line.split("Function :", 1)[1].strip()
                func = name if "ILi15E" in name else None
                if func:
                    mix[func] = collections.Counter()
            if func is not None:
                dump.write(line + "\n")
            if func is not None and "Function :" not in line:
                m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)", line)
                if m and m.group(1) in OPCODES:
                    op = m.group(1)
                    if op in ("LDG", "STG"):     # keep the width
                        w = re.search(r"\.(64|128)\b", m.group(2))
                        op += "." + (w.group(1) if w else "32")
                    mix[func][op] += 1
    return {f: dict(sorted(c.items())) for f, c in mix.items()}


def stages() -> list:
    """(name, M, N) of MobileNetV2's 34 pointwise stages at batch 32."""
    from chip_smoke import MB_BATCH
    from repro_torch.configs import get_config
    from repro_torch.models.mobilenet import _conv_shapes
    cfg = get_config("mobilenetv2")
    return [(name, MB_BATCH * h * h, cout)
            for name, cin, cout, k, _, _, h in _conv_shapes(cfg)[0]
            if k == 1]


def main() -> int:
    import torch
    from chip_smoke import HBM_BYTES_PER_S, _time, smi_line
    from repro_torch.kernels.thresholds import ref as tref

    if not torch.cuda.is_available():
        print("threshold_tiles: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT
    reps = int(os.environ.get("REPS", "20"))
    print(f"{smi_line()} | {torch.cuda.get_device_name(0)}", flush=True)
    paths = compile_variants(variants)
    fns = {}
    for name, so in paths.items():
        for func, mix in sass_mix(so).items():
            print(f"{name} {func}: {json.dumps(mix)}", flush=True)
        fn = ctypes.CDLL(so).threshold_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fns[name] = fn
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    L = 15
    res = collections.defaultdict(list)
    bound, floor = [], []
    names = []
    for stage, M, N in stages():
        names.append(f"{stage} {M}x{N}")
        acc = torch.randint(-4000, 4000, (M, N), generator=gen, device=dev,
                            dtype=torch.int32)
        thr = torch.sort(torch.randn((N, L), generator=gen, device=dev)
                         * 1500, dim=1).values.contiguous()
        sign = torch.where(torch.rand((N,), generator=gen, device=dev)
                           < 0.8, 1.0, -1.0).contiguous()
        bound.append(8 * M * N / HBM_BYTES_PER_S * 1e3)
        copy = torch.empty_like(acc)
        floor.append(_time(lambda: copy.copy_(acc), reps, flush))
        for name, fn in fns.items():
            out = torch.empty_like(acc)

            def call(fn=fn, out=out):
                code = fn(acc.data_ptr(), thr.data_ptr(), sign.data_ptr(),
                          out.data_ptr(), M, N, L, stream)
                assert code == 0, code
            call()
            want = acc if variants[name].get("COPY") else \
                tref.threshold_ref(acc, thr, sign)
            if not variants[name].get("NOTHR") and not torch.equal(out,
                                                                  want):
                raise AssertionError(f"{name} disagrees with the plain "
                                     f"version at {M}x{N}")
            res[name].append(_time(call, reps, flush))
        del acc, copy
    print(f"stages: {json.dumps(names)}", flush=True)
    print(f"bound: {sum(bound):.4f} ms "
          f"[{' '.join(f'{x:.4f}' for x in bound)}]")
    print(f"copy_ of the same bytes: {sum(floor):.4f} ms "
          f"[{' '.join(f'{x:.4f}' for x in floor)}]", flush=True)
    for name, r in res.items():
        print(f"{name}: {sum(r):.4f} ms, bound / ms {sum(bound) / sum(r):.3f}"
              f" [{' '.join(f'{x:.4f}' for x in r)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
