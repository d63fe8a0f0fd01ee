#!/usr/bin/env python3
"""Time tile variants of ``csrc/lutmul.cu`` at the served shapes (one GPU).

    python3 scripts/lutmul_tiles.py                       # the source's tiles
    python3 scripts/lutmul_tiles.py '{"v1": ["Tile<...>", "Tile<...>"]}'

Each variant names the ``Decode`` and ``Tall`` tile types, as
``Tile<NG, TM, WM, WK, MINB, TARGET>`` (their meaning is in the source);
the script compiles one copy of the
source per variant into ``build/lutmul_tiles/`` (``nvcc`` in parallel, the
flags of ``kernels/build.py``), holds every variant's int32 and bf16 outputs
against the plain versions, and times the int32 entry point as
``chip_smoke.py`` does (median of CUDA events, L2 flushed before each
launch): qwen2-7b's 7 inner projections at M = 8 (signed codes, also the
fused bf16 epilogue) and MobileNetV2's 34 pointwise stages at batch 32
(unsigned).  Beside them, ``torch.sum`` over the same weight bytes: a read
of those bytes by PyTorch under the same flush, the yardstick of what the
measurement itself costs a bytes-bound kernel.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)


def compile_variants(variants: dict, source: str = "lutmul",
                     kinds: tuple = ("Decode", "Tall")) -> dict:
    """{variant: loaded library} for ``csrc/<source>.cu`` with each
    variant's tile types (``kinds``, in order) substituted."""
    from repro_torch.kernels import build
    src = (build.CSRC / f"{source}.cu").read_text()
    out_dir = os.path.join(REPO, "build", f"{source}_tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, tiles in variants.items():
        text = src
        for kind, tile in zip(kinds, tiles or ()):
            text, n = re.subn(rf"using {kind} = Tile<[^;]*>;",
                              f"using {kind} = {tile};", text)
            assert n == 1, kind
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        regs = sorted({ln.strip() for ln in logs[name].splitlines()
                       if "registers" in ln or "spill stores" in ln})
        print(f"{name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    import torch
    from chip_smoke import QWEN_INNER, SLOTS, MB_BATCH, _time, smi_line
    from repro_torch.configs import get_config
    from repro_torch.kernels.lutmul import kernel, ref
    from repro_torch.models.mobilenet import _conv_shapes

    if not torch.cuda.is_available():
        print("lutmul_tiles: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {
        "source": None}
    reps = int(os.environ.get("REPS", "20"))
    print(smi_line(), flush=True)
    libs = {}
    for name, lib in compile_variants(variants).items():
        libs[name] = lib.lutmul_launch
        libs[name].argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config("mobilenetv2")
    cases = [("qwen", SLOTS, K, N, True) for K, N in QWEN_INNER.values()]
    cases += [("mobilenetv2", MB_BATCH * h * h, cin, cout, False)
              for _, cin, cout, k, _, _, h in _conv_shapes(cfg)[0] if k == 1]
    work = torch.zeros(max(M * N for _, M, _, N, _ in cases) + (1 << 20),
                       dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    res = {name: {"qwen": [], "qwen bf16": [], "mobilenetv2": []}
           for name in libs}
    res["torch.sum of the weight bytes"] = {"qwen": []}
    for group, M, K, N, signed in cases:
        a = torch.randint(0, 16, (M, K), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                          dtype=torch.uint8)
        a_s = torch.rand((M, 1), generator=gen, device=dev) + 0.01
        w_s = torch.rand((1, N), generator=gen, device=dev) + 0.01
        words = kernel.product_words(signed, dev)
        want = ref.lutmul_ref(a, w, signed)
        for name, fn in libs.items():
            for out_dtype in (torch.int32, torch.bfloat16):
                if out_dtype == torch.bfloat16 and group != "qwen":
                    continue
                out = torch.empty((M, N), dtype=out_dtype, device=dev)
                epi = 0 if out_dtype == torch.int32 else 1

                def call(fn=fn, out=out, epi=epi):
                    code = fn(a.data_ptr(), w.data_ptr(), words.data_ptr(),
                              a_s.data_ptr(), w_s.data_ptr(), out.data_ptr(),
                              work.data_ptr(), M, K, N, epi, stream)
                    assert code == 0, code
                call()
                exp = want if epi == 0 else ref.dequant_epilogue(
                    want, a_s, w_s, out_dtype)
                bits = torch.int32 if epi == 0 else torch.int16
                assert torch.equal(out.view(bits), exp.view(bits)), (
                    name, M, K, N, out_dtype)
                key = group if epi == 0 else "qwen bf16"
                res[name][key].append(_time(call, reps, flush))
        if group == "qwen":
            w32 = w.view(torch.int32)
            res["torch.sum of the weight bytes"]["qwen"].append(_time(
                lambda: torch.sum(w32, dtype=torch.int32), reps, flush))
        del a, w, want
    assert not work.any(), "the K-split workspace was not left zero"
    for name, r in res.items():
        print(name + ": " + "; ".join(
            f"{g} {sum(v):.4f} ms [{' '.join(f'{x:.4f}' for x in v)}]"
            for g, v in r.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
