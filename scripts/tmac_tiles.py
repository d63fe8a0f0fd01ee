#!/usr/bin/env python3
"""Time tile variants of ``csrc/lutmul_tmac.cu`` at the served layers (one GPU).

    python3 scripts/tmac_tiles.py                        # the source's tiles
    python3 scripts/tmac_tiles.py '{"v1": ["Tile<...>", "Tile<...>"]}'

Each variant names the ``Decode`` (M <= 8) and ``Wide`` tile types, as
``Tile<TM, WARPS, BK, STAGES, MINB>`` (their meaning is in the source).
The script compiles one copy of the source per variant (``nvcc`` in
parallel, the flags of ``kernels/build.py``), holds every variant's int32
and bf16 outputs against the plain versions, and times both as
``chip_smoke.py`` does (median of CUDA events, L2 flushed before each
launch) over the 7 projections of one layer in chip_smoke's four T-MAC
groups: qwen2-7b's target (P = 4, M = 8), drafter (P = 2), verify (P = 4,
M = 32) and bitnet-3b's ternary layer.  Beside them, in the same process:
the LUT kernel (``kernel.lutmul``) on qwen2-7b's layer at M = 8 (the same
bytes as P = 4), and ``torch.sum`` over each group's plane bytes, a read of
those bytes by PyTorch under the same flush.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)


def main() -> int:
    import torch
    from chip_smoke import (BITNET_INNER, QWEN_INNER, SLOTS, VERIFY_M, _time,
                            smi_line)
    from repro_torch.core.lut import plane_decomposition
    from repro_torch.kernels.lutmul import kernel, ref
    from scripts.lutmul_tiles import compile_variants

    if not torch.cuda.is_available():
        print("tmac_tiles: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {
        "source": None}
    reps = int(os.environ.get("REPS", "20"))
    print(smi_line(), flush=True)
    libs = {}
    for name, lib in compile_variants(variants, "lutmul_tmac",
                                      ("Decode", "Wide")).items():
        libs[name] = (lib.lutmul_tmac_launch, lib.lutmul_tmac_workspace_words)
        libs[name][0].argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 11 + [ctypes.c_void_p]
        libs[name][1].argtypes = [ctypes.c_int, ctypes.c_int]
        libs[name][1].restype = ctypes.c_longlong
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    groups = {"qwen2-7b target layer, P=4 M=8": (QWEN_INNER, 4, 4, SLOTS),
              "qwen2-7b drafter layer, P=2 M=8": (QWEN_INNER, 2, 4, SLOTS),
              "qwen2-7b verify layer, P=4 M=32": (QWEN_INNER, 4, 4,
                                                  VERIFY_M),
              "bitnet-3b layer, ternary M=8": (BITNET_INNER, "ternary", 8,
                                               SLOTS)}
    res: dict = {}

    def add(name, group, ms):
        res.setdefault(name, {}).setdefault(group, []).append(ms)

    for group, (shapes, spec, abits, M) in groups.items():
        P, coeffs, const = plane_decomposition(spec)
        co = list(coeffs) + [0] * (4 - len(coeffs))
        g = 1 if abits == 8 else 2
        for K, N in shapes.values():
            lo = -(1 << (abits - 1))
            a = torch.randint(lo, -lo, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            planes = torch.randint(0, 256, (P, K // 8, N), generator=gen,
                                   device=dev, dtype=torch.uint8)
            a_s = torch.rand((M, 1), generator=gen, device=dev) + 0.01
            w_s = torch.rand((1, N), generator=gen, device=dev) + 0.01
            want = ref.tmac_ref(a, planes, spec)
            for name, (fn, words) in libs.items():
                work = torch.zeros(words(M, N), dtype=torch.int32,
                                   device=dev)
                for epi, out_dtype in ((0, torch.int32), (1, torch.bfloat16)):
                    out = torch.empty((M, N), dtype=out_dtype, device=dev)

                    def call(fn=fn, out=out, epi=epi, work=work):
                        code = fn(a.data_ptr(), planes.data_ptr(),
                                  a_s.data_ptr(), w_s.data_ptr(),
                                  out.data_ptr(), work.data_ptr(), M, K, N,
                                  P, g, *co, const, epi, stream)
                        assert code == 0, code
                    call()
                    exp = want if epi == 0 else ref.dequant_epilogue(
                        want, a_s, w_s, out_dtype)
                    bits = torch.int32 if epi == 0 else torch.int16
                    assert torch.equal(out.view(bits), exp.view(bits)), (
                        name, group, K, N, out_dtype)
                    add(f"{name} {out_dtype}".replace("torch.", ""), group,
                        _time(call, reps, flush))
                assert not work.any(), "the K-split workspace was not left zero"
            p32 = planes.view(torch.int32)
            add("torch.sum of the plane bytes", group, _time(
                lambda: torch.sum(p32, dtype=torch.int32), reps, flush))
            if group.startswith("qwen2-7b target"):
                codes = torch.randint(0, 16, (M, K), generator=gen,
                                      device=dev, dtype=torch.uint8)
                packed = torch.randint(0, 256, (K // 2, N), generator=gen,
                                       device=dev, dtype=torch.uint8)
                add("lutmul (LUT kernel, the same bytes)", group, _time(
                    lambda: kernel.lutmul(codes, packed), reps, flush))
                del codes, packed
            del a, planes, want
    for name, r in res.items():
        print(name + ": " + "; ".join(
            f"{grp} {sum(v):.4f} ms [{' '.join(f'{x:.4f}' for x in v)}]"
            for grp, v in r.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
