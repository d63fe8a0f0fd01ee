#!/usr/bin/env python3
"""Time tile variants of ``csrc/int_matmul.cu`` at the served heads (one GPU).

    python3 scripts/int_matmul_tiles.py                   # the source's tiles
    python3 scripts/int_matmul_tiles.py '{"v1": ["Tile<...>", "Tile<...>"]}'

Each variant names the ``Decode`` (M <= 8) and ``Wide`` tile types, as
``Tile<TM, WARPS, BK, STAGES, MINB>`` (their meaning is in the source).
The script compiles one copy of the source per variant (``nvcc`` in
parallel, the flags of ``kernels/build.py``), holds every variant's int32
and bf16 outputs against the plain versions, and times both as
``chip_smoke.py`` does (median of CUDA events, L2 flushed before each
launch) at chip_smoke's three head groups: qwen2-7b at M = 8 and at the
verify's M = 32, bitnet-3b at M = 8.  Beside them ``torch._int_mm`` on the
same codes (rows zero-padded to 32 where M < 32) and ``torch.sum`` over the
same weight bytes: a read of those bytes by PyTorch under the same flush.
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
    from chip_smoke import (BITNET_HEAD, QWEN_HEAD, SLOTS, VERIFY_M, _time,
                            smi_line)
    from repro_torch.kernels.lutmul import ref
    from scripts.lutmul_tiles import compile_variants

    if not torch.cuda.is_available():
        print("int_matmul_tiles: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {
        "source": None}
    reps = int(os.environ.get("REPS", "20"))
    print(smi_line(), flush=True)
    libs = {}
    for name, lib in compile_variants(variants, "int_matmul",
                                      ("Decode", "Wide")).items():
        libs[name] = (lib.int_matmul_launch, lib.int_matmul_workspace_words)
        libs[name][0].argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name][1].argtypes = [ctypes.c_int, ctypes.c_int]
        libs[name][1].restype = ctypes.c_longlong
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    groups = {"qwen2-7b head, M=8": (SLOTS, *QWEN_HEAD),
              "qwen2-7b verify head, M=32": (VERIFY_M, *QWEN_HEAD),
              "bitnet-3b head, M=8": (SLOTS, *BITNET_HEAD)}
    res = {}
    for group, (M, K, N) in groups.items():
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        a_s = torch.rand((M, 1), generator=gen, device=dev) + 0.01
        w_s = torch.rand((1, N), generator=gen, device=dev) + 0.01
        want = ref.int_matmul_ref(a, w)
        for name, (fn, words) in libs.items():
            work = torch.zeros(words(M, N), dtype=torch.int32, device=dev)
            for epi, out_dtype in ((0, torch.int32), (1, torch.bfloat16)):
                out = torch.empty((M, N), dtype=out_dtype, device=dev)

                def call(fn=fn, out=out, epi=epi, work=work):
                    code = fn(a.data_ptr(), w.data_ptr(), a_s.data_ptr(),
                              w_s.data_ptr(), out.data_ptr(),
                              work.data_ptr(), M, K, N, epi, stream)
                    assert code == 0, code
                call()
                exp = want if epi == 0 else ref.dequant_epilogue(
                    want, a_s, w_s, out_dtype)
                bits = torch.int32 if epi == 0 else torch.int16
                assert torch.equal(out.view(bits), exp.view(bits)), (
                    name, group, out_dtype)
                res.setdefault(f"{name} {out_dtype}".replace("torch.", ""),
                               {})[group] = _time(call, reps, flush)
            assert not work.any(), "the K-split workspace was not left zero"
        ap = torch.zeros((max(M, 32), K), dtype=torch.int8, device=dev)
        ap[:M] = a
        res.setdefault("torch._int_mm", {})[group] = _time(
            lambda: torch._int_mm(ap, w), reps, flush)
        w32 = w.view(torch.int32)
        res.setdefault("torch.sum of the weight bytes", {})[group] = _time(
            lambda: torch.sum(w32, dtype=torch.int32), reps, flush)
        del a, w, want
    for name, r in res.items():
        print(name + ": " + "; ".join(f"{g} {t:.4f} ms" for g, t in
                                      r.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
