"""Time full-batch decode steps of qwen2-7b in w4a4_lut on one GPU.

    PYTHONPATH=src python -m repro_torch.serve.bench [--layers 28]
        [--steps 32] [--rounds 5] [--graphs]

Builds the model at full width from seed-0 random weights, quantizes it at
load through ``make_engine``, and times ``rounds`` rounds of ``steps``
``decode_step`` calls on the 8-slot batch, the unit that ``chip_smoke.py``
reports as ms per decode step.  Each round is timed on the host clock
between two device synchronizations, and by the process's CPU time (which
other tenants of a shared host disturb less).  Prints one JSON line: ms
per step of every round, their medians, and the kernel launches per step.
Two versions of the kernels are compared by running this in each version's
checkout within one session on the same card, interleaved.

``--graphs`` also times ``rounds`` decode rounds of ``steps`` iterations
through ``Engine.step``: each replayed from its captured CUDA graph, beside
the same round run op by op (``_eager``), interleaved; the capture's
seconds (warm-up included) are reported apart.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=28)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--label", default="")
    p.add_argument("--graphs", action="store_true",
                   help="also time replayed and eager decode rounds")
    args = p.parse_args()

    import torch
    from repro_torch.configs import qwen2_7b
    from repro_torch.kernels.lutmul import kernel, ops
    from repro_torch.models import transformer
    from repro_torch.serve import ServeConfig, make_engine

    cfg = dataclasses.replace(qwen2_7b.config(quant="w4a4_lut"),
                              n_layers=args.layers)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    engine = make_engine(params, cfg,
                         ServeConfig(quant="w4a4_lut", max_len=256))
    del params
    torch.cuda.empty_cache()
    ops.set_backend("cuda")
    slots = 8
    cache = engine.init_cache(slots)
    tok = torch.zeros((slots,), dtype=torch.int32, device="cuda")
    pos = torch.arange(slots, dtype=torch.int32, device="cuda") + 16
    for _ in range(4):                                   # warm
        _, cache = engine._decode(tok, cache, pos)
    torch.cuda.synchronize()
    kernel.reset_launches()
    rounds, cpu = [], []
    for _ in range(args.rounds):
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(args.steps):
            _, cache = engine._decode(tok, cache, pos)
        torch.cuda.synchronize()
        rounds.append(1e3 * (time.perf_counter() - t0) / args.steps)
        cpu.append(1e3 * (time.process_time() - c0) / args.steps)
    n = args.rounds * args.steps
    out = {
        "label": args.label, "layers": cfg.n_layers, "slots": slots,
        "ms_per_step": sorted(rounds)[len(rounds) // 2],
        "cpu_ms_per_step": sorted(cpu)[len(cpu) // 2],
        "rounds_ms_per_step": rounds,
        "launches_per_step": {k: v / n for k, v in kernel.LAUNCHES.items()},
        "device": torch.cuda.get_device_name(0)}
    if args.graphs:
        done = torch.zeros((slots,), dtype=torch.bool, device="cuda")
        eos = torch.full((slots,), -1, dtype=torch.int32, device="cuda")

        def decode_round(eager: bool) -> float:
            t0 = time.perf_counter()
            engine.step(cache, None, tok, pos, done, eos, args.steps,
                        _eager=eager)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / args.steps

        decode_round(False)                               # capture
        times = {True: [], False: []}
        for _ in range(args.rounds):
            for eager in (False, True):
                times[eager].append(decode_round(eager))
        out.update({
            "replay_ms_per_step": sorted(times[False])[args.rounds // 2],
            "eager_round_ms_per_step": sorted(times[True])[args.rounds // 2],
            "rounds_replay_ms_per_step": times[False],
            "rounds_eager_ms_per_step": times[True],
            "capture_s": engine.graphs.capture_s})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
