"""Fault-tolerant training runner (port of ``repro.train.loop``):
checkpoint/restart supervision, failure injection, straggler monitoring,
and the periodic evaluation of the deployed (integer-code) model.

``run()`` is the supervisor: it (re)builds state from the latest committed
checkpoint (``ckpt.checkpoint``), executes steps, saves asynchronously
every ``ckpt_every``, and on an injected ``SimulatedFailure`` restarts from
the last committed checkpoint.  A step is timed with CUDA events on the
card (:class:`StepTimer`), not with the host clock around an asynchronous
launch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.core.tree import flatten, tree_map
from repro_torch.data import pipeline
from repro_torch.dist.straggler import StragglerMonitor
from repro_torch.train.step import (TrainConfig, init_state, loss_for,
                                    make_train_step, to_device)


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class RunConfig:
    steps: int = 20
    ckpt_every: int = 5
    ckpt_dir: str = "/tmp/repro_ckpt"
    async_ckpt: bool = True
    fail_at_step: Optional[int] = None     # inject exactly one failure
    max_restarts: int = 3
    log_every: int = 1
    # QAT eval: periodically evaluate the *deployed* (integer-code) model
    eval_every: int = 0                    # 0 disables
    eval_batches: int = 2
    eval_quant: str = "w4a4_mxu"


class StepTimer:
    """Spans of a step on ``device``: CUDA events on the card, the host
    clock on the CPU.  ``start()``, then ``mark(name)`` at each boundary
    (``make_train_step``'s ``mark``); ``seconds()`` waits for the last
    mark and returns {name: seconds since the previous mark} and
    ``"total"``."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [("start", self._now())]

    def mark(self, name: str) -> None:
        self.marks.append((name, self._now()))

    def seconds(self) -> dict:
        if self.cuda:
            self.marks[-1][1].synchronize()

            def span(a, b):
                return a.elapsed_time(b) / 1e3
        else:
            def span(a, b):
                return b - a
        out = {name: span(prev, t) for (_, prev), (name, t)
               in zip(self.marks, self.marks[1:])}
        out["total"] = span(self.marks[0][1], self.marks[-1][1])
        return out


def make_eval_fn(model_cfg, eval_quant: str = "w4a4_mxu"):
    """QAT eval through the weight-code cache.

    Evaluating the deployed model means running the integer-code path the
    serving engine runs.  Weights are quantized + packed ONCE per evaluation
    (``models.layers.QuantizedLinear`` under ``serve.quantize``); every eval
    batch then reads the cached codes through ``ops.prequant_matmul`` —
    zero weight-quantization events per batch, which tests assert via
    ``kernels.lutmul.ops.WEIGHT_QUANT_COUNT``.
    """
    from repro_torch.serve.quantize import quantize_params_for_serving
    ecfg = dataclasses.replace(model_cfg, quant=eval_quant)
    eval_loss = loss_for(ecfg)

    def evaluate(params, batches) -> float:
        dev = flatten(params)[1][0].device
        with torch.no_grad():
            coded = quantize_params_for_serving(params, mode=eval_quant)
            losses = [float(eval_loss(coded, to_device(b, dev)))
                      for b in batches]
        return sum(losses) / len(losses)

    return evaluate


def _batch(dcfg: pipeline.DataConfig, step: int, batch_kind: str) -> dict:
    return pipeline.lm_batch(dcfg, step) if batch_kind == "lm" \
        else pipeline.image_batch(dcfg, step)


def run(model_cfg, init_params_fn: Callable, dcfg: pipeline.DataConfig,
        tcfg: TrainConfig = TrainConfig(), rcfg: RunConfig = RunConfig(),
        batch_kind: str = "lm") -> dict:
    """Returns {"history": [metrics...], "restarts": n, "straggler":
    report}.  ``init_params_fn()`` makes fresh parameters on the device to
    train on; the loop owns them (its steps update them in place)."""
    step_fn = make_train_step(model_cfg, tcfg, donate=True)
    eval_fn = make_eval_fn(model_cfg, rcfg.eval_quant) if rcfg.eval_every \
        else None
    monitor = StragglerMonitor()
    history: list[dict] = []
    restarts = 0
    failed_once = False

    def fresh_state():
        return init_state(init_params_fn(), bf16_params=tcfg.bf16_params)

    def restored(state):
        host, extra = checkpoint.restore(rcfg.ckpt_dir, state)
        return tree_map(lambda h, t: h.to(t.device, copy=True), host,
                        state), extra

    state = fresh_state()
    device = flatten(state["params"])[1][0].device
    start = checkpoint.latest_step(rcfg.ckpt_dir)
    if start is not None:
        state, extra = restored(state)
        step0 = extra.get("next_step", start)
    else:
        step0 = 0

    pending_save = None
    step = step0
    while step < rcfg.steps:
        try:
            batch = _batch(dcfg, step, batch_kind)
            if rcfg.fail_at_step is not None and step == rcfg.fail_at_step \
                    and not failed_once:
                failed_once = True
                raise SimulatedFailure(f"injected failure at step {step}")
            timer = StepTimer(device)
            timer.start()
            state, metrics = step_fn(state, batch, mark=timer.mark)
            spans = timer.seconds()
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = spans["total"]
            monitor.record("host0", dt)
            metrics.update(step=step, wall_s=dt, grads_s=spans["grads"],
                           update_s=spans["update"])
            if eval_fn is not None and (step + 1) % rcfg.eval_every == 0:
                # eval batches come from a disjoint step range (held-out
                # shards of the synthetic stream)
                ebatches = [_batch(dcfg, 10 ** 6 + i, batch_kind)
                            for i in range(rcfg.eval_batches)]
                metrics["eval_loss"] = eval_fn(state["params"], ebatches)
            history.append(metrics)
            step += 1
            if step % rcfg.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = checkpoint.save(
                    rcfg.ckpt_dir, step, state, extra={"next_step": step},
                    async_save=rcfg.async_ckpt)
        except SimulatedFailure:
            restarts += 1
            if restarts > rcfg.max_restarts:
                raise
            if pending_save is not None:
                pending_save.join()
                pending_save = None
            last = checkpoint.latest_step(rcfg.ckpt_dir)
            if last is not None:
                state, extra = restored(state)
                step = extra.get("next_step", last)
            else:
                state = fresh_state()
                step = 0
    if pending_save is not None:
        pending_save.join()
    return {"history": history, "restarts": restarts,
            "straggler": monitor.evaluate()}
