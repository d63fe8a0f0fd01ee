"""Serving: continuous batching over static-shape decode buffers (port of
``repro.serve``, single-device part: dense or paged KV).

    Request -> Scheduler (FIFO queue, slot map, paged block accounting)
                   -> Engine.step
                   one round = chunk lane of prompt tokens + `chunk` decode
                   tokens for every slot, each a transformer.decode_step
                   whose projections run the LUT / int8 kernels, its
                   tokens drawn on the device (per-slot temperature /
                   top-k / top-p over core.prng's threefry stream)
    PagePool (serve.paged): with ServeConfig(paged=True), the host-side
                   page allocator (prefix reuse, preemption, speculative
                   trim) whose table the round reads on the device
    FaultPlan (serve.faults): seeded NaN / page-table / dispatch / stall
                   faults at the engine's dispatch sites; the guards
                   (finite logits, the in-round cache sweep, the pool
                   audit) raise CacheCorruption, and the Scheduler's
                   rolling snapshots give token-identical replay recovery
    QoS: requests carry a logical-time ``deadline`` and a ``priority``; the
                   Scheduler expires, sheds (``shed_watermark``,
                   ``overload_queue``) and preempts by slack on the
                   caller's ``now=`` clock, and ``Scheduler.save`` /
                   ``load`` carry the serving state across a process
                   restart through ``repro_torch.ckpt.checkpoint``
"""
from repro_torch.serve.engine import Engine, ServeConfig, sample_logits
from repro_torch.serve.faults import (CacheCorruption, EngineFault, Fault,
                                      FaultPlan, InjectedFault)
from repro_torch.serve.paged import PagedLayout, PagePool
from repro_torch.serve.request import Request, RequestStatus
from repro_torch.serve.scheduler import Scheduler


def make_engine(params, cfg, scfg: ServeConfig = ServeConfig(), *,
                device=None) -> Engine:
    """Build the serving engine on ``device`` (default ``cuda``; raises when
    no GPU is present and no device is named).  ``scfg.quant`` quantizes the
    weights to integer codes once, here."""
    return Engine(cfg, params, scfg, device=device)


__all__ = ["Engine", "ServeConfig", "Request", "RequestStatus", "Scheduler",
           "PagedLayout", "PagePool", "make_engine", "sample_logits",
           "FaultPlan", "Fault", "EngineFault", "InjectedFault",
           "CacheCorruption"]
