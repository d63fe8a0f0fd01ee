"""Request: the unit of work the continuous-batching scheduler admits (port
of ``repro.serve.request``): the prompt, a decode budget, an optional EOS
id, per-request sampling knobs (``None``: the engine's ServeConfig default)
and an optional streaming callback.

Status moves QUEUED -> RUNNING -> FINISHED; ``finish_reason`` says why
decode stopped ("eos" | "length").  The scheduler can impose three other
terminal statuses:

  * TIMED_OUT — the request's ``deadline`` passed, in the scheduler's
    LOGICAL clock (the ``now=`` values the caller threads through
    ``submit`` / ``step`` / ``run``, never the wall clock, so a run
    replays exactly);
  * SHED — overload shedding picked this request (lowest priority first,
    then least deadline slack, then latest submitted);
  * FAILED — its streaming callback raised, or it was in flight through
    more fault recoveries than the Scheduler's ``max_retries`` (``retries``
    counts them).

``deadline`` is a logical-time instant (the units of ``now``) and
``priority`` a number where HIGHER survives shedding longer; both must be
finite, checked here and again at ``Scheduler.submit``.  The scheduler
stamps ``arrival_time`` at submit and ``finish_time`` when the request
ends (both ``None`` when the caller runs without a clock).
"""
from __future__ import annotations

import dataclasses
import enum
import math
import numbers
from typing import Callable, List, Optional, Sequence


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    TIMED_OUT = "timed_out"
    SHED = "shed"
    FAILED = "failed"


# finish_reason -> terminal status (anything else finishes FINISHED)
_REASON_STATUS = {
    "timed_out": RequestStatus.TIMED_OUT,
    "shed": RequestStatus.SHED,
    "failed": RequestStatus.FAILED,
}

_TERMINAL = frozenset((RequestStatus.FINISHED, RequestStatus.TIMED_OUT,
                       RequestStatus.SHED, RequestStatus.FAILED))


def _real(x) -> bool:
    return isinstance(x, numbers.Real) and not isinstance(x, bool) \
        and math.isfinite(x)


def check_sampling(temperature, top_k, top_p) -> None:
    """Reject sampling knobs that mean nothing (``None`` is skipped): a
    temperature (<= 0 is greedy) and a top_p (>= 1 is no filter) must be
    finite numbers, top_p at least 0, top_k an int >= 0 (0 is no filter)."""
    if temperature is not None and not _real(temperature):
        raise ValueError(f"temperature must be a finite number, got "
                         f"{temperature!r}")
    if top_k is not None and (not isinstance(top_k, numbers.Integral)
                              or isinstance(top_k, bool) or top_k < 0):
        raise ValueError(f"top_k must be an int >= 0, got {top_k!r}")
    if top_p is not None and (not _real(top_p) or top_p < 0):
        raise ValueError(f"top_p must be a finite number >= 0, got "
                         f"{top_p!r}")


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # per-request sampling (defaults to the engine ServeConfig when None)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # streaming: called with (request, token) for every emitted token
    on_token: Optional[Callable[["Request", int], None]] = None
    # QoS: logical-time deadline and shedding priority
    deadline: Optional[float] = None
    priority: int = 0

    # -- scheduler-managed state --------------------------------------------
    status: RequestStatus = RequestStatus.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    slot: Optional[int] = None            # decode slot while RUNNING
    arrival_time: Optional[float] = None  # set by the scheduler on submit
    finish_time: Optional[float] = None
    retries: int = 0                      # fault recoveries survived in flight

    def __post_init__(self):
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if len(self.prompt) < 1:
            raise ValueError("prompt must be non-empty")
        if self.deadline is not None and not math.isfinite(self.deadline):
            raise ValueError(f"deadline must be finite, got {self.deadline}")
        if not math.isfinite(self.priority):
            raise ValueError(f"priority must be finite, got {self.priority}")
        check_sampling(self.temperature, self.top_k, self.top_p)

    @property
    def done(self) -> bool:
        return self.status in _TERMINAL

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    def slack(self, now: Optional[float]) -> float:
        """Logical time to spare before the deadline; +inf without a
        deadline or a clock.  The scheduler preempts the MOST-slack slot
        (it can be requeued and still make its deadline) and sheds the
        LEAST-slack queued request (it was going to miss anyway)."""
        if self.deadline is None or now is None:
            return math.inf
        return self.deadline - now

    def emit(self, token: int) -> None:
        """Record one generated token, then stream it (a raising callback
        propagates to the scheduler, which fails only this request)."""
        self.tokens.append(int(token))
        if self.on_token is not None:
            self.on_token(self, int(token))

    def finish(self, reason: str, now: Optional[float] = None) -> None:
        self.status = _REASON_STATUS.get(reason, RequestStatus.FINISHED)
        self.finish_reason = reason
        self.finish_time = now
        self.slot = None
