"""Request: the unit of work the continuous-batching scheduler admits (port
of ``repro.serve.request`` without deadlines and priorities): the prompt, a
decode budget, an optional EOS id, per-request sampling knobs (``None``:
the engine's ServeConfig default) and an optional streaming callback.

Status moves QUEUED -> RUNNING -> FINISHED; ``finish_reason`` says why
decode stopped ("eos" | "length").  A streaming callback that raises fails
only its own request (status FAILED, reason "failed"), and so does a
request that was in flight through more fault recoveries than the
Scheduler's ``max_retries`` (``retries`` counts them).
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
    FAILED = "failed"


_TERMINAL = frozenset((RequestStatus.FINISHED, RequestStatus.FAILED))


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

    # -- scheduler-managed state --------------------------------------------
    status: RequestStatus = RequestStatus.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    slot: Optional[int] = None            # decode slot while RUNNING
    retries: int = 0                      # fault recoveries survived in flight

    def __post_init__(self):
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if len(self.prompt) < 1:
            raise ValueError("prompt must be non-empty")
        check_sampling(self.temperature, self.top_k, self.top_p)

    @property
    def done(self) -> bool:
        return self.status in _TERMINAL

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    def emit(self, token: int) -> None:
        """Record one generated token, then stream it (a raising callback
        propagates to the scheduler, which fails only this request)."""
        self.tokens.append(int(token))
        if self.on_token is not None:
            self.on_token(self, int(token))

    def finish(self, reason: str) -> None:
        self.status = (RequestStatus.FAILED if reason == "failed"
                       else RequestStatus.FINISHED)
        self.finish_reason = reason
        self.slot = None
