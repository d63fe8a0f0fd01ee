"""Request: the unit of work the continuous-batching scheduler admits (port
of ``repro.serve.request`` without deadlines, priorities, retries and
per-request sampling: the port decodes greedily).

Status moves QUEUED -> RUNNING -> FINISHED; ``finish_reason`` says why
decode stopped ("eos" | "length").  A streaming callback that raises fails
only its own request (status FAILED, reason "failed").
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Sequence


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"


_TERMINAL = frozenset((RequestStatus.FINISHED, RequestStatus.FAILED))


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # streaming: called with (request, token) for every emitted token
    on_token: Optional[Callable[["Request", int], None]] = None

    # -- scheduler-managed state --------------------------------------------
    status: RequestStatus = RequestStatus.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    slot: Optional[int] = None            # decode slot while RUNNING

    def __post_init__(self):
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if len(self.prompt) < 1:
            raise ValueError("prompt must be non-empty")

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
