"""Request model for the continuous-batching serving engine (host-only
copy of paddle_tpu/serving/request.py, trimmed to what the port's
engine uses: no retry, tracing or tenant fields).

    QUEUED ──admission──> PREFILLING ──final chunk──> DECODING ──> DONE
      ├── deadline passed before prefill ──> EXPIRED
      ├── bounded queue full at submit ──> REJECTED
      └── engine closed without drain ──> CANCELLED

EXPIRED is checked at the admission edge: a request whose deadline
passed is dropped before any prefill compute is spent on it.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import math

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"
    REJECTED = "rejected"
    EXPIRED = "expired"
    CANCELLED = "cancelled"


_REQ_SEQ = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request. ``priority``: lower = more urgent.
    ``deadline``: engine-clock stamp by which admission must START
    (None = none). ``seq`` is the global FIFO tiebreak."""
    tokens: np.ndarray
    max_new_tokens: int
    priority: int = 0
    deadline: float | None = None
    request_id: str | None = None
    # the stochastic sampling lane (spec_sample sessions): 0.0 = greedy.
    # The seed is the request's whole sampling state (every draw derives
    # from (seed, absolute position, lane)); None picks the seq number
    temperature: float = 0.0
    seed: int | None = None
    # filled by the engine
    seq: int = dataclasses.field(default_factory=lambda: next(_REQ_SEQ))
    state: RequestState = RequestState.QUEUED
    arrival_ts: float = 0.0
    # always a time.perf_counter() stamp (the domain TTFT is measured
    # in), even when the engine runs on an injected clock
    arrival_perf: float = 0.0
    admitted_ts: float | None = None
    first_token_ts: float | None = None
    finished_ts: float | None = None
    slot: int | None = None
    output: list[int] = dataclasses.field(default_factory=list)
    # prompt positions served from the prefix pool instead of prefill
    prefix_hit_tokens: int = 0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.shape[0] < 1:
            raise ValueError("request needs at least one prompt token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.seed is None:
            self.seed = self.seq
        if self.request_id is None:
            self.request_id = f"req{self.seq}"

    def sched_key(self) -> tuple:
        """Earliest-deadline-first within a priority lane, FIFO tiebreak."""
        return (self.priority,
                self.deadline if self.deadline is not None else math.inf,
                self.seq)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    def finished(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.REJECTED,
                              RequestState.EXPIRED, RequestState.CANCELLED)
