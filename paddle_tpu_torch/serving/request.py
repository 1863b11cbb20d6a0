"""Request model for the continuous-batching serving engine (host-only
copy of paddle_tpu/serving/request.py).

One request = one prompt + a generation budget + scheduling hints
(priority, deadline). The engine owns the lifecycle:

    QUEUED ──admission──> PREFILLING ──final chunk──> DECODING ──> DONE
      │        ^                                       (eos / budget /
      │        └── retry/requeue (keeps generated ──────┤ cache full)
      │            tokens; budget left)                 │
      │                                   retry budget exhausted
      │                                                 v
      ├── deadline passed before prefill ──> EXPIRED  FAILED
      ├── bounded queue full / SLO shed at submit ──> REJECTED
      └── engine closed without drain ──> CANCELLED

EXPIRED is deliberately checked at the *admission* edge: a request
whose deadline already passed is dropped before any prefill compute is
spent on it. Once prefill starts the engine finishes the request —
partially-prefilled cache rows are paid for, abandoning them mid-decode
saves nothing — UNLESS the resilience layer evicts it (stall shed,
chaos poison, engine crash): then it re-enters the queue carrying its
generated-so-far tokens (``resume_tokens``) and resumes by
re-prefilling prompt+generated — bit-identical for greedy decoding —
under a bounded per-request retry budget; an exhausted budget is the
loud terminal FAILED, never a hang.
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
    # retry budget exhausted (a poisoned/repeatedly-evicted request) —
    # loudly terminal, the partial output rides along for inspection
    FAILED = "failed"


_REQ_SEQ = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request.

    ``priority``: lower = more urgent (0 is the default lane).
    ``deadline``: absolute clock stamp (engine clock, default
    ``time.perf_counter``) by which admission must START; ``None`` =
    no deadline. ``seq`` is the global FIFO tiebreak."""
    tokens: np.ndarray
    max_new_tokens: int
    priority: int = 0
    deadline: float | None = None
    request_id: str | None = None
    # stochastic sampling lane (spec_sample sessions): 0.0 = greedy.
    # ``seed`` is the request's ENTIRE sampling state — every draw
    # re-derives from (seed, absolute position, lane), no host RNG —
    # so journaling (temperature, seed) makes requeue/crash-replay/
    # failover reproduce sampled continuations bit-identically.
    # None picks a deterministic per-request default (the seq number).
    temperature: float = 0.0
    seed: int | None = None
    # filled by the engine
    seq: int = dataclasses.field(default_factory=lambda: next(_REQ_SEQ))
    state: RequestState = RequestState.QUEUED
    arrival_ts: float = 0.0
    # always a time.perf_counter() stamp, even when the engine runs on
    # an injected clock: ServingMetrics measures TTFT in the
    # perf_counter domain, so the arrival fed into it must match
    arrival_perf: float = 0.0
    admitted_ts: float | None = None
    first_token_ts: float | None = None
    finished_ts: float | None = None
    slot: int | None = None
    prefix_hit_tokens: int = 0
    output: list[int] = dataclasses.field(default_factory=list)
    # resilience bookkeeping (engine/ResiliencePolicy-owned)
    retries: int = 0                 # requeues consumed so far
    not_before: float = 0.0          # backoff: earliest re-admission
    # tokens of ``output`` that predate the CURRENT admission (resumed
    # via requeue/crash replay): they were re-prefilled, not decoded,
    # so the session's evict() record excludes them
    resumed_len: int = 0
    # when THIS queuing episode started (submit or requeue release) —
    # the stamp SLO queue-wait windows measure against; arrival_ts
    # keeps the original submit time across retries
    enqueued_ts: float = 0.0
    clamped_from: int | None = None  # brownout budget clamp provenance
    shed_reason: str | None = None   # why the shedder rejected it
    poisoned: bool = False           # chaos poison_request marked it
    # distributed-tracing context (observability/tracing.py): the trace
    # this request's lineage belongs to, and the span id the NEXT
    # incarnation/child span parents to.  Rides the crash journal and
    # KVHandoff so retry, prefill→decode handoff and journal replay
    # stay ONE connected trace.  None whenever tracing is disarmed.
    trace_id: str | None = None
    trace_parent: str | None = None
    # tenant identity for per-tenant metering (observability/metering):
    # an opaque caller-chosen string (client group, API key hash, LoRA
    # adapter id ...).  It rides the crash journal and KVHandoff so
    # retry/failover keep the attribution; None = untagged, metered
    # into the meter's untagged bucket.
    tenant: str | None = None

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
        if self.tenant is not None:
            self.tenant = str(self.tenant)
        if self.request_id is None:
            self.request_id = f"req{self.seq}"

    # earliest-deadline-first within a priority lane, FIFO tiebreak
    def sched_key(self) -> tuple:
        return (self.priority,
                self.deadline if self.deadline is not None else math.inf,
                self.seq)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    def resume_tokens(self) -> np.ndarray:
        """The tokens a (re-)admission must make cache-resident: the
        prompt plus everything already generated.  Re-prefilling this
        reproduces the evicted slot's K/V exactly (prefill and decode
        write the same bits for the same positions), so a resumed
        greedy request continues bit-identically to never having been
        evicted."""
        if not self.output:
            return self.tokens
        return np.concatenate(
            [self.tokens, np.asarray(self.output, np.int32)])

    @property
    def ttft_s(self) -> float | None:
        """Submit-to-first-token latency (queue wait + prefill + first
        decode tick), None until the first token lands."""
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.arrival_ts

    def finished(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.REJECTED,
                              RequestState.EXPIRED,
                              RequestState.CANCELLED, RequestState.FAILED)
