"""Serving-resilience telemetry of the port (a copy of
paddle_tpu/observability/resilience.py on the port's event sink).

Fed by ``serving/resilience.py`` (the SLO shedder, the
brownout ladder, the retry/requeue path and the crash-recovery request
journal).  Event kinds:

- ``serving_shed``    — the admission shedder acted: one event per shed
  request (``rid``, lane, reason) plus enter/exit transition events
  when a lane SLO breach arms/disarms shedding (``phase`` field),
- ``serving_brownout`` — one degradation-ladder transition: the level,
  the step name, and the direction (``enter``/``exit``) — every step
  is individually reversible and every transition is auditable,
- ``serving_retry``   — an in-flight request was evicted and requeued
  with its generated-so-far tokens (``action="requeue"``), or its
  retry budget exhausted into the terminal FAILED state
  (``action="failed"``),
- ``serving_journal_replay`` — a post-crash engine re-admitted the
  journaled in-flight requests.

Gauges land in StatRegistry prefixed ``resil_<name>_`` (shed totals,
shed-active flag, brownout level, SLO breach count, retries/failures,
journal replays).  Same contract as every other feed: gauges and JSONL
events publish only under ``PADDLE_TPU_TELEMETRY=1``; the resilience
policy keeps its own unconditional counters for ``engine.metrics()``.
"""
from __future__ import annotations

from . import events

__all__ = ["record_shed", "record_shed_state", "record_brownout",
           "record_retry", "record_journal_replay"]


def _gauges(name: str, **vals) -> None:
    try:
        from ..framework.monitor import stat_registry
        for key, v in vals.items():
            kind = "float" if isinstance(v, float) else "int64"
            stat_registry.register(f"resil_{name}_{key}", kind).set(v)
    except Exception:  # telemetry must never take down the serve loop
        pass


def _add(name: str, key: str, n: int = 1) -> None:
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register(f"resil_{name}_{key}").add(n)
    except Exception:
        pass


def record_shed(name: str, *, rid: str, priority: int,
                reason: str) -> None:
    """One request rejected at the admission edge by the shedder /
    brownout priority gate — loud by construction (the submit raised),
    audited here."""
    if not events.enabled():
        return
    _add(name, "shed_total")
    events.emit("serving_shed", name=name, rid=str(rid),
                priority=int(priority), reason=str(reason))


def record_shed_state(name: str, *, active: bool, lane: int,
                      metric: str | None = None,
                      p99_ms: float | None = None,
                      target_ms: float | None = None) -> None:
    """The shedder armed (a lane SLO breached) or disarmed (hysteresis
    recovery) — the transition, not the per-request sheds."""
    if not events.enabled():
        return
    _gauges(name, shed_active=int(active))
    if active:
        _add(name, "slo_breaches_total")
    events.emit("serving_shed", name=name,
                phase="enter" if active else "exit", lane=int(lane),
                metric=metric, p99_ms=p99_ms, target_ms=target_ms)


def record_brownout(name: str, *, level: int, step: str,
                    direction: str) -> None:
    if not events.enabled():
        return
    _gauges(name, brownout_level=int(level))
    events.emit("serving_brownout", name=name, level=int(level),
                step=str(step), direction=str(direction))


def record_retry(name: str, *, rid: str, attempt: int, reason: str,
                 action: str, kept_tokens: int = 0) -> None:
    """One pass through the requeue path: ``action="requeue"`` (the
    request re-entered the queue with ``kept_tokens`` generated tokens
    preserved) or ``action="failed"`` (budget exhausted — terminal)."""
    if not events.enabled():
        return
    _add(name, "retries_total" if action == "requeue"
         else "retry_failed_total")
    events.emit("serving_retry", name=name, rid=str(rid),
                attempt=int(attempt), reason=str(reason),
                action=str(action), kept_tokens=int(kept_tokens))


def record_journal_replay(name: str, *, path: str, scanned: int,
                          replayed: int, already_done: int) -> None:
    if not events.enabled():
        return
    _add(name, "journal_replays_total")
    _gauges(name, journal_replayed=int(replayed))
    events.emit("serving_journal_replay", name=name, path=str(path),
                scanned=int(scanned), replayed=int(replayed),
                already_done=int(already_done))
