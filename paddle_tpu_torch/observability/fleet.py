"""Serving-fleet telemetry of the port (a copy of
paddle_tpu/observability/fleet.py on the port's event sink).

Fed by ``serving/fleet.py`` (the multi-replica router: prefix-
affinity routing, prefill→decode disaggregation handoffs, fleet-level
SLO and replica failover).  Event kinds:

- ``fleet_route``    — one routing decision: the chosen replica, the
  policy that picked it (``affinity`` / ``least_loaded`` /
  ``failover``), the affinity match length in tokens, and how many
  replicas refused before it landed; a ROUTER-EDGE shed (every
  candidate refused, or the fleet deliberately rejected) is the same
  kind with ``action="shed"`` — the rejection happens at the edge, so
  it must be audited at the edge,
- ``fleet_handoff``  — one prefill→decode K/V span handoff: source and
  destination replicas, the span length in tokens, and the number of
  block-copy plan entries that described it,
- ``fleet_failover`` — one replica death recovered: how many in-flight
  requests its journal replayed onto survivors as retries, and how
  many were already terminal (untouched).

Gauges land in StatRegistry prefixed ``fleet_<name>_`` (routed totals,
affinity-routed count, router sheds, handoffs, failovers + replayed
requests, replicas alive).  Same contract as every other feed: gauges
and JSONL events publish only under ``PADDLE_TPU_TELEMETRY=1``; the
fleet keeps its own unconditional counters for ``fleet.metrics()``.
"""
from __future__ import annotations

from . import events

__all__ = ["record_route", "record_router_shed", "record_handoff",
           "record_failover", "set_replicas_alive"]


def _add(name: str, key: str, n: int = 1) -> None:
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register(f"fleet_{name}_{key}").add(n)
    except Exception:  # telemetry must never take down the serve loop
        pass


def _gauge(name: str, key: str, v: int) -> None:
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register(f"fleet_{name}_{key}").set(int(v))
    except Exception:
        pass


def record_route(name: str, *, rid: str, replica: str, policy: str,
                 affinity_tokens: int, fallbacks: int = 0) -> None:
    """One request routed onto a replica (``policy``: what picked it —
    ``affinity`` when a prefix-chain match decided, ``least_loaded``
    for cold prompts, ``failover`` for a dead replica's replay)."""
    if not events.enabled():
        return
    _add(name, "routed_total")
    if policy == "affinity":
        _add(name, "affinity_routed_total")
    events.emit("fleet_route", name=name, rid=str(rid),
                replica=str(replica), policy=str(policy),
                affinity_tokens=int(affinity_tokens),
                fallbacks=int(fallbacks))


def record_router_shed(name: str, *, rid: str, priority: int,
                       reason: str) -> None:
    """The ROUTER refused the request — every candidate replica shed
    or was full, so the rejection is an edge decision, audited as a
    ``fleet_route`` event with ``action="shed"`` (and counted as a
    lane MISS in the fleet attainment ledger by the caller)."""
    if not events.enabled():
        return
    _add(name, "router_sheds_total")
    events.emit("fleet_route", name=name, rid=str(rid), action="shed",
                priority=int(priority), reason=str(reason))


def record_handoff(name: str, *, rid: str, src: str, dst: str,
                   span_tokens: int, plan_entries: int,
                   src_pages=None) -> None:
    if not events.enabled():
        return
    _add(name, "handoffs_total")
    kw = {}
    if src_pages is not None:
        kw["src_pages"] = [int(p) for p in src_pages]
    events.emit("fleet_handoff", name=name, rid=str(rid), src=str(src),
                dst=str(dst), span_tokens=int(span_tokens),
                plan_entries=int(plan_entries), **kw)


def record_failover(name: str, *, replica: str, replayed: int,
                    already_done: int, journal: str | None) -> None:
    if not events.enabled():
        return
    _add(name, "failovers_total")
    _add(name, "failover_replayed_total", int(replayed))
    events.emit("fleet_failover", name=name, replica=str(replica),
                replayed=int(replayed), already_done=int(already_done),
                journal=journal)


def set_replicas_alive(name: str, alive: int) -> None:
    if not events.enabled():
        return
    _gauge(name, "replicas_alive", alive)
