"""Request-scoped distributed tracing across the serving fleet, plus the
crash flight recorder: a copy of paddle_tpu/observability/tracing.py on
the port's event sink.

The telemetry feeds answer "what is the system doing in aggregate";
since the fleet/resilience layers landed, a single request's life
crosses queue lanes, chunked prefill, prefix-cache hits, spec-decode
windows, fleet routing, a prefill→decode K/V handoff, stall-evict /
retry incarnations and journal replay after a crash — and nothing in
the aggregate feeds can reconstruct that path or say where a slow
request's TTFT went.  This module is the Dapper-style answer:

- every :class:`~paddle_tpu_torch.serving.Request` gets a **trace id** at
  submit; each admission episode ("incarnation") opens a ``request``
  root span with host-side child phases — ``queue`` (submit/requeue →
  admission), ``prefill`` (admission → last chunk), ``decode``
  (activation → terminal, with the first-token stamp riding as an
  attr).  Retry, handoff and failover open the NEXT incarnation's root
  with an explicit **parent link** to the previous one (or to the
  ``handoff``/``failover`` span that moved it), so a request's spans
  stay ONE connected trace across replica boundaries and crash
  incarnations.  The context rides ``Request`` (``trace_id`` /
  ``trace_parent``), :class:`~paddle_tpu_torch.serving.fleet.KVHandoff`, and
  the crash journal's submit/retry records — ``replay_journal`` and
  fleet failover therefore resume the SAME trace.
- phase transitions share one clock stamp (the span that closes and
  the span that opens use the same ``perf_counter`` read), so a
  request's TTFT decomposes EXACTLY into time-in-phase — the invariant
  ``tools/trace_report.py`` checks per request.

Two sinks:

1. **chrome-trace plane** — finished (and still-open) spans export via
   :func:`export_chrome` as per-track ``X`` slices; a parent link that
   crosses tracks (the handoff seam, a failover) additionally renders
   as a chrome flow arrow (``s``/``f`` events) between the replica
   tracks.
2. **flight recorder** — a bounded in-memory ring of the most recent
   spans + telemetry events that dumps atomically (tmp + rename) on
   engine ``abandon``, retry-budget exhaustion, or an unhandled poll
   exception — postmortems get the last N records without paying
   always-on fsync.

OFF is the default and must cost ~nothing: every hook opens with one
enabled() check (a dict lookup) and allocates nothing. Tracing is
host-side only: spans read host clocks, never the device, so a captured
tick graph is the same either way and no hook adds a device sync. Arm
with ``PADDLE_TPU_TRACING=1`` or :func:`set_enabled`.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

from . import events

__all__ = ["enabled", "set_enabled", "reset", "records", "live_count",
           "ctx_of", "export_chrome", "flight_dump", "flight_records",
           "on_submit", "on_resume", "on_admit", "on_decoding",
           "on_first_token", "on_finish", "on_requeue", "on_route",
           "on_handoff", "end_seam", "on_failover", "on_track_crash",
           "poll_begin", "on_poll", "on_session_span", "on_session_mark",
           "mark"]

_lock = threading.Lock()
_override: bool | None = None
_ids = itertools.count(1)

# finished AND open span records, bounded like the profiler's host-event
# deque (a week-long armed server must not grow without bound; beyond
# ~10^5 spans chrome cannot render the trace anyway).  Records are
# dicts appended at OPEN and mutated in place at close, so a crashed
# incarnation's never-closed root still exports (t1 == None) and its
# children never dangle.
_SPAN_CAP = int(os.environ.get("PADDLE_TPU_TRACE_MAX_SPANS", "200000"))
_spans: deque = deque(maxlen=_SPAN_CAP)
# trace_id -> {"root": rec, "phase": rec | None} for in-flight requests
_live: dict = {}

# ------------------------------------------------------------ recorder
# the flight recorder ring: most recent N closed spans / marks / tapped
# telemetry events — small, always cheap, dumped only on faults
_RING_CAP = int(os.environ.get("PADDLE_TPU_FLIGHT_RING", "2048"))
_ring: deque = deque(maxlen=_RING_CAP)
_dump_seq = itertools.count(1)
_tap_installed = False


def enabled() -> bool:
    """ONE flag: ``PADDLE_TPU_TRACING=1`` (or a programmatic
    :func:`set_enabled` override, used by tests and child processes)."""
    if _override is not None:
        return _override
    return os.environ.get("PADDLE_TPU_TRACING", "0") == "1"


def set_enabled(flag: bool | None) -> None:
    """Force tracing on/off in-process; ``None`` defers to the env.
    Arming also tees telemetry JSONL events into the flight ring."""
    global _override
    _override = flag
    if flag:
        _install_tap()


def _install_tap() -> None:
    global _tap_installed
    if _tap_installed:
        return
    _tap_installed = True
    events.add_tap(_flight_tap)


def _flight_tap(rec: dict) -> None:
    """Telemetry events ride the ring next to spans, so a flight dump
    shows cause (chaos_inject, serving_shed) beside effect (spans)."""
    if not enabled():
        return
    with _lock:
        _ring.append({"ev": True, **rec})


# arm-at-import for env-flag users (set_enabled covers the rest)
if os.environ.get("PADDLE_TPU_TRACING", "0") == "1":
    _install_tap()


def reset() -> None:
    """Drop every span, live trace and ring record (tests and child
    processes isolating rounds)."""
    with _lock:
        _spans.clear()
        _live.clear()
        _ring.clear()


def records() -> list[dict]:
    """Snapshot of the span store (open spans included, ``t1 None``)."""
    with _lock:
        return [dict(r) for r in _spans]


def live_count() -> int:
    with _lock:
        return len(_live)


def flight_records() -> list[dict]:
    with _lock:
        return [dict(r) for r in _ring]


# ------------------------------------------------------------ internals
def _sid() -> str:
    return f"{os.getpid():x}-{next(_ids)}"


def _open(name: str, track: str, *, tr=None, par=None, t0=None,
          **attrs) -> dict:
    # lazy tap install covers env-var arming AFTER import (only span
    # creation reaches here, so the disarmed path never pays the check)
    if not _tap_installed:
        _install_tap()
    rec = {"sid": _sid(), "tr": tr, "par": par, "name": name,
           "track": str(track), "t0": time.perf_counter()
           if t0 is None else t0, "t1": None}
    if attrs:
        rec.update(attrs)
    with _lock:
        _spans.append(rec)
    return rec


def _close(rec: dict, t1=None, **attrs) -> None:
    if rec is None or rec["t1"] is not None:
        return
    rec["t1"] = time.perf_counter() if t1 is None else t1
    if attrs:
        rec.update(attrs)
    with _lock:
        _ring.append(dict(rec))


def mark(name: str, track: str, *, tr=None, par=None, **attrs) -> None:
    """Zero-duration record (a point event on the timeline)."""
    if not enabled():
        return
    now = time.perf_counter()
    rec = _open(name, track, tr=tr, par=par, t0=now, **attrs)
    _close(rec, t1=now)


def ctx_of(req) -> tuple | None:
    """The (trace_id, parent_span_id) context a handoff / journal
    record carries for this request — ``None`` when the request was
    never traced (tracing disarmed at its submit)."""
    tid = getattr(req, "trace_id", None)
    if tid is None:
        return None
    return (tid, getattr(req, "trace_parent", None))


# ------------------------------------------------- request lifecycle
def _begin_incarnation(track: str, req, kind: str, **attrs) -> None:
    """Open one admission episode: a ``request`` root (parented to the
    previous incarnation's root — or to the handoff/failover span that
    moved the request here) plus its ``queue`` phase, sharing one clock
    stamp.  Updates ``req.trace_parent`` to the NEW root so later
    context captures (journal, handoff) link children to it."""
    if req.trace_id is None:
        req.trace_id = f"tr-{os.getpid():x}-{next(_ids)}"
    now = time.perf_counter()
    root = _open("request", track, tr=req.trace_id,
                 par=req.trace_parent, t0=now, rid=req.request_id,
                 kind=kind, **attrs)
    req.trace_parent = root["sid"]
    phase = _open("queue", track, tr=req.trace_id, par=root["sid"],
                  t0=now, rid=req.request_id)
    with _lock:
        _live[req.trace_id] = {"root": root, "phase": phase}


def on_submit(track: str, req) -> None:
    """A fresh request entered the engine queue: start its trace."""
    if not enabled():
        return
    _begin_incarnation(track, req, "submit", prio=req.priority)


def on_resume(track: str, req, ctx=None, kind: str = "resume") -> None:
    """A re-admission (handoff target, crash-journal replay, fleet
    failover): continue the SAME trace.  ``ctx`` is the
    ``(trace_id, parent_span_id)`` the seam carried — ``None`` keeps
    whatever the request already holds (or starts fresh)."""
    if not enabled():
        return
    if ctx is not None:
        req.trace_id, req.trace_parent = ctx[0], ctx[1]
    _begin_incarnation(track, req, kind, retries=req.retries,
                       resumed_tokens=len(req.output))


def _transition(req, name: str, track: str, **attrs):
    """Close the current phase and open the next at ONE clock stamp —
    zero inter-phase gap is what makes the TTFT decomposition exact."""
    st = _live.get(req.trace_id) if req.trace_id is not None else None
    if st is None:
        return None
    now = time.perf_counter()
    _close(st["phase"], t1=now)
    st["phase"] = _open(name, track, tr=req.trace_id,
                        par=st["root"]["sid"], t0=now,
                        rid=req.request_id, **attrs)
    return st["phase"]


def on_admit(track: str, req, prefix_hit: int = 0) -> None:
    """Admission edge: the queue phase ends, prefill begins (with the
    prefix-cache hit length — reused tokens skip their compute)."""
    if not enabled():
        return
    _transition(req, "prefill", track, prefix_hit=int(prefix_hit))
    if prefix_hit:
        mark("prefix_hit", track, tr=req.trace_id,
             par=req.trace_parent, rid=req.request_id,
             tokens=int(prefix_hit))


def on_decoding(track: str, req) -> None:
    """Last prefill chunk finalized: the row is live, decode begins."""
    if not enabled():
        return
    _transition(req, "decode", track)


def on_first_token(track: str, req) -> None:
    """First token landed — stamped as an attr on the open decode span
    (the decomposition boundary trace_report integrates up to)."""
    if not enabled():
        return
    st = _live.get(req.trace_id) if req.trace_id is not None else None
    if st is None or st["phase"] is None:
        return
    st["phase"]["t_first"] = time.perf_counter()


def on_finish(track: str, req, state: str) -> None:
    """Terminal edge (done/expired/failed/cancelled/rejected — or a
    handoff-side DONE): close the open phase and the incarnation root.
    Idempotent: a trace no longer live is left alone."""
    if not enabled():
        return
    st = _live.pop(req.trace_id, None) if req.trace_id is not None \
        else None
    if st is None:
        return
    now = time.perf_counter()
    _close(st["phase"], t1=now)
    _close(st["root"], t1=now, state=str(state),
           tokens=len(getattr(req, "output", ()) or ()))


def on_requeue(track: str, req, reason: str, attempt: int) -> None:
    """Retry/requeue: the current incarnation ends (state ``evicted``)
    and the retry incarnation opens at the SAME stamp, parented to the
    evicted root — the link the retry-propagation tests assert."""
    if not enabled():
        return
    st = _live.pop(req.trace_id, None) if req.trace_id is not None \
        else None
    now = time.perf_counter()
    if st is not None:
        _close(st["phase"], t1=now)
        _close(st["root"], t1=now, state="evicted", reason=str(reason))
        req.trace_parent = st["root"]["sid"]
    _begin_incarnation(track, req, "retry", attempt=int(attempt),
                       reason=str(reason))


# ------------------------------------------------------ fleet seams
def on_route(track: str, req, *, replica: str, policy: str,
             affinity: int, fallbacks: int) -> None:
    """One router decision, as a point event inside the trace."""
    if not enabled():
        return
    mark("route", track, tr=req.trace_id, par=req.trace_parent,
         rid=req.request_id, replica=str(replica), policy=str(policy),
         affinity_tokens=int(affinity), fallbacks=int(fallbacks))


def on_handoff(track: str, req, *, src: str,
               span_tokens: int) -> dict | None:
    """Open the prefill→decode handoff span (parented to the PREFILL
    incarnation's root).  Returns the record; the caller closes it via
    :func:`end_handoff` once a decode replica accepted, and threads
    ``(trace_id, sid)`` into the resume so the decode incarnation
    parents to this span — the cross-track link the chrome export
    renders as a flow arrow."""
    if not enabled() or req.trace_id is None:
        return None
    return _open("handoff", track, tr=req.trace_id,
                 par=req.trace_parent, rid=req.request_id,
                 src=str(src), span_tokens=int(span_tokens))


def end_seam(rec: dict | None, *, dst: str | None,
             accepted: bool) -> tuple | None:
    """Close a handoff/failover seam span with the destination that
    actually ACCEPTED (one span per seam crossing, however many
    candidates refused first); returns the ``(trace_id, sid)`` context
    the accepted resume rides (``None`` for backpressure — the next
    attempt opens a fresh span)."""
    if rec is None:
        return None
    _close(rec, dst=dst, accepted=bool(accepted))
    return (rec["tr"], rec["sid"]) if accepted else None


def on_failover(track: str, rid: str, ctx, *, src: str) -> dict | None:
    """A dead replica's journaled request is moving to a survivor:
    open the recovery span, parented to the crashed incarnation
    (``ctx`` from the journal record).  The caller threads
    ``(ctx[0], rec["sid"])`` into the resume and closes the span via
    :func:`end_seam` once a survivor accepted."""
    if not enabled() or ctx is None:
        return None
    return _open("failover", track, tr=ctx[0], par=ctx[1],
                 rid=str(rid), src=str(src))


def on_track_crash(track: str) -> None:
    """Engine ``abandon`` (the in-process SIGKILL stand-in): every
    in-flight trace whose incarnation lives on this track closes with
    state ``crashed`` — the next incarnation (journal replay) parents
    to the closed root, keeping the trace connected through the
    crash."""
    if not enabled():
        return
    now = time.perf_counter()
    for tid in [t for t, st in list(_live.items())
                if st["root"]["track"] == str(track)]:
        st = _live.pop(tid)
        _close(st["phase"], t1=now)
        _close(st["root"], t1=now, state="crashed")


# ------------------------------------------------------ poll / session
def poll_begin() -> float | None:
    """Stamp the top of an engine poll — ``None`` when disarmed, so the
    OFF path allocates nothing downstream."""
    if not enabled():
        return None
    return time.perf_counter()


def on_poll(track: str, tick: int, *, rows: int, emitted: int,
            t0: float | None, spec: bool = False, rids=None) -> None:
    """One engine poll as a track-level span (no trace id — polls are
    communal), with per-row attribution via the ownership stamps the
    engine resolved (``rids``)."""
    if t0 is None or not enabled():
        return
    now = time.perf_counter()
    rec = _open("poll", track, t0=t0, tick=int(tick), rows=int(rows),
                emitted=int(emitted), spec=bool(spec))
    if rids:
        rec["rids"] = list(rids)[:32]
    _close(rec, t1=now)


def on_session_span(track: str, name: str, t0: float, t1: float,
                    **attrs) -> None:
    """Track-level span for a session device call (admit prefill etc. —
    the generation-session hooks)."""
    if not enabled():
        return
    rec = _open(name, track, t0=t0, **attrs)
    _close(rec, t1=t1)


def on_session_mark(track: str, name: str, **attrs) -> None:
    """Point event on a session track (evict, emit)."""
    if not enabled():
        return
    mark(name, track, **attrs)


# ------------------------------------------------------ chrome export
def export_chrome(path: str) -> str:
    """Write the span store as chrome-trace JSON: one ``pid`` (track)
    per engine/session/fleet, spans as ``X`` slices carrying
    ``tr``/``sid``/``par`` in args, and every parent link that crosses
    tracks as an ``s``→``f`` flow arrow (the handoff seam renders as
    an arrow between the replica tracks).  Open spans export with
    their duration truncated at the newest stamp."""
    recs = records()
    tracks = sorted({r["track"] for r in recs})
    pid_of = {t: i + 1 for i, t in enumerate(tracks)}
    by_sid = {r["sid"]: r for r in recs}
    t_end = max((r["t1"] or r["t0"] for r in recs), default=0.0)
    ev = [{"name": "process_name", "ph": "M", "pid": pid_of[t],
           "args": {"name": t}} for t in tracks]
    flow = itertools.count(1)
    for r in recs:
        args = {k: v for k, v in r.items()
                if k not in ("name", "track", "t0", "t1")}
        ev.append({"name": r["name"], "ph": "X", "cat": "trace",
                   "pid": pid_of[r["track"]], "tid": 0,
                   "ts": r["t0"] * 1e6,
                   "dur": max(0.0, ((r["t1"] if r["t1"] is not None
                                     else t_end) - r["t0"]) * 1e6),
                   "args": args})
        par = r.get("par")
        if par and par in by_sid \
                and by_sid[par]["track"] != r["track"]:
            p = by_sid[par]
            fid = next(flow)
            p_ts = (p["t1"] if p["t1"] is not None else p["t0"]) * 1e6
            ev.append({"name": "trace", "ph": "s", "cat": "trace_flow",
                       "pid": pid_of[p["track"]], "tid": 0,
                       "ts": min(p_ts, r["t0"] * 1e6), "id": fid})
            ev.append({"name": "trace", "ph": "f", "bp": "e",
                       "cat": "trace_flow", "pid": pid_of[r["track"]],
                       "tid": 0, "ts": r["t0"] * 1e6, "id": fid})
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, path)
    return path


# ------------------------------------------------------ flight dumps
def flight_dir() -> str:
    return os.environ.get("PADDLE_TPU_FLIGHT_DIR",
                          os.path.join(events.default_dir(), "flight"))


def flight_dump(reason: str, track: str | None = None,
                path: str | None = None) -> str | None:
    """Dump the recorder ring + every still-open span atomically
    (tmp + ``os.replace`` — the ``ft/atomic`` rule: a crash mid-dump
    leaves either no file or a complete one, never a torn JSON).
    Returns the path, or ``None`` when tracing is disarmed.  Never
    raises: the dump is a postmortem courtesy, not a failure path."""
    if not enabled():
        return None
    try:
        with _lock:
            recs = [dict(r) for r in _ring]
            open_spans = [dict(r) for r in _spans
                          if r.get("t1") is None]
        if path is None:
            path = os.path.join(
                flight_dir(),
                f"flightrec_{os.getpid()}_{next(_dump_seq)}.json")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"reason": str(reason), "track": track,
                       "ts": round(time.time(), 6),
                       "perf_now": time.perf_counter(),
                       "records": recs, "open_spans": open_spans},
                      f, default=str)
        os.replace(tmp, path)
        events.emit("flight_dump", reason=str(reason), track=track,
                    path=path, records=len(recs),
                    open_spans=len(open_spans))
        return path
    except Exception:  # noqa: BLE001 — never take down the serve loop
        return None
