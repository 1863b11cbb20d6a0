"""Telemetry event sink of the port: structured JSONL, gated by ONE env
flag — a copy of paddle_tpu/observability/events.py, so the port stands
alone (each package keeps its own sink, path and override).

``PADDLE_TPU_TELEMETRY=1`` turns the whole plane on; every publisher of
the port (``observability.serving``, ``observability.quant``) funnels
through :func:`emit` here, one JSON object per line. With the flag off
every publisher is a no-op behind one check.

The file is size-bounded: past ``PADDLE_TPU_TELEMETRY_MAX_MB`` (default
256) the segment rotates — ``events.jsonl`` renames to ``events.jsonl.1``
(older segments shift up, ``PADDLE_TPU_TELEMETRY_KEEP`` of them kept,
default 3) and a fresh file opens. Rotation happens between appends, so
every rotated segment ends on a complete line; the only torn line a
reader can meet is the live file's last line under a crashed writer,
which :func:`iter_events` skips.

Events never raise: telemetry must not be able to take down the thing
it observes.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time

__all__ = ["enabled", "set_enabled", "emit", "event_log_path",
           "set_event_path", "default_dir", "add_tap", "remove_tap",
           "iter_events", "max_bytes", "keep_segments"]

_lock = threading.Lock()
_path: str | None = None
_fh = None
# programmatic override (tests / comm_scope); None defers to the env
_override: bool | None = None
# taps: callables fed every emitted record (the flight recorder rides
# here) — registered once, never raise into the emit path
_taps: list = []


def enabled() -> bool:
    """ONE flag for the whole plane: ``PADDLE_TPU_TELEMETRY=1`` (or a
    programmatic :func:`set_enabled` override, used by tests)."""
    if _override is not None:
        return _override
    return os.environ.get("PADDLE_TPU_TELEMETRY", "0") == "1"


def set_enabled(flag: bool | None) -> None:
    """Force telemetry on/off in-process; ``None`` defers back to the
    env flag.  Tests use this so they never mutate ``os.environ``."""
    global _override
    _override = flag


def add_tap(fn) -> None:
    """Register a per-record tap (called with the dict of every emitted
    event).  The flight recorder uses this to tee events into its
    ring; taps must never raise — a raising tap is dropped."""
    if fn not in _taps:
        _taps.append(fn)


def remove_tap(fn) -> None:
    try:
        _taps.remove(fn)
    except ValueError:
        pass


def default_dir() -> str:
    """``PADDLE_TPU_TELEMETRY_DIR``, else ``paddle_tpu_telemetry`` under
    the temporary directory (``TMPDIR``)."""
    return os.environ.get("PADDLE_TPU_TELEMETRY_DIR", os.path.join(
        tempfile.gettempdir(), "paddle_tpu_telemetry"))


def event_log_path() -> str:
    """The JSONL file this process appends to (per-pid so bench child
    processes never interleave lines)."""
    global _path
    if _path is None:
        _path = os.path.join(default_dir(),
                             f"telemetry_{os.getpid()}.jsonl")
    return _path


def set_event_path(path: str | None) -> None:
    """Redirect the sink (tests point it at tmp_path); ``None`` resets
    to the default per-pid location."""
    global _path, _fh
    with _lock:
        if _fh is not None:
            try:
                _fh.close()
            except OSError:
                pass
            _fh = None
        _path = path


def max_bytes() -> int:
    """Rotation threshold for the live segment: a long-lived armed
    serving process must not append without bound.  ``<= 0`` disables
    rotation entirely."""
    try:
        mb = float(os.environ.get("PADDLE_TPU_TELEMETRY_MAX_MB", "256"))
    except ValueError:
        mb = 256.0
    return int(mb * 1024 * 1024)


def keep_segments() -> int:
    """How many rotated segments survive (``.1`` newest … ``.K``
    oldest); older ones are deleted at rotation."""
    try:
        k = int(os.environ.get("PADDLE_TPU_TELEMETRY_KEEP", "3"))
    except ValueError:
        k = 3
    return max(1, k)


def _rotate_locked() -> None:
    """Shift ``path.i`` → ``path.(i+1)`` (dropping past keep-K), move
    the live file to ``.1``, and reopen fresh.  Runs between appends —
    every rotated segment therefore ends on a complete line."""
    global _fh
    path = event_log_path()
    try:
        _fh.close()
    except OSError:
        pass
    _fh = None
    keep = keep_segments()
    try:
        for i in range(keep, 0, -1):
            src = f"{path}.{i}"
            if not os.path.exists(src):
                continue
            if i >= keep:
                os.remove(src)
            else:
                os.replace(src, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")
    except OSError:
        pass  # rotation is best-effort; appends continue regardless


def emit(kind: str, **fields) -> None:
    """Append one structured event.  No-op when disabled; never raises
    (an unwritable disk must not kill a train loop)."""
    if not enabled():
        return
    rec = {"ts": round(time.time(), 6), "kind": kind}
    rec.update(fields)
    try:
        line = json.dumps(rec, default=str)
    except (TypeError, ValueError):
        return
    for tap in list(_taps):
        try:
            tap(rec)
        except Exception:  # noqa: BLE001 — a broken tap is dropped
            remove_tap(tap)
    global _fh
    try:
        with _lock:
            if _fh is None:
                d = os.path.dirname(event_log_path())
                if d:
                    os.makedirs(d, exist_ok=True)
                _fh = open(event_log_path(), "a")
            _fh.write(line + "\n")
            _fh.flush()
            cap = max_bytes()
            if cap > 0 and _fh.tell() >= cap:
                _rotate_locked()
    except OSError:
        pass


def iter_events(path: str | None = None):
    """Yield parsed event dicts across the rotated segment chain
    (oldest segment first, live file last).  Undecodable lines — the
    torn tail a crashed writer leaves on the LIVE file — are skipped,
    the journal reader's rule; every rotated segment is complete by
    construction."""
    path = event_log_path() if path is None else path
    chain = [f"{path}.{i}" for i in range(keep_segments(), 0, -1)]
    chain.append(path)
    for seg in chain:
        try:
            f = open(seg, encoding="utf-8")
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue  # torn tail of a crashed writer
