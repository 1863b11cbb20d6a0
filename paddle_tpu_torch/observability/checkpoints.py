"""Checkpoint telemetry of the port: save/commit/restore events in the one
plane — a copy of paddle_tpu/observability/checkpoints.py on the port's
event sink.

Fed by ``distributed/ft/manager.py``.  Three event kinds prove the
async save costs the train step ~nothing:

- ``ckpt_save``    — scheduled: bytes + **host-blocked ms** (the
  device->host copy, the ONLY part the step waits on),
- ``ckpt_commit``  — durable: background-write ms + end-to-end commit
  latency (schedule -> rename visible),
- ``ckpt_restore`` — bytes + read ms.

Gauges land in StatRegistry (prefixed ``ckpt_``) so ``stats_report()``
carries the host-blocked vs
background-write split next to the step timeline.  Gated by the same
ONE flag as the rest of the plane; off, each hook is a single
dict-lookup no-op (the manager keeps its own plain counters for bench
rows either way).
"""
from __future__ import annotations

from . import events

__all__ = ["record_save", "record_commit", "record_restore"]


def _gauges(name: str, **vals) -> None:
    try:
        from ..framework.monitor import stat_registry
        for key, v in vals.items():
            kind = "int64" if isinstance(v, int) else "float"
            stat_registry.register(f"ckpt_{name}_{key}", kind).set(v)
    except Exception:  # telemetry must never take down the train loop
        pass


def record_save(name: str, *, step: int, bytes: int,
                host_blocked_ms: float) -> None:
    if not events.enabled():
        return
    _gauges(name, last_bytes=int(bytes),
            last_host_blocked_ms=float(host_blocked_ms))
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register(f"ckpt_{name}_saves_total").add(1)
    except Exception:
        pass
    events.emit("ckpt_save", name=name, step=step, bytes=int(bytes),
                host_blocked_ms=round(float(host_blocked_ms), 3))


def record_commit(name: str, *, step: int, bytes: int, bg_write_ms: float,
                  commit_ms: float) -> None:
    if not events.enabled():
        return
    _gauges(name, last_bg_write_ms=float(bg_write_ms),
            last_commit_ms=float(commit_ms))
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register(f"ckpt_{name}_commits_total").add(1)
    except Exception:
        pass
    events.emit("ckpt_commit", name=name, step=step, bytes=int(bytes),
                bg_write_ms=round(float(bg_write_ms), 3),
                commit_ms=round(float(commit_ms), 3))


def record_restore(name: str, *, step: int, bytes: int, ms: float) -> None:
    if not events.enabled():
        return
    _gauges(name, last_restore_ms=float(ms))
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register(f"ckpt_{name}_restores_total").add(1)
    except Exception:
        pass
    events.emit("ckpt_restore", name=name, step=step, bytes=int(bytes),
                restore_ms=round(float(ms), 3))
