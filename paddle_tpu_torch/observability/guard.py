"""Guardrail telemetry of the port: the training sentinel's feed into the
one plane — a copy of paddle_tpu/observability/guard.py on the port's
event sink.

Fed by ``distributed/ft/sentinel.py`` (StepGuard) and
``distributed/ft/chaos.py`` (fault injections). Event kinds:

- ``guard_anomaly``  — one anomalous step: index, anomaly bitmask
  (loss-nonfinite / grad-nonfinite / spike), loss, grad norm, and the
  action taken (``skip`` or ``rollback``),
- ``guard_rollback`` — a consecutive-anomaly burst escalated: the
  restored checkpoint step and the newly-quarantined indices,
- ``chaos_inject``   — a planned fault fired (the chaos harness leaves
  its own audit trail, so a gate log shows cause next to effect).

Gauges land in StatRegistry prefixed ``guard_<name>_`` (anomalies /
skips / rollbacks / quarantined totals, last loss + grad norm + loss
cap); gauges and JSONL events publish only when the ONE telemetry flag
is on, same contract as every other feed.
"""
from __future__ import annotations

from . import events

__all__ = ["record_step", "record_anomaly", "record_rollback",
           "record_chaos"]


def _gauges(name: str, **vals) -> None:
    try:
        from ..framework.monitor import stat_registry
        for key, v in vals.items():
            kind = "int64" if isinstance(v, int) else "float"
            stat_registry.register(f"guard_{name}_{key}", kind).set(v)
    except Exception:  # telemetry must never take down the train loop
        pass


def record_step(name: str, *, step: int, loss: float, grad_norm: float,
                loss_cap: float) -> None:
    """One HEALTHY guarded step (gauge-only — a per-step JSONL event
    would dwarf the log; anomalies are the signal)."""
    if not events.enabled():
        return
    cap = float(loss_cap)
    _gauges(name, last_step=int(step), last_loss=float(loss),
            last_grad_norm=float(grad_norm),
            # +inf is not JSON; the registry coerces, so clamp to 0
            # meaning "spike test disarmed (insufficient history)"
            loss_cap=(cap if cap != float("inf") else 0.0))


def record_anomaly(name: str, *, step: int, code: int, loss: float,
                   grad_norm: float, action: str,
                   consecutive: int) -> None:
    if not events.enabled():
        return
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register(f"guard_{name}_anomalies_total").add(1)
        if action == "skip":
            stat_registry.register(f"guard_{name}_skips_total").add(1)
    except Exception:
        pass
    _gauges(name, last_anomaly_step=int(step), last_anomaly_code=int(code))
    events.emit("guard_anomaly", name=name, step=int(step), code=int(code),
                loss=float(loss), grad_norm=float(grad_norm),
                action=action, consecutive=int(consecutive))


def record_rollback(name: str, *, restored_step, quarantined,
                    total_quarantined: int, rollbacks: int) -> None:
    if not events.enabled():
        return
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register(f"guard_{name}_rollbacks_total").add(1)
    except Exception:
        pass
    _gauges(name, quarantined_total=int(total_quarantined))
    events.emit("guard_rollback", name=name,
                restored_step=(None if restored_step is None
                               else int(restored_step)),
                quarantined=[int(s) for s in quarantined],
                rollbacks=int(rollbacks))


def record_chaos(kind: str, **fields) -> None:
    """A planned fault fired (chaos.py) — audited next to its effect."""
    if not events.enabled():
        return
    try:
        from ..framework.monitor import stat_registry
        stat_registry.register("chaos_injections_total").add(1)
    except Exception:
        pass
    events.emit("chaos_inject", fault=kind, **fields)
