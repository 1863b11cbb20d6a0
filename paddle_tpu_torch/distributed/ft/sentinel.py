"""Anomaly sentinel + host-side skip/rollback/quarantine policy — port of
paddle_tpu/distributed/ft/sentinel.py on torch tensors.

The checkpoint manager makes a *killed* run recoverable; this layer makes
a *poisoned* one recoverable — the NaN/Inf gradient, the loss spike from a bad batch,
the silently-diverging step that corrupts optimizer state and burns the
job (the dominant failure mode in large-scale training logbooks;
loss-spike skip-and-rollback is standard practice in PaLM/OPT-class
runs).  Two halves:

**Device half (the sentinel).**  A guarded train step
(``models/gpt.py:build_train_step(sentinel=True)``) computes a tiny
HEALTH VECTOR on the device — loss finiteness, gradient finiteness (via
the global grad-square-sum, where a single NaN/Inf leaf poisons the
reduction), the global grad norm, and a caller-supplied ``loss_cap``
spike test — and applies no optimizer update when the step is
anomalous. Where the reference masks the update with a ``lax.cond`` on
the device, the port's step reads the verdict on the host once a step
and skips the update: AdamW writes params and moments in place, so it
must not run at all.

**Host half (:class:`StepGuard`).**  Reads the fetched health vector
each step and escalates:

- *skip* — an anomalous step's update was already masked on device;
  the guard records it and moves on,
- *rollback* — ``max_consecutive`` anomalies in a row mean the data
  (or state) is poisoned beyond one bad batch: restore the last
  committed checkpoint (``CheckpointManager``) and
- *quarantine* — the restored run DETERMINISTICALLY skips the poisoned
  step indices (the per-step data stream is a pure function of the
  step index, so skipping an index excises exactly that batch); the
  quarantine set rides in the checkpoint aux so a later resume skips
  them too.

The spike detector is a bounded median window over recent healthy
losses: ``loss_cap = spike_factor * median(window)`` once
``min_history`` losses accumulate (``+inf`` before — startup loss
cliffs must not read as anomalies).

:func:`run_guarded` is the loop composing all of it, driven under the
deterministic fault plans of :mod:`.chaos`.
"""
from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

__all__ = ["HEALTH_LEN", "H_LOSS", "H_APPLIED", "H_CODE", "H_GNORM",
           "CODE_LOSS_NONFINITE", "CODE_GRAD_NONFINITE", "CODE_LOSS_SPIKE",
           "anomaly_code", "health_vector", "grad_square_sum",
           "guarded_update", "StepGuard", "run_guarded"]

# health-vector layout — ONE device->host fetch per step carries all of it
HEALTH_LEN = 4
H_LOSS = 0      # the step's (reduced) loss, possibly non-finite
H_APPLIED = 1   # 1.0 = optimizer update applied, 0.0 = masked to a no-op
H_CODE = 2      # anomaly bitmask (0 = healthy)
H_GNORM = 3     # global grad norm (of the final, normalized gradient)

# anomaly bitmask values (a step can trip several at once)
CODE_LOSS_NONFINITE = 1
CODE_GRAD_NONFINITE = 2
CODE_LOSS_SPIKE = 4


def anomaly_code(loss, grad_sq, loss_cap):
    """Device-side anomaly test: returns ``(ok, code)`` — ``ok`` a 0-dim
    bool tensor (True = healthy, apply the update), ``code`` the f32
    bitmask, both on the loss's device.  ``grad_sq`` is the GLOBAL grad
    square-sum (any non-finite gradient leaf poisons it — that is the
    whole trick: finiteness of the full tree collapses into one scalar).
    ``loss_cap``: a float or a 0-dim tensor; pass ``+inf`` to disable
    the spike test, ``-inf`` to force-mask a step."""
    loss = torch.as_tensor(loss).float()
    dev = loss.device
    grad_sq = torch.as_tensor(grad_sq, device=dev).float()
    bad_loss = ~torch.isfinite(loss)
    bad_grad = ~torch.isfinite(grad_sq)
    # NaN compares false against everything: a non-finite loss must not
    # slip past the spike test just because `nan > cap` is False
    spike = loss > torch.as_tensor(loss_cap, dtype=torch.float32,
                                   device=dev)
    code = (CODE_LOSS_NONFINITE * bad_loss.float()
            + CODE_GRAD_NONFINITE * bad_grad.float()
            + CODE_LOSS_SPIKE * spike.float())
    ok = ~(bad_loss | bad_grad | spike)
    return ok, code


def health_vector(loss, ok, code, gnorm):
    """Pack the per-step health into the fixed [HEALTH_LEN] f32 layout
    (on the loss's device)."""
    loss = torch.as_tensor(loss).float()
    dev = loss.device
    return torch.stack([loss] + [torch.as_tensor(t, device=dev).float()
                                 for t in (ok, code, gnorm)])


# elements of one slice of the square-sum: a large leaf is reduced this
# many at a time, so each f32 temporary stays near 0.54 GB
_SQ_SLICE = 1 << 27


def grad_square_sum(grads) -> torch.Tensor:
    """The global f32 square-sum of a gradient tree (a nested dict of
    tensors); any non-finite leaf poisons it. A leaf larger than
    :data:`_SQ_SLICE` elements is reduced a slice of its leading dim at a
    time."""
    from ...ops.kernels.fused_adamw import tree_flatten
    total = None
    for g in tree_flatten(grads):
        parts = [g]
        if g.dim() and g.numel() > _SQ_SLICE:
            parts = g.split(max(1, _SQ_SLICE // max(g[0].numel(), 1)))
        for part in parts:
            s = part.float().square().sum()
            total = s if total is None else total + s
    return total


def guarded_update(loss, grads, loss_cap, update):
    """The device half around an optimizer update: the global grad
    square-sum, :func:`anomaly_code`, ONE host read of the verdict, and
    ``update()`` only on a healthy step. Returns ``(update() or None,
    health)``; an anomalous step runs nothing, so params and moments stay
    as they were, bit for bit, whether the update works in place or
    not."""
    grad_sq = grad_square_sum(grads)
    ok, code = anomaly_code(loss, grad_sq, loss_cap)
    out = update() if bool(ok) else None
    return out, health_vector(loss, ok, code, torch.sqrt(grad_sq))


def _host(health) -> np.ndarray:
    """A health vector (tensor on any device, or array-like) as float64
    numpy on the host: the one device-to-host fetch a step."""
    if torch.is_tensor(health):
        health = health.detach().to("cpu", torch.float64).numpy()
    return np.asarray(health, np.float64).reshape(-1)


class StepGuard:
    """Host-side escalation policy over the sentinel's health vectors.

    ``observe(step, health)`` returns the action taken:

    - ``"ok"``       — healthy step, loss joins the spike window,
    - ``"skip"``     — anomalous; the device already masked the update,
      the step index joins the PENDING quarantine set,
    - ``"rollback"`` — ``max_consecutive`` anomalies in a row; the
      caller must restore the last committed checkpoint and call
      :meth:`rolled_back`, after which the pending indices are
      QUARANTINED (deterministically skipped on the re-run and by any
      later resume via the checkpoint aux).

    The guard is checkpointable (:meth:`state_dict` /
    :meth:`load_state_dict`) so quarantine survives preemption.
    """

    def __init__(self, spike_factor: float = 10.0, window: int = 32,
                 min_history: int = 5, max_consecutive: int = 3,
                 name: str = "guard"):
        if spike_factor <= 1.0:
            raise ValueError(f"spike_factor must be > 1, got {spike_factor}")
        if max_consecutive < 1:
            raise ValueError(
                f"max_consecutive must be >= 1, got {max_consecutive}")
        self.name = str(name)
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self.max_consecutive = int(max_consecutive)
        self._window: deque = deque(maxlen=int(window))
        self.quarantined: set = set()
        self._pending: list = []        # anomalous steps since last healthy
        self.consecutive = 0
        # counters (exported by bench rows and the guard_* gauges)
        self.anomalies = 0
        self.skips = 0
        self.rollbacks = 0
        self.last_restored_step = None

    # ------------------------------------------------------------ policy
    def loss_cap(self) -> float:
        """Spike threshold fed to the compiled step: ``spike_factor x
        median(recent healthy losses)``, ``+inf`` until ``min_history``
        losses accumulate (warmup cliffs are not anomalies)."""
        if len(self._window) < self.min_history:
            return float("inf")
        return self.spike_factor * float(np.median(list(self._window)))

    def observe(self, step: int, health) -> str:
        """Digest one fetched health vector; returns "ok" | "skip" |
        "rollback" (the device already masked anomalous updates — the
        return value is what the HOST should now do)."""
        h = _host(health)
        loss, applied = float(h[H_LOSS]), h[H_APPLIED] >= 0.5
        code, gnorm = int(h[H_CODE]), float(h[H_GNORM])
        from ...observability import guard as obs_guard
        if applied:
            self.consecutive = 0
            self._pending.clear()
            if math.isfinite(loss):
                self._window.append(loss)
            obs_guard.record_step(self.name, step=int(step), loss=loss,
                                  grad_norm=gnorm,
                                  loss_cap=self.loss_cap())
            return "ok"
        self.anomalies += 1
        self.consecutive += 1
        self._pending.append(int(step))
        escalate = self.consecutive >= self.max_consecutive
        action = "rollback" if escalate else "skip"
        if not escalate:
            self.skips += 1
        obs_guard.record_anomaly(self.name, step=int(step), code=code,
                                 loss=loss, grad_norm=gnorm, action=action,
                                 consecutive=self.consecutive)
        return action

    def rolled_back(self, restored_step) -> None:
        """The caller restored a committed checkpoint: quarantine every
        pending anomalous index so the re-run (and any later resume)
        deterministically skips the poisoned data steps."""
        self.rollbacks += 1
        self.last_restored_step = (None if restored_step is None
                                   else int(restored_step))
        quarantined = sorted(self._pending)
        self.quarantined.update(self._pending)
        self._pending.clear()
        self.consecutive = 0
        from ...observability import guard as obs_guard
        obs_guard.record_rollback(self.name, restored_step=restored_step,
                                  quarantined=quarantined,
                                  total_quarantined=len(self.quarantined),
                                  rollbacks=self.rollbacks)
        # guard escalation is a postmortem moment: dump the flight
        # recorder so the last N spans/events around the anomaly burst
        # survive (no-op unless tracing is armed)
        from ...observability import tracing
        tracing.flight_dump("guard_rollback", track=self.name)

    # ------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        """JSON-encodable state for the checkpoint aux — a resumed run
        must keep skipping the quarantined indices."""
        return {"quarantined": sorted(self.quarantined),
                "window": [float(x) for x in self._window],
                "anomalies": self.anomalies, "skips": self.skips,
                "rollbacks": self.rollbacks}

    def load_state_dict(self, state) -> None:
        if not state:
            return
        self.quarantined = set(int(s) for s in state.get("quarantined", ()))
        self._window.clear()
        self._window.extend(float(x) for x in state.get("window", ()))
        self.anomalies = int(state.get("anomalies", 0))
        self.skips = int(state.get("skips", 0))
        self.rollbacks = int(state.get("rollbacks", 0))
        self._pending.clear()
        self.consecutive = 0

    def stats(self) -> dict:
        """Counters for bench rows / assertions."""
        return {"anomalies": self.anomalies, "skips": self.skips,
                "rollbacks": self.rollbacks,
                "quarantined": sorted(self.quarantined),
                "last_restored_step": self.last_restored_step}


def run_guarded(step_fn, guard: StepGuard, state, data_for, n_steps: int,
                *, start: int = 0, save_every: int = 0, saver=None,
                restorer=None, max_rollbacks: int = 8, on_step=None):
    """Reference guarded train loop — the composition the bench rung and
    the tests drive.

    - ``step_fn(state, x, y, loss_cap) -> (state, health)`` — a
      sentinel-built step (``state`` is whatever tuple the caller's
      step threads, e.g. ``(params, opt)``),
    - ``data_for(t) -> (x, y)`` — MUST be a pure function of the step
      index (that purity is what makes skip and quarantine
      deterministic: excising index ``t`` excises exactly that batch),
    - ``saver(next_step, state, guard)`` — schedule a checkpoint
      (called after every ``save_every``-th applied step),
    - ``restorer(guard) -> (state, next_step) | None`` — restore the
      last committed checkpoint; ``None`` (or no restorer) means
      "nothing committed yet": the guard quarantines the pending steps
      and continues in place — every one of them was masked on device,
      so the live state is still the last healthy one.

    Returns ``(state, losses)`` where ``losses`` maps step index ->
    loss for every APPLIED step (skipped/quarantined indices absent).
    """
    losses: dict = {}
    t = int(start)
    while t < n_steps:
        if t in guard.quarantined:
            t += 1
            continue
        x, y = data_for(t)
        state, health = step_fn(state, x, y, np.float32(guard.loss_cap()))
        action = guard.observe(t, health)
        if action == "rollback":
            if guard.rollbacks >= max_rollbacks:
                raise RuntimeError(
                    f"guard: {guard.rollbacks} rollbacks already — the "
                    "anomaly is not data-local, refusing to thrash")
            restored = restorer(guard) if restorer is not None else None
            if restored is None:
                # nothing committed: quarantine in place (the masked
                # updates never touched the state)
                guard.rolled_back(None)
                t += 1
                continue
            state, t = restored[0], int(restored[1])
            guard.rolled_back(t)
            # drop re-run-window losses newer than the restore point —
            # the re-run recomputes them (bit-identically, data purity)
            losses = {s: v for s, v in losses.items() if s < t}
            continue
        if action == "ok":
            losses[t] = float(_host(health)[H_LOSS])
        if on_step is not None:
            on_step(t, state, action)
        if (saver is not None and save_every
                and (t + 1) % save_every == 0):
            saver(t + 1, state, guard)
        t += 1
    return state, losses
