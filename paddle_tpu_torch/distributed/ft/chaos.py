"""Deterministic chaos injection of the port: the fault-plan DSL of
paddle_tpu/distributed/ft/chaos.py and its serving faults.

    PADDLE_TPU_CHAOS="slow_tick@tick=3:x120,queue_flood@tick=5-9:x4,kill@tick=11"

Grammar (comma-separated faults)::

    fault     := kind '@' key '=' span [':x' magnitude]
    kind      := nan_grad | inf_grad | spike_loss | ckpt_write_fail
               | kill | slow_tick | queue_flood | poison_request
    key       := step | save | tick | req   (which counter triggers it)
    span      := N | N '-' M          (inclusive counter range)
    magnitude := float                (spike_loss / slow_tick /
                                       queue_flood only)

The whole grammar parses, so a plan written for the reference reads the
same here. The serving faults are injected by
``serving/resilience.py``'s ``ResiliencePolicy.on_poll_start``:

- ``kill@tick=N`` — :func:`maybe_kill` SIGKILLs the process at the
  engine's poll N (the crash the request journal recovers from);
- ``slow_tick@tick=N:xK`` — poll N stalls K ms on the host (default 50);
- ``queue_flood@tick=N:xK`` — K synthetic lowest-priority requests
  (default 8, tokens derived from the tick) join the queue at poll N;
- ``poison_request@req=N`` — the N-th external submission is evicted
  through the retry path every time it reaches a decode slot, until its
  retry budget ends in a loud FAILED.

The training faults (``nan_grad``, ``inf_grad``, ``spike_loss``,
``ckpt_write_fail``, ``kill@step``) parse but have no injection point in
the port yet: the batch corruption and checkpoint hooks come with the
training guards. Every injection is exact and seed-free — the plan is the
seed — so a chaos run replays bit for bit.
"""
from __future__ import annotations

import os
import re
import signal

__all__ = ["Fault", "ChaosPlan", "plan_from_env", "maybe_kill",
           "BATCH_KINDS", "SERVING_KINDS", "KINDS"]

BATCH_KINDS = ("nan_grad", "inf_grad", "spike_loss")
SERVING_KINDS = ("slow_tick", "queue_flood", "poison_request")
KINDS = BATCH_KINDS + ("ckpt_write_fail", "kill") + SERVING_KINDS
# allowed trigger keys per kind (kill fires on a train step OR a
# serving tick — two distinct counters, so matching is key-aware)
_KEYS_FOR = {"nan_grad": ("step",), "inf_grad": ("step",),
             "spike_loss": ("step",), "kill": ("step", "tick"),
             "ckpt_write_fail": ("save",), "slow_tick": ("tick",),
             "queue_flood": ("tick",), "poison_request": ("req",)}
# kinds that take a magnitude: (minimum exclusive bound, default)
_MAGNITUDE = {"spike_loss": (1.0, 8.0), "slow_tick": (0.0, 50.0),
              "queue_flood": (0.0, 8.0)}

_FAULT_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<key>[a-z]+)=(?P<lo>\d+)(?:-(?P<hi>\d+))?"
    r"(?::x(?P<mag>[0-9.]+))?$")

class Fault:
    """One planned fault: ``kind`` firing when ``key``'s counter is in
    ``[lo, hi]`` (inclusive), with an optional magnitude."""

    __slots__ = ("kind", "key", "lo", "hi", "magnitude")

    def __init__(self, kind, key, lo, hi=None, magnitude=None):
        self.kind = kind
        self.key = key
        self.lo = int(lo)
        self.hi = self.lo if hi is None else int(hi)
        self.magnitude = magnitude

    def hits(self, value: int) -> bool:
        return self.lo <= int(value) <= self.hi

    def __repr__(self):
        span = (f"{self.lo}" if self.lo == self.hi
                else f"{self.lo}-{self.hi}")
        mag = "" if self.magnitude is None else f":x{self.magnitude:g}"
        return f"{self.kind}@{self.key}={span}{mag}"

class ChaosPlan:
    """A parsed, immutable list of :class:`Fault`s."""

    def __init__(self, faults=()):
        self.faults = tuple(faults)

    def __bool__(self):
        return bool(self.faults)

    def __repr__(self):
        return f"ChaosPlan({', '.join(map(repr, self.faults))})"

    @classmethod
    def parse(cls, spec: str | None) -> "ChaosPlan":
        """Parse a plan string; raises ``ValueError`` naming the bad
        fault — a typo'd chaos plan silently injecting nothing would be
        a vacuously-green gate."""
        faults = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            m = _FAULT_RE.match(part)
            if not m:
                raise ValueError(
                    f"chaos fault {part!r} does not parse — expected "
                    "kind@key=N[-M][:xMAG] "
                    f"(kinds: {', '.join(KINDS)})")
            kind, key = m.group("kind"), m.group("key")
            if kind not in KINDS:
                raise ValueError(
                    f"chaos fault {part!r}: unknown kind {kind!r} "
                    f"(kinds: {', '.join(KINDS)})")
            if key not in _KEYS_FOR[kind]:
                raise ValueError(
                    f"chaos fault {part!r}: kind {kind!r} triggers on "
                    f"{' or '.join(map(repr, _KEYS_FOR[kind]))}, "
                    f"not {key!r}")
            hi = m.group("hi")
            if hi is not None and int(hi) < int(m.group("lo")):
                raise ValueError(
                    f"chaos fault {part!r}: empty range")
            mag = m.group("mag")
            if mag is not None:
                if kind not in _MAGNITUDE:
                    raise ValueError(
                        f"chaos fault {part!r}: kind {kind!r} takes no "
                        f"magnitude (only "
                        f"{', '.join(sorted(_MAGNITUDE))} do)")
                floor, _ = _MAGNITUDE[kind]
                mag = float(mag)
                if not mag > floor:
                    raise ValueError(
                        f"chaos fault {part!r}: magnitude must be "
                        f"> {floor:g}")
            elif kind in _MAGNITUDE:
                mag = _MAGNITUDE[kind][1]
            faults.append(Fault(kind, key, m.group("lo"), hi, mag))
        return cls(faults)

    def matching(self, kind: str, value: int, key: str | None = None
                 ) -> list:
        """Faults of ``kind`` whose span covers ``value``.  ``key``
        narrows to one trigger counter — required where a kind fires on
        more than one (``kill@step`` vs ``kill@tick`` are different
        faults; a step counter must never trip a tick-keyed kill)."""
        return [f for f in self.faults
                if f.kind == kind and f.hits(value)
                and (key is None or f.key == key)]

def plan_from_env(env_var: str = "PADDLE_TPU_CHAOS") -> ChaosPlan:
    """The plan the environment declares (empty plan when unset)."""
    return ChaosPlan.parse(os.environ.get(env_var))

def _record(kind: str, **fields) -> None:
    """A planned fault fired: the ``chaos_inject`` event and the
    ``chaos_injections_total`` counter (telemetry on only)."""
    from ...observability import events
    if not events.enabled():
        return
    from ...framework.monitor import stat_registry
    stat_registry.register("chaos_injections_total").add(1)
    events.emit("chaos_inject", fault=kind, **fields)

def maybe_kill(plan: ChaosPlan, step: int, key: str = "step") -> None:
    """SIGKILL the process if the plan says this counter value dies.
    The serving engine passes ``key="tick"`` with its poll counter
    (``kill@tick=N``); ``key="step"`` is the training form."""
    if plan.matching("kill", step, key=key):
        _record("kill", **{key: int(step)})
        os.kill(os.getpid(), signal.SIGKILL)
