"""Named process-wide gauges, introspectable from Python: the stat
registry of paddle_tpu/framework/monitor.py (the reference's
``StatRegistry`` after ``paddle/fluid/platform/monitor.h``), copied so the
port stands alone. The serving plane publishes its gauges here
(``observability.serving``, ``quant``, ``resilience``, ``fleet`` and
``metering``) when telemetry is on; :func:`stats_report` reads them,
:func:`stats_prom` renders them in the Prometheus text format and
:func:`write_stats_snapshot` writes either form to a file atomically.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable

__all__ = ["StatRegistry", "stat_registry", "STAT_INT64", "STAT_FLOAT",
           "stat_get", "stat_set", "stat_add", "stat_reset",
           "stats_report", "stats_prom", "prom_labeled_name",
           "write_stats_snapshot"]


class _Stat:
    __slots__ = ("name", "kind", "_value", "_lock", "_getter")

    def __init__(self, name, kind, getter=None):
        self.name = name
        self.kind = kind
        self._value = 0 if kind == "int64" else 0.0
        self._lock = threading.Lock()
        self._getter = getter

    @property
    def value(self):
        if self._getter is not None:
            try:
                return self._getter()
            except Exception:  # noqa: BLE001 — stats must never raise
                return 0
        return self._value

    def set(self, v):
        with self._lock:
            self._value = int(v) if self.kind == "int64" else float(v)

    def add(self, v=1):
        with self._lock:
            self._value += v
            return self._value


def _jsonable(v):
    """Plain int/float/str/bool/None from whatever a getter returned."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    item = getattr(v, "item", None)     # numpy scalars
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:  # noqa: BLE001
            pass
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class StatRegistry:
    """Singleton named-gauge registry."""

    def __init__(self):
        self._stats: dict[str, _Stat] = {}
        self._lock = threading.Lock()

    def register(self, name: str, kind: str = "int64",
                 getter: Callable | None = None) -> _Stat:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = _Stat(name, kind, getter)
            return self._stats[name]

    def get(self, name: str) -> _Stat:
        if name not in self._stats:
            return self.register(name)
        return self._stats[name]

    def names(self):
        return sorted(self._stats)

    def unregister(self, name: str | None = None,
                   prefix: str | None = None):
        """Drop a gauge (or every gauge under ``prefix``) — per-instance
        publishers (one serving session's gauges) must be able to clean
        up after themselves or session churn grows the registry and
        every snapshot forever."""
        with self._lock:
            if name is not None:
                self._stats.pop(name, None)
            if prefix is not None:
                for k in [k for k in self._stats if k.startswith(prefix)]:
                    del self._stats[k]

    def report(self) -> dict:
        """Stable snapshot: keys sorted, every value coerced to a plain
        JSON-serializable scalar (getters may hand back numpy types)."""
        return {n: _jsonable(s.value)
                for n, s in sorted(self._stats.items())}

    def reset(self, name: str | None = None):
        targets = [self._stats[name]] if name else self._stats.values()
        for s in targets:
            if s._getter is None:
                s.set(0)


stat_registry = StatRegistry()


def STAT_INT64(name: str):
    """Register (or fetch) an int64 gauge — the reference macro's shape."""
    return stat_registry.register(name, "int64")


def STAT_FLOAT(name: str):
    return stat_registry.register(name, "float")


def stat_get(name: str):
    return stat_registry.get(name).value


def stat_set(name: str, value):
    stat_registry.get(name).set(value)


def stat_add(name: str, value=1):
    return stat_registry.get(name).add(value)


def stat_reset(name: str | None = None):
    stat_registry.reset(name)


def stats_report() -> dict:
    return stat_registry.report()


def _prom_name(name: str) -> str:
    """Prometheus metric names allow ``[a-zA-Z_:][a-zA-Z0-9_:]*``; the
    registry's dotted/dashed names sanitize to underscores."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return out if out and not out[0].isdigit() else "_" + out


def _prom_escape(value: str) -> str:
    """Prometheus label-value escaping: backslash, double quote and
    newline must be escaped inside the quoted value."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prom_labeled_name(family: str, **labels) -> str:
    """Build a registry key that ``stats_prom`` renders as a LABELED
    sample: ``family{k="v",...}``.  Labels sort by key so two
    registrations of the same label set collapse to one gauge, and
    values are escaped here (once, at registration) so the exposition
    face never has to re-parse them.  Flat (label-free) gauges are just
    plain names — this helper is only for publishers that need
    per-label-set samples (e.g. per-tenant meters)."""
    if not labels:
        return family
    inner = ",".join(f'{k}="{_prom_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{family}{{{inner}}}"


def stats_prom(prefix: str = "paddle_tpu_") -> str:
    """The registry in Prometheus text exposition format: one
    ``# TYPE`` line per metric family + one sample per gauge.
    Non-numeric values (a getter that degraded to a string) are
    skipped — Prometheus samples are numbers; booleans coerce to 0/1.
    Keys stay sorted, so two identical snapshots render byte-identical
    text.

    Labeled gauges — registry keys shaped ``family{k="v"}`` (see
    ``prom_labeled_name``) — render as ``prefix_family{k="v"} value``
    with ONE ``# TYPE`` line per family: only the family part is
    sanitized, the label block (escaped at registration) passes through
    verbatim.  A registry with no labeled keys renders byte-identically
    to the flat-only format."""
    lines = []
    last_family = None
    for name, v in sorted(stats_report().items()):
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)) or v != v:  # skip str/NaN
            continue
        brace = name.find("{")
        if brace > 0 and name.endswith("}"):
            family = _prom_name(prefix + name[:brace])
            sample = family + name[brace:]
        else:
            family = _prom_name(prefix + name)
            sample = family
        if family != last_family:
            lines.append(f"# TYPE {family} gauge")
            last_family = family
        lines.append(f"{sample} {v}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_stats_snapshot(path: str, fmt: str = "prom") -> str:
    """Write the registry snapshot to ``path`` atomically (tmp + rename, so
    a scraper never reads a torn file) as Prometheus text (``fmt="prom"``)
    or JSON (``fmt="json"``). Returns the path."""
    if fmt == "prom":
        payload = stats_prom()
    elif fmt == "json":
        payload = json.dumps(stats_report(), indent=2, sort_keys=True) + "\n"
    else:
        raise ValueError(f"fmt must be 'prom' or 'json', got {fmt!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)
    return path
