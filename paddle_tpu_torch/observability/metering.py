"""Per-tenant resource metering of the port: a copy of
paddle_tpu/observability/metering.py on the port's event sink and stat
registry.

The serving plane (ServingMetrics) answers "what is the engine doing";
this feed answers "WHO is consuming it".  A ``tenant`` id rides
``Request`` through admission, the session's slot-ownership stamps, the
crash journal and fleet K/V handoffs, and every resource the engine
spends is charged to the stamped tenant:

  - prefill / decode / speculative-accepted tokens (charged at the
    exact same points the untagged ServingMetrics counters increment,
    so per-tenant sums conserve against the engine totals),
  - queue-wait and TTFT latency reservoirs (bounded, mergeable),
  - sheds / expiries / retries,
  - prefix-cache hit tokens and the KV bytes they saved,
  - KV **page-seconds**: the paged pool's per-row page grants
    integrated over poll ticks.  Aliased (prefix-shared) pages appear
    in every referencing row's grant list, so a shared page is charged
    to each tenant that holds a reference — that is the fair-share
    reading (the alternative, charging the first owner, makes a popular
    prefix a liability).  The meter separately integrates the pool
    gauge itself (``pool_page_seconds``), which per-tenant sums conserve
    against.  The page counts come from the session's host page-table
    mirror, never from the device.

Everything is host-side float/int arithmetic — metering never touches
a tick body, adds no device sync or copy, and is OFF unless the engine is
constructed with ``metering=`` (or ``PADDLE_TPU_TENANT_METERING=1``).

Noisy-neighbour attribution: every poll the engine reports each
tenant's share of queue depth and of live KV pages.  A tenant holding
more than ``dominance_threshold`` of either resource for
``dominance_polls`` CONSECUTIVE polls — while at least one other
tenant is live, so a lone tenant draining the tail of a trace never
trips it — raises one ``serving_noisy_tenant`` event per episode
(re-armed when its share drops back under the threshold).

Cardinality is bounded twice: the meter tracks at most ``max_tenants``
distinct ids (the long tail folds into ``_other``), and the Prometheus
export publishes only the top-``top_k`` tenants by token volume plus
one aggregated ``other`` label — a scrape face that cannot explode no
matter what ids callers send.

Fleet story: one meter per replica engine; ``TenantMeter.merged``
combines them (counter sums + seen-weighted ``_Reservoir.merged``)
exactly like ``ServingMetrics.merged`` does for the untagged plane.
"""
from __future__ import annotations

import os

from . import events
from .serving import _Reservoir

__all__ = ["TenantMeter", "UNTAGGED", "OTHER"]

# reserved tenant labels (leading underscore keeps them out of any
# real tenant namespace that sticks to printable ids)
UNTAGGED = "_untagged"    # requests submitted without a tenant id
OTHER = "_other"          # long-tail fold past the max_tenants cap

# integer resource counters a _Tenant carries (export order)
_COUNTERS = ("requests", "prefill_tokens", "decode_tokens",
             "spec_accepted_tokens", "prefix_hit_tokens",
             "prefix_hit_bytes", "sheds", "expiries", "retries")


def metering_env_default() -> bool:
    """The env-var default for engines constructed with
    ``metering=None``."""
    return os.environ.get("PADDLE_TPU_TENANT_METERING", "0").lower() \
        not in ("0", "", "false", "off")


class _Tenant:
    """One tenant's accumulators: integer resource counters, the
    float page-second integral, and two bounded latency reservoirs."""

    __slots__ = _COUNTERS + ("page_seconds", "ttft_ms", "queue_wait_ms")

    def __init__(self):
        for c in _COUNTERS:
            setattr(self, c, 0)
        self.page_seconds = 0.0
        self.ttft_ms = _Reservoir(seed=0)
        self.queue_wait_ms = _Reservoir(seed=0)

    def counters(self) -> dict:
        out = {c: getattr(self, c) for c in _COUNTERS}
        out["page_seconds"] = self.page_seconds
        return out


class TenantMeter:
    """Per-tenant resource accounting for one serving engine (or, via
    :meth:`merged`, a whole fleet).  Purely host-side; every hook is a
    few dict lookups and float adds."""

    def __init__(self, name: str = "engine", top_k: int = 8,
                 max_tenants: int = 256,
                 dominance_threshold: float = 0.6,
                 dominance_polls: int = 16,
                 publish_every: int = 32):
        self.name = str(name)
        self.top_k = int(top_k)
        self.max_tenants = int(max_tenants)
        self.dominance_threshold = float(dominance_threshold)
        self.dominance_polls = int(dominance_polls)
        self.publish_every = max(1, int(publish_every))
        self._t: dict[str, _Tenant] = {}
        # the pool gauge integrated over the SAME poll instants the
        # per-tenant grants are sampled at — the conservation oracle's
        # independent side (sum-of-per-tenant must equal this)
        self.pool_page_seconds = 0.0
        self.polls = 0
        self.noisy_total = 0
        self.noisy: list[dict] = []          # bounded episode log
        self._streak: dict[tuple, int] = {}  # (metric, tenant) -> polls
        self._fired: set[tuple] = set()      # episodes already reported

    # ------------------------------------------------------------ keys
    def _key(self, tenant) -> str:
        if tenant is None:
            return UNTAGGED
        t = str(tenant)
        if t in self._t or len(self._t) < self.max_tenants:
            return t
        return OTHER   # cardinality cap: fold the long tail

    def _rec(self, tenant) -> _Tenant:
        k = self._key(tenant)
        r = self._t.get(k)
        if r is None:
            r = self._t[k] = _Tenant()
        return r

    # ----------------------------------------------------------- hooks
    def on_submit(self, tenant) -> None:
        self._rec(tenant).requests += 1

    def on_prefill(self, tenant, n: int) -> None:
        if n:
            self._rec(tenant).prefill_tokens += int(n)

    def on_decode(self, tenant, n: int = 1) -> None:
        if n:
            self._rec(tenant).decode_tokens += int(n)

    def on_spec_accepted(self, tenant, n: int) -> None:
        if n:
            self._rec(tenant).spec_accepted_tokens += int(n)

    def on_prefix_hit(self, tenant, tokens: int,
                      bytes_saved: int = 0) -> None:
        if tokens:
            r = self._rec(tenant)
            r.prefix_hit_tokens += int(tokens)
            r.prefix_hit_bytes += int(bytes_saved)

    def on_queue_wait(self, tenant, ms: float) -> None:
        self._rec(tenant).queue_wait_ms.add(float(ms))

    def on_ttft(self, tenant, ms: float) -> None:
        self._rec(tenant).ttft_ms.add(float(ms))

    def on_shed(self, tenant) -> None:
        self._rec(tenant).sheds += 1

    def on_expired(self, tenant) -> None:
        self._rec(tenant).expiries += 1

    def on_retry(self, tenant) -> None:
        self._rec(tenant).retries += 1

    # ------------------------------------------------- per-poll observe
    def observe_poll(self, pages_by_tenant: dict, queue_by_tenant: dict,
                     dt: float, pool_pages: int = 0) -> None:
        """One engine poll tick: integrate page-seconds (per tenant AND
        the independent pool gauge, over the same ``dt``), then run the
        dominance detector over this poll's queue/page shares."""
        self.polls += 1
        if dt > 0:
            for ten, n in pages_by_tenant.items():
                if n:
                    self._rec(ten).page_seconds += n * dt
            if pool_pages:
                self.pool_page_seconds += pool_pages * dt
        self._observe_dominance(pages_by_tenant, queue_by_tenant)
        if self.polls % self.publish_every == 0:
            self.publish_gauges()

    def _observe_dominance(self, pages_by, queue_by) -> None:
        # a tenant alone on the engine is not a noisy neighbour — it
        # has no neighbours.  Require >= 2 distinct live tenants
        # (queue + pages combined) before any share counts.
        live = {self._key(t) for t, v in queue_by.items() if v} \
            | {self._key(t) for t, v in pages_by.items() if v}
        eligible = len(live) >= 2
        for metric, counts in (("queue", queue_by), ("pages", pages_by)):
            total = sum(counts.values())
            dominators = set()
            shares = {}
            if eligible and total > 0:
                for ten, n in counts.items():
                    k = self._key(ten)
                    share = n / total
                    if share >= self.dominance_threshold:
                        dominators.add(k)
                        shares[k] = share
            # streaks reset the first poll a tenant is NOT dominating
            # — consecutive means consecutive — and the episode
            # re-arms for the next sustained run
            for key in [k for k in self._streak if k[0] == metric
                        and k[1] not in dominators]:
                del self._streak[key]
                self._fired.discard(key)
            for k in dominators:
                key = (metric, k)
                self._streak[key] = self._streak.get(key, 0) + 1
                if self._streak[key] >= self.dominance_polls \
                        and key not in self._fired:
                    self._fired.add(key)
                    self.noisy_total += 1
                    ep = {"tenant": k, "metric": metric,
                          "share": round(shares[k], 4),
                          "streak": self._streak[key],
                          "poll": self.polls}
                    self.noisy.append(ep)
                    del self.noisy[:-64]
                    events.emit("serving_noisy_tenant", name=self.name,
                                **ep)

    # ------------------------------------------------------ aggregation
    def tenants(self) -> list[str]:
        return sorted(self._t)

    def counters(self) -> dict:
        """Full-cardinality {tenant: {counter: value}} snapshot — the
        conservation oracles read this, not the top-K export."""
        return {k: self._t[k].counters() for k in sorted(self._t)}

    def totals(self) -> dict:
        """Resource sums across every tracked tenant (the side the
        gate compares against the engine's untagged counters)."""
        out = {c: 0 for c in _COUNTERS}
        out["page_seconds"] = 0.0
        for r in self._t.values():
            for c in _COUNTERS:
                out[c] += getattr(r, c)
            out["page_seconds"] += r.page_seconds
        return out

    def _ranked(self) -> list[str]:
        """Tenants by token volume (prefill+decode) desc, name asc."""
        return sorted(
            self._t,
            key=lambda k: (-(self._t[k].prefill_tokens
                             + self._t[k].decode_tokens), k))

    def export_rows(self) -> list[tuple[str, dict]]:
        """Bounded-cardinality export: the top-``top_k`` tenants by
        token volume, then ONE aggregated ``other`` row folding
        everything else (counter sums, merged reservoirs)."""
        ranked = self._ranked()
        head, tail = ranked[:self.top_k], ranked[self.top_k:]
        rows = []
        for k in head:
            rows.append((k, self._row(self._t[k])))
        if tail:
            agg = _Tenant()
            for k in tail:
                r = self._t[k]
                for c in _COUNTERS:
                    setattr(agg, c, getattr(agg, c) + getattr(r, c))
                agg.page_seconds += r.page_seconds
            agg.ttft_ms = _Reservoir.merged(
                [self._t[k].ttft_ms for k in tail], seed=4)
            agg.queue_wait_ms = _Reservoir.merged(
                [self._t[k].queue_wait_ms for k in tail], seed=5)
            rows.append((OTHER, self._row(agg)))
        return rows

    @staticmethod
    def _row(r: _Tenant) -> dict:
        rnd = lambda res, q: (round(v, 4)
                              if (v := res.percentile(q)) is not None
                              else None)
        out = r.counters()
        out["page_seconds"] = round(out["page_seconds"], 6)
        out.update(
            ttft_ms_p50=rnd(r.ttft_ms, 50),
            ttft_ms_p99=rnd(r.ttft_ms, 99),
            queue_wait_ms_p50=rnd(r.queue_wait_ms, 50),
            queue_wait_ms_p99=rnd(r.queue_wait_ms, 99),
        )
        return dict(sorted(out.items()))

    def metrics(self) -> dict:
        """Sorted, JSON-serializable snapshot (bounded: top-K +
        other rows, recent noisy episodes)."""
        return {
            "by_tenant": dict(self.export_rows()),
            "noisy_events_total": self.noisy_total,
            "noisy_recent": list(self.noisy),
            "polls": self.polls,
            "pool_page_seconds": round(self.pool_page_seconds, 6),
            "tenants_tracked": len(self._t),
        }

    # -------------------------------------------------------- lifecycle
    @classmethod
    def merged(cls, name: str, parts) -> "TenantMeter":
        """Fleet-wide view: counter sums per tenant (full cardinality,
        re-capped at this meter's ``max_tenants``), reservoirs merged
        seen-weighted and deterministically — the same machinery
        ``ServingMetrics.merged`` uses for the untagged plane."""
        parts = list(parts)
        proto = parts[0] if parts else cls()
        out = cls(name=name, top_k=proto.top_k,
                  max_tenants=proto.max_tenants,
                  dominance_threshold=proto.dominance_threshold,
                  dominance_polls=proto.dominance_polls,
                  publish_every=proto.publish_every)
        keys = sorted({k for p in parts for k in p._t})
        for k in keys:
            recs = [p._t[k] for p in parts if k in p._t]
            dst = out._rec(k)
            for c in _COUNTERS:
                setattr(dst, c,
                        getattr(dst, c) + sum(getattr(r, c)
                                              for r in recs))
            dst.page_seconds += sum(r.page_seconds for r in recs)
            dst.ttft_ms = _Reservoir.merged(
                [r.ttft_ms for r in recs]
                + ([dst.ttft_ms] if dst.ttft_ms.seen else []), seed=1)
            dst.queue_wait_ms = _Reservoir.merged(
                [r.queue_wait_ms for r in recs]
                + ([dst.queue_wait_ms] if dst.queue_wait_ms.seen
                   else []), seed=2)
        out.pool_page_seconds = sum(p.pool_page_seconds for p in parts)
        out.polls = sum(p.polls for p in parts)
        out.noisy_total = sum(p.noisy_total for p in parts)
        noisy = [dict(ep, replica=p.name) for p in parts
                 for ep in p.noisy]
        out.noisy = noisy[-64:]
        return out

    def reset(self) -> None:
        self._t.clear()
        self.pool_page_seconds = 0.0
        self.polls = self.noisy_total = 0
        self.noisy.clear()
        self._streak.clear()
        self._fired.clear()

    def close(self) -> None:
        """Unregister this meter's gauge family (session churn must
        not grow the registry forever)."""
        try:
            from ..framework.monitor import stat_registry
            stat_registry.unregister(prefix=f"tenant_{self.name}_")
        except Exception:  # noqa: BLE001
            pass

    # ----------------------------------------------------------- gauges
    def publish_gauges(self) -> None:
        """Publish the bounded top-K+other export as LABELED gauges
        (``tenant_<name>_<meter>{tenant="..."}``).  Stale label sets
        (a tenant dropping out of the top-K) unregister first, so the
        scrape face always reflects exactly the current export."""
        if not events.enabled():
            return
        try:
            from ..framework.monitor import (prom_labeled_name,
                                             stat_registry)
            pre = f"tenant_{self.name}_"
            stat_registry.unregister(prefix=pre)
            reg = stat_registry.register
            for label, row in self.export_rows():
                for c in _COUNTERS:
                    reg(prom_labeled_name(pre + c + "_total",
                                          tenant=label)).set(row[c])
                reg(prom_labeled_name(pre + "page_seconds_total",
                                      tenant=label),
                    "float").set(row["page_seconds"])
                for fam in ("ttft_ms_p50", "ttft_ms_p99",
                            "queue_wait_ms_p50", "queue_wait_ms_p99"):
                    if row[fam] is not None:
                        reg(prom_labeled_name(pre + fam, tenant=label),
                            "float").set(row[fam])
            reg(pre + "tracked").set(len(self._t))
            reg(pre + "noisy_events_total").set(self.noisy_total)
            reg(pre + "pool_page_seconds_total", "float").set(
                self.pool_page_seconds)
        except Exception:  # noqa: BLE001
            pass
