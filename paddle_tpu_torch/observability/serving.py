"""Serving-plane metrics of the port's generation sessions and the
scheduler above them: paddle_tpu/observability/serving.py without the
fleet merge and the resilience counters (retries, failures), which come
with the serving-resilience slice.

Host-side only: per-request time-to-first-token, per-token decode
latency over LIVE rows (eos-frozen and cache-full rows emit pad filler
but add neither tokens nor samples), admission wait, rejects, expiries,
queue depth, evictions and stall evictions, the speculative lane's
proposals, accepts, emitted tokens and residual resamples and, for a
paged session, the KV page pool (total, free, shared). Latency
distributions keep a bounded, deterministically seeded reservoir
(algorithm R) and report p50/p99.

Counters accumulate unconditionally (they back ``session.metrics()`` and
``engine.metrics()``); with telemetry on (``PADDLE_TPU_TELEMETRY=1``,
``events.set_enabled``) each hook also emits its JSONL event
(``serving_admit``, ``serving_prefill_chunk``, ``serving_reject``,
``serving_expired``, ``serving_spec``, ``page_alloc`` / ``page_free`` /
``page_share``, ``serving_evict``, ``serving_stall_evict``) and publishes
the ``serving_<name>_*`` gauges to ``framework.monitor``'s registry.
"""
from __future__ import annotations

import random
import time

from ..framework.monitor import stat_registry
from . import events

__all__ = ["ServingMetrics"]

RESERVOIR_CAP = 512


class _Reservoir:
    """Algorithm-R reservoir with a fixed seed: bounded memory, uniform
    over the stream, identical percentiles for identical runs."""

    def __init__(self, cap: int = RESERVOIR_CAP, seed: int = 0):
        self.cap = int(cap)
        self.seed = int(seed)
        self.seen = 0
        self._samples: list[float] = []
        self._sorted: list[float] | None = None
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        self.seen += 1
        self._sorted = None
        if len(self._samples) < self.cap:
            self._samples.append(float(x))
            return
        j = self._rng.randrange(self.seen)
        if j < self.cap:
            self._samples[j] = float(x)

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile (q in [0, 100]); None when empty."""
        if not self._samples:
            return None
        if self._sorted is None:
            self._sorted = sorted(self._samples)
        s = self._sorted
        k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[k]

    def reset(self) -> None:
        self.seen = 0
        self._samples.clear()
        self._sorted = None
        self._rng = random.Random(self.seed)


class ServingMetrics:
    def __init__(self, name: str = "session", max_slots: int = 0):
        self.name = str(name)
        self.max_slots = int(max_slots)
        self._occupied = 0
        # paged KV pool snapshot; a dense session never feeds it, so its
        # metrics() keep exactly the dense keys
        self.kv_pages_total = self.kv_pages_free = self.kv_pages_shared = 0
        self._paged_seen = False
        # survives reset(): once a session has spec-ticked its spec gauges
        # keep publishing (zeros after a reset)
        self._spec_seen = False
        self._ttft_ms = _Reservoir(seed=1)
        self._queue_wait_ms = _Reservoir(seed=2)
        self._decode_ms_tok = _Reservoir(seed=3)
        self.reset()

    # ------------------------------------------------------------- hooks
    def admitted(self, n: int, prefill_s: float, occupied: int,
                 queue_wait_s: float = 0.0) -> None:
        self.requests_admitted += n
        self.admissions += 1
        self.prefill_s += prefill_s
        self.queue_wait_s += queue_wait_s * n
        self._queue_wait_ms.add(queue_wait_s * 1e3)
        self._occupied = occupied
        events.emit("serving_admit", name=self.name, n=n,
                    prefill_ms=round(prefill_s * 1e3, 3),
                    queue_wait_ms=round(queue_wait_s * 1e3, 3),
                    occupied=occupied, max_slots=self.max_slots)

    def prefill_tick(self, wall_s: float, rows: int = 1) -> None:
        """One chunk tick advancing ``rows`` prompts by a chunk; fused
        chunk+decode ticks pass ``wall_s=0`` since their wall is charged
        once, to :meth:`tick`."""
        self.prefill_s += wall_s
        self.prefill_chunks += 1
        events.emit("serving_prefill_chunk", name=self.name, rows=rows,
                    wall_ms=round(wall_s * 1e3, 3))

    def rejected(self, n: int = 1) -> None:
        self.requests_rejected += n
        events.emit("serving_reject", name=self.name, n=n,
                    occupied=self._occupied, max_slots=self.max_slots)
        self._publish_gauges()

    def expired(self, n: int = 1) -> None:
        """Deadline-expired requests dropped before any prefill."""
        self.requests_expired += n
        events.emit("serving_expired", name=self.name, n=n,
                    occupied=self._occupied, max_slots=self.max_slots)
        self._publish_gauges()

    def set_queue_depth(self, depth: int) -> None:
        self.queue_depth = int(depth)

    def tick(self, wall_s: float, emitted: int) -> None:
        """One decode tick in which ``emitted`` live rows produced a real
        token; an all-frozen tick charges no latency."""
        self.decode_ticks += 1
        if emitted > 0:
            self.decode_s += wall_s
            self.tokens_emitted += emitted
            self._decode_ms_tok.add(wall_s / emitted * 1e3)
        self._publish_gauges()

    def spec(self, proposed: int, accepted: int, rows: int,
             emitted: int | None = None, resampled: int = 0,
             mode: str = "greedy") -> None:
        """One speculative tick: ``rows`` live rows got ``proposed`` draft
        proposals, ``accepted`` of them survived verification (greedy:
        argmax equality; stochastic: the u < p/q test). ``emitted`` is the
        tick's real output; greedy ticks leave it None (rows + accepted),
        stochastic ticks pass it, since a row may emit its pending residual
        without a fresh accept, or nothing on a fresh row-0 rejection.
        ``resampled`` counts residual resamples drawn; ``mode`` names the
        lane (``greedy`` or ``stochastic``) in the event."""
        self.spec_ticks += 1
        self._spec_seen = True
        self.spec_rows_total += rows
        self.spec_proposed_total += proposed
        self.spec_accepted_total += accepted
        if emitted is None:
            emitted = rows + accepted
        self.spec_emitted_total += emitted
        self.spec_resample_total += resampled
        events.emit("serving_spec", name=self.name, rows=rows,
                    proposed=proposed, accepted=accepted, emitted=emitted,
                    resampled=resampled, mode=mode)
        self._publish_gauges()

    def kv_pages(self, total: int, free: int, shared: int,
                 event: str | None = None, **kw) -> None:
        """Paged-KV pool snapshot from the session's allocator: ``total``
        / ``free`` / ``shared`` pages (shared = more than one reader).
        ``event`` names the transition (``page_alloc``, ``page_free``,
        ``page_share``) and ``kw`` its details, which ride in its JSONL
        event."""
        self.kv_pages_total = int(total)
        self.kv_pages_free = int(free)
        self.kv_pages_shared = int(shared)
        self._paged_seen = True
        if event is not None:
            events.emit(event, name=self.name, total=int(total),
                        free=int(free), shared=int(shared), **kw)
        self._publish_gauges()

    def first_token(self, admit_t: float) -> None:
        ttft = time.perf_counter() - admit_t
        self.ttft_sum_s += ttft
        self.ttft_last_s = ttft
        self.ttft_n += 1
        self._ttft_ms.add(ttft * 1e3)

    def evicted(self, occupied: int) -> None:
        self.evictions += 1
        self._occupied = occupied
        events.emit("serving_evict", name=self.name, occupied=occupied,
                    max_slots=self.max_slots)

    def stall_evicted(self, slot: int) -> None:
        """A starved scheduler expired a held slot to free capacity: a
        deliberate shed, apart from the finished-request evictions
        (:meth:`evicted` counted this slot too)."""
        self.stall_evictions += 1
        events.emit("serving_stall_evict", name=self.name, slot=int(slot),
                    occupied=self._occupied, max_slots=self.max_slots)
        self._publish_gauges()

    def reset(self) -> None:
        """Zero the accumulators (occupancy and identity stay) — e.g.
        after a warm-up wave, so TTFT reflects steady state."""
        self.requests_admitted = self.requests_rejected = 0
        self.requests_expired = self.stall_evictions = 0
        self.evictions = self.tokens_emitted = self.admissions = 0
        self.prefill_s = self.queue_wait_s = self.decode_s = 0.0
        self.decode_ticks = self.prefill_chunks = 0
        self.spec_proposed_total = self.spec_accepted_total = 0
        self.spec_ticks = self.spec_rows_total = 0
        self.spec_emitted_total = self.spec_resample_total = 0
        self.queue_depth = 0
        self.ttft_sum_s = self.ttft_last_s = 0.0
        self.ttft_n = 0
        for r in (self._ttft_ms, self._queue_wait_ms, self._decode_ms_tok):
            r.reset()

    def close(self) -> None:
        """Unregister this instance's gauges (the counters stay readable
        through :meth:`metrics`): a retired session leaves no gauge family
        in the process-wide registry."""
        stat_registry.unregister(prefix=f"serving_{self.name}_")

    # ----------------------------------------------------------- reading
    def metrics(self) -> dict:
        """Sorted, JSON-serializable snapshot."""
        toks = self.tokens_emitted
        rnd = lambda r, q: (round(v, 4)
                            if (v := r.percentile(q)) is not None else None)
        out = {
            "admissions": self.admissions,
            "decode_ms_per_token": round(self.decode_s / toks * 1e3, 4)
            if toks else None,
            "decode_ms_per_token_p50": rnd(self._decode_ms_tok, 50),
            "decode_ms_per_token_p99": rnd(self._decode_ms_tok, 99),
            "decode_ticks": self.decode_ticks,
            "decode_tokens_per_sec": round(toks / self.decode_s, 2)
            if self.decode_s > 0 else None,
            "evictions": self.evictions,
            "prefill_chunks": self.prefill_chunks,
            "prefill_ms_total": round(self.prefill_s * 1e3, 3),
            "queue_depth": self.queue_depth,
            "queue_wait_ms_mean": round(
                self.queue_wait_s / self.requests_admitted * 1e3, 3)
            if self.requests_admitted else None,
            "queue_wait_ms_p50": rnd(self._queue_wait_ms, 50),
            "queue_wait_ms_p99": rnd(self._queue_wait_ms, 99),
            "requests_admitted": self.requests_admitted,
            "requests_expired": self.requests_expired,
            "requests_rejected": self.requests_rejected,
            "slot_occupancy": round(self._occupied / self.max_slots, 4)
            if self.max_slots else None,
            "slots_occupied": self._occupied,
            "stall_evictions": self.stall_evictions,
            # accepted / proposed draft tokens
            "spec_accept_rate": round(
                self.spec_accepted_total / self.spec_proposed_total, 4)
            if self.spec_proposed_total else None,
            "spec_accepted_total": self.spec_accepted_total,
            "spec_emitted_total": self.spec_emitted_total,
            "spec_proposed_total": self.spec_proposed_total,
            "spec_resample_total": self.spec_resample_total,
            "spec_ticks": self.spec_ticks,
            # the tokens a live row emits a spec tick (1.0 = plain decode)
            "spec_tokens_per_row_tick": round(
                self.spec_emitted_total / self.spec_rows_total, 4)
            if self.spec_rows_total else None,
            "tokens_emitted": toks,
            "ttft_ms_last": round(self.ttft_last_s * 1e3, 3)
            if self.ttft_n else None,
            "ttft_ms_mean": round(self.ttft_sum_s / self.ttft_n * 1e3, 3)
            if self.ttft_n else None,
            "ttft_ms_p50": rnd(self._ttft_ms, 50),
            "ttft_ms_p99": rnd(self._ttft_ms, 99),
        }
        if self._paged_seen:
            out["kv_pages_total"] = self.kv_pages_total
            out["kv_pages_free"] = self.kv_pages_free
            out["kv_pages_shared"] = self.kv_pages_shared
        return dict(sorted(out.items()))

    def _publish_gauges(self) -> None:
        """The ``serving_<name>_*`` gauges (telemetry on only): the
        reference's set, less the resilience slice's failures and
        retries."""
        if not events.enabled():
            return
        p = f"serving_{self.name}"
        reg = stat_registry.register
        for key, v in (("tokens_emitted", self.tokens_emitted),
                       ("requests_admitted", self.requests_admitted),
                       ("requests_rejected", self.requests_rejected),
                       ("requests_expired", self.requests_expired),
                       ("queue_depth", self.queue_depth),
                       ("evictions", self.evictions),
                       ("stall_evictions", self.stall_evictions),
                       ("slots_occupied", self._occupied)):
            reg(f"{p}_{key}").set(v)
        if self._paged_seen:
            reg(f"{p}_kv_pages_total").set(self.kv_pages_total)
            reg(f"{p}_kv_pages_free").set(self.kv_pages_free)
            reg(f"{p}_kv_pages_shared").set(self.kv_pages_shared)
        if self._spec_seen:
            reg(f"{p}_spec_proposed_total").set(self.spec_proposed_total)
            reg(f"{p}_spec_accepted_total").set(self.spec_accepted_total)
            reg(f"{p}_spec_emitted_total").set(self.spec_emitted_total)
            reg(f"{p}_spec_resample_total").set(self.spec_resample_total)
            if self.spec_proposed_total:
                reg(f"{p}_spec_accept_rate", "float").set(
                    self.spec_accepted_total / self.spec_proposed_total)
            if self.spec_rows_total:
                reg(f"{p}_spec_tokens_per_row_tick", "float").set(
                    self.spec_emitted_total / self.spec_rows_total)
        if self.tokens_emitted and self.decode_s > 0:
            reg(f"{p}_decode_ms_per_token", "float").set(
                self.decode_s / self.tokens_emitted * 1e3)
            reg(f"{p}_tokens_per_sec", "float").set(
                self.tokens_emitted / self.decode_s)
        if self.ttft_n:
            reg(f"{p}_ttft_ms_last", "float").set(self.ttft_last_s * 1e3)
            # percentiles sort the reservoir: refreshed every 32nd tick and
            # on the first sample, not every tick
            if self.decode_ticks % 32 == 0 or self.ttft_n == 1:
                for q in (50, 99):
                    v = self._ttft_ms.percentile(q)
                    if v is not None:
                        reg(f"{p}_ttft_ms_p{q}", "float").set(v)
