"""Serving-plane counters and latency percentiles for generation sessions
and the scheduler above them (the counter and percentile half of
paddle_tpu/observability/serving.py; gauges and JSONL events come with
the telemetry slice).

Host-side only: per-request time-to-first-token, per-token decode
latency over LIVE rows (eos-frozen and cache-full rows emit pad filler
but add neither tokens nor samples), admission wait, rejects, expiries,
queue depth, evictions, the speculative lane's proposals, accepts,
emitted tokens and residual resamples and, for a paged session, the KV
page pool (total, free, shared). Latency distributions keep a bounded,
deterministically seeded reservoir (algorithm R) and report p50/p99.
"""
from __future__ import annotations

import random
import time

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

    def prefill_tick(self, wall_s: float) -> None:
        """One chunked/suffix prefill call; fused chunk+decode ticks pass
        ``wall_s=0`` since their wall is charged once, to :meth:`tick`."""
        self.prefill_s += wall_s
        self.prefill_chunks += 1

    def rejected(self, n: int = 1) -> None:
        self.requests_rejected += n

    def expired(self, n: int = 1) -> None:
        """Deadline-expired requests dropped before any prefill."""
        self.requests_expired += n

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

    def spec(self, proposed: int, accepted: int, rows: int,
             emitted: int | None = None, resampled: int = 0) -> None:
        """One speculative tick: ``rows`` live rows got ``proposed`` draft
        proposals, ``accepted`` of them survived verification (greedy:
        argmax equality; stochastic: the u < p/q test). ``emitted`` is the
        tick's real output; greedy ticks leave it None (rows + accepted),
        stochastic ticks pass it, since a row may emit its pending residual
        without a fresh accept, or nothing on a fresh row-0 rejection.
        ``resampled`` counts residual resamples drawn. (The reference also
        emits a ``serving_spec`` JSONL event here; it comes with the
        events slice.)"""
        self.spec_ticks += 1
        self.spec_rows_total += rows
        self.spec_proposed_total += proposed
        self.spec_accepted_total += accepted
        self.spec_emitted_total += rows + accepted if emitted is None \
            else emitted
        self.spec_resample_total += resampled

    def kv_pages(self, total: int, free: int, shared: int,
                 event: str | None = None, **kw) -> None:
        """Paged-KV pool snapshot from the session's allocator: ``total``
        / ``free`` / ``shared`` pages (shared = more than one reader).
        ``event`` names the transition (``page_alloc``, ``page_free``,
        ``page_share``) and ``kw`` its details; they feed the JSONL event
        of the telemetry slice and are not kept here."""
        self.kv_pages_total = int(total)
        self.kv_pages_free = int(free)
        self.kv_pages_shared = int(shared)
        self._paged_seen = True

    def first_token(self, admit_t: float) -> None:
        ttft = time.perf_counter() - admit_t
        self.ttft_sum_s += ttft
        self.ttft_last_s = ttft
        self.ttft_n += 1
        self._ttft_ms.add(ttft * 1e3)

    def evicted(self, occupied: int) -> None:
        self.evictions += 1
        self._occupied = occupied

    def reset(self) -> None:
        """Zero the accumulators (occupancy and identity stay) — e.g.
        after a warm-up wave, so TTFT reflects steady state."""
        self.requests_admitted = self.requests_rejected = 0
        self.requests_expired = 0
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
