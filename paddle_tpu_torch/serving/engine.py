"""Continuous-batching serving engine — the scheduler between user requests
and a ``GenerationSession``. Port of paddle_tpu/serving/engine.py:

- a bounded request queue: lower ``priority`` first, earliest deadline
  first within a lane, FIFO tiebreak; a full queue rejects loudly at
  submit (:class:`QueueFull`), and a request whose deadline passes
  while queued is dropped at the admission edge, before any prefill;
- whole-prompt admission (``prefill_chunk=0``: the prompt prefills in
  one finalizing chunk) or chunked prefill interleaved with decode
  (``prefill_chunk>0``): each :meth:`poll` advances every partial prompt
  by one chunk and decodes every live row (``session.fused_tick``), so a
  long prompt never stalls the decode batch;
- width buckets (``width_buckets``): a tick's chunk batch runs at the
  smallest bucket that fits its longest piece, one captured graph per
  bucket, so a short suffix pays a narrow tick; and prefill batching
  (``prefill_min_batch``, ``prefill_max_defer``): admissions may wait a
  few ticks so the fixed-cost chunk half serves a fuller cohort;
- :meth:`prewarm` captures the session's graphs for every bucket before
  traffic (in the background if asked);
- full-occupancy decode: every poll fills freed slots first; a starved
  :meth:`run` (every slot held by work this engine does not own) expires
  the longest-held foreign slot (``stall_evictions``);
- speculative sessions (``session.spec_k > 1``): the poll's tick is
  ``spec_tick`` / ``spec_step`` and a row may emit several tokens, cut at
  eos and at the request's budget; ``submit(temperature=, seed=)`` sets a
  request's sampling lane on a session with the stochastic lane;
- prefix KV reuse (``prefix_cache_blocks > 0``): admission copies the
  longest pooled block-aligned prefix into the slot and prefills only the
  tail; a finalized prompt's full blocks are offered to the pool
  (second-touch promotion). On a paged session pool entries are
  by-reference page spans and the slot's page grant is sized to the
  request (``need_tokens``); page exhaustion requeues like slot
  exhaustion;
- the resilience plane (``resilience=ResiliencePolicy(...)``, see
  ``resilience.py``): SLO-driven load shedding and a brownout ladder at
  the admission edge; :meth:`requeue` re-enqueues an evicted in-flight
  request with its generated tokens (bounded retry budget, jittered
  backoff, exhaustion a loud FAILED), and a request that another
  engine's stall-evict shed is reclaimed that way; the crash journal
  (one flush a poll) lets :func:`~.resilience.replay_journal` re-admit
  every in-flight request on a fresh engine through :meth:`resume`;
- tenant metering (``metering=True`` or a ``TenantMeter``, or
  ``PADDLE_TPU_TENANT_METERING=1``): tokens, latencies, sheds, prefix
  hits and KV page-seconds charged to each request's ``tenant``;
- request tracing (``PADDLE_TPU_TRACING=1``): lifecycle spans with
  parent links across retry, handoff and crash incarnations, and the
  flight recorder.

Every plane is host-side: no plane reads the device, copies to it or
changes a tick body, so the captured graphs and streams are the plain
engine's.
"""
from __future__ import annotations

import heapq
import threading
import time

import numpy as np

from ..device import resolve_device
from ..observability import resilience as obs_resil
from ..observability import tracing
from ..observability.metering import TenantMeter, metering_env_default
from .prefix_cache import PrefixCache
from .request import Request, RequestState
from .resilience import RequestShed

__all__ = ["ServingEngine", "QueueFull"]


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the submit was refused, nothing was
    enqueued. The rejected request rides along for inspection."""

    def __init__(self, request: Request, max_queue: int):
        self.request = request
        super().__init__(
            f"serving queue full ({max_queue} requests) — request "
            f"{request.request_id} rejected; retry later or raise "
            "max_queue")


class _Prewarm(threading.Thread):
    """``session.prewarm_programs(**kw)`` on a daemon thread, keeping its
    result or the exception it raised for the engine's next poll."""

    def __init__(self, session, kw):
        super().__init__(name="paddle-tpu-prewarm", daemon=True)
        self.session, self.kw = session, kw
        self.result = self.error = None

    def run(self):
        try:
            self.result = self.session.prewarm_programs(**self.kw)
        except Exception as e:  # noqa: BLE001 — re-raised by the next poll
            self.error = e


class ServingEngine:
    """Iteration-level request scheduler over a ``GenerationSession``.

    >>> eng = ServingEngine(sess, max_queue=64, prefill_chunk=64,
    ...                     prefix_cache_blocks=32)
    >>> req = eng.submit(prompt_tokens, max_new_tokens=32)
    >>> eng.run()                      # tick until drained
    >>> req.output                     # generated token ids
    """

    # consecutive zero-progress polls before run() declares starvation
    # (requests queued, every slot held by work this engine does not own)
    STALL_LIMIT = 1000

    def __init__(self, session, max_queue: int = 64,
                 prefill_chunk: int = 0, clock=time.perf_counter,
                 device=None, prefix_cache_blocks: int = 0,
                 width_buckets=None, prefix_promote_after: int = 2,
                 prefill_min_batch: int = 1, prefill_max_defer: int = 4,
                 resilience=None, max_retries: int = 2,
                 retry_backoff_s: float = 0.05, metering=None):
        dev = resolve_device(device)
        if dev.type != session.device.type:
            raise ValueError(f"engine device {dev} differs from the "
                             f"session's {session.device}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_retries < 0 or retry_backoff_s < 0:
            raise ValueError(
                f"need max_retries >= 0 (got {max_retries}) and "
                f"retry_backoff_s >= 0 (got {retry_backoff_s})")
        self.session = session
        self.max_queue = int(max_queue)
        self.clock = clock
        self.chunked = prefill_chunk > 0
        # the chunk width: the configured piece size, or the whole
        # (admission-width) prompt in one finalizing chunk
        self.width = int(prefill_chunk) if self.chunked \
            else int(session.max_prompt_len)
        if self.width < 1:
            raise ValueError(f"prefill chunk width must be >= 1, got "
                             f"{self.width}")
        # each tick's chunk batch runs at the SMALLEST bucket that fits its
        # longest piece: one captured graph per bucket, so keep the set
        # small
        buckets = {int(b) for b in (width_buckets or ())}
        bad = [b for b in buckets if not 0 < b <= self.width]
        if bad:
            raise ValueError(
                f"width_buckets {sorted(bad)} invalid: every bucket "
                f"must be in [1, {self.width}] (the admission width — "
                "wider programs would never be picked)")
        buckets.add(self.width)
        self.width_buckets = tuple(sorted(buckets))
        # prefill batching: the chunk half of a tick costs the same for 1
        # or max_slots rows (fixed shapes), so admissions may DEFER their
        # first chunk until prefill_min_batch partials wait, for at most
        # prefill_max_defer ticks, and never when the decode batch has
        # nothing else to do. 1 = every poll runs the chunk half
        if prefill_min_batch < 1 or prefill_max_defer < 0:
            raise ValueError(
                f"need prefill_min_batch >= 1 (got {prefill_min_batch}) "
                f"and prefill_max_defer >= 0 (got {prefill_max_defer})")
        self.prefill_min_batch = int(prefill_min_batch)
        self.prefill_max_defer = int(prefill_max_defer)
        self._defer_ticks = 0   # polls the oldest pending partial waited
        self.prefix_cache = None
        if prefix_cache_blocks > 0:
            # a paged session's entries are by-reference PageSpans: LRU
            # eviction hands them back to the session's page refcounts
            self.prefix_cache = PrefixCache(
                block=session.cfg.decode_block,
                max_blocks=prefix_cache_blocks,
                promote_after=prefix_promote_after,
                on_release=session.release_pooled_entry
                if session.kv_paged else None)
        self._tm = session.telemetry
        self._heap: list[tuple] = []    # (sched_key, Request)
        self._queued = 0
        # slot -> [req, next_off, work] — work is the token array this
        # admission makes resident: the prompt, or prompt+generated for
        # a requeued/resumed request (resume_tokens)
        self._partials: dict[int, list] = {}
        self._by_slot: dict[int, Request] = {}  # slot -> decoding req
        self._requests: list[Request] = []
        self._closed = False
        self._prewarm_thread = None
        # ---- resilience plane (all host-side; None = no policy) ----
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._ticks = 0                 # poll counter (chaos @tick key)
        self._delayed: list[tuple] = []  # (not_before, seq, req) heap
        self.resil = resilience
        if resilience is not None:
            resilience.bind(self)
        # ---- tenant metering (host-side only, default off) ----
        # metering= takes a TenantMeter (shared or preconfigured), True
        # (a fresh meter), False (off) or None (PADDLE_TPU_TENANT_METERING).
        # The meter also attaches to the session, whose token accounting
        # charges each prefill, decode and spec token to the slot's tenant
        # stamp where the untagged counters count it.
        if metering is None:
            metering = metering_env_default()
        if metering is True:
            metering = TenantMeter(name=self._tm.name)
        self.meter = metering if isinstance(metering, TenantMeter) \
            else None
        self._meter_last_t: float | None = None
        if self.meter is not None:
            session.attach_meter(self.meter)

    def prewarm(self, background: bool = False):
        """Capture the session's tick graphs for every width bucket (the
        decode or spec tick, and per bucket the chunk tick and the fused
        one) before traffic, so no request pays a warm-up tick or a
        capture (``session.prewarm_programs``; no stream changes). The
        reference warms its chunk programs in chunked mode only; the port
        warms the buckets in both modes, since a whole-prompt tick runs
        them too. Returns the session's ``{"programs", "loaded"}`` dict,
        or with ``background=True`` the thread that captures; the next
        :meth:`poll` joins it first (no capture overlaps a replay) and
        raises what it raised."""
        if self._prewarm_thread is not None:
            self._join_prewarm()
        blocks = ((self.session.cfg.decode_block,)
                  if self.prefix_cache is not None else ())
        kw = dict(widths=self.width_buckets, blocks=blocks)
        if not background:
            return self.session.prewarm_programs(**kw)
        self._prewarm_thread = _Prewarm(self.session, kw)
        self._prewarm_thread.start()
        return self._prewarm_thread

    def _join_prewarm(self) -> None:
        t, self._prewarm_thread = self._prewarm_thread, None
        t.join()
        if t.error is not None:
            raise RuntimeError("prewarm failed") from t.error

    @property
    def _journal(self):
        return self.resil.journal if self.resil is not None else None

    def _journal_flush(self) -> None:
        j = self._journal
        if j is not None:
            j.flush()

    # ------------------------------------------------------------ submit
    def submit(self, tokens, max_new_tokens: int = 32, priority: int = 0,
               deadline: float | None = None,
               request_id: str | None = None,
               temperature: float | None = None,
               seed: int | None = None,
               tenant: str | None = None) -> Request:
        """Enqueue one request; raises :class:`QueueFull` when the
        bounded queue is at capacity (backpressure is LOUD — a silent
        drop would read as an infinitely-slow request).

        ``temperature``/``seed`` set the request's sampling lane on a
        stochastic-spec session (``spec_sample``); ``temperature=None``
        means the SESSION's default (so a session built hot samples
        every request unless told otherwise), and a non-zero
        temperature on a session without the lane raises loudly —
        silently decoding greedy would misreport the distribution the
        caller asked for.  ``seed=None`` picks a deterministic
        per-request default; the RESOLVED pair rides the crash
        journal, so replay reproduces the sampled continuation
        bit-identically."""
        if self._closed:
            raise RuntimeError("engine is closed")
        temperature = self._resolve_temp(temperature)
        req = Request(tokens=tokens, max_new_tokens=int(max_new_tokens),
                      priority=int(priority), deadline=deadline,
                      request_id=request_id,
                      temperature=float(temperature), seed=seed,
                      tenant=tenant)
        req.arrival_ts = self.clock()
        req.arrival_perf = time.perf_counter()
        if req.prompt_len >= self.session.max_len:
            raise ValueError(
                f"prompt ({req.prompt_len} tokens) leaves no room to "
                f"decode in the {self.session.max_len}-token cache")
        if not self.chunked and req.prompt_len > self.width:
            raise ValueError(
                f"prompt ({req.prompt_len} tokens) exceeds the "
                f"whole-prompt admission width ({self.width}) — "
                "construct the engine with prefill_chunk > 0")
        req.enqueued_ts = req.arrival_ts
        self._requests.append(req)   # rejected ones count too
        if self.resil is not None:
            # SLO shed / brownout gate — raises RequestShed (a LOUD
            # policy rejection at the admission edge) or clamps
            self.resil.admission_gate(req, req.arrival_ts)
        # trace starts HERE — past the shed gate (a policy rejection
        # never entered the system) but before the journal append, so
        # the submit record carries the context a crash replay resumes
        tracing.on_submit(self._tm.name, req)
        if self._queued >= self.max_queue:
            req.state = RequestState.REJECTED
            req.finished_ts = req.arrival_ts
            self._tm.rejected(1)
            if self.meter is not None:
                self.meter.on_shed(req.tenant)
            if self.resil is not None:
                self.resil.observe_terminal(req)
            tracing.on_finish(self._tm.name, req, "rejected")
            raise QueueFull(req, self.max_queue)
        heapq.heappush(self._heap, (req.sched_key(), req))
        self._queued += 1
        if self.meter is not None:
            self.meter.on_submit(req.tenant)
        j = self._journal
        if j is not None:
            j.push_submit(req)
            j.flush()
        self._tm.set_queue_depth(self._queued + len(self._delayed))
        return req

    def try_submit(self, tokens, **kw) -> Request | None:
        """:meth:`submit` that returns ``None`` instead of raising on a
        full queue or a resilience shed (both rejections still count —
        they are real sheds)."""
        try:
            return self.submit(tokens, **kw)
        except (QueueFull, RequestShed):
            return None

    def resume(self, tokens, generated, max_new_tokens: int,
               priority: int = 0, deadline: float | None = None,
               request_id: str | None = None,
               retries: int = 0, temperature: float = 0.0,
               seed: int | None = None, trace_ctx=None,
               tenant: str | None = None) -> Request:
        """Re-admit a request that already generated ``generated``
        tokens in a previous engine (crash-journal replay).  The
        request re-enters the queue carrying its output; admission
        re-prefills prompt+generated and decode continues the
        remaining budget — bit-identical for greedy sampling.  The
        resilience admission gate is deliberately SKIPPED (this work
        was already admitted once; recovery must not re-litigate it),
        but the bounded queue still applies.

        ``trace_ctx``: the ``(trace_id, parent_span_id)`` tuple the
        seam carried (journal record, KVHandoff, failover span) — the
        resumed incarnation continues the SAME trace, parented to the
        span that moved it here.  ``None`` when tracing is off."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if temperature:
            # resumed work carries its RESOLVED temperature (journal /
            # handoff record) — validate only, never re-default
            self._resolve_temp(temperature)
        req = Request(tokens=tokens, max_new_tokens=int(max_new_tokens),
                      priority=int(priority), deadline=deadline,
                      request_id=request_id,
                      temperature=float(temperature), seed=seed,
                      tenant=tenant)
        req.arrival_ts = self.clock()
        req.arrival_perf = time.perf_counter()
        req.enqueued_ts = req.arrival_ts
        req.output = [int(t) for t in generated]
        req.retries = int(retries)
        req.resumed_len = len(req.output)
        self._requests.append(req)
        work_len = req.prompt_len + len(req.output)
        if not self.chunked and work_len > self.width:
            raise ValueError(
                f"resumed work (prompt {req.prompt_len} + "
                f"{len(req.output)} generated tokens) exceeds the "
                f"whole-prompt admission width ({self.width}) — "
                "construct the engine with prefill_chunk > 0")
        tracing.on_resume(self._tm.name, req, trace_ctx)
        if len(req.output) >= req.max_new_tokens \
                or work_len >= self.session.max_len:
            # budget already spent (or cache already full at the kill):
            # nothing left to decode — terminal immediately
            req.state = RequestState.DONE
            req.finished_ts = req.arrival_ts
            self._on_terminal(req)
            self._journal_flush()
            return req
        if self._queued >= self.max_queue:
            req.state = RequestState.REJECTED
            req.finished_ts = req.arrival_ts
            self._tm.rejected(1)
            if self.resil is not None:
                self.resil.observe_terminal(req)
            tracing.on_finish(self._tm.name, req, "rejected")
            raise QueueFull(req, self.max_queue)
        heapq.heappush(self._heap, (req.sched_key(), req))
        self._queued += 1
        j = self._journal
        if j is not None:
            j.push_submit(req)   # carries the resumed output + trace
            j.flush()
        self._tm.set_queue_depth(self._queued + len(self._delayed))
        return req

    # --------------------------------------------------------- scheduling
    def _pop_best(self, now: float) -> Request | None:
        """Highest-priority / earliest-deadline / FIFO queued request;
        expired heads are dropped on the way (deadline-expiry costs
        zero prefill compute by construction — it happens before the
        request ever touches a slot)."""
        while self._heap:
            _, req = heapq.heappop(self._heap)
            self._queued -= 1
            if req.deadline is not None and now > req.deadline:
                req.state = RequestState.EXPIRED
                req.finished_ts = now
                self._tm.expired(1)
                if self.meter is not None:
                    self.meter.on_expired(req.tenant)
                self._on_terminal(req)
                continue
            return req
        return None

    def _on_terminal(self, req: Request) -> None:
        """Resilience bookkeeping for a request reaching ANY terminal
        state: journal the end record (so a crash replay never
        re-admits finished work), feed the SLO attainment ledger, and
        close the request's trace incarnation."""
        j = self._journal
        if j is not None:
            j.push_end(req)
        if self.resil is not None:
            self.resil.observe_terminal(req)
        tracing.on_finish(self._tm.name, req, req.state.value)

    def _release_due_retries(self, now: float) -> None:
        """Move backoff-expired requeued requests from the delay heap
        back into the admission queue (they keep their original
        scheduling key — a retry is not a priority bump)."""
        moved = False
        while self._delayed and self._delayed[0][0] <= now:
            _, _, req = heapq.heappop(self._delayed)
            heapq.heappush(self._heap, (req.sched_key(), req))
            self._queued += 1
            moved = True
        if moved:
            self._tm.set_queue_depth(self._queued + len(self._delayed))

    def _resolve_temp(self, temperature: float | None) -> float:
        """None is the session's own temperature (0.0 without the
        stochastic lane); a non-zero temperature needs the lane."""
        armed = self.session.spec_sample
        if temperature is None:
            return self.session.default_temperature if armed else 0.0
        if temperature and not armed:
            raise ValueError(
                f"temperature={temperature} needs the stochastic sampling "
                "lane — build the session with spec_decode >= 2 and "
                "spec_sample=True (or a non-zero session temperature)")
        return float(temperature)

    def _start(self, req: Request, slot: int, now: float) -> None:
        req.state = RequestState.PREFILLING
        req.slot = slot
        req.admitted_ts = now
        if self.session.spec_sample:
            # staged now; the finalizing chunk moves it to the device
            self.session.set_sampling(slot, req.temperature, req.seed)
        if self.resil is not None:
            self.resil.observe_queue_wait(
                req, max(0.0, now - req.enqueued_ts))
        if self.meter is not None:
            # slot ownership stamp: from here until evict, every token
            # and page-second this slot spends charges to req.tenant
            self.session.stamp_tenant(slot, req.tenant)
            self.meter.on_queue_wait(
                req.tenant, max(0.0, now - req.enqueued_ts) * 1e3)
        # the token array this admission makes resident: the prompt,
        # or prompt+generated for a requeued/resumed request — re-
        # prefilling the generated tokens writes the exact K/V decode
        # would have, so a greedy resume continues bit-identically
        work = req.resume_tokens()
        off = 0
        if self.prefix_cache is not None:
            # cap the match one token short: the last resident position
            # must prefill so its logits exist to start decode
            _, blocks = self.prefix_cache.match(
                work, max_prefix=work.shape[0] - 1)
            if blocks:
                off = self.session.copy_prefix_into(slot, blocks)
                req.prefix_hit_tokens = off
                if self.meter is not None:
                    self.meter.on_prefix_hit(
                        req.tenant, off,
                        off * self.session.kv_bytes_per_token())
        tracing.on_admit(self._tm.name, req, prefix_hit=off)
        self._partials[slot] = [req, off, work]

    def _collect_chunks(self):
        """Assemble this tick's chunk batch: every in-flight partial
        prompt advances by one chunk; last chunks finalize."""
        chunks, arrivals, waits, fins = [], {}, {}, []
        resumed = set()
        wmax = 1
        for slot, (req, off, work) in self._partials.items():
            end = min(off + self.width, work.shape[0])
            fin = end == work.shape[0]
            chunks.append((slot, work[off:end], off, fin))
            wmax = max(wmax, end - off)
            if fin:
                # TTFT is measured by ServingMetrics in the
                # perf_counter domain — feed it the perf stamp, not
                # the (possibly injected) engine-clock one
                arrivals[slot] = req.arrival_perf
                waits[slot] = max(0.0, req.admitted_ts - req.arrival_ts)
                if req.resumed_len > 0:
                    # re-admitted work that already emitted tokens:
                    # the session keeps the ownership stamp but must
                    # not record a second admission/TTFT sample
                    resumed.add(slot)
                fins.append((slot, req))
            else:
                self._partials[slot][1] = end
        # smallest bucket that fits this tick's longest piece
        width = next((b for b in self.width_buckets if b >= wmax),
                     self.width)
        return chunks, width, arrivals, waits, resumed, fins

    def _absorb_fins(self, fins) -> None:
        for slot, req in fins:
            del self._partials[slot]
            req.state = RequestState.DECODING
            self._by_slot[slot] = req
            tracing.on_decoding(self._tm.name, req)
            if self.prefix_cache is not None and not (
                    self.resil is not None
                    and self.resil.prefix_writes_suspended()):
                # pool every full block of the now-resident prompt so
                # the NEXT request sharing this prefix skips its compute
                # (ONE span read for the contiguous missing tail)
                n = self.prefix_cache.insert(
                    req.tokens,
                    lambda start, length, s=slot:
                        self.session.read_prefix_block(s, start, length))
                if n:
                    tracing.mark("prefix_promote", self._tm.name,
                                 tr=req.trace_id, par=req.trace_parent,
                                 rid=req.request_id, blocks=int(n))

    def _finish(self, req: Request, now: float,
                state: RequestState = RequestState.DONE) -> None:
        # the session's evict record covers tokens decoded since THIS
        # admission; a resumed request's earlier tokens were
        # re-prefilled, so they ride in the resumed_len prefix. A spec
        # tick can accept past the request budget inside one window —
        # the slice below trims the session record to the contract
        req.output = (req.output[:req.resumed_len]
                      + self.session.evict(req.slot))[:req.max_new_tokens]
        del self._by_slot[req.slot]
        req.slot = None
        req.state = state
        req.finished_ts = now
        self._on_terminal(req)

    # ------------------------------------------------------ retry/requeue
    def requeue(self, req: Request, reason: str,
                evicted: bool = False) -> bool:
        """Pull an in-flight request out of its slot and re-enqueue it
        WITH its generated-so-far tokens (re-admission re-prefills
        prompt+generated, so a greedy request resumes bit-identically; a
        stall shed discards no partial work).

        ``evicted=True`` means the slot was already torn down
        externally (a stall eviction by another session user) — skip
        the session-side free.  The retry budget bounds livelock: a
        request past ``max_retries`` goes loudly terminal (FAILED,
        ``requests_failed`` metric, ``serving_retry`` event) instead of
        cycling forever; otherwise it waits out a deterministic
        jittered exponential backoff in the delay heap before
        re-entering admission.  Returns True when requeued, False when
        the budget was exhausted."""
        now = self.clock()
        slot = req.slot
        if slot is not None:
            if slot in self._by_slot:
                del self._by_slot[slot]
                if not evicted:
                    # discard the session record: req.output already
                    # carries every emitted token
                    self.session.evict(slot)
            elif slot in self._partials:
                del self._partials[slot]
                if not evicted:
                    self.session.release_slot(slot)
            req.slot = None
        kept = len(req.output)
        if req.retries >= self.max_retries:
            req.state = RequestState.FAILED
            req.finished_ts = now
            req.shed_reason = (f"retry budget exhausted after "
                               f"{req.retries} requeue(s) ({reason})")
            self._tm.failed(1)
            if self.meter is not None:
                self.meter.on_shed(req.tenant)
            obs_resil.record_retry(self._tm.name, rid=req.request_id,
                                   attempt=req.retries, reason=reason,
                                   action="failed", kept_tokens=kept)
            self._on_terminal(req)
            # retry-budget exhaustion is a postmortem moment: dump the
            # flight ring so the poisoned request's last spans survive
            tracing.flight_dump("request_failed", track=self._tm.name)
            return False
        req.retries += 1
        req.resumed_len = kept
        req.state = RequestState.QUEUED
        # deterministic jitter — the plan-is-the-seed chaos rule: the
        # same (request seq, attempt) always backs off the same amount,
        # so chaos runs replay bit-for-bit while concurrent retries
        # still de-synchronize
        jit = 0.5 + np.random.default_rng(
            ((req.seq & 0xFFFF) << 8) ^ req.retries).random()
        req.not_before = now + self.retry_backoff_s \
            * (2.0 ** (req.retries - 1)) * jit
        req.enqueued_ts = req.not_before
        heapq.heappush(self._delayed, (req.not_before, req.seq, req))
        # the retry incarnation's root parents to the evicted root —
        # the link that keeps a requeued request ONE connected trace
        tracing.on_requeue(self._tm.name, req, reason,
                           attempt=req.retries)
        self._tm.retried(1)
        if self.meter is not None:
            self.meter.on_retry(req.tenant)
        j = self._journal
        if j is not None:
            j.push_retry(req)   # carries the retry incarnation's ctx
        obs_resil.record_retry(self._tm.name, rid=req.request_id,
                               attempt=req.retries, reason=reason,
                               action="requeue", kept_tokens=kept)
        self._tm.set_queue_depth(self._queued + len(self._delayed))
        return True

    def _owns_slot(self, slot: int, req: Request) -> bool:
        """Is this decoding slot still OURS?  A stall shed by another
        engine/user on the shared session frees (and may re-fill) it;
        the admission stamp the session keeps is the request's own
        ``arrival_perf``, so a mismatch means the occupant changed."""
        sess = self.session
        return bool(sess._occupied[slot]) \
            and sess._admit_t[slot] == req.arrival_perf

    def _reclaim_evicted(self) -> None:
        """Route externally-evicted in-flight requests through the
        requeue path: the victim of another engine's stall shed
        re-enqueues with its generated-so-far output instead of losing
        it."""
        for slot, req in list(self._by_slot.items()):
            if not self._owns_slot(slot, req):
                self.requeue(req, "external_evict", evicted=True)
        for slot, (req, _, _) in list(self._partials.items()):
            if not self.session._occupied[slot]:
                self.requeue(req, "external_evict", evicted=True)

    # --------------------------------------------------------------- tick
    def poll(self) -> dict:
        """ONE scheduler tick: admit into freed slots (prefix-reuse
        copy + partial-prefill start), advance every partial prefill by
        one chunk, then one decode tick across the live batch. Returns
        {"admitted": [...], "finished": [...], "emitted": n}.

        Tracing armed: the whole poll spans the engine track (with
        per-row attribution via the ownership stamps), and an
        UNHANDLED exception dumps the flight-recorder ring before
        propagating — the postmortem gets the last N spans/events."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self._prewarm_thread is not None:
            self._join_prewarm()
        t_tr = tracing.poll_begin()   # None when disarmed: zero cost
        try:
            out = self._poll_impl()
        except Exception:
            tracing.flight_dump("poll_exception", track=self._tm.name)
            raise
        if t_tr is not None:
            tracing.on_poll(
                self._tm.name, self._ticks,
                rows=len(self._by_slot), emitted=out["emitted"],
                t0=t_tr, spec=self.session.spec_k > 1,
                rids=[r.request_id for s, r in self._by_slot.items()
                      if self._owns_slot(s, r)])
        return out

    def _poll_impl(self) -> dict:
        now = self.clock()
        self._ticks += 1   # 1-based: chaos @tick=N hits the N-th poll
        if self.resil is not None:
            # chaos injection (slow_tick stall, kill, queue_flood,
            # poison evictions) + SLO evaluation + brownout ladder
            self.resil.on_poll_start(self, now)
            now = self.clock()   # a slow_tick stall consumed real time
        # requests whose slots a foreign stall shed tore down re-enter
        # the queue with their tokens; backoff-expired retries release
        self._reclaim_evicted()
        self._release_due_retries(now)
        admitted: list[Request] = []
        finished: list[Request] = []

        # 1. keep the decode batch at full occupancy: freed slots take
        # the best queued requests before anything else this tick
        while self._queued:
            req = self._pop_best(now)
            if req is None:
                break
            kw = {}
            if self.session.kv_paged:
                # a paged session grants exactly the pages this request
                # can ever touch (prompt/resumed work + decode budget)
                # instead of a full row — THE concurrency unlock: page
                # exhaustion backpressures like slot exhaustion below
                kw["need_tokens"] = req.prompt_len + req.max_new_tokens
            slot = self.session.alloc_slot(**kw)
            if slot is None:
                # no capacity (slots or KV pages): back into the queue,
                # same seq = same FIFO position
                heapq.heappush(self._heap, (req.sched_key(), req))
                self._queued += 1
                break
            self._start(req, slot, now)
            admitted.append(req)

        # 2. one chunk for every partial prompt and one decode tick over
        # every live row (a spec tick on a spec session); rows the chunk
        # half finalizes emit in the same tick. Degenerate ticks
        # (nothing to prefill / nothing decoding) run one half.
        emitted_n = 0
        # ticks are COMMUNAL on the session (a batched decode advances
        # every live row, exactly like generate()'s shared ticks), but
        # the engine only INITIATES one when it owns decodable work —
        # an engine with nothing of its own must not keep appending
        # tokens to a direct session.admit() user's rows
        own_active = any(self.session.is_active(s)
                         for s in self._by_slot)
        run_chunks = bool(self._partials) and (
            len(self._partials) >= self.prefill_min_batch
            or self._defer_ticks >= self.prefill_max_defer
            or not own_active
            or not self._queued)
        if self._partials and not run_chunks:
            self._defer_ticks += 1
        else:
            self._defer_ticks = 0
        chunks, width, arrivals, waits, resumed, fins = (
            self._collect_chunks() if run_chunks
            else ([], self.width, {}, {}, set(), []))
        # a spec session's tick emits up to spec_k tokens a live row
        spec = self.session.spec_k > 1
        if chunks and (fins or own_active):
            tick = self.session.spec_tick if spec \
                else self.session.fused_tick
            emitted = tick(chunks, width, arrivals=arrivals,
                           queue_waits=waits, resumed=resumed)
        elif chunks:
            self.session.prefill_chunks(chunks, width,
                                        arrivals=arrivals,
                                        queue_waits=waits,
                                        resumed=resumed)
            emitted = {}
        elif own_active:
            emitted = self.session.spec_step() if spec \
                else self.session.step()
        else:
            emitted = {}
        self._absorb_fins(fins)
        if emitted:
            now = self.clock()
            eos = self.session.eos_token_id
            j = self._journal
            for slot, toks in emitted.items():
                req = self._by_slot.get(slot)
                if req is None:
                    continue   # a direct session.admit() user's slot
                # plain ticks emit one int per slot, spec ticks a list
                toks = toks if isinstance(toks, list) else [toks]
                accepted = []
                for tok in toks:
                    accepted.append(int(tok))
                    req.output.append(int(tok))
                    if (eos is not None and tok == eos) \
                            or len(req.output) >= req.max_new_tokens:
                        break
                emitted_n += len(accepted)
                if j is not None:
                    # buffered: ONE append per poll at the flush below
                    j.push_tokens(req.request_id, accepted)
                if req.first_token_ts is None:
                    req.first_token_ts = now
                    tracing.on_first_token(self._tm.name, req)
                    if self.meter is not None:
                        self.meter.on_ttft(
                            req.tenant,
                            max(0.0, now - req.arrival_ts) * 1e3)
                    if self.resil is not None:
                        self.resil.observe_first_token(
                            req, max(0.0, now - req.arrival_ts))
                if (eos is not None and accepted[-1] == eos) \
                        or len(req.output) >= req.max_new_tokens:
                    self._finish(req, now)
                    finished.append(req)
        if self._by_slot:
            # rows the session froze itself (cache full) stop emitting
            # without an eos — close their requests out too
            for slot, req in list(self._by_slot.items()):
                if req.state is RequestState.DECODING \
                        and not self.session.is_active(slot):
                    self._finish(req, now)
                    finished.append(req)

        self._journal_flush()   # the poll's one durability point
        self._tm.set_queue_depth(self._queued + len(self._delayed))
        if self.meter is not None:
            self._meter_poll()
        return {"admitted": admitted, "finished": finished,
                "emitted": emitted_n}

    def _meter_poll(self) -> None:
        """Per-poll tenant metering: integrate KV page-seconds (each
        occupied row's page grants x the wall since the last poll,
        charged to the row's tenant stamp — aliased pages count once
        per referencing row) and feed the noisy-neighbour detector
        this poll's queue/page shares.  The pool-side integrand
        (``kv_row_pages_total``) samples the SAME instant, so the
        per-tenant page-second sums conserve against the pool
        integral exactly."""
        m = self.meter
        t = time.perf_counter()
        dt, self._meter_last_t = \
            (0.0 if self._meter_last_t is None
             else max(0.0, t - self._meter_last_t)), t
        sess = self.session
        pages_by: dict = {}
        pool_pages = 0
        if sess.kv_paged:
            for s in range(sess.max_slots):
                if not sess._occupied[s]:
                    continue
                n = len(sess._row_pages[s])
                if n:
                    ten = sess._slot_tenant[s]
                    pages_by[ten] = pages_by.get(ten, 0) + n
            pool_pages = sess.kv_row_pages_total()
        queue_by: dict = {}
        for _, req in self._heap:
            queue_by[req.tenant] = queue_by.get(req.tenant, 0) + 1
        for _, _, req in self._delayed:
            queue_by[req.tenant] = queue_by.get(req.tenant, 0) + 1
        m.observe_poll(pages_by, queue_by, dt, pool_pages=pool_pages)

    def _stall_evict(self) -> bool:
        """Graceful degradation at the stall limit: expire the
        LONGEST-HELD slot this engine does not own (deadline-eligible by
        tenure — it has starved a full ``STALL_LIMIT`` of polls' worth
        of queued work), freeing one slot for the queue.  The eviction
        is counted in ``ServingMetrics.stall_evictions`` and logged as
        a ``serving_stall_evict`` event — never a silent drop — and the
        victim's generated tokens are NOT lost: if it belongs to an
        engine on this session, that engine's next poll reclaims the
        request through :meth:`requeue` (retry budget permitting —
        exhaustion is a loud FAILED); only a direct ``session.admit()``
        user's row, which no engine tracks, forfeits its record.
        Returns False when there is nothing evictable (the caller then
        raises the original starvation error)."""
        sess = self.session
        held = [s for s in range(sess.max_slots)
                if sess._occupied[s]
                and s not in self._partials and s not in self._by_slot]
        if not held:
            return False
        victim = min(held, key=lambda s: sess._admit_t[s])
        sess.evict(victim)
        # if the victim belongs to ANOTHER engine on this session, that
        # engine's next poll reclaims its request through requeue() —
        # the generated tokens ride along instead of being lost
        self._tm.stall_evicted(victim)
        return True

    def run(self, max_ticks: int | None = None,
            deadline: float | None = None) -> int:
        """Tick until every submitted request reaches a terminal state
        (or ``max_ticks``). Returns the tick count.

        ``deadline`` (seconds of WALL clock — ``time.monotonic``, not
        the engine clock, so a wedged tick under an injected clock
        still trips it) bounds the whole drain: past it a loud
        :class:`TimeoutError` names every stuck request instead of
        hanging forever.

        When the engine is STARVED — requests queued but it owns no
        slot, no partial, and no decoding row, so nothing it can do
        will ever free capacity (a direct ``session.admit()`` user
        holds every slot) — it degrades gracefully after
        ``STALL_LIMIT`` zero-progress polls: the longest-held foreign
        slot is forcibly expired (``stall_evictions`` metric) and
        serving resumes.  It raises RuntimeError only when eviction
        frees nothing.  Polls spent waiting out a retry backoff are
        not stalls — they are progress pending by time."""
        n = 0
        stalls = 0
        t_end = None if deadline is None \
            else time.monotonic() + deadline
        while self._queued or self._delayed or self._partials \
                or self._by_slot:
            if t_end is not None and time.monotonic() > t_end:
                stuck = [f"{r.request_id}({r.state.value})"
                         for r in self._requests if not r.finished()]
                raise TimeoutError(
                    f"engine drain exceeded its {deadline}s deadline "
                    f"after {n} tick(s) with {len(stuck)} request(s) "
                    f"still live: {', '.join(stuck[:8])}"
                    + (" ..." if len(stuck) > 8 else ""))
            out = self.poll()
            n += 1
            if (out["admitted"] or out["finished"] or out["emitted"]
                    or self._partials or self._by_slot):
                stalls = 0
            elif self._delayed and not self._queued:
                # every live request is waiting out its retry backoff:
                # sleep to the earliest release instead of busy-spinning
                stalls = 0
                if self.clock is time.perf_counter:
                    time.sleep(min(
                        0.05, max(0.0,
                                  self._delayed[0][0] - self.clock())))
            else:
                stalls += 1
                if stalls >= self.STALL_LIMIT:
                    if self._stall_evict():
                        stalls = 0
                        continue
                    raise RuntimeError(
                        f"engine starved: {self._queued} queued "
                        "request(s) but no free slots, no engine-owned "
                        f"work, and nothing evictable for {stalls} "
                        "consecutive polls — serve this queue from a "
                        "session with capacity")
            if max_ticks is not None and n >= max_ticks:
                break
        return n

    # -------------------------------------------------------------- close
    def close(self, drain: bool = True, max_ticks: int = 1_000_000,
              deadline: float | None = None) -> None:
        """Shut the engine down. ``drain=True`` (default) finishes every
        queued and in-flight request first; ``drain=False`` cancels
        queued/mid-prefill requests (their slots release) and evicts
        decoding ones with whatever they produced. The session stays
        usable — only this engine retires.

        ``deadline`` (seconds, wall clock) bounds the drain: a wedged
        tick or a request that will never finish raises a loud
        :class:`TimeoutError` naming the stuck request(s) instead of
        hanging shutdown indefinitely.  The engine stays open after the
        timeout so the caller can inspect state and retry or
        ``close(drain=False)``."""
        if self._closed:
            return
        if self._prewarm_thread is not None:
            self._join_prewarm()
        if drain:
            ticks = self.run(max_ticks=max_ticks, deadline=deadline)
            if self._queued or self._delayed or self._partials \
                    or self._by_slot:
                raise RuntimeError(
                    f"engine failed to drain within {ticks} ticks")
        else:
            now = self.clock()
            while self._heap:
                _, req = heapq.heappop(self._heap)
                req.state = RequestState.CANCELLED
                req.finished_ts = now
                self._on_terminal(req)
            self._queued = 0
            while self._delayed:
                _, _, req = heapq.heappop(self._delayed)
                req.state = RequestState.CANCELLED
                req.finished_ts = now
                self._on_terminal(req)
            for slot, (req, _, _) in list(self._partials.items()):
                self.session.release_slot(slot)
                req.state = RequestState.CANCELLED
                req.finished_ts = now
                req.slot = None
                self._on_terminal(req)
            self._partials.clear()
            for slot, req in list(self._by_slot.items()):
                self._finish(req, now, state=RequestState.CANCELLED)
        self._tm.set_queue_depth(0)
        if self.meter is not None:
            # final publish (counters survive in meter.metrics()),
            # then retire the gauge family with the engine
            self.meter.publish_gauges()
            self.meter.close()
            if self.session._meter is self.meter:
                self.session.attach_meter(None)
        j = self._journal
        if j is not None:
            j.close()
        self._closed = True

    def abandon(self) -> None:
        """Simulated-crash teardown — the fleet failover path's
        in-process stand-in for SIGKILL.  Unlike :meth:`close` it
        drains nothing, cancels nothing, and journals NO end records:
        the journal file is dropped mid-stream (buffered records lost,
        exactly what a real crash loses — see
        :meth:`RequestJournal.abandon`), in-flight requests keep their
        non-terminal states, and the session's slots stay occupied.
        Recovery must therefore come from the journal FILE, the same
        evidence a real SIGKILL leaves.  Tracing armed: the flight
        ring dumps (the crash postmortem) and every in-flight trace on
        this engine closes ``crashed`` — the journal-replay incarnation
        parents to the crashed root, keeping the trace connected."""
        if self._closed:
            return
        j = self._journal
        if j is not None:
            j.abandon()
        tracing.flight_dump("engine_abandon", track=self._tm.name)
        tracing.on_track_crash(self._tm.name)
        self._closed = True

    # ------------------------------------------------------------ reading
    @property
    def pending(self) -> int:
        """Requests not yet in a terminal state (queued + backoff-
        delayed + prefilling + decoding) — 0 means a replay loop may
        stop polling."""
        return (self._queued + len(self._delayed)
                + len(self._partials) + len(self._by_slot))

    @property
    def requests(self) -> list[Request]:
        """Every request ever submitted to this engine (terminal ones
        included), in submit order."""
        return list(self._requests)

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        """Session serving metrics + scheduler state: queue depth,
        expiry/reject counts, p50/p99 TTFT and queue wait (bounded
        reservoirs), prefix-pool hit rates."""
        out = dict(self.session.metrics())
        out["queue_depth"] = self._queued
        out["retry_backlog"] = len(self._delayed)
        out["requests_inflight"] = len(self._partials) + len(self._by_slot)
        out["requests_submitted"] = len(self._requests)
        if self.resil is not None:
            out["resilience"] = self.resil.metrics()
        by_state: dict[str, int] = {}
        for r in self._requests:
            by_state[r.state.value] = by_state.get(r.state.value, 0) + 1
        out["requests_by_state"] = dict(sorted(by_state.items()))
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self.meter is not None:
            out["tenants"] = self.meter.metrics()
        return dict(sorted(out.items()))
