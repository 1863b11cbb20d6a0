"""Continuous-batching serving engine — the scheduler between user requests
and a ``GenerationSession``. Port of the core of
paddle_tpu/serving/engine.py:

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
  exhaustion.

The resilience plane (load shedding, retries and the requeue of a
stall-evicted request, the crash journal), tenant metering and request
tracing belong to later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import heapq
import os
import threading
import time

from ..device import resolve_device
from .prefix_cache import PrefixCache
from .request import Request, RequestState

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
                 resilience=None, metering=None):
        # the reference arms the crash journal through ``resilience`` and
        # tracing / metering also through the environment
        for what, armed, later in (
                ("resilience (shedding, retries, journal)", resilience,
                 "serving-resilience"),
                ("metering", metering or os.environ.get(
                    "PADDLE_TPU_TENANT_METERING", "0").lower()
                 in ("1", "true", "on"), "tenant-metering"),
                ("PADDLE_TPU_TRACING=1",
                 os.environ.get("PADDLE_TPU_TRACING", "0") == "1",
                 "request-tracing")):
            if armed:
                raise NotImplementedError(
                    f"ServingEngine: {what} belongs to the {later} slice of "
                    "the port")
        dev = resolve_device(device)
        if dev.type != session.device.type:
            raise ValueError(f"engine device {dev} differs from the "
                             f"session's {session.device}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
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
        self._partials: dict[int, list] = {}    # slot -> [req, next_off]
        self._by_slot: dict[int, Request] = {}  # slot -> decoding req
        self._requests: list[Request] = []
        self._closed = False
        self._prewarm_thread = None

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

    # ------------------------------------------------------------ submit
    def submit(self, tokens, max_new_tokens: int = 32, priority: int = 0,
               deadline: float | None = None,
               request_id: str | None = None,
               temperature: float | None = None,
               seed: int | None = None) -> Request:
        """Enqueue one request; raises :class:`QueueFull` when the bounded
        queue is at capacity (a silent drop would read as an infinitely
        slow request). ``temperature``/``seed`` set the request's sampling
        lane on a session with the stochastic lane (``spec_sample``):
        None is the session's temperature and a per-request default seed;
        a non-zero temperature on any other session raises."""
        if self._closed:
            raise RuntimeError("engine is closed")
        req = Request(tokens=tokens, max_new_tokens=int(max_new_tokens),
                      priority=int(priority), deadline=deadline,
                      request_id=request_id,
                      temperature=self._resolve_temp(temperature),
                      seed=seed)
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
        self._requests.append(req)   # rejected ones count too
        if self._queued >= self.max_queue:
            req.state = RequestState.REJECTED
            req.finished_ts = req.arrival_ts
            self._tm.rejected(1)
            raise QueueFull(req, self.max_queue)
        heapq.heappush(self._heap, (req.sched_key(), req))
        self._queued += 1
        self._tm.set_queue_depth(self._queued)
        return req

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

    def try_submit(self, tokens, **kw) -> Request | None:
        """:meth:`submit` that returns None on a full queue (the
        rejection still counts)."""
        try:
            return self.submit(tokens, **kw)
        except QueueFull:
            return None

    # --------------------------------------------------------- scheduling
    def _pop_best(self, now: float) -> Request | None:
        """The best queued request; expired heads are dropped on the way,
        before they touch a slot."""
        while self._heap:
            _, req = heapq.heappop(self._heap)
            self._queued -= 1
            if req.deadline is not None and now > req.deadline:
                req.state = RequestState.EXPIRED
                req.finished_ts = now
                self._tm.expired(1)
                continue
            return req
        return None

    def _reuse_prefix(self, req: Request, slot: int) -> int:
        """Land the longest pooled prefix of the prompt in the slot; returns
        the offset its prefill starts at. The match stops one token short:
        the last prompt position must prefill so its logits exist."""
        if self.prefix_cache is None:
            return 0
        _, blocks = self.prefix_cache.match(req.tokens,
                                            max_prefix=req.prompt_len - 1)
        if not blocks:
            return 0
        req.prefix_hit_tokens = self.session.copy_prefix_into(slot, blocks)
        return req.prefix_hit_tokens

    def _pool_prompt(self, req: Request, slot: int) -> None:
        """Offer the now-resident prompt's full blocks to the prefix pool
        (one span read for the contiguous run it promotes)."""
        self.prefix_cache.insert(
            req.tokens, lambda start, length:
            self.session.read_prefix_block(slot, start, length))

    def _collect_chunks(self):
        """This tick's chunk batch: every partial prompt advances one
        chunk; last chunks finalize. The width is the smallest bucket
        that fits the longest piece."""
        chunks, arrivals, waits, fins = [], {}, {}, []
        wmax = 1
        for slot, (req, off) in self._partials.items():
            end = min(off + self.width, req.prompt_len)
            fin = end == req.prompt_len
            chunks.append((slot, req.tokens[off:end], off, fin))
            wmax = max(wmax, end - off)
            if fin:
                # TTFT runs in the perf_counter domain
                arrivals[slot] = req.arrival_perf
                waits[slot] = max(0.0, req.admitted_ts - req.arrival_ts)
                fins.append((slot, req))
            else:
                self._partials[slot][1] = end
        width = next((b for b in self.width_buckets if b >= wmax),
                     self.width)
        return chunks, width, arrivals, waits, fins

    def _absorb_fins(self, fins) -> None:
        """Finalized prompts start decoding; their full blocks are
        offered to the prefix pool."""
        for slot, req in fins:
            del self._partials[slot]
            req.state = RequestState.DECODING
            self._by_slot[slot] = req
            if self.prefix_cache is not None:
                self._pool_prompt(req, slot)

    def _finish(self, req: Request, now: float,
                state: RequestState = RequestState.DONE) -> None:
        req.output = self.session.evict(req.slot)[:req.max_new_tokens]
        del self._by_slot[req.slot]
        req.slot = None
        req.state = state
        req.finished_ts = now

    # --------------------------------------------------------------- tick
    def poll(self) -> dict:
        """ONE scheduler tick: admit into freed slots, advance every
        partial prefill by one chunk, and decode one token across the
        live batch. Returns {"admitted": [...], "finished": [...],
        "emitted": n}."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self._prewarm_thread is not None:
            self._join_prewarm()
        now = self.clock()
        admitted: list[Request] = []
        finished: list[Request] = []
        sess = self.session

        # 1. fill freed slots with the best queued requests
        while self._queued:
            req = self._pop_best(now)
            if req is None:
                break
            # a paged session grants only the pages this request can touch
            kw = {"need_tokens": req.prompt_len + req.max_new_tokens} \
                if sess.kv_paged else {}
            slot = sess.alloc_slot(**kw)
            if slot is None:
                # no capacity (slots or KV pages): back into the queue,
                # same FIFO position
                heapq.heappush(self._heap, (req.sched_key(), req))
                self._queued += 1
                break
            req.state = RequestState.PREFILLING
            req.slot = slot
            req.admitted_ts = now
            if sess.spec_sample:
                # staged now; the finalizing chunk moves it to the device
                sess.set_sampling(slot, req.temperature, req.seed)
            self._partials[slot] = [req, self._reuse_prefix(req, slot)]
            admitted.append(req)

        # 2. one chunk for every partial prompt and one decode tick over
        # every live row (a spec tick on a spec session); rows the chunk
        # half finalizes emit in the same tick. The engine only starts a
        # tick when it owns decodable work (ticks are communal). The chunk
        # half may wait for a fuller cohort (prefill_min_batch), at most
        # prefill_max_defer polls, and never when nothing else would run
        own_active = any(sess.is_active(s) for s in self._by_slot)
        run_chunks = bool(self._partials) and (
            len(self._partials) >= self.prefill_min_batch
            or self._defer_ticks >= self.prefill_max_defer
            or not own_active or not self._queued)
        if self._partials and not run_chunks:
            self._defer_ticks += 1
        else:
            self._defer_ticks = 0
        chunks, width, arrivals, waits, fins = (
            self._collect_chunks() if run_chunks
            else ([], self.width, {}, {}, []))
        spec = sess.spec_k > 1
        if chunks and (fins or own_active):
            tick = sess.spec_tick if spec else sess.fused_tick
            emitted = tick(chunks, width, arrivals=arrivals,
                           queue_waits=waits)
        elif chunks:
            sess.prefill_chunks(chunks, width, arrivals=arrivals,
                                queue_waits=waits)
            emitted = {}
        elif own_active:
            emitted = sess.spec_step() if spec else sess.step()
        else:
            emitted = {}
        self._absorb_fins(fins)

        emitted_n = 0
        if emitted:
            now = self.clock()
            eos = sess.eos_token_id
            for slot, toks in emitted.items():
                req = self._by_slot.get(slot)
                if req is None:
                    continue   # a direct session.admit() user's slot
                # a plain tick emits one token a slot, a spec tick a list
                toks = toks if isinstance(toks, list) else [toks]
                done = False
                for tok in toks:
                    req.output.append(int(tok))
                    emitted_n += 1
                    done = (eos is not None and tok == eos) \
                        or len(req.output) >= req.max_new_tokens
                    if done:
                        break
                if req.first_token_ts is None:
                    req.first_token_ts = now
                if done:
                    self._finish(req, now)
                    finished.append(req)
        # rows the session froze itself (cache full) stop without an eos
        for slot, req in list(self._by_slot.items()):
            if req.state is RequestState.DECODING \
                    and not sess.is_active(slot):
                self._finish(req, now)
                finished.append(req)
        self._tm.set_queue_depth(self._queued)
        return {"admitted": admitted, "finished": finished,
                "emitted": emitted_n}

    def _stall_evict(self) -> bool:
        """Graceful degradation at the stall limit: expire the
        longest-held slot this engine does not own, freeing one slot for
        the queue; counted in ``stall_evictions`` and logged as a
        ``serving_stall_evict`` event. A direct ``session.admit()`` user's
        row forfeits its record. (The reference's other engines on the
        session reclaim a victim of theirs through the requeue of the
        resilience slice.) Returns False when nothing is evictable."""
        sess = self.session
        held = [s for s in range(sess.max_slots)
                if sess._occupied[s]
                and s not in self._partials and s not in self._by_slot]
        if not held:
            return False
        victim = min(held, key=lambda s: sess._admit_t[s])
        sess.evict(victim)
        self._tm.stall_evicted(victim)
        return True

    def run(self, max_ticks: int | None = None,
            deadline: float | None = None) -> int:
        """Tick until every submitted request is terminal (or
        ``max_ticks``). Returns the tick count. ``deadline`` (seconds of
        wall clock) bounds the drain with a TimeoutError naming the stuck
        requests. When starved (requests queued, every slot held by work
        this engine does not own) it expires the longest-held foreign
        slot after ``STALL_LIMIT`` zero-progress polls and serves on; it
        raises RuntimeError only when that frees nothing."""
        n = stalls = 0
        t_end = None if deadline is None else time.monotonic() + deadline
        while self._queued or self._partials or self._by_slot:
            if t_end is not None and time.monotonic() > t_end:
                stuck = [f"{r.request_id}({r.state.value})"
                         for r in self._requests if not r.finished()]
                raise TimeoutError(
                    f"engine drain exceeded its {deadline}s deadline after "
                    f"{n} tick(s) with {len(stuck)} request(s) still live: "
                    + ", ".join(stuck[:8]))
            out = self.poll()
            n += 1
            if (out["admitted"] or out["finished"] or out["emitted"]
                    or self._partials or self._by_slot):
                stalls = 0
            else:
                stalls += 1
                if stalls >= self.STALL_LIMIT:
                    if self._stall_evict():
                        stalls = 0
                        continue
                    raise RuntimeError(
                        f"engine starved: {self._queued} queued request(s) "
                        "but no free slots, no engine-owned work, and "
                        f"nothing evictable for {stalls} consecutive polls "
                        "— serve this queue from a session with capacity")
            if max_ticks is not None and n >= max_ticks:
                break
        return n

    def close(self, drain: bool = True, max_ticks: int = 1_000_000,
              deadline: float | None = None) -> None:
        """Shut the engine down: ``drain=True`` finishes every queued and
        in-flight request first; ``drain=False`` cancels queued and
        mid-prefill requests and evicts decoding ones with what they
        produced. The session stays usable."""
        if self._closed:
            return
        if self._prewarm_thread is not None:
            self._join_prewarm()
        if drain:
            ticks = self.run(max_ticks=max_ticks, deadline=deadline)
            if self._queued or self._partials or self._by_slot:
                raise RuntimeError(
                    f"engine failed to drain within {ticks} ticks")
        else:
            now = self.clock()
            while self._heap:
                _, req = heapq.heappop(self._heap)
                req.state = RequestState.CANCELLED
                req.finished_ts = now
            self._queued = 0
            for slot, (req, _) in list(self._partials.items()):
                self.session.release_slot(slot)
                req.state = RequestState.CANCELLED
                req.finished_ts = now
                req.slot = None
            self._partials.clear()
            for req in list(self._by_slot.values()):
                self._finish(req, now, state=RequestState.CANCELLED)
        self._tm.set_queue_depth(0)
        self._closed = True

    # ------------------------------------------------------------ reading
    @property
    def pending(self) -> int:
        """Requests not yet terminal (queued + prefilling + decoding)."""
        return self._queued + len(self._partials) + len(self._by_slot)

    @property
    def requests(self) -> list[Request]:
        """Every request ever submitted (terminal ones included)."""
        return list(self._requests)

    def metrics(self) -> dict:
        """Session serving metrics + scheduler state."""
        out = dict(self.session.metrics())
        out["queue_depth"] = self._queued
        out["requests_inflight"] = len(self._partials) + len(self._by_slot)
        out["requests_submitted"] = len(self._requests)
        by_state: dict[str, int] = {}
        for r in self._requests:
            by_state[r.state.value] = by_state.get(r.state.value, 0) + 1
        out["requests_by_state"] = dict(sorted(by_state.items()))
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return dict(sorted(out.items()))
