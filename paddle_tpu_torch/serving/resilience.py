"""Serving resilience plane of the port (host-only copy of
paddle_tpu/serving/resilience.py): SLO-driven load shedding, brownout
degradation, retry/requeue, and crash-recovery journaling for the
continuous-batching :class:`~paddle_tpu_torch.serving.ServingEngine`.

Every decision it makes is host-side: with resilience enabled but no
faults injected, the captured tick graphs, the tick sequence and the
streams are the plain engine's — the device never sees this layer.

- **SLO-driven adaptive admission** (:class:`LaneSLO` +
  :meth:`ResiliencePolicy.admission_gate`): per-priority-lane SLOs (TTFT
  p99 ms, queue-wait p99 ms) evaluated every poll over bounded sliding
  windows. When a lane breaches, below-priority work is rejected loudly
  at the admission edge (``submit`` raises :class:`RequestShed`, state
  ``REJECTED``), and shedding disarms only after ``recover_polls``
  consecutive healthy evaluations (hysteresis).
- **Brownout degradation ladder**: ordered, individually reversible
  steps under sustained queue pressure — (1) clamp new requests'
  ``max_new_tokens``, (2) suspend prefix-cache extraction writes (reads
  keep serving hits), (3) priority-only admission. Each transition emits
  a ``serving_brownout`` event; de-escalation walks back one step at a
  time.
- **Retry/requeue**: a stall-evicted, chaos-evicted or crash-replayed
  request re-enters the queue with its generated tokens
  (:meth:`Request.resume_tokens`) and resumes by re-prefilling
  prompt+generated (through the prefix pool's span copy when its blocks
  are pooled): the same greedy stream. A per-request retry budget with
  jittered exponential backoff ends a poisoned request in a loud
  ``FAILED``.
- **Crash recovery** (:class:`RequestJournal` + :func:`replay_journal`):
  an append-only JSONL journal (submit, emitted-token and terminal
  records; one flushed append per poll, fsync amortized) lets a fresh
  engine after SIGKILL re-admit every journaled in-flight request.
- **Serving chaos faults**: ``slow_tick@tick=N:xK``,
  ``queue_flood@tick=N:xK``, ``poison_request@req=N`` and
  ``kill@tick=N`` of the ``PADDLE_TPU_CHAOS`` plan
  (``distributed/ft/chaos.py``), injected here at the poll edge.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque

import numpy as np

from ..distributed.ft import chaos as ft_chaos
from ..observability import resilience as obs_resil
from ..observability import tracing
from .request import Request, RequestState

__all__ = ["LaneSLO", "ResiliencePolicy", "RequestShed",
           "RequestJournal", "replay_journal", "BROWNOUT_STEPS"]


class RequestShed(RuntimeError):
    """The admission shedder refused the submit — nothing was enqueued.
    Distinct from :class:`~paddle_tpu_torch.serving.QueueFull` (capacity
    backpressure): this is a POLICY rejection protecting a breached
    SLO lane or enforcing a brownout step.  The shed request rides
    along (state ``REJECTED``, ``shed_reason`` set) for inspection."""

    def __init__(self, request: Request, reason: str):
        self.request = request
        self.reason = reason
        super().__init__(
            f"request {request.request_id} (priority {request.priority}) "
            f"shed at admission: {reason}")


@dataclasses.dataclass(frozen=True)
class LaneSLO:
    """Declarative service-level objective for ONE priority lane.

    ``priority``: the lane (lower = more urgent).  ``ttft_p99_ms`` /
    ``queue_wait_p99_ms``: breach thresholds over the lane's sliding
    window (``None`` = not part of this lane's SLO).  A breach arms
    shedding of every lane with priority > this lane's."""
    priority: int
    ttft_p99_ms: float | None = None
    queue_wait_p99_ms: float | None = None

    def __post_init__(self):
        if self.ttft_p99_ms is None and self.queue_wait_p99_ms is None:
            raise ValueError(
                f"LaneSLO for priority {self.priority} declares no "
                "objective — set ttft_p99_ms and/or queue_wait_p99_ms")


def _p99(xs) -> float:
    """Nearest-rank p99 (same rule the ServingMetrics reservoirs
    report), over a small window — one sort per evaluation."""
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(0.99 * (len(s) - 1)))))
    return s[k]


# the ordered degradation ladder (level N = steps [0, N) active)
BROWNOUT_STEPS = ("clamp_new_tokens", "suspend_prefix_writes",
                  "priority_only_admission")


class RequestJournal:
    """Append-only request journal: enough to re-admit every in-flight
    request after a SIGKILL.  One JSON object per line::

        {"ev": "submit", "rid", "tokens", "new", "prio", "deadline"}
                                      # + "temp"/"seed" when sampled
        {"ev": "toks",   "rid", "t": [tok, ...]}      # per poll, batched
        {"ev": "retry",  "rid", "n": attempt}
        {"ev": "end",    "rid", "state": "done" | ...}

    Commit discipline (the ``ft/atomic.py`` rule adapted to a log):
    records buffer in-process and land as ONE append (write + kernel
    flush) per poll, so a crash at any point leaves a readable
    prefix — at worst one torn trailing line, which :meth:`scan`
    skips.  A request is in-flight iff its ``submit`` is journaled and
    no ``end`` is; its resume state is prompt + the concatenation of
    its ``toks`` records (ordered — the journal is single-writer).

    Durability tiers, chosen by what each record class actually needs:
    a PROCESS crash (SIGKILL — the preemption model ``kill@tick`` injects)
    loses nothing once ``write()`` handed the bytes to the kernel, so
    the per-poll flush fully covers it.  ``fsync`` only matters for a
    MACHINE crash, and there the recovery math is asymmetric: a lost
    trailing ``toks`` record is harmless (greedy replay re-decodes the
    exact same tokens from the journaled prompt — bit-identical by the
    same argument as requeue), while a lost ``submit`` record loses the
    request.  So fsync is amortized to every ``fsync_every``-th flush
    (and close) instead of every poll — measured 3-11s of a ~10s serve
    replay when fsync'ing per poll on the CPU substrate's filesystem —
    bounding the machine-crash admission-loss window to one fsync
    cadence.  ``fsync_every=1`` restores full per-poll fsync where the
    storage makes that cheap."""

    def __init__(self, path: str, fsync_every: int = 32):
        if fsync_every < 1:
            raise ValueError(
                f"fsync_every must be >= 1, got {fsync_every}")
        self.path = str(path)
        self.fsync_every = int(fsync_every)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._buf: list[str] = []
        self._since_sync = 0

    # ------------------------------------------------------------ writing
    def push(self, rec: dict) -> None:
        """Buffer one record (ordered); durable at the next flush."""
        self._buf.append(json.dumps(rec, separators=(",", ":")))

    def flush(self) -> None:
        """ONE append (write + kernel flush) for everything buffered —
        called once per poll / submit, not per record; every
        ``fsync_every``-th flush also fsyncs (see the class docstring
        for the durability-tier rationale)."""
        if not self._buf or self._f.closed:
            return
        self._f.write("\n".join(self._buf) + "\n")
        self._buf.clear()
        self._f.flush()
        self._since_sync += 1
        if self._since_sync >= self.fsync_every:
            os.fsync(self._f.fileno())
            self._since_sync = 0

    def push_submit(self, req: Request) -> None:
        rec = {"ev": "submit", "rid": req.request_id,
               "tokens": req.tokens.tolist(),
               "new": req.max_new_tokens, "prio": req.priority,
               "deadline": req.deadline,
               "out": list(req.output), "retries": req.retries}
        if req.temperature:
            # the sampling lane's WHOLE state: every device draw
            # re-derives from (seed, position, lane), so these two
            # fields are all a replay needs to continue a sampled
            # request bit-identically.  Greedy records stay
            # byte-identical to the pre-sampling journal format.
            rec["temp"] = req.temperature
            rec["seed"] = req.seed
        if getattr(req, "tenant", None) is not None:
            # tenant attribution survives crash replay and fleet
            # failover; untenanted records stay byte-identical to the
            # pre-metering journal format
            rec["tenant"] = req.tenant
        ctx = tracing.ctx_of(req)
        if ctx is not None:
            # the tracing context rides the journal so a post-crash
            # replay resumes the SAME trace, parented to the crashed
            # incarnation's root span
            rec["trace"] = list(ctx)
        self.push(rec)

    def push_tokens(self, rid: str, toks: list) -> None:
        self.push({"ev": "toks", "rid": rid,
                   "t": [int(t) for t in toks]})

    def push_retry(self, req: Request) -> None:
        rec = {"ev": "retry", "rid": req.request_id, "n": req.retries}
        ctx = tracing.ctx_of(req)
        if ctx is not None:
            # the retry incarnation re-parented the context — a crash
            # after this point must resume from the NEW root
            rec["trace"] = list(ctx)
        self.push(rec)

    def push_end(self, req: Request) -> None:
        self.push({"ev": "end", "rid": req.request_id,
                   "state": req.state.value})

    def close(self) -> None:
        try:
            self.flush()
            if not self._f.closed:
                os.fsync(self._f.fileno())   # close is a commit point
        finally:
            if not self._f.closed:
                self._f.close()

    def abandon(self) -> None:
        """Crash-simulation teardown (the fleet failover path): drop
        the journal exactly as SIGKILL would — buffered-but-unflushed
        records are LOST, nothing is flushed or fsynced on the way
        out, and the file keeps only what prior per-poll flushes
        handed the kernel.  A recovery that scans this file sees the
        same bytes a real crash leaves."""
        self._buf.clear()
        if not self._f.closed:
            self._f.close()

    # ------------------------------------------------------------ reading
    @staticmethod
    def scan(path: str) -> dict:
        """Parse a journal into ``{rid: entry}`` where entry carries
        ``tokens``/``new``/``prio``/``deadline``/``out`` (prompt,
        budget, scheduling hints, emitted tokens in order),
        ``retries``, and ``state`` (``None`` while in-flight).
        Undecodable lines (the torn tail of a crash) are skipped — the
        journal's append discipline guarantees every complete line is
        valid."""
        entries: dict[str, dict] = {}
        try:
            f = open(path, encoding="utf-8")
        except OSError:
            return entries
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue   # torn trailing line of a crashed writer
                rid = rec.get("rid")
                ev = rec.get("ev")
                if ev == "submit":
                    entries[rid] = {
                        "tokens": rec["tokens"], "new": rec["new"],
                        "prio": rec.get("prio", 0),
                        "deadline": rec.get("deadline"),
                        "out": list(rec.get("out", ())),
                        "retries": int(rec.get("retries", 0)),
                        "trace": rec.get("trace"),
                        # pre-sampling journals carry neither key —
                        # they replay greedy, exactly as written
                        "temp": float(rec.get("temp", 0.0)),
                        "seed": rec.get("seed"),
                        # pre-metering journals: None = untagged
                        "tenant": rec.get("tenant"),
                        "state": None}
                elif rid in entries:
                    e = entries[rid]
                    if ev == "toks":
                        e["out"].extend(rec["t"])
                    elif ev == "retry":
                        e["retries"] = int(rec["n"])
                        if rec.get("trace") is not None:
                            e["trace"] = rec["trace"]
                    elif ev == "end":
                        e["state"] = rec["state"]
        return entries


def replay_journal(engine, path: str) -> list:
    """Re-admit every in-flight request a crashed engine's journal
    recorded.  Each one resumes with its generated-so-far tokens
    (:meth:`ServingEngine.resume`), so for greedy decoding the fresh
    engine reproduces the remaining tokens bit-identically.  Returns
    the resumed :class:`Request` objects (already-terminal journal
    entries are NOT resubmitted — their outputs live in the journal)."""
    entries = RequestJournal.scan(path)
    resumed = []
    for rid, e in entries.items():
        if e["state"] is not None:
            continue
        trace = e.get("trace")
        resumed.append(engine.resume(
            np.asarray(e["tokens"], np.int32), generated=e["out"],
            max_new_tokens=e["new"], priority=e["prio"],
            deadline=e["deadline"], request_id=rid,
            retries=e["retries"],
            temperature=e.get("temp", 0.0), seed=e.get("seed"),
            trace_ctx=tuple(trace) if trace else None,
            tenant=e.get("tenant")))
    obs_resil.record_journal_replay(
        engine._tm.name, path=path, scanned=len(entries),
        replayed=len(resumed),
        already_done=sum(1 for e in entries.values()
                         if e["state"] is not None))
    return resumed


class ResiliencePolicy:
    """The engine's host-side resilience brain: pass one to
    ``ServingEngine(..., resilience=policy)``.

    >>> policy = ResiliencePolicy(
    ...     slos=[LaneSLO(priority=0, ttft_p99_ms=500.0)],
    ...     journal_path="/var/serve/journal.jsonl")
    >>> eng = ServingEngine(sess, resilience=policy, max_retries=2)

    Every decision is host-side: with a policy attached and no faults,
    the engine captures the same tick graphs and serves the same streams
    as the plain engine.  One policy serves one engine
    (:meth:`bind` is called by the engine constructor)."""

    def __init__(self, slos=(), *, window: int = 128,
                 min_samples: int = 8, recover_polls: int = 64,
                 brownout_high: float = 0.75, brownout_low: float = 0.25,
                 brownout_after: int = 16, brownout_recover: int = 32,
                 clamp_new_tokens: int = 16, priority_only_max: int = 0,
                 flood_priority: int = 9, flood_prompt_len: int = 16,
                 flood_new_tokens: int = 4, chaos=None,
                 journal_path: str | None = None,
                 journal_fsync_every: int = 32):
        """``slos``: the declarative per-lane objectives.  ``window`` /
        ``min_samples``: per-lane sliding-window size and the sample
        floor below which a lane is presumed healthy (don't shed on
        two unlucky requests).  ``recover_polls``: consecutive healthy
        evaluations before shedding disarms (hysteresis).

        ``brownout_high``/``low``: queue-depth fractions (of
        ``max_queue``) that count as pressure / calm;
        ``brownout_after``/``recover``: consecutive pressured / calm
        polls per ladder step up / down.  ``clamp_new_tokens``: the
        level-1 budget clamp.  ``priority_only_max``: the only lanes
        still admitted at level 3.

        ``chaos``: a parsed :class:`~paddle_tpu_torch.distributed.ft.chaos.
        ChaosPlan` (``None`` = read ``PADDLE_TPU_CHAOS``); the serving
        fault kinds inject at the poll edge, everything host-side.
        ``flood_*`` shape the synthetic ``queue_flood`` requests.
        ``journal_path``: enables the crash-recovery request journal
        (opened lazily at :meth:`bind`); ``journal_fsync_every``
        bounds its machine-crash admission-loss window (see
        :class:`RequestJournal`)."""
        self.slos = tuple(sorted(slos, key=lambda s: s.priority))
        seen = [s.priority for s in self.slos]
        if len(set(seen)) != len(seen):
            raise ValueError(f"duplicate LaneSLO priorities: {seen}")
        if not (0.0 < brownout_low < brownout_high):
            raise ValueError(
                f"need 0 < brownout_low ({brownout_low}) < "
                f"brownout_high ({brownout_high})")
        if window < 1 or min_samples < 1 or recover_polls < 1 \
                or brownout_after < 1 or brownout_recover < 1:
            raise ValueError("window, min_samples, recover_polls and "
                             "the brownout streaks must all be >= 1")
        if clamp_new_tokens < 1:
            raise ValueError(
                f"clamp_new_tokens must be >= 1, got {clamp_new_tokens}")
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.recover_polls = int(recover_polls)
        self.brownout_high = float(brownout_high)
        self.brownout_low = float(brownout_low)
        self.brownout_after = int(brownout_after)
        self.brownout_recover = int(brownout_recover)
        self.clamp_new_tokens = int(clamp_new_tokens)
        self.priority_only_max = int(priority_only_max)
        self.flood_priority = int(flood_priority)
        self.flood_prompt_len = int(flood_prompt_len)
        self.flood_new_tokens = int(flood_new_tokens)
        self.chaos = (ft_chaos.plan_from_env() if chaos is None
                      else chaos)
        # per-lane sliding windows: {priority: {"ttft": deque, ...}}
        self._lanes = {
            s.priority: {"ttft": deque(maxlen=self.window),
                         "qwait": deque(maxlen=self.window)}
            for s in self.slos}
        # poll counter + per-lane last-sample stamp: a lane whose
        # window has gone recover_polls polls without a NEW sample is
        # STALE and presumed healthy — otherwise a breach followed by
        # lane silence would latch the shedder forever (the stale p99
        # re-breaches every evaluation and no traffic ever refills the
        # window on an engine the shedder itself is keeping idle)
        self._polls = 0
        self._lane_last_sample = {s.priority: 0 for s in self.slos}
        # SLO attainment ledger per SLO lane: [met, total] over
        # TERMINAL requests (a shed/expired/failed request in an SLO
        # lane counts as missed — attainment must not hide drops)
        self._attain = {s.priority: [0, 0] for s in self.slos}
        # shed state
        self.shed_active = False
        self.shed_below: int | None = None   # reject priority > this
        self._healthy_streak = 0
        self.shed_total = 0
        self.slo_breaches = 0
        # brownout ladder state
        self.brownout_level = 0
        self._pressure_streak = 0
        self._calm_streak = 0
        self.clamped_total = 0
        # chaos bookkeeping
        self.floods_injected = 0
        self.poisoned_total = 0
        self._submit_ord = 0      # external submissions only
        self._in_flood = False
        # journal + engine binding
        self.journal: RequestJournal | None = None
        self._journal_path = (None if journal_path is None
                              else str(journal_path))
        self._journal_fsync_every = int(journal_fsync_every)
        self._engine = None
        self._name = "engine"

    # ------------------------------------------------------------ binding
    def bind(self, engine) -> None:
        """Attach to the engine (called by the engine constructor) and
        open the crash-recovery journal when configured."""
        if self._engine is not None and self._engine is not engine:
            raise ValueError(
                "this ResiliencePolicy is already bound to another "
                "engine — one policy serves one engine")
        self._engine = engine
        self._name = engine._tm.name
        if self._journal_path is not None and self.journal is None:
            self.journal = RequestJournal(
                self._journal_path,
                fsync_every=self._journal_fsync_every)

    # ----------------------------------------------------------- admission
    def admission_gate(self, req: Request, now: float) -> None:
        """Runs inside ``submit()`` BEFORE the request queues: sheds
        (raises :class:`RequestShed`) or clamps.  Order matters — the
        brownout priority gate and the SLO shedder both reject at this
        edge so a shed request costs zero queue space and zero prefill,
        and the rejection is always loud."""
        if not self._in_flood:
            self._submit_ord += 1
            if self.chaos and self.chaos.matching(
                    "poison_request", self._submit_ord, key="req"):
                req.poisoned = True
                self.poisoned_total += 1
                ft_chaos._record("poison_request", req=self._submit_ord,
                                 rid=req.request_id)
        if self.brownout_level >= 3 \
                and req.priority > self.priority_only_max:
            self._shed(req, now,
                       f"brownout level {self.brownout_level} "
                       f"({BROWNOUT_STEPS[2]}): only priority <= "
                       f"{self.priority_only_max} admitted")
        if self.shed_active and self.shed_below is not None \
                and req.priority > self.shed_below:
            self._shed(req, now,
                       f"SLO breach in lane {self.shed_below}: "
                       f"shedding priority > {self.shed_below}")
        if self.brownout_level >= 1 \
                and req.max_new_tokens > self.clamp_new_tokens:
            req.clamped_from = req.max_new_tokens
            req.max_new_tokens = self.clamp_new_tokens
            self.clamped_total += 1

    def _shed(self, req: Request, now: float, reason: str) -> None:
        req.state = RequestState.REJECTED
        req.shed_reason = reason
        req.finished_ts = now
        self.shed_total += 1
        self.observe_terminal(req)
        self._engine._tm.rejected(1)
        if getattr(self._engine, "meter", None) is not None:
            self._engine.meter.on_shed(req.tenant)
        obs_resil.record_shed(self._name, rid=req.request_id,
                              priority=req.priority, reason=reason)
        raise RequestShed(req, reason)

    def prefix_writes_suspended(self) -> bool:
        """Brownout step 2: extraction WRITES stop (no device span
        reads to grow the pool) while pool READS keep serving hits."""
        return self.brownout_level >= 2

    # ---------------------------------------------------------- poll edge
    def on_poll_start(self, engine, now: float) -> None:
        """Called at the top of every ``poll()``: chaos injections
        first (they create the pressure), then the SLO evaluation and
        the brownout ladder react to it."""
        self._polls += 1
        tick = engine._ticks
        plan = self.chaos
        if plan:
            for f in plan.matching("slow_tick", tick, key="tick"):
                ms = 50.0 if f.magnitude is None else float(f.magnitude)
                ft_chaos._record("slow_tick", tick=tick, ms=ms)
                time.sleep(ms / 1e3)
            ft_chaos.maybe_kill(plan, tick, key="tick")
            for f in plan.matching("queue_flood", tick, key="tick"):
                n = 8 if f.magnitude is None else int(f.magnitude)
                self._flood(engine, tick, n)
            for slot, req in list(engine._by_slot.items()):
                if req.poisoned and req.state is RequestState.DECODING:
                    engine.requeue(req, "chaos_poison")
        self._evaluate_slos(now)
        self._update_brownout(engine)

    def _flood(self, engine, tick: int, n: int) -> None:
        """Inject ``n`` deterministic lowest-priority requests — the
        overload burst.  Token content derives from (tick, i) alone, so
        two runs of the same plan see byte-identical floods.  Floods go
        through ``try_submit`` (their OWN sheds/rejects count — that is
        the load-shedding story under test) and never consume
        poison_request ordinals."""
        vocab = engine.session.cfg.vocab_size
        ft_chaos._record("queue_flood", tick=tick, n=n)
        self._in_flood = True
        try:
            for i in range(n):
                rng = np.random.default_rng((tick << 16) + i)
                toks = rng.integers(
                    0, vocab, (self.flood_prompt_len,)).astype(np.int32)
                engine.try_submit(
                    toks, max_new_tokens=self.flood_new_tokens,
                    priority=self.flood_priority,
                    request_id=f"flood_t{tick}_{i}")
                self.floods_injected += 1
        finally:
            self._in_flood = False

    # --------------------------------------------------------- SLO engine
    def _evaluate_slos(self, now: float) -> None:
        worst = None      # (priority, metric, p99, target) of a breach
        for slo in self.slos:
            lane = self._lanes[slo.priority]
            if self._polls - self._lane_last_sample[slo.priority] \
                    >= self.recover_polls:
                continue   # stale window (lane silent) = healthy
            for metric, target in (("ttft", slo.ttft_p99_ms),
                                   ("qwait", slo.queue_wait_p99_ms)):
                if target is None:
                    continue
                xs = lane[metric]
                if len(xs) < self.min_samples:
                    continue
                p99 = _p99(xs)
                if p99 > target and (worst is None
                                     or slo.priority < worst[0]):
                    worst = (slo.priority, metric, p99, target)
        if worst is not None:
            lane, metric, p99, target = worst
            newly = not self.shed_active or self.shed_below is None \
                or lane < self.shed_below
            self.shed_active = True
            self.shed_below = lane if self.shed_below is None \
                else min(self.shed_below, lane)
            self._healthy_streak = 0
            if newly:
                self.slo_breaches += 1
                obs_resil.record_shed_state(
                    self._name, active=True, lane=lane,
                    metric=metric, p99_ms=round(p99, 3),
                    target_ms=target)
        elif self.shed_active:
            self._healthy_streak += 1
            if self._healthy_streak >= self.recover_polls:
                lane = self.shed_below
                self.shed_active = False
                self.shed_below = None
                self._healthy_streak = 0
                obs_resil.record_shed_state(self._name, active=False,
                                            lane=lane)

    def _update_brownout(self, engine) -> None:
        # pressure = deep queue OR an armed shedder (SLO pain counts
        # even when the queue itself is short)
        frac = engine._queued / engine.max_queue
        if frac >= self.brownout_high or self.shed_active:
            self._pressure_streak += 1
            self._calm_streak = 0
        elif frac <= self.brownout_low and not self.shed_active:
            self._calm_streak += 1
            self._pressure_streak = 0
        else:
            self._pressure_streak = 0
            self._calm_streak = 0
        if self._pressure_streak >= self.brownout_after \
                and self.brownout_level < len(BROWNOUT_STEPS):
            self.brownout_level += 1
            self._pressure_streak = 0
            obs_resil.record_brownout(
                self._name, level=self.brownout_level,
                step=BROWNOUT_STEPS[self.brownout_level - 1],
                direction="enter")
        elif self._calm_streak >= self.brownout_recover \
                and self.brownout_level > 0:
            step = BROWNOUT_STEPS[self.brownout_level - 1]
            self.brownout_level -= 1
            self._calm_streak = 0
            obs_resil.record_brownout(self._name,
                                      level=self.brownout_level,
                                      step=step, direction="exit")

    # -------------------------------------------------------- observations
    def observe_queue_wait(self, req: Request, wait_s: float) -> None:
        lane = self._lanes.get(req.priority)
        if lane is not None:
            lane["qwait"].append(wait_s * 1e3)
            self._lane_last_sample[req.priority] = self._polls

    def observe_first_token(self, req: Request, ttft_s: float) -> None:
        lane = self._lanes.get(req.priority)
        if lane is not None:
            lane["ttft"].append(ttft_s * 1e3)
            self._lane_last_sample[req.priority] = self._polls

    def observe_terminal(self, req: Request) -> None:
        """Terminal-state attainment ledger: a DONE request met its
        lane's SLO iff its TTFT landed under the lane target; every
        other terminal state (shed, expired, failed, cancelled) is a
        miss — attainment must count the drops, not hide them."""
        led = self._attain.get(req.priority)
        if led is None:
            return
        led[1] += 1
        if req.state is not RequestState.DONE:
            return
        slo = next(s for s in self.slos if s.priority == req.priority)
        if slo.ttft_p99_ms is not None:
            ttft = req.ttft_s
            if ttft is not None and ttft * 1e3 <= slo.ttft_p99_ms:
                led[0] += 1
        else:
            led[0] += 1   # queue-wait-only lane: completing meets it

    def attainment(self, priority: int) -> float | None:
        """Fraction of this lane's TERMINAL requests that completed
        within their SLO (None before any terminal request)."""
        led = self._attain.get(priority)
        if led is None or led[1] == 0:
            return None
        return led[0] / led[1]

    def attainment_counts(self, priority: int) -> tuple[int, int]:
        """The lane's raw (met, total) ledger — the form a fleet
        router SUMS across replicas so fleet attainment is the
        request-weighted aggregate, not a mean of per-replica
        ratios."""
        led = self._attain.get(priority)
        return (0, 0) if led is None else (led[0], led[1])

    # ------------------------------------------------------------- reading
    def metrics(self) -> dict:
        lanes = {}
        for slo in self.slos:
            w = self._lanes[slo.priority]
            lanes[str(slo.priority)] = {
                "ttft_p99_ms": round(_p99(w["ttft"]), 3)
                if w["ttft"] else None,
                "ttft_target_ms": slo.ttft_p99_ms,
                "queue_wait_p99_ms": round(_p99(w["qwait"]), 3)
                if w["qwait"] else None,
                "queue_wait_target_ms": slo.queue_wait_p99_ms,
                "attainment": (round(a, 4)
                               if (a := self.attainment(slo.priority))
                               is not None else None),
            }
        return {
            "brownout_level": self.brownout_level,
            "brownout_steps_active": list(
                BROWNOUT_STEPS[:self.brownout_level]),
            "budget_clamped_total": self.clamped_total,
            "floods_injected": self.floods_injected,
            "journal_path": self._journal_path,
            "lanes": lanes,
            "poisoned_total": self.poisoned_total,
            "shed_active": self.shed_active,
            "shed_below_priority": self.shed_below,
            "shed_total": self.shed_total,
            "slo_breaches": self.slo_breaches,
        }
