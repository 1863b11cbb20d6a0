"""Disaggregated multi-replica serving of the port (host-only copy of
paddle_tpu/serving/fleet.py): the router tier over N engine replicas.

:class:`ServingFleet` fronts N :class:`ServingEngine` replicas (each over
its own :class:`~paddle_tpu_torch.inference.GenerationSession`; replicas
on one card may share one set of weight tensors) with:

- **Prefix-affinity routing**: the router hashes a prompt into the same
  chained decode-block hashes the replicas' :class:`PrefixCache` pools
  key by (``prefix_cache.chain_keys``) and routes to the replica that
  owns the longest matching chain — scored against the replica pool
  (:meth:`PrefixCache.peek`, no mutation) plus the router's own bounded
  routed-chain record, which pins a shared prefix to one replica from
  its first sighting. Cold prompts go to the least-loaded replica
  (pending requests, then free slots).
- **Prefill/decode disaggregation**: a ``role="prefill"`` replica runs
  chunked prefill and decodes ONE token (the TTFT token); the finished
  K/V span then hands off to a ``role="decode"`` replica as an explicit
  span copy (:func:`plan_handoff`: block-granular ``(dst_off, src_off,
  length)`` entries). A paged source materializes its pages into device
  tensors (``GenerationSession.materialize_span``), so a handoff never
  ships a page reference. The span lands in the decode replica's prefix
  pool (:meth:`PrefixCache.inject`) and the request resumes
  (:meth:`ServingEngine.resume`): prefix copy + suffix prefill
  re-create the K/V, so greedy streams match a monolithic engine.
- **Fleet-level SLO + failover**: the fleet keeps its own per-lane
  attainment ledger over final outcomes, merges the replicas' policy
  ledgers, metrics and meters, and routes around sick replicas (armed
  shedder, deep brownout). A dead replica (:meth:`ServingFleet.
  kill_replica`, the in-process stand-in for SIGKILL) is recovered from
  its journal file: every in-flight request replays onto a survivor as a
  retry carrying its generated tokens; terminal entries are left alone.

All of it is host-side routing over the engines' own entry points.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np

from ..observability import ServingMetrics, TenantMeter
from ..observability import fleet as obs_fleet
from ..observability import tracing
from .engine import QueueFull, ServingEngine
from .prefix_cache import chain_keys
from .request import Request, RequestState
from .resilience import RequestJournal, RequestShed

__all__ = ["ServingFleet", "FleetReplica", "KVHandoff", "plan_handoff"]


def plan_handoff(span: int, block: int):
    """Explicit copy plan for a prefill→decode K/V span handoff:
    ``[(dst_off, src_off, length), ...]`` covering ``span`` tokens in
    ``block``-granular contiguous copies — the
    ``ft/reshard.py:plan_reshard`` per-rank streaming-copy shape
    specialized to a 1→1 span stream (offsets coincide; each entry is
    one contiguous copy a receiver can apply without materializing the
    rest).  Kept block-granular so the receiving pool can key every
    entry by its chain hash."""
    if span < 0 or block < 1:
        raise ValueError(f"need span >= 0 and block >= 1, got "
                         f"span={span}, block={block}")
    return [(off, off, min(block, span - off))
            for off in range(0, span, block)]


class KVHandoff:
    """One prefill→decode handoff in flight: the request identity and
    budget, the K/V span (concatenated cache-layout arrays), the
    block-copy plan that describes how the receiver splits it, and the
    distributed-tracing context (``trace`` — the ``(trace_id,
    handoff_span_id)`` tuple the router stamps in ``_apply_handoff``,
    ``None`` when tracing is disarmed): the decode-side ``resume``
    consumes it, so the new incarnation parents to the handoff span
    and the trace stays connected across the replica boundary."""

    __slots__ = ("rid", "tokens", "generated", "max_new_tokens",
                 "priority", "deadline", "temperature", "seed", "span",
                 "plan", "k", "v", "trace", "src_pages", "tenant")

    def __init__(self, *, rid, tokens, generated, max_new_tokens,
                 priority, deadline, span, plan, k, v, temperature=0.0,
                 seed=None, trace=None, src_pages=None, tenant=None):
        self.rid = rid
        # tenant attribution rides the wire object so the decode
        # replica's meter keeps charging the same tenant
        self.tenant = tenant
        self.tokens = tokens
        self.generated = generated
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        self.deadline = deadline
        # sampling lane identity: the RESOLVED (temperature, seed) the
        # request decodes under — rides the wire object so the decode
        # replica re-derives the exact same per-position draws the
        # source would have
        self.temperature = temperature
        self.seed = seed
        self.span = span
        self.plan = plan
        self.k = k
        self.v = v
        self.trace = trace
        # paged source only: the physical page ids the span occupied on
        # the SOURCE replica — audit metadata for the handoff event (the
        # span itself always ships materialized bytes; page ids are
        # meaningless outside their own pool)
        self.src_pages = src_pages

    def blocks(self):
        """Split the span per the plan — the [(k, v)] block pairs the
        receiving pool keys by chain hash.  Slices by the SOURCE
        offsets (the span arrays are the source side; a plan with
        shifted destination offsets must not change what is read).
        Scaled-int8 spans split codes + step planes together
        (span_slice), so handed-off blocks land with their scales
        bit-exact."""
        from .prefix_cache import span_slice
        return [(span_slice(self.k, s, n), span_slice(self.v, s, n))
                for _, s, n in self.plan]


class FleetReplica:
    """One engine behind the router: identity, role, liveness, and the
    router-side counters.  ``role``: ``"mixed"`` (prefill + decode —
    the default), ``"prefill"`` (chunked prefill + the first token
    only; hands the K/V span off), ``"decode"`` (receives handoffs and
    decodes; prefills only handoff suffixes)."""

    ROLES = ("mixed", "prefill", "decode")

    def __init__(self, name: str, engine: ServingEngine,
                 role: str = "mixed"):
        if role not in self.ROLES:
            raise ValueError(f"replica {name!r}: role must be one of "
                             f"{self.ROLES}, got {role!r}")
        if role in ("prefill", "decode") and engine.prefix_cache is None:
            raise ValueError(
                f"replica {name!r} (role {role!r}) needs a prefix "
                "cache: the K/V handoff exports from the prefill "
                "pool and injects into the decode pool — construct "
                "the engine with prefix_cache_blocks > 0")
        if role == "prefill" and engine.prefix_cache.promote_after != 1:
            raise ValueError(
                f"prefill replica {name!r} needs "
                "prefix_promote_after=1: the handoff exports a "
                "prompt's blocks the moment prefill finishes — "
                "second-touch promotion would stall every unique "
                "prompt's handoff behind a recurrence that never "
                "comes")
        self.name = str(name)
        self.engine = engine
        self.role = role
        self.alive = True
        self.routed = 0

    @property
    def load(self) -> tuple:
        """Least-loaded ranking key: pending requests first (queued +
        in-flight — the backlog a new request queues behind), then
        negated free slots (admission headroom breaks ties)."""
        return (self.engine.pending,
                -len(self.engine.session.free_slots()))

    def healthy(self) -> bool:
        """Route-around signal: a replica whose shedder is armed or
        whose brownout ladder reached priority-only admission is SICK —
        the router prefers healthy peers while this one recovers (it
        stays a last-resort fallback; its own policy still gates)."""
        pol = self.engine.resil
        if pol is None:
            return True
        return not (pol.shed_active or pol.brownout_level >= 3)

    @property
    def journal_path(self) -> str | None:
        pol = self.engine.resil
        if pol is None or pol.journal is None:
            return None
        return pol.journal.path


class ServingFleet:
    """N serving-engine replicas behind one prefix-affinity router.

    >>> fleet = ServingFleet([("r0", eng0), ("r1", eng1)],
    ...                      slos=[LaneSLO(priority=0,
    ...                                    ttft_p99_ms=500.0)])
    >>> req = fleet.submit(prompt_tokens, max_new_tokens=32)
    >>> fleet.run()
    >>> fleet.outputs()["req0"]

    ``replicas``: ``(name, engine)`` or ``(name, engine, role)``
    tuples, or prebuilt :class:`FleetReplica` objects.  All engines
    must share one ``decode_block`` (the routing hash granularity) —
    the router asserts it.  ``slos``: fleet-level :class:`LaneSLO`
    lanes for the FINAL-outcome attainment ledger (independent of any
    per-replica policies).  ``affinity=False`` degrades routing to
    pure least-loaded — the A/B arm the affinity tests compare
    against."""

    def __init__(self, replicas, *, slos=(), affinity: bool = True,
                 routed_keys_cap: int = 4096, name: str = "fleet",
                 clock=time.perf_counter):
        reps = []
        for r in replicas:
            reps.append(r if isinstance(r, FleetReplica)
                        else FleetReplica(*r))
        if not reps:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in reps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        blocks = {r.engine.session.cfg.decode_block for r in reps}
        if len(blocks) != 1:
            raise ValueError(
                f"replicas disagree on decode_block ({sorted(blocks)}) "
                "— the routing hash granularity must be fleet-wide")
        self.replicas = reps
        self._by_name = {r.name: r for r in reps}
        self.block = blocks.pop()
        self.affinity = bool(affinity)
        self.name = str(name)
        self.clock = clock
        has_prefill = any(r.role == "prefill" for r in reps)
        if has_prefill and not any(r.role in ("mixed", "decode")
                                   for r in reps):
            raise ValueError("prefill replicas need at least one "
                             "mixed/decode replica to hand off to")
        self.disaggregated = has_prefill
        # fleet-level SLO lanes + FINAL-outcome attainment ledger (a
        # replica shed the router recovers is not a fleet miss; a
        # router-edge shed is)
        self.slos = tuple(sorted(slos, key=lambda s: s.priority))
        self._attain = {s.priority: [0, 0] for s in self.slos}
        # rid -> latest Request incarnation (failover/handoff may
        # re-admit under a new object; the fleet tracks the lineage)
        self._tracked: dict[str, Request] = {}
        # rid -> (submit_ts, first_token_ts|None, budget, priority,
        #         deadline, replica_name) — the cross-incarnation
        # truth the ledger and failover read
        self._meta: dict[str, list] = {}
        self._open: set[str] = set()
        self._handoff: set[str] = set()   # rids awaiting prefill→decode
        # bounded routed-chain record: chain key -> replica name.  This
        # is the router's PREDICTION of pool ownership — it pins a
        # shared prefix to one replica from its first sighting, before
        # the pool's promotion lifecycle has anything to show.
        self._routed: OrderedDict[str, str] = OrderedDict()
        self._routed_cap = int(routed_keys_cap)
        # unconditional counters (metrics() works without telemetry)
        self.routed_total = 0
        self.affinity_routed_total = 0
        self.router_sheds_total = 0
        self.handoffs_total = 0
        self.failovers_total = 0
        self.failover_replayed_total = 0
        obs_fleet.set_replicas_alive(self.name, len(reps))

    def prewarm(self, background: bool = False) -> dict:
        """Prewarm every live replica's engine (see
        :meth:`ServingEngine.prewarm`: each replica's session captures
        its tick graphs before traffic). Returns per-replica results (or
        threads when background)."""
        return {rep.name: rep.engine.prewarm(background=background)
                for rep in self.replicas if rep.alive}

    # ------------------------------------------------------------ routing
    def _chain(self, tokens) -> list[str]:
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        # cap one short like the engine's own match: the last position
        # must prefill anyway, so a full-prompt chain buys nothing
        return chain_keys(tokens, self.block,
                          max(0, tokens.shape[0] - 1) // self.block)

    def _affinity_tokens(self, rep: FleetReplica, keys) -> int:
        """Longest leading chain run this replica owns: pooled blocks
        (probed, no side effects) or router-routed keys."""
        n = 0
        pool = rep.engine.prefix_cache
        for key in keys:
            if (pool is not None and pool.has_block(key)) \
                    or self._routed.get(key) == rep.name:
                n += 1
            else:
                break
        return n * self.block

    def _record_routed(self, keys, rep_name: str) -> None:
        for key in keys:
            self._routed[key] = rep_name
            self._routed.move_to_end(key)
        while len(self._routed) > self._routed_cap:
            self._routed.popitem(last=False)

    def _rank(self, keys, candidates):
        """Routing order over candidate replicas: healthy before sick,
        longest affinity chain first, least-loaded as the tiebreak and
        the cold-prompt fallback.  Returns [(replica, affinity_tokens,
        policy), ...] best-first."""
        scored = []
        for rep in candidates:
            aff = (self._affinity_tokens(rep, keys)
                   if self.affinity and keys else 0)
            scored.append((rep, aff))
        scored.sort(key=lambda t: (not t[0].healthy(), -t[1],
                                   t[0].load, t[0].name))
        return [(rep, aff, "affinity" if aff > 0 else "least_loaded")
                for rep, aff in scored]

    def _entry_candidates(self):
        """Where NEW requests go: prefill replicas when disaggregated
        (decode replicas only ever prefill handoff suffixes), mixed
        replicas otherwise."""
        role = "prefill" if self.disaggregated else "mixed"
        return [r for r in self.replicas if r.alive and r.role == role]

    # ------------------------------------------------------------- submit
    def submit(self, tokens, max_new_tokens: int = 32,
               priority: int = 0, deadline: float | None = None,
               request_id: str | None = None,
               temperature: float | None = None,
               seed: int | None = None,
               tenant: str | None = None) -> Request:
        """Route one request onto a replica.  Tries candidates in
        affinity/health/load order; a replica-level refusal
        (:class:`QueueFull` backpressure or a policy
        :class:`RequestShed`) falls through to the next candidate —
        the ROUTER sheds only when every candidate refused, and that
        edge shed is what the fleet attainment ledger counts as a lane
        miss."""
        keys = self._chain(tokens)
        ranked = self._rank(keys, self._entry_candidates())
        if not ranked:
            raise RuntimeError("fleet has no live entry replicas")
        now = self.clock()
        refusals = []
        for tried, (rep, aff, policy) in enumerate(ranked):
            try:
                if self.disaggregated:
                    # the prefill replica decodes exactly ONE token
                    # (the TTFT token); the remaining budget decodes on
                    # the handoff target
                    req = rep.engine.submit(
                        tokens, max_new_tokens=1, priority=priority,
                        deadline=deadline, request_id=request_id,
                        temperature=temperature, seed=seed,
                        tenant=tenant)
                else:
                    req = rep.engine.submit(
                        tokens, max_new_tokens=max_new_tokens,
                        priority=priority, deadline=deadline,
                        request_id=request_id,
                        temperature=temperature, seed=seed,
                        tenant=tenant)
            except (QueueFull, RequestShed) as exc:
                refusals.append(f"{rep.name}: "
                                f"{type(exc).__name__}")
                continue
            rep.routed += 1
            self.routed_total += 1
            if policy == "affinity":
                self.affinity_routed_total += 1
            self._record_routed(keys, rep.name)
            tracing.on_route(self.name, req, replica=rep.name,
                             policy=policy, affinity=aff,
                             fallbacks=tried)
            rid = req.request_id
            self._tracked[rid] = req
            self._meta[rid] = [now, None, int(max_new_tokens),
                               int(priority), deadline, rep.name]
            self._open.add(rid)
            if self.disaggregated:
                self._handoff.add(rid)
            obs_fleet.record_route(self.name, rid=rid, replica=rep.name,
                                   policy=policy, affinity_tokens=aff,
                                   fallbacks=tried)
            return req
        # every candidate refused: the rejection moves to the router
        # edge — loud, audited, and a MISS in the fleet lane ledger
        self.router_sheds_total += 1
        self._count_final(priority, met=False)
        req = Request(tokens=tokens, max_new_tokens=int(max_new_tokens),
                      priority=int(priority), deadline=deadline,
                      request_id=request_id, tenant=tenant)
        req.state = RequestState.REJECTED
        req.arrival_ts = req.finished_ts = now
        reason = ("router shed: every candidate replica refused ("
                  + "; ".join(refusals) + ")")
        req.shed_reason = reason
        obs_fleet.record_router_shed(self.name, rid=req.request_id,
                                     priority=priority, reason=reason)
        raise RequestShed(req, reason)

    def try_submit(self, tokens, **kw) -> Request | None:
        """:meth:`submit` returning ``None`` on a router shed (still
        counted — it is a real edge rejection)."""
        try:
            return self.submit(tokens, **kw)
        except RequestShed:
            return None

    # ----------------------------------------------------------- handoff
    def _export_handoff(self, rep: FleetReplica, req: Request,
                        budget: int) -> KVHandoff | None:
        """Build the K/V span handoff for a prefill-finished request:
        the prompt's pooled blocks (extracted by the prefill replica's
        own pool the moment prefill finalized), concatenated into one
        span with the block-copy plan that describes it."""
        work = req.resume_tokens()
        span_len, _, blocks = rep.engine.prefix_cache.peek(
            work, max_prefix=work.shape[0] - 1)
        if not blocks:
            return None
        from .prefix_cache import PageSpan, span_concat
        k = span_concat([b[0] for b in blocks])
        v = span_concat([b[1] for b in blocks])
        src_pages = None
        if isinstance(k, PageSpan):
            # a paged source pools spans BY REFERENCE — meaningless to
            # a receiver with no access to the source page pool, so the
            # handoff materializes the bytes here (one page gather on
            # the device) and ships the page list as audit metadata only
            src_pages = list(k.pages)
            k, v = rep.engine.session.materialize_span(k, v)
        # .trace is stamped by _apply_handoff once the handoff span
        # exists (the decode incarnation parents to the SPAN, not to
        # the pre-handoff context)
        return KVHandoff(rid=req.request_id, tokens=req.tokens,
                         generated=list(req.output),
                         max_new_tokens=budget, priority=req.priority,
                         deadline=req.deadline, span=span_len,
                         plan=plan_handoff(span_len, self.block),
                         k=k, v=v, temperature=req.temperature,
                         seed=req.seed, src_pages=src_pages,
                         tenant=req.tenant)

    def _apply_handoff(self, src: FleetReplica, req: Request) -> bool:
        """Move a prefill-finished request to a decode replica: inject
        the span into the target pool (per the block plan), then RESUME
        — the prefix-copy + suffix-prefill admission rebuilds the K/V
        bit-identically, so greedy decode continues exactly where a
        monolithic engine would.  Returns False when every target's
        queue is full (backpressure — the handoff stays pending and
        the next poll retries)."""
        rid = req.request_id
        meta = self._meta[rid]
        budget = meta[2]
        if len(req.output) >= budget:
            # budget was 1: the prefill token IS the whole answer
            self._handoff.discard(rid)
            return True
        cands = [r for r in self.replicas
                 if r.alive and r.role in ("mixed", "decode")]
        ranked = self._rank(self._chain(req.resume_tokens()), cands)
        if not ranked:
            raise RuntimeError(
                f"fleet has no live decode replica for handoff {rid}")
        hand = self._export_handoff(src, req, budget)
        # the handoff span parents to the prefill incarnation's root;
        # the decode incarnation parents to the handoff span — across
        # tracks, so the chrome export renders the seam as an arrow.
        # The context rides the KVHandoff itself (the wire object a
        # multi-host transport serializes), and resume() consumes it
        # FROM there.
        h_span = tracing.on_handoff(
            self.name, req, src=src.name,
            span_tokens=hand.span if hand is not None else 0)
        ctx = (req.trace_id, h_span["sid"]) if h_span is not None \
            else None
        if hand is not None:
            hand.trace = ctx
        for dst, _, _ in ranked:
            try:
                new_req = dst.engine.resume(
                    req.tokens, generated=req.output,
                    max_new_tokens=budget, priority=req.priority,
                    deadline=req.deadline, request_id=rid,
                    temperature=req.temperature, seed=req.seed,
                    trace_ctx=hand.trace if hand is not None else ctx,
                    tenant=req.tenant)
            except QueueFull:
                continue
            if hand is not None:
                # inject only into the replica that ACCEPTED: resume
                # merely enqueues, and the prefix match runs at a later
                # poll's admission, so inject-after-resume is safe —
                # while inject-before would leave (and LRU-touch)
                # blocks in every refusing replica's pool, evicting
                # its hot shared prefixes for a request it never
                # serves
                dst.engine.prefix_cache.inject(hand.tokens,
                                               hand.blocks())
            self._handoff.discard(rid)
            self._tracked[rid] = new_req
            meta[5] = dst.name
            self.handoffs_total += 1
            tracing.end_seam(h_span, dst=dst.name, accepted=True)
            obs_fleet.record_handoff(
                self.name, rid=rid, src=src.name, dst=dst.name,
                span_tokens=hand.span if hand is not None else 0,
                plan_entries=len(hand.plan) if hand is not None else 0,
                src_pages=hand.src_pages if hand is not None else None)
            return True
        tracing.end_seam(h_span, dst=None, accepted=False)
        return False

    # ------------------------------------------------------------ ticking
    def poll(self) -> dict:
        """One fleet tick: poll every live replica, move finished
        prefill-role requests through their handoff, harvest terminal
        outcomes into the fleet ledger.  Returns aggregate
        {"finished": [...], "emitted": n}."""
        finished, emitted = [], 0
        for rep in self.replicas:
            if not rep.alive:
                continue
            out = rep.engine.poll()
            emitted += out["emitted"]
        self._sweep(finished)
        return {"finished": finished, "emitted": emitted}

    def _sweep(self, finished: list) -> None:
        """Harvest state off the tracked requests: first-token stamps
        (cross-incarnation — the ledger must credit the PREFILL
        replica's token, not a resume's), handoffs, finals.  Iterates
        in submit order (``_tracked`` preserves insertion), so two
        identical runs make identical handoff/ledger decisions."""
        for rid in [r for r in self._tracked if r in self._open]:
            req = self._tracked[rid]
            meta = self._meta[rid]
            if meta[1] is None and req.first_token_ts is not None:
                meta[1] = req.first_token_ts
            if not req.finished():
                continue
            if rid in self._handoff:
                if req.state is RequestState.DONE:
                    src = self._by_name[meta[5]]
                    self._apply_handoff(src, req)
                    continue
                self._handoff.discard(rid)   # expired/failed at prefill
            self._open.discard(rid)
            finished.append(req)
            self._observe_final(req, meta)

    def _count_final(self, priority: int, met: bool) -> None:
        led = self._attain.get(priority)
        if led is not None:
            led[1] += 1
            led[0] += int(met)

    def _observe_final(self, req: Request, meta) -> None:
        """Fleet attainment: ONE ledger entry per request lineage, at
        its FINAL outcome (mirrors ``ResiliencePolicy.
        observe_terminal``, lifted across incarnations: DONE within
        the lane's TTFT target = met; every other terminal state — or
        a DONE whose first token missed the target — is a miss)."""
        slo = next((s for s in self.slos
                    if s.priority == req.priority), None)
        if slo is None:
            return
        if req.state is not RequestState.DONE:
            self._count_final(req.priority, met=False)
            return
        if slo.ttft_p99_ms is None:
            self._count_final(req.priority, met=True)
            return
        first = meta[1]
        met = first is not None \
            and (first - meta[0]) * 1e3 <= slo.ttft_p99_ms
        self._count_final(req.priority, met=met)

    def run(self, max_ticks: int | None = None,
            deadline: float | None = None) -> int:
        """Poll until every fleet-routed request is terminal (or
        ``max_ticks``).  ``deadline`` (wall seconds) bounds the drain
        with a loud :class:`TimeoutError` naming the stuck requests."""
        n = 0
        t_end = None if deadline is None \
            else time.monotonic() + deadline
        while self._open:
            if t_end is not None and time.monotonic() > t_end:
                stuck = sorted(self._open)
                raise TimeoutError(
                    f"fleet drain exceeded its {deadline}s deadline "
                    f"after {n} tick(s) with {len(stuck)} request(s) "
                    f"still live: {', '.join(stuck[:8])}"
                    + (" ..." if len(stuck) > 8 else ""))
            self.poll()
            n += 1
            if max_ticks is not None and n >= max_ticks:
                break
        return n

    # ----------------------------------------------------------- failover
    def kill_replica(self, name: str) -> list:
        """Simulated replica SIGKILL + fleet recovery.  The replica is
        torn down with crash semantics (:meth:`ServingEngine.abandon`:
        no drain, no cancels, no journal end records — the journal
        FILE keeps only what per-poll flushes already handed the
        kernel), then its journal is scanned FROM DISK — the same
        evidence a real crash leaves — and every in-flight request
        replays onto a surviving replica as a RETRY carrying its
        generated-so-far tokens: bit-identical greedy resume, zero
        losses.  Already-terminal journal entries are left alone.
        Returns the resumed :class:`Request` objects."""
        rep = self._by_name[name]
        if not rep.alive:
            raise ValueError(f"replica {name!r} is already dead")
        jpath = rep.journal_path
        rep.alive = False
        rep.engine.abandon()
        rep.engine.session.close()   # host-side gauge hygiene only
        obs_fleet.set_replicas_alive(
            self.name, sum(1 for r in self.replicas if r.alive))
        if not any(r.alive for r in self.replicas):
            raise RuntimeError(
                f"killed the last live replica ({name!r}) — nothing "
                "left to fail over onto")
        entries = RequestJournal.scan(jpath) if jpath else {}
        resumed, already_done = [], 0
        for rid, e in entries.items():
            if e["state"] is not None:
                already_done += 1
                continue
            meta = self._meta.get(rid)
            # the fleet's meta is authoritative for the budget: a
            # disaggregated prefill journal records the 1-token TTFT
            # budget, not the request's real one
            budget = meta[2] if meta is not None else e["new"]
            prio = meta[3] if meta is not None else e["prio"]
            dl = meta[4] if meta is not None else e["deadline"]
            tokens = np.asarray(e["tokens"], np.int32)
            # a mid-prefill (pre-handoff) request prefers a surviving
            # PREFILL replica (budget 1, handoff later); with none
            # left, a mixed/decode survivor owns the whole request —
            # resume re-prefills, nothing special to do
            pre_handoff = rid in self._handoff
            cands = [r for r in self.replicas
                     if r.alive and r.role == "prefill"] \
                if pre_handoff else []
            if not cands:
                self._handoff.discard(rid)
                pre_handoff = False
                cands = [r for r in self.replicas if r.alive
                         and r.role in ("mixed", "decode")]
            ranked = self._rank(self._chain(tokens), cands)
            if not ranked:
                raise RuntimeError(
                    f"failover of {rid} found no surviving "
                    "mixed/decode replica to resume onto")
            jtrace = e.get("trace")
            # ONE failover span per recovery, parented to the crashed
            # incarnation (the context the journal FILE preserved);
            # the survivor's incarnation parents to the span, and the
            # span closes naming the replica that actually ACCEPTED
            f_span = tracing.on_failover(
                self.name, rid, tuple(jtrace) if jtrace else None,
                src=name)
            fctx = (jtrace[0], f_span["sid"]) if f_span is not None \
                else None
            req = None
            for dst, aff, _ in ranked:
                try:
                    req = dst.engine.resume(
                        tokens, generated=e["out"],
                        max_new_tokens=(1 if pre_handoff else budget),
                        priority=prio, deadline=dl, request_id=rid,
                        retries=e["retries"] + 1,
                        temperature=e.get("temp", 0.0),
                        seed=e.get("seed"), trace_ctx=fctx,
                        tenant=e.get("tenant"))
                except QueueFull:
                    continue
                break
            tracing.end_seam(f_span,
                             dst=dst.name if req is not None else None,
                             accepted=req is not None)
            if req is None:
                raise RuntimeError(
                    f"failover of {rid} found every surviving "
                    "replica's queue full — raise max_queue")
            dst.engine.session.telemetry.retried(1)
            resumed.append(req)
            if meta is not None:
                self._tracked[rid] = req
                meta[5] = dst.name
            obs_fleet.record_route(self.name, rid=rid, replica=dst.name,
                                   policy="failover",
                                   affinity_tokens=0)
        self.failovers_total += 1
        self.failover_replayed_total += len(resumed)
        obs_fleet.record_failover(self.name, replica=name,
                                  replayed=len(resumed),
                                  already_done=already_done,
                                  journal=jpath)
        # resumed DONE-at-kill requests (budget already spent) went
        # terminal inside resume(); harvest them immediately
        self._sweep([])
        return resumed

    # ------------------------------------------------------------ reading
    def attainment(self, priority: int) -> float | None:
        """Fleet-lane attainment over FINAL outcomes (router sheds
        included as misses); None before any final request."""
        led = self._attain.get(priority)
        if led is None or led[1] == 0:
            return None
        return led[0] / led[1]

    def replica_attainment_counts(self, priority: int) -> tuple:
        """Sum of the per-replica policy ledgers — the replica-level
        view (counts every terminal incarnation, including sheds the
        router then recovered elsewhere)."""
        met = total = 0
        for rep in self.replicas:
            pol = rep.engine.resil
            if pol is not None:
                m, t = pol.attainment_counts(priority)
                met += m
                total += t
        return met, total

    def outputs(self) -> dict:
        """rid -> generated tokens for every fleet-routed request (what
        tests compare across topologies)."""
        return {rid: list(req.output)
                for rid, req in self._tracked.items()}

    @property
    def pending(self) -> int:
        return len(self._open)

    @property
    def requests(self) -> list:
        """Latest incarnation of every fleet-routed request, in submit
        order (dict preserves insertion)."""
        return list(self._tracked.values())

    def prefix_hit_tokens_total(self) -> int:
        """Prompt tokens served from prefix pools across the fleet —
        EXCLUDING handoff resumes (a handoff hit is disaggregation
        transport, not shared-prefix reuse; counting it would let the
        disagg topology fake a higher hit rate)."""
        total = 0
        for rid, req in self._tracked.items():
            hit = req.prefix_hit_tokens
            if req.resumed_len > 0:
                # resumed incarnation: its prefix hit is the handoff /
                # failover copy; the ORIGINAL prefill-side hit was
                # counted on the first incarnation, which _tracked no
                # longer holds — conservatively count zero
                hit = 0
            total += hit
        return total

    def close(self, drain: bool = True) -> None:
        for rep in self.replicas:
            if rep.alive:
                rep.engine.close(drain=drain)

    def metrics(self) -> dict:
        """Fleet snapshot: merged ServingMetrics percentiles (bounded,
        deterministic), router counters, lane attainment (fleet-final
        AND replica-aggregate), per-replica engine metrics."""
        alive = [r for r in self.replicas if r.alive]
        merged = ServingMetrics.merged(
            self.name,
            [r.engine.session.telemetry for r in self.replicas])
        lanes = {}
        for slo in self.slos:
            a = self.attainment(slo.priority)
            rm, rt = self.replica_attainment_counts(slo.priority)
            lanes[str(slo.priority)] = {
                "attainment": round(a, 4) if a is not None else None,
                "ttft_target_ms": slo.ttft_p99_ms,
                "replica_ledger": {"met": rm, "total": rt},
            }
        # fleet-wide tenant attribution: merge every armed replica
        # meter (counter sums + keyed reservoir re-sample) so one
        # tenant's cross-replica spend reads as one row
        meters = [r.engine.meter for r in self.replicas
                  if getattr(r.engine, "meter", None) is not None]
        tenants = (TenantMeter.merged(self.name, meters).metrics()
                   if meters else None)
        out = {
            "affinity_routed_total": self.affinity_routed_total,
            "disaggregated": self.disaggregated,
            "failover_replayed_total": self.failover_replayed_total,
            "failovers_total": self.failovers_total,
            "handoffs_total": self.handoffs_total,
            "lanes": lanes,
            "merged": merged.metrics(),
            "prefix_hit_tokens_total": self.prefix_hit_tokens_total(),
            "replicas": {r.name: {"role": r.role, "alive": r.alive,
                                  "routed": r.routed}
                         for r in self.replicas},
            "replicas_alive": len(alive),
            "router_sheds_total": self.router_sheds_total,
            "routed_total": self.routed_total,
        }
        if tenants is not None:
            out["tenants"] = tenants
        return out
