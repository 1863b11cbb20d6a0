"""The port's serving fleet on the CPU (gpt tiny, f32): the scenarios of
tests/test_serving_fleet.py run against ``paddle_tpu_torch`` — prefix
affinity against round-robin, the least-loaded fallback, prefill/decode
handoffs equal to a monolithic engine, replica-kill failover from the
journal, the span export/import primitives and the fleet's metric
merges — and one two-tenant serve_trace trace replayed through a port
fleet and a reference fleet with a replica killed mid-trace, with equal
routes, streams and counters."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import ResiliencePolicy as JResiliencePolicy
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import ServingFleet as JServingFleet
from paddle_tpu_torch.models import gpt as tg

from paddle_tpu_torch.inference import GenerationSession as _Session
from paddle_tpu_torch.models.gpt import GPTConfig, init_params
from paddle_tpu_torch.observability.serving import (RESERVOIR_CAP,
                                                    ServingMetrics,
                                                    _Reservoir)
from paddle_tpu_torch.serving import (FleetReplica, LaneSLO, RequestShed,
                                      RequestState, ResiliencePolicy,
                                      ServingFleet, chain_keys, plan_handoff)

from paddle_tpu_torch.serving import ServingEngine as _Engine


# the port's entry points default to the card: these wrappers run the
# reference's scenarios on the CPU
def GenerationSession(params, cfg, **kw):
    return _Session(params, cfg, device="cpu", **kw)


def ServingEngine(session, *args, **kw):
    kw.setdefault("device", "cpu")
    return _Engine(session, *args, **kw)


def _cfg(**kw):
    kw.setdefault("decode_block", 8)
    return GPTConfig(vocab_size=64, hidden=32, n_layers=1, n_heads=2,
                     max_seq=64, dtype=torch.float32, micro_batches=1,
                     remat=False, **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    return cfg, init_params(cfg, 7, device="cpu")


def _engine(setup, slots=2, promote=2, resil=None, max_queue=64,
            pool=16):
    cfg, params = setup
    sess = GenerationSession(params, cfg, max_slots=slots,
                             max_prompt_len=24, max_len=48)
    return ServingEngine(sess, max_queue=max_queue, prefill_chunk=8,
                         prefix_cache_blocks=pool,
                         prefix_promote_after=promote, resilience=resil)


def _mt_prompts(rng, groups=2, per_group=4, cold=2, shared_len=16,
                prompt_len=22, vocab=64):
    """Interleaved multi-tenant prompts: per-group shared prefixes +
    unique tails, plus fully-cold rows."""
    prefixes = [rng.integers(0, vocab, (shared_len,)).astype(np.int32)
                for _ in range(groups)]
    rows = []
    for i in range(per_group):
        for g in range(groups):
            tail = rng.integers(0, vocab, (prompt_len - shared_len,)) \
                .astype(np.int32)
            rows.append((g, np.concatenate([prefixes[g], tail])))
    for _ in range(cold):
        rows.append((-1, rng.integers(0, vocab, (prompt_len,))
                     .astype(np.int32)))
    return rows


def _hit_tokens(engines) -> int:
    return sum(r.prefix_hit_tokens for e in engines for r in e.requests)


# ===================================================================
# handoff primitives
# ===================================================================
class TestHandoffPrimitives:
    def test_plan_handoff_covers_span_block_granular(self):
        assert plan_handoff(24, 8) == [(0, 0, 8), (8, 8, 8),
                                       (16, 16, 8)]
        assert plan_handoff(20, 8)[-1] == (16, 16, 4)
        assert plan_handoff(0, 8) == []
        covered = sum(n for _, _, n in plan_handoff(37, 8))
        assert covered == 37
        with pytest.raises(ValueError):
            plan_handoff(8, 0)

    def test_chain_keys_match_pool_keying(self):
        toks = np.arange(32, dtype=np.int32)
        keys = chain_keys(toks, 8)
        assert len(keys) == 4
        # chained: key i commits to the WHOLE prefix, so changing an
        # early token churns every later key
        toks2 = toks.copy()
        toks2[0] += 1
        assert chain_keys(toks2, 8)[-1] != keys[-1]
        assert chain_keys(toks, 8, 2) == keys[:2]

    def test_peek_has_no_side_effects(self, setup):
        eng = _engine(setup, promote=1)
        rng = np.random.default_rng(0)
        p = rng.integers(0, 64, (20,)).astype(np.int32)
        eng.submit(p, max_new_tokens=2)
        eng.run()
        pool = eng.prefix_cache
        before = dict(pool.stats())
        n, keys, blocks = pool.peek(p, max_prefix=p.shape[0] - 1)
        assert n == 16 and len(keys) == 2 and len(blocks) == 2
        assert pool.stats() == before   # no hits/misses/LRU accounting
        eng.close()

    def test_inject_then_match_serves_handoff_blocks(self, setup):
        src = _engine(setup, promote=1)
        dst = _engine(setup, promote=1)
        rng = np.random.default_rng(1)
        p = rng.integers(0, 64, (20,)).astype(np.int32)
        src.submit(p, max_new_tokens=2)
        src.run()
        _, _, blocks = src.prefix_cache.peek(p, max_prefix=19)
        added = dst.prefix_cache.inject(p, blocks)
        assert added == len(blocks) == 2
        assert dst.prefix_cache.stats()["injections"] == 2
        # re-inject is a no-op (chain-key commitment: same key = same
        # bits)
        assert dst.prefix_cache.inject(p, blocks) == 0
        n, blks = dst.prefix_cache.match(p, max_prefix=19)
        assert n == 16 and len(blks) == 2
        src.close(), dst.close()

    def test_export_import_kv_span_bit_exact(self, setup):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=3,
                                 max_prompt_len=16, max_len=32)
        rng = np.random.default_rng(2)
        p = rng.integers(0, 64, (1, 16)).astype(np.int32)
        [slot] = sess.admit(p)
        k, v = sess.export_kv_span(slot, 16)
        assert k.shape[2] == 16
        dst = sess.alloc_slot()
        assert sess.import_kv_span(dst, k, v) == 16
        k2, v2 = sess.export_kv_span(dst, 16)
        np.testing.assert_array_equal(np.asarray(k), np.asarray(k2))
        np.testing.assert_array_equal(np.asarray(v), np.asarray(v2))
        # the streaming (pre-split blocks) form lands identically
        dst2 = sess.alloc_slot()
        plan = plan_handoff(16, 8)
        blocks = [(k[:, :, o:o + n], v[:, :, o:o + n])
                  for o, _, n in plan]
        assert sess.import_kv_span(dst2, blocks=blocks) == 16
        k3, _ = sess.export_kv_span(dst2, 16)
        np.testing.assert_array_equal(np.asarray(k), np.asarray(k3))
        sess.close()


# ===================================================================
# routing
# ===================================================================
class TestRouting:
    def test_affinity_beats_round_robin_on_hit_rate(self, setup):
        rng = np.random.default_rng(3)
        # 3 groups over 2 replicas: the interleave (g0,g1,g2,g0,...)
        # never aligns with an i%2 round-robin, so RR genuinely
        # scatters every group across both replicas
        rows = _mt_prompts(rng, groups=3, per_group=4, cold=2)

        fleet = ServingFleet([("r0", _engine(setup)),
                              ("r1", _engine(setup))])
        for i, (_, p) in enumerate(rows):
            fleet.submit(p, max_new_tokens=2, request_id=f"a{i}")
        fleet.run(deadline=120)
        aff_hits = fleet.metrics()["prefix_hit_tokens_total"]

        engines = [_engine(setup), _engine(setup)]
        for i, (_, p) in enumerate(rows):
            engines[i % 2].submit(p, max_new_tokens=2,
                                  request_id=f"b{i}")
        while any(e.pending for e in engines):
            for e in engines:
                e.poll()
        rr_hits = _hit_tokens(engines)

        # round-robin SCATTERS each group across replicas, so every
        # replica pays its own promote warmup; affinity concentrates a
        # group on one replica and keeps the monolithic hit count
        assert aff_hits > rr_hits, (aff_hits, rr_hits)
        fleet.close()
        for e in engines:
            e.close()

    def test_affinity_pins_group_before_promotion(self, setup):
        """The routed-chain record concentrates a shared prefix from
        its FIRST sighting — the second request of a group must land
        on the same replica even though no pool entry exists yet."""
        rng = np.random.default_rng(4)
        rows = _mt_prompts(rng, groups=2, per_group=3, cold=0)
        fleet = ServingFleet([("r0", _engine(setup)),
                              ("r1", _engine(setup))])
        by_group = {}
        for i, (g, p) in enumerate(rows):
            fleet.submit(p, max_new_tokens=2, request_id=f"p{i}")
            rep = fleet._meta[f"p{i}"][5]
            by_group.setdefault(g, set()).add(rep)
        assert all(len(reps) == 1 for reps in by_group.values()), \
            by_group
        # the two groups spread over BOTH replicas (load balance)
        assert len(set().union(*by_group.values())) == 2
        fleet.close()

    def test_least_loaded_fallback_on_cold_prompts(self, setup):
        rng = np.random.default_rng(5)
        fleet = ServingFleet([("r0", _engine(setup)),
                              ("r1", _engine(setup))])
        cold = [rng.integers(0, 64, (20,)).astype(np.int32)
                for _ in range(4)]
        # no chains in common: routing must alternate by load
        for i, p in enumerate(cold):
            fleet.submit(p, max_new_tokens=2, request_id=f"c{i}")
        routed = {r.name: r.routed for r in fleet.replicas}
        assert routed == {"r0": 2, "r1": 2}, routed
        assert fleet.metrics()["affinity_routed_total"] == 0
        fleet.close()

    def test_router_avoids_sick_replica(self, setup):
        pol = ResiliencePolicy(slos=[LaneSLO(priority=0,
                                             ttft_p99_ms=1.0)])
        sick = _engine(setup, resil=pol)
        fleet = ServingFleet([("sick", sick),
                              ("ok", _engine(setup))])
        pol.shed_active = True          # armed shedder = sick
        pol.shed_below = 0
        rng = np.random.default_rng(6)
        for i in range(3):
            fleet.submit(rng.integers(0, 64, (20,)).astype(np.int32),
                         max_new_tokens=2, request_id=f"s{i}",
                         priority=1)
        assert fleet._by_name["ok"].routed == 3
        assert fleet._by_name["sick"].routed == 0
        pol.shed_active = False
        fleet.close()


# ===================================================================
# disaggregation
# ===================================================================
class TestDisaggregation:
    def test_prefill_replica_requires_pool_and_eager_promote(self,
                                                             setup):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=24, max_len=48)
        nopool = ServingEngine(sess, max_queue=8, prefill_chunk=8)
        with pytest.raises(ValueError, match="prefix "):
            FleetReplica("pf", nopool, "prefill")
        with pytest.raises(ValueError, match="promote_after"):
            FleetReplica("pf", _engine(setup, promote=2), "prefill")
        sess.close()

    def test_disagg_digest_identical_to_monolithic(self, setup):
        rng = np.random.default_rng(7)
        rows = _mt_prompts(rng, groups=2, per_group=3, cold=2)
        fleet = ServingFleet(
            [("pf", _engine(setup, promote=1), "prefill"),
             ("d0", _engine(setup), "decode"),
             ("d1", _engine(setup), "decode")])
        for i, (_, p) in enumerate(rows):
            fleet.submit(p, max_new_tokens=4, request_id=f"d{i}")
        fleet.run(deadline=120)
        m = fleet.metrics()
        # every multi-token request crossed the prefill→decode seam
        assert m["handoffs_total"] == len(rows)

        mono = _engine(setup, slots=4)
        for i, (_, p) in enumerate(rows):
            mono.submit(p, max_new_tokens=4, request_id=f"d{i}")
        mono.run()
        mono_outs = {r.request_id: list(r.output)
                     for r in mono.requests}
        assert fleet.outputs() == mono_outs
        fleet.close()
        mono.close()

    def test_budget_one_skips_the_handoff(self, setup):
        rng = np.random.default_rng(8)
        fleet = ServingFleet(
            [("pf", _engine(setup, promote=1), "prefill"),
             ("d0", _engine(setup), "decode")])
        req = fleet.submit(rng.integers(0, 64, (20,)).astype(np.int32),
                           max_new_tokens=1, request_id="one")
        fleet.run(deadline=60)
        assert req.state is RequestState.DONE and len(req.output) == 1
        assert fleet.metrics()["handoffs_total"] == 0
        fleet.close()


# ===================================================================
# failover + fleet SLO
# ===================================================================
class TestFailover:
    def _resil(self, tmp_path, tag):
        return ResiliencePolicy(
            slos=[LaneSLO(priority=0, ttft_p99_ms=1e9)],
            journal_path=str(tmp_path / f"{tag}.jsonl"))

    def test_kill_replays_onto_survivor_bit_identically(self, setup,
                                                        tmp_path):
        rng = np.random.default_rng(9)
        rows = _mt_prompts(rng, groups=2, per_group=3, cold=2)

        ref = ServingFleet([("a", _engine(setup)),
                            ("b", _engine(setup))])
        for i, (_, p) in enumerate(rows):
            ref.submit(p, max_new_tokens=5, request_id=f"f{i}")
        ref.run(deadline=120)
        ref_outs = ref.outputs()
        ref.close()

        fleet = ServingFleet(
            [("a", _engine(setup, resil=self._resil(tmp_path, "a"))),
             ("b", _engine(setup, resil=self._resil(tmp_path, "b")))],
            slos=[LaneSLO(priority=0, ttft_p99_ms=1e9)])
        for i, (_, p) in enumerate(rows):
            fleet.submit(p, max_new_tokens=5, request_id=f"f{i}")
        for _ in range(3):
            fleet.poll()
        victim = max(fleet.replicas,
                     key=lambda r: r.engine.pending)
        assert victim.engine.pending > 0
        resumed = fleet.kill_replica(victim.name)
        assert len(resumed) >= 1
        # the dead engine is closed with crash semantics: no new work
        with pytest.raises(RuntimeError):
            victim.engine.poll()
        fleet.run(deadline=120)
        assert fleet.outputs() == ref_outs   # replay-as-retry, no loss
        assert all(r.state is RequestState.DONE
                   for r in fleet.requests)
        assert fleet.attainment(0) == 1.0
        m = fleet.metrics()
        assert m["failovers_total"] == 1
        assert m["failover_replayed_total"] == len(resumed)
        assert m["replicas_alive"] == 1
        # resumed requests carry a retry mark, not a fresh admission
        assert all(r.retries >= 1 for r in resumed)
        fleet.close()

    def test_kill_last_replica_is_loud(self, setup, tmp_path):
        fleet = ServingFleet(
            [("a", _engine(setup, resil=self._resil(tmp_path, "x")))])
        with pytest.raises(RuntimeError, match="last live replica"):
            fleet.kill_replica("a")

    def test_router_shed_counts_as_fleet_lane_miss(self, setup):
        # tiny queues + an armed shedder on every replica: the router
        # has nowhere to put the request, so the shed happens (and is
        # counted) at the EDGE
        pols = [ResiliencePolicy(slos=[LaneSLO(priority=0,
                                               ttft_p99_ms=1.0)])
                for _ in range(2)]
        fleet = ServingFleet(
            [("a", _engine(setup, resil=pols[0])),
             ("b", _engine(setup, resil=pols[1]))],
            slos=[LaneSLO(priority=1, ttft_p99_ms=1e9)])
        for pol in pols:
            pol.shed_active = True
            pol.shed_below = 0
        rng = np.random.default_rng(10)
        with pytest.raises(RequestShed, match="router shed"):
            fleet.submit(rng.integers(0, 64, (20,)).astype(np.int32),
                         max_new_tokens=2, priority=1,
                         request_id="edge")
        assert fleet.router_sheds_total == 1
        assert fleet.attainment(1) == 0.0    # the miss is on the ledger
        for pol in pols:
            pol.shed_active = False
        fleet.close()

    def test_try_submit_returns_none_on_router_shed(self, setup):
        pol = ResiliencePolicy(slos=[LaneSLO(priority=0,
                                             ttft_p99_ms=1.0)])
        fleet = ServingFleet([("a", _engine(setup, resil=pol))])
        pol.shed_active = True
        pol.shed_below = 0
        rng = np.random.default_rng(11)
        assert fleet.try_submit(
            rng.integers(0, 64, (20,)).astype(np.int32),
            max_new_tokens=2, priority=1) is None
        pol.shed_active = False
        fleet.close()


# ===================================================================
# metric merging
# ===================================================================
class TestMetricMerge:
    def test_reservoir_merge_of_splits_tracks_whole_stream(self):
        rng = np.random.default_rng(12)
        stream = rng.lognormal(3.0, 0.6, size=4000)
        whole = _Reservoir(seed=0)
        parts = [_Reservoir(seed=i) for i in range(4)]
        for i, x in enumerate(stream):
            whole.add(float(x))
            parts[i % 4].add(float(x))
        merged = _Reservoir.merged(parts)
        assert len(merged) == RESERVOIR_CAP       # bounded
        assert merged.seen == len(stream)
        for q in (50, 99):
            a, b = merged.percentile(q), np.percentile(stream, q)
            assert abs(a - b) / b < 0.25, (q, a, b)
        # p50 is tight (both sides sample 512 of 4000)
        p50 = merged.percentile(50)
        assert abs(p50 - np.percentile(stream, 50)) \
            / np.percentile(stream, 50) < 0.1

    def test_reservoir_merge_deterministic_and_weighted(self):
        a, b = _Reservoir(seed=1), _Reservoir(seed=2)
        for i in range(2000):
            a.add(0.0)
        for i in range(200):
            b.add(1000.0)
        m1 = _Reservoir.merged([a, b])
        m2 = _Reservoir.merged([a, b])
        assert m1._samples == m2._samples          # deterministic
        ones = sum(1 for s in m1._samples if s == 1000.0)
        # b carries ~1/11 of the stream: its quota must be seen-
        # weighted, not per-part-equal
        assert 20 <= ones <= 80, ones

    def test_small_parts_concatenate_exactly(self):
        a, b = _Reservoir(), _Reservoir()
        for x in (1.0, 2.0):
            a.add(x)
        b.add(3.0)
        m = _Reservoir.merged([a, b])
        assert sorted(m._samples) == [1.0, 2.0, 3.0] and m.seen == 3

    def test_serving_metrics_merged_counters_and_percentiles(self):
        parts = []
        for i in range(3):
            tm = ServingMetrics(f"rep{i}", max_slots=4)
            tm.admitted(2, prefill_s=0.1, occupied=2,
                        queue_wait_s=0.05 * (i + 1))
            tm.tick(0.02, emitted=2)
            tm.rejected(1)
            parts.append(tm)
        merged = ServingMetrics.merged("fleet", parts)
        m = merged.metrics()
        assert m["requests_admitted"] == 6
        assert m["requests_rejected"] == 3
        assert m["tokens_emitted"] == 6
        assert merged.max_slots == 12
        assert m["queue_wait_ms_p50"] is not None
        assert m["decode_ms_per_token"] == pytest.approx(10.0)


# ===================================================================
# the same trace through the reference's engine
# ===================================================================
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from serve_trace import make_multitenant_trace  # noqa: E402


@pytest.fixture(scope="module")
def ref_weights():
    """gpt_tiny (decode_block 8) weights for both packages, scaled so
    greedy streams vary token to token: (jcfg, jparams, tcfg, tparams)."""
    jcfg = dataclasses.replace(jg.gpt_tiny(), decode_block=8)
    tcfg = tg.gpt_tiny(decode_block=8)
    tree = jax.device_get(jg.init_params(jcfg, 7))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * 8.0
    tree["wte"] = tree["wte"] * 8.0
    tree["wpe"] = tree["wpe"] * 30.0
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            tg.params_from_numpy(tree, tcfg, device="cpu"))


def _serve_trace():
    """Two tenants, each with its own two-block system prompt."""
    return make_multitenant_trace(seed=5, n=8, rate=50.0, groups=2,
                                  prompt_len=20, new_tokens=5,
                                  new_jitter=2, shared_len=16, vocab=256)


class _Clock:
    """The engine clock of a replay, stepped by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _replay(submit, poll, run, clock, trace):
    """Submit each trace row at its arrival (engine clock) with one poll
    after it, then drain; the clock steps 10 ms a poll."""
    reqs = []
    for row in trace:
        clock.t = max(clock.t, row["t"])
        reqs.append(submit(np.asarray(row["tokens"], np.int32),
                           max_new_tokens=row["max_new_tokens"],
                           request_id=row["rid"], tenant=row["tenant"]))
        poll()
        clock.t += 0.01
    while run(max_ticks=1):
        clock.t += 0.01
    return reqs


def test_trace_replay_matches_reference_fleet(ref_weights, tmp_path):
    """One two-tenant serve_trace trace through a port fleet and a
    reference fleet built alike (a prefill replica and two decode
    replicas, each with a crash journal), on a fake clock, with one decode
    replica killed mid-trace: equal routes, equal streams, equal router,
    handoff and failover counters, and no request lost."""
    jcfg, jp, tcfg, tp = ref_weights
    trace = _serve_trace()
    sides = []
    for side, (make_sess, Eng, Pol, Fleet) in enumerate((
            (lambda: GenerationSession(tp, tcfg, max_slots=2,
                                       max_prompt_len=24, max_len=40),
             ServingEngine, ResiliencePolicy, ServingFleet),
            (lambda: JSession(jp, jcfg, max_slots=2, max_prompt_len=24,
                              max_len=40),
             JEngine, JResiliencePolicy, JServingFleet))):
        clock = _Clock()

        def engine(name, promote):
            pol = Pol(journal_path=str(tmp_path / f"{side}{name}.jsonl"))
            return Eng(make_sess(), max_queue=16, prefill_chunk=8,
                       prefix_cache_blocks=8, prefix_promote_after=promote,
                       clock=clock, resilience=pol)

        fleet = Fleet([("pf", engine("pf", 1), "prefill"),
                       ("d0", engine("d0", 2), "decode"),
                       ("d1", engine("d1", 2), "decode")], clock=clock)
        half = len(trace) // 2
        reqs = _replay(fleet.submit, fleet.poll,
                       lambda max_ticks: 0, clock, trace[:half])
        resumed = fleet.kill_replica("d1")
        reqs += _replay(fleet.submit, fleet.poll, fleet.run, clock,
                        trace[half:])
        met = fleet.metrics()
        routes = {rid: meta[5] for rid, meta in fleet._meta.items()}
        sides.append((routes, fleet.outputs(),
                      sorted(r.request_id for r in resumed),
                      {k: met[k] for k in (
                          "affinity_routed_total", "handoffs_total",
                          "failovers_total", "failover_replayed_total",
                          "prefix_hit_tokens_total", "replicas",
                          "routed_total", "router_sheds_total")}))
        fleet.close()
    assert sides[0] == sides[1]
    routes, outs, resumed, met = sides[0]
    assert len(outs) == len(trace) and all(
        len(outs[row["rid"]]) == row["max_new_tokens"] for row in trace)
    assert resumed and met["failover_replayed_total"] == len(resumed)
    assert met["failovers_total"] == 1 and met["handoffs_total"] > 0
    assert set(routes.values()) == {"d0"}   # d1 died, every row moved
