"""The port's serving resilience plane on the CPU (gpt tiny, f32, fake
clocks): the scenarios of tests/test_serving_resilience.py run against
``paddle_tpu_torch`` — SLO-driven shedding and its hysteresis, the
brownout ladder, retry/requeue of evicted in-flight requests (greedy
resume equal to an uninterrupted run), the crash journal and its replay,
the serving chaos faults, no-fault identity and the engine's close
deadline — and one serve_trace trace replayed through the port's engine
and the reference's under the same policy, with equal streams, journal
records and policy metrics."""
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.ft.chaos import ChaosPlan as JChaosPlan
from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import LaneSLO as JLaneSLO
from paddle_tpu.serving import ResiliencePolicy as JResiliencePolicy
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.models import gpt as tg

from paddle_tpu_torch.distributed.ft.chaos import ChaosPlan
from paddle_tpu_torch.inference import GenerationSession as _Session
from paddle_tpu_torch.models.gpt import GPTConfig, init_params, generate
from paddle_tpu_torch.serving import (LaneSLO, QueueFull, RequestJournal,
                                      RequestShed, RequestState,
                                      ResiliencePolicy, replay_journal)
from paddle_tpu_torch.serving.resilience import BROWNOUT_STEPS

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
    return GPTConfig(vocab_size=128, hidden=64, n_layers=2, n_heads=4,
                     max_seq=64, dtype=torch.float32, micro_batches=1,
                     remat=False, **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    return cfg, init_params(cfg, 7, device="cpu")


def _row_generate(params, cfg, row, n):
    out = np.asarray(generate(params, cfg, row[None, :], max_new_tokens=n,
                              device="cpu"))
    return out[0, row.shape[0]:]


def _prompt(rng, n, vocab=128):
    return rng.integers(0, vocab, (n,)).astype(np.int32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ===================================================================
# chaos DSL: serving fault kinds
# ===================================================================
class TestServingChaosDSL:
    def test_parse_serving_kinds(self):
        plan = ChaosPlan.parse(
            "slow_tick@tick=3:x120,queue_flood@tick=5-9:x4,"
            "poison_request@req=2,kill@tick=11")
        kinds = [f.kind for f in plan.faults]
        assert kinds == ["slow_tick", "queue_flood", "poison_request",
                         "kill"]
        st, qf, pr, kl = plan.faults
        assert st.magnitude == 120.0 and st.key == "tick"
        assert qf.magnitude == 4.0 and qf.hits(7) and not qf.hits(10)
        assert pr.key == "req" and pr.magnitude is None
        assert kl.key == "tick"

    def test_magnitude_defaults(self):
        plan = ChaosPlan.parse("slow_tick@tick=1,queue_flood@tick=2")
        assert plan.faults[0].magnitude == 50.0   # ms
        assert plan.faults[1].magnitude == 8.0    # requests

    def test_reject_wrong_key(self):
        with pytest.raises(ValueError, match="triggers on"):
            ChaosPlan.parse("slow_tick@step=3")
        with pytest.raises(ValueError, match="triggers on"):
            ChaosPlan.parse("queue_flood@req=3")
        with pytest.raises(ValueError, match="triggers on"):
            ChaosPlan.parse("poison_request@tick=3")
        # kill fires on a train step OR a serving tick, nothing else
        with pytest.raises(ValueError, match="triggers on"):
            ChaosPlan.parse("kill@save=3")

    def test_reject_bad_magnitude(self):
        with pytest.raises(ValueError, match="takes no magnitude"):
            ChaosPlan.parse("poison_request@req=1:x2")
        with pytest.raises(ValueError, match="magnitude must be"):
            ChaosPlan.parse("slow_tick@tick=1:x0")
        with pytest.raises(ValueError, match="magnitude must be"):
            ChaosPlan.parse("queue_flood@tick=1:x0")

    def test_kill_key_matching_is_counter_aware(self):
        """kill@tick must never be tripped by a train-step counter (and
        vice versa) — the two counters advance independently."""
        plan = ChaosPlan.parse("kill@tick=5")
        assert plan.matching("kill", 5, key="tick")
        assert not plan.matching("kill", 5, key="step")
        plan2 = ChaosPlan.parse("kill@step=5")
        assert not plan2.matching("kill", 5, key="tick")
        # keyless matching stays permissive for the legacy callers
        assert plan2.matching("kill", 5)


# ===================================================================
# policy construction / validation
# ===================================================================
class TestPolicyValidation:
    def test_lane_slo_requires_an_objective(self):
        with pytest.raises(ValueError, match="no objective"):
            LaneSLO(priority=0)
        s = LaneSLO(priority=0, ttft_p99_ms=100.0)
        assert s.queue_wait_p99_ms is None

    def test_duplicate_lanes_and_bad_knobs_reject(self):
        with pytest.raises(ValueError, match="duplicate"):
            ResiliencePolicy(slos=[LaneSLO(0, ttft_p99_ms=1.0),
                                   LaneSLO(0, queue_wait_p99_ms=1.0)])
        with pytest.raises(ValueError, match="brownout_low"):
            ResiliencePolicy(brownout_low=0.9, brownout_high=0.5)
        with pytest.raises(ValueError, match="clamp_new_tokens"):
            ResiliencePolicy(clamp_new_tokens=0)

    def test_one_policy_one_engine(self, setup):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(chaos=ChaosPlan())
        eng = ServingEngine(sess, max_queue=4, resilience=pol)
        with pytest.raises(ValueError, match="already bound"):
            ServingEngine(sess, max_queue=4, resilience=pol)
        eng.close()


# ===================================================================
# SLO-driven shedding
# ===================================================================
class TestSLOShed:
    def test_breach_sheds_below_priority_and_recovers(self, setup):
        """A lane-0 TTFT breach arms shedding of priority > 0 work
        (loud RequestShed at submit, state REJECTED), lane-0 work keeps
        admitting, and hysteresis disarms only after recover_polls
        consecutive healthy evaluations once the window slides."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=8, max_len=32)
        clock = FakeClock()
        pol = ResiliencePolicy(
            slos=[LaneSLO(priority=0, ttft_p99_ms=100.0)],
            window=4, min_samples=1, recover_polls=2,
            chaos=ChaosPlan())
        eng = ServingEngine(sess, max_queue=16, clock=clock,
                            resilience=pol)
        rng = np.random.default_rng(50)
        slow = eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=0)
        clock.t = 0.5    # 500ms of queue+prefill latency > 100ms target
        eng.poll()       # first token lands; TTFT 500ms observed
        assert slow.state is RequestState.DONE
        eng.poll()       # evaluation at the NEXT poll edge arms the shed
        assert pol.shed_active and pol.shed_below == 0
        with pytest.raises(RequestShed, match="SLO breach in lane 0"):
            eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=1)
        shed = eng.requests[-1]
        assert shed.state is RequestState.REJECTED
        assert "shedding priority > 0" in shed.shed_reason
        assert pol.shed_total == 1
        assert eng.try_submit(_prompt(rng, 4), priority=5) is None
        # lane-0 work is never shed — it is the lane being protected
        ok = eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=0)
        eng.run()
        assert ok.state is RequestState.DONE
        # slide the breach sample out of the bounded window with fast
        # lane-0 requests, then recover_polls healthy evaluations disarm
        for _ in range(4):
            eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=0)
            eng.run()
        eng.poll(); eng.poll()   # recover_polls healthy evaluations
        assert not pol.shed_active and pol.shed_below is None
        r = eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=1)
        eng.run()
        assert r.state is RequestState.DONE
        m = pol.metrics()
        assert m["slo_breaches"] == 1 and m["shed_total"] == 2
        assert m["lanes"]["0"]["attainment"] is not None
        eng.close()

    def test_stale_window_does_not_latch_the_shedder(self, setup):
        """A breach followed by lane SILENCE must not shed forever:
        after recover_polls polls with no new lane samples the stale
        window is presumed healthy and hysteresis disarms — otherwise
        the shedder itself keeps the engine idle and nothing can ever
        refill the window it is re-breaching on."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        clock = FakeClock()
        pol = ResiliencePolicy(
            slos=[LaneSLO(priority=0, ttft_p99_ms=100.0)],
            window=8, min_samples=1, recover_polls=3,
            chaos=ChaosPlan())
        eng = ServingEngine(sess, max_queue=8, clock=clock,
                            resilience=pol)
        rng = np.random.default_rng(52)
        eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=0)
        clock.t = 0.5                 # TTFT 500ms > 100ms target
        eng.run()
        eng.poll()
        assert pol.shed_active
        # lane 0 goes silent; idle polls alone must disarm the shed
        for _ in range(6):
            eng.poll()
        assert not pol.shed_active
        r = eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=1)
        eng.run()
        assert r.state is RequestState.DONE
        eng.close()

    def test_attainment_counts_drops_as_misses(self, setup):
        """The attainment ledger must count a shed/failed lane request
        as a miss — hiding drops would let a shedder fake a perfect
        SLO by rejecting everything."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        clock = FakeClock()
        pol = ResiliencePolicy(
            slos=[LaneSLO(priority=1, ttft_p99_ms=1000.0)],
            window=4, min_samples=1, recover_polls=64,
            chaos=ChaosPlan())
        eng = ServingEngine(sess, max_queue=8, clock=clock,
                            resilience=pol)
        rng = np.random.default_rng(51)
        eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=1)
        eng.run()
        assert pol.attainment(1) == 1.0
        eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=1)
        clock.t = 5.0    # breach lane 1 (TTFT 5000ms > 1000ms)
        eng.run()
        eng.poll()       # evaluate -> shed arms for priority > 1
        assert pol.shed_active
        with pytest.raises(RequestShed):
            eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=2)
        # lane 1 saw: one met, one over-target, and no shed (the shed
        # request was lane 2, outside the ledger)
        assert pol.attainment(1) == 0.5
        eng.close()


# ===================================================================
# brownout degradation ladder
# ===================================================================
class TestBrownoutLadder:
    def _pressured_engine(self, setup, **pol_kw):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(
            brownout_high=0.5, brownout_low=0.25, brownout_after=2,
            brownout_recover=2, clamp_new_tokens=2,
            chaos=ChaosPlan(), **pol_kw)
        eng = ServingEngine(sess, max_queue=8, prefill_chunk=4,
                            prefix_cache_blocks=8,
                            resilience=pol)
        return sess, pol, eng

    def test_ladder_escalates_clamps_and_sheds(self, setup):
        """Sustained deep queue walks the ladder up in order: level 1
        clamps new max_new_tokens budgets, level 2 suspends prefix
        extraction writes (reads stay), level 3 admits only
        priority <= priority_only_max — each step observable and the
        shed LOUD."""
        sess, pol, eng = self._pressured_engine(setup)
        rng = np.random.default_rng(60)
        hog = eng.submit(_prompt(rng, 4), max_new_tokens=24)
        eng.poll()    # hog takes the only slot
        for _ in range(5):   # depth 5/8 >= brownout_high
            eng.submit(_prompt(rng, 4), max_new_tokens=1)
        assert pol.brownout_level == 0
        eng.poll(); eng.poll()
        assert pol.brownout_level == 1      # clamp_new_tokens
        clamped = eng.submit(_prompt(rng, 4), max_new_tokens=9)
        assert clamped.max_new_tokens == 2
        assert clamped.clamped_from == 9
        assert pol.clamped_total == 1
        eng.poll(); eng.poll()
        assert pol.brownout_level == 2      # suspend_prefix_writes
        assert pol.prefix_writes_suspended()
        eng.poll(); eng.poll()
        assert pol.brownout_level == 3      # priority_only_admission
        with pytest.raises(RequestShed, match="brownout level 3"):
            eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=1)
        assert eng.requests[-1].state is RequestState.REJECTED
        # priority <= priority_only_max (0) still admits under level 3
        vip = eng.submit(_prompt(rng, 4), max_new_tokens=1, priority=0)
        assert vip.state is RequestState.QUEUED
        m = pol.metrics()
        assert m["brownout_steps_active"] == list(BROWNOUT_STEPS)
        eng.close()

    def test_prefix_writes_suspended_reads_still_serve(self, setup):
        """Level 2 stops pool GROWTH (no extraction reads) while
        already-pooled blocks keep serving hits."""
        sess, pol, eng = self._pressured_engine(setup)
        rng = np.random.default_rng(61)
        shared = _prompt(rng, 16)
        p = np.concatenate([shared, _prompt(rng, 4)])
        for _ in range(2):            # second touch promotes the blocks
            eng.submit(p, max_new_tokens=1)
            eng.run()
        pooled = eng.prefix_cache.stats()["insertions"]
        assert pooled >= 1
        pol.brownout_level = 2        # force the suspended step
        pol.brownout_recover = 10 ** 9   # and pin it there: no calm exit
        novel = np.concatenate([_prompt(rng, 16), _prompt(rng, 4)])
        for _ in range(3):
            eng.submit(novel, max_new_tokens=1)
            eng.run()
        assert eng.prefix_cache.stats()["insertions"] == pooled  # no growth
        hit = eng.submit(p, max_new_tokens=1)
        eng.run()
        assert hit.prefix_hit_tokens == 16     # reads keep serving
        np.testing.assert_array_equal(
            hit.output, _row_generate(setup[1], setup[0], p, 1))
        eng.close()

    def test_ladder_deescalates_one_step_at_a_time(self, setup):
        sess, pol, eng = self._pressured_engine(setup)
        pol.brownout_level = 3
        # empty queue = calm; each brownout_recover streak steps DOWN one
        levels = []
        for _ in range(7):
            eng.poll()
            levels.append(pol.brownout_level)
        assert levels == [3, 2, 2, 1, 1, 0, 0]
        eng.close()


# ===================================================================
# retry / requeue
# ===================================================================
class TestRetryRequeue:
    def test_external_evict_requeues_with_tokens(self, setup):
        """A stall-shed victim keeps its work: an
        externally-evicted decoding request re-enters the queue with
        its generated-so-far tokens and its final output is
        bit-identical to never having been evicted."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(chaos=ChaosPlan())
        eng = ServingEngine(sess, max_queue=4, resilience=pol,
                            max_retries=2, retry_backoff_s=0.0)
        rng = np.random.default_rng(70)
        p = _prompt(rng, 5)
        req = eng.submit(p, max_new_tokens=8)
        eng.poll(); eng.poll(); eng.poll()
        assert req.state is RequestState.DECODING
        kept = len(req.output)
        assert kept >= 1
        sess.evict(req.slot)          # a foreign stall shed tears it down
        eng.run()                     # reclaim -> requeue -> resume
        assert req.state is RequestState.DONE
        assert req.retries == 1 and req.resumed_len == kept
        np.testing.assert_array_equal(req.output,
                                      _row_generate(params, cfg, p, 8))
        assert eng.metrics()["retries"] == 1
        assert eng.metrics()["requests_failed"] == 0
        # the re-admission is NOT a fresh admission: one admitted count
        # and ONE TTFT sample (a resume's first emitted token is not a
        # first token — a second stale-stamped sample would skew p99)
        assert sess.telemetry.requests_admitted == 1
        assert len(sess.telemetry._ttft_ms) == 1
        eng.close()

    def test_retry_budget_exhausts_loudly(self, setup):
        """max_retries=0: the first eviction goes straight to terminal
        FAILED (partial output kept, reason recorded) — run() returns
        instead of hanging."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(chaos=ChaosPlan())
        eng = ServingEngine(sess, max_queue=4, resilience=pol,
                            max_retries=0)
        rng = np.random.default_rng(71)
        req = eng.submit(_prompt(rng, 5), max_new_tokens=8)
        eng.poll(); eng.poll()
        assert req.state is RequestState.DECODING
        sess.evict(req.slot)
        eng.run()
        assert req.state is RequestState.FAILED
        assert req.finished()
        assert "retry budget exhausted" in req.shed_reason
        assert len(req.output) >= 1             # partial work rides along
        assert eng.metrics()["requests_failed"] == 1
        assert eng.metrics()["requests_by_state"]["failed"] == 1
        eng.close()

    def test_backoff_is_deterministic_and_waits(self, setup):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        clock = FakeClock()
        pol = ResiliencePolicy(chaos=ChaosPlan())
        eng = ServingEngine(sess, max_queue=4, clock=clock,
                            resilience=pol, max_retries=3,
                            retry_backoff_s=10.0)
        rng = np.random.default_rng(72)
        req = eng.submit(_prompt(rng, 5), max_new_tokens=4)
        eng.poll(); eng.poll()
        sess.evict(req.slot)
        eng.poll()                    # reclaim -> delay heap
        assert req.state is RequestState.QUEUED
        assert len(eng._delayed) == 1
        # jitter is a pure function of (seq, attempt): 10s * [0.5, 1.5)
        assert 5.0 <= req.not_before - clock.t <= 15.0
        eng.poll()
        assert req.slot is None       # still waiting out the backoff
        clock.t = req.not_before + 0.01
        eng.poll()
        assert req.state in (RequestState.PREFILLING,
                             RequestState.DECODING)
        eng.run()
        assert req.state is RequestState.DONE
        eng.close()


# ===================================================================
# chaos faults at the engine poll edge
# ===================================================================
class TestServingChaosInjection:
    def test_queue_flood_trace_is_deterministic(self, setup):
        """Two runs of the same flood plan inject byte-identical
        synthetic requests (rids AND token content) — the plan is the
        seed, so a chaos run replays bit-for-bit."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=8, max_len=32)
        floods = []
        for _ in range(2):
            pol = ResiliencePolicy(
                chaos=ChaosPlan.parse("queue_flood@tick=2:x3"),
                flood_prompt_len=6, flood_new_tokens=2)
            eng = ServingEngine(sess, max_queue=16, resilience=pol)
            rng = np.random.default_rng(80)
            eng.submit(_prompt(rng, 4), max_new_tokens=2)
            eng.run()
            assert pol.floods_injected == 3
            floods.append({r.request_id: (r.tokens.tolist(),
                                          list(r.output))
                           for r in eng.requests
                           if r.request_id.startswith("flood_")})
            eng.close()
        assert floods[0] == floods[1]
        assert sorted(floods[0]) == ["flood_t2_0", "flood_t2_1",
                                     "flood_t2_2"]

    def test_slow_tick_stalls_the_poll(self, setup):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(
            chaos=ChaosPlan.parse("slow_tick@tick=1:x80"))
        eng = ServingEngine(sess, max_queue=4, resilience=pol)
        rng = np.random.default_rng(81)
        eng.submit(_prompt(rng, 4), max_new_tokens=1)
        t0 = time.perf_counter()
        eng.poll()
        assert time.perf_counter() - t0 >= 0.08
        eng.run()
        eng.close()

    def test_poison_request_fails_without_stalling_others(self, setup):
        """poison_request@req=1 marks the first EXTERNAL submission:
        every time it reaches decode the resilience layer evicts it
        through the requeue path, its budget exhausts into terminal
        FAILED, and the healthy lane drains with bit-identical
        output — the poison never livelocks the engine."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(
            chaos=ChaosPlan.parse("poison_request@req=1"))
        eng = ServingEngine(sess, max_queue=8, resilience=pol,
                            max_retries=1, retry_backoff_s=0.0)
        rng = np.random.default_rng(82)
        bad_p, good_p = _prompt(rng, 4), _prompt(rng, 5)
        bad = eng.submit(bad_p, max_new_tokens=6)
        good = eng.submit(good_p, max_new_tokens=6, priority=1)
        assert bad.poisoned and not good.poisoned
        assert pol.poisoned_total == 1
        eng.run()
        assert bad.state is RequestState.FAILED
        assert bad.retries == 1
        assert "chaos_poison" in bad.shed_reason
        assert good.state is RequestState.DONE
        np.testing.assert_array_equal(
            good.output, _row_generate(params, cfg, good_p, 6))
        assert eng.metrics()["retries"] == 1
        assert eng.metrics()["requests_failed"] == 1
        eng.close()


# ===================================================================
# crash-recovery journal
# ===================================================================
class TestRequestJournal:
    def test_scan_roundtrip_and_torn_tail(self, tmp_path):
        path = str(tmp_path / "journal.jsonl")
        j = RequestJournal(path)
        j.push({"ev": "submit", "rid": "a", "tokens": [1, 2], "new": 4,
                "prio": 0, "deadline": None, "out": [], "retries": 0})
        j.push_tokens("a", [7, 8])
        j.push({"ev": "submit", "rid": "b", "tokens": [3], "new": 2,
                "prio": 1, "deadline": 9.0, "out": [5], "retries": 1})
        j.push({"ev": "retry", "rid": "b", "n": 2})
        j.push({"ev": "end", "rid": "a", "state": "done"})
        j.flush()
        # a crash mid-append leaves a torn trailing line — scan skips it
        with open(path, "a") as f:
            f.write('{"ev": "toks", "rid": "a", "t": [9')
        j.close()
        entries = RequestJournal.scan(path)
        assert entries["a"]["out"] == [7, 8]
        assert entries["a"]["state"] == "done"
        assert entries["b"]["state"] is None          # in-flight
        assert entries["b"]["out"] == [5]
        assert entries["b"]["retries"] == 2
        assert entries["b"]["deadline"] == 9.0
        assert RequestJournal.scan(str(tmp_path / "missing")) == {}

    def test_replay_resumes_in_flight_bit_identically(self, setup,
                                                      tmp_path):
        """Abandon an engine mid-flight (the SIGKILL stand-in: the
        journal is the only surviving state) and replay into a fresh
        engine: finished work is NOT re-admitted, in-flight and queued
        work resumes, and resumed greedy outputs are bit-identical to
        an uninterrupted run."""
        cfg, params = setup
        path = str(tmp_path / "engine.jsonl")
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(chaos=ChaosPlan(), journal_path=path)
        eng = ServingEngine(sess, max_queue=8, resilience=pol)
        rng = np.random.default_rng(90)
        pa, pb, pc = (_prompt(rng, 5) for _ in range(3))
        ra = eng.submit(pa, max_new_tokens=2, request_id="ra")
        rb = eng.submit(pb, max_new_tokens=6, request_id="rb",
                        priority=1)
        rc = eng.submit(pc, max_new_tokens=3, request_id="rc",
                        priority=2)
        while ra.state is not RequestState.DONE:
            eng.poll()
        for _ in range(2):            # rb decodes a couple of tokens
            eng.poll()
        assert rb.state is RequestState.DECODING and len(rb.output) >= 1
        assert rc.state is RequestState.QUEUED
        mid = len(rb.output)
        # crash: no close(), no drain — the journal file is all that
        # survives; free the slot so the shared session can be reused
        sess.evict(rb.slot)
        sess2_pol = ResiliencePolicy(chaos=ChaosPlan(),
                                     journal_path=path)
        eng2 = ServingEngine(sess, max_queue=8, resilience=sess2_pol)
        resumed = replay_journal(eng2, path)
        assert {r.request_id for r in resumed} == {"rb", "rc"}
        nb = next(r for r in resumed if r.request_id == "rb")
        assert nb.output == rb.output and nb.resumed_len == mid
        eng2.run()
        assert all(r.state is RequestState.DONE for r in resumed)
        np.testing.assert_array_equal(
            nb.output, _row_generate(params, cfg, pb, 6))
        nc = next(r for r in resumed if r.request_id == "rc")
        np.testing.assert_array_equal(
            nc.output, _row_generate(params, cfg, pc, 3))
        eng2.close()
        # the journal now records every request terminal with full
        # outputs — a second replay re-admits nothing
        done = RequestJournal.scan(path)
        assert all(e["state"] == "done" for e in done.values())
        assert done["rb"]["out"] == list(nb.output)
        pol3 = ResiliencePolicy(chaos=ChaosPlan(), journal_path=path)
        eng3 = ServingEngine(sess, max_queue=8, resilience=pol3)
        assert replay_journal(eng3, path) == []
        eng3.close()

    def test_resume_with_spent_budget_is_terminal(self, setup,
                                                  tmp_path):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(chaos=ChaosPlan(),
                               journal_path=str(tmp_path / "j.jsonl"))
        eng = ServingEngine(sess, max_queue=4, resilience=pol)
        rng = np.random.default_rng(91)
        r = eng.resume(_prompt(rng, 4), generated=[1, 2, 3],
                       max_new_tokens=3, request_id="spent")
        assert r.state is RequestState.DONE and r.output == [1, 2, 3]
        assert eng.pending == 0
        eng.close()


# ===================================================================
# no-fault identity (the happy path pays nothing semantic)
# ===================================================================
class TestNoFaultIdentity:
    def test_resilience_on_no_faults_is_bit_identical(self, setup,
                                                      tmp_path):
        """With resilience armed (SLOs declared, journal on) but no
        faults injected, greedy outputs are bit-identical to the plain
        engine — every resilience decision is host-side."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=16, max_len=48)
        rng = np.random.default_rng(100)
        prompts = [_prompt(rng, 9) for _ in range(4)]

        def serve(resil):
            eng = ServingEngine(sess, max_queue=8, prefill_chunk=4,
                                resilience=resil)
            reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
            eng.run()
            eng.close()
            return [list(r.output) for r in reqs]

        plain = serve(None)
        pol = ResiliencePolicy(
            slos=[LaneSLO(priority=0, ttft_p99_ms=1e9)],
            chaos=ChaosPlan(),
            journal_path=str(tmp_path / "ident.jsonl"))
        armed = serve(pol)
        assert plain == armed
        assert pol.shed_total == 0 and pol.brownout_level == 0


# ===================================================================
# shutdown deadlines (satellites)
# ===================================================================
class TestShutdownDeadlines:
    def test_close_deadline_names_stuck_requests(self, setup):
        """A wedged drain (foreign slot hog, stall eviction disabled)
        raises a loud TimeoutError naming the stuck request instead of
        hanging shutdown; the engine stays open for a drain=False."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        rng = np.random.default_rng(110)
        [foreign] = sess.admit(_prompt(rng, 4)[None, :])
        sess.freeze([foreign])
        eng = ServingEngine(sess, max_queue=4)
        eng.STALL_LIMIT = 10 ** 9      # starvation never resolves
        req = eng.submit(_prompt(rng, 4), max_new_tokens=2,
                         request_id="wedged")
        with pytest.raises(TimeoutError, match="wedged"):
            eng.close(deadline=0.3)
        assert not eng._closed
        eng.close(drain=False)
        assert req.state is RequestState.CANCELLED
        sess.evict(foreign)

    # test_ckpt_manager_wait_timeout_names_step and
    # test_module_wait_all_timeout_requeues_pending of the reference's file
    # drive the checkpoint manager's and distributed.checkpoint's wait
    # deadlines, which the port has not yet (the training guards and
    # checkpoints come later): they are left out here.


# ===================================================================
# metrics plumbing
# ===================================================================
class TestResilMetrics:
    def test_serving_metrics_retry_failed_counters(self):
        from paddle_tpu_torch.observability.serving import ServingMetrics
        m = ServingMetrics("t", max_slots=2)
        m.retried(); m.retried(); m.failed()
        out = m.metrics()
        assert out["retries"] == 2 and out["requests_failed"] == 1
        m.reset()
        out = m.metrics()
        assert out["retries"] == 0 and out["requests_failed"] == 0

    def test_engine_metrics_embed_resilience(self, setup):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(
            slos=[LaneSLO(priority=0, ttft_p99_ms=500.0)],
            chaos=ChaosPlan())
        eng = ServingEngine(sess, max_queue=4, resilience=pol)
        rng = np.random.default_rng(120)
        eng.submit(_prompt(rng, 4), max_new_tokens=1)
        eng.run()
        m = eng.metrics()
        r = m["resilience"]
        assert r["brownout_level"] == 0 and r["shed_total"] == 0
        assert "0" in r["lanes"]
        assert r["lanes"]["0"]["ttft_target_ms"] == 500.0
        assert m["retry_backlog"] == 0
        eng.close()


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


def test_trace_replay_matches_reference_engine(ref_weights, tmp_path):
    """One serve_trace trace through the port's engine and the
    reference's, each under a ResiliencePolicy with a lane SLO, a
    poisoned request (``poison_request@req=3``, one retry allowed) and the
    crash journal, on a fake clock: equal streams, states and retry
    counts, equal journal records (they hold no wall time) and equal
    policy metrics."""
    jcfg, jp, tcfg, tp = ref_weights
    trace = _serve_trace()
    sides = []
    for make_sess, make_eng, Pol, Slo, Plan in (
            (lambda: GenerationSession(tp, tcfg, max_slots=3,
                                       max_prompt_len=24, max_len=40),
             ServingEngine, ResiliencePolicy, LaneSLO, ChaosPlan),
            (lambda: JSession(jp, jcfg, max_slots=3, max_prompt_len=24,
                              max_len=40),
             JEngine, JResiliencePolicy, JLaneSLO, JChaosPlan)):
        clock = FakeClock()
        path = tmp_path / f"journal{len(sides)}.jsonl"
        pol = Pol(slos=[Slo(priority=0, ttft_p99_ms=1e9)],
                  chaos=Plan.parse("poison_request@req=3"),
                  journal_path=str(path))
        eng = make_eng(make_sess(), max_queue=16, prefill_chunk=8,
                       prefix_cache_blocks=8, clock=clock, resilience=pol,
                       max_retries=1, retry_backoff_s=0.001)
        reqs = _replay(eng.submit, eng.poll, eng.run, clock, trace)
        eng.close()
        met = pol.metrics()
        assert met.pop("journal_path") == str(path)
        sides.append(([(r.request_id, r.state.value, r.retries,
                        list(r.output)) for r in reqs],
                      [json.loads(line) for line in open(path)], met))
    assert sides[0] == sides[1]
    states = [st for _, st, _, _ in sides[0][0]]
    assert states.count("failed") == 1 and states.count("done") == 7
