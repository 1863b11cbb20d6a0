"""The port's per-tenant metering on the CPU (gpt tiny, f32): the
scenarios of tests/test_metering.py run against ``paddle_tpu_torch`` —
keyed reservoir merges, cardinality bounds, noisy-neighbour detection,
Prometheus labels, tenant-tagged crash journals, and per-tenant token
sums conserving against the engine's untagged counters — and one
two-tenant serve_trace trace replayed through the port's metered paged
engine and the reference's, with equal streams and per-tenant
counters."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.models import gpt as tg

from paddle_tpu_torch.distributed.ft.chaos import ChaosPlan
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.inference import GenerationSession as _Session
from paddle_tpu_torch.models.gpt import GPTConfig, init_params
from paddle_tpu_torch.observability.metering import (OTHER, UNTAGGED,
                                                     TenantMeter)
from paddle_tpu_torch.serving import (RequestJournal, RequestState,
                                      ResiliencePolicy, replay_journal)

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


def _prompt(rng, n, vocab=128):
    return rng.integers(0, vocab, (n,)).astype(np.int32)


# ===================================================================
# host-side accounting (no engine)
# ===================================================================
class TestTenantAccounting:
    def test_counters_keyed_and_untagged(self):
        m = TenantMeter()
        m.on_submit("a")
        m.on_prefill("a", 10)
        m.on_decode("a", 3)
        m.on_submit(None)          # untenanted -> the reserved bucket
        m.on_decode(None, 2)
        c = m.counters()
        assert c["a"]["prefill_tokens"] == 10
        assert c["a"]["decode_tokens"] == 3
        assert c[UNTAGGED]["decode_tokens"] == 2
        t = m.totals()
        assert t["requests"] == 2 and t["decode_tokens"] == 5

    def test_max_tenants_folds_long_tail_conserving_totals(self):
        m = TenantMeter(max_tenants=4)
        for i in range(10):
            m.on_submit(f"t{i}")
            m.on_decode(f"t{i}", 1)
        # 4 tracked ids + ONE fold bucket, never 10
        assert len(m.tenants()) == 5 and OTHER in m.tenants()
        assert m.counters()[OTHER]["requests"] == 6
        assert m.totals()["requests"] == 10
        assert m.totals()["decode_tokens"] == 10

    def test_export_rows_bounded_topk_plus_other(self):
        m = TenantMeter(top_k=2)
        for i, toks in enumerate([100, 50, 10, 5, 1]):
            m.on_decode(f"t{i}", toks)
            m.on_ttft(f"t{i}", float(10 * i + 1))
        rows = dict(m.export_rows())
        assert set(rows) == {"t0", "t1", OTHER}
        assert rows[OTHER]["decode_tokens"] == 16     # 10 + 5 + 1
        # export conserves: the fold loses no tokens
        assert sum(r["decode_tokens"] for r in rows.values()) \
            == m.totals()["decode_tokens"]
        # the folded row's reservoir merged the tail's samples
        assert rows[OTHER]["ttft_ms_p50"] is not None

    def test_merged_sums_counters_exactly(self):
        parts = []
        for seed in range(3):
            p = TenantMeter(name=f"r{seed}")
            rng = np.random.default_rng(seed)
            for t in ("a", "b"):
                p.on_prefill(t, int(rng.integers(1, 100)))
                p.on_decode(t, int(rng.integers(1, 100)))
                p.on_shed(t)
            p.pool_page_seconds = float(seed)
            parts.append(p)
        m = TenantMeter.merged("fleet", parts)
        for t in ("a", "b"):
            for c in ("prefill_tokens", "decode_tokens", "sheds"):
                assert m.counters()[t][c] == sum(
                    p.counters()[t][c] for p in parts)
        assert m.pool_page_seconds == sum(
            p.pool_page_seconds for p in parts)

    def test_merged_reservoirs_exact_under_cap(self):
        """Merge-of-splits == whole, per tenant: below the reservoir
        cap nothing is subsampled, so every percentile of the merged
        keyed reservoirs equals the percentile over the full stream."""
        rng = np.random.default_rng(0)
        streams = {"a": rng.normal(50, 10, 120),
                   "b": rng.normal(200, 30, 90)}
        whole = TenantMeter(name="whole")
        parts = [TenantMeter(name=f"p{i}") for i in range(3)]
        for t, vals in streams.items():
            for i, v in enumerate(vals):
                whole.on_ttft(t, float(v))
                parts[i % 3].on_ttft(t, float(v))
        m = TenantMeter.merged("m", parts)
        for t in streams:
            for q in (50, 99):
                assert m._t[t].ttft_ms.percentile(q) == pytest.approx(
                    whole._t[t].ttft_ms.percentile(q))

    def test_merged_reservoirs_statistical_over_cap(self):
        """Past the cap the merge subsamples seen-weighted; the p50 of
        a large merged stream must land near the true median."""
        rng = np.random.default_rng(1)
        parts = []
        for i in range(4):
            p = TenantMeter(name=f"p{i}")
            for v in rng.normal(100, 10, 700):
                p.on_queue_wait("big", float(v))
            parts.append(p)
        m = TenantMeter.merged("m", parts)
        r = m._t["big"].queue_wait_ms
        assert r.seen == 2800
        assert r.percentile(50) == pytest.approx(100, abs=3)

    def test_merged_is_deterministic(self):
        rng = np.random.default_rng(2)
        vals = rng.normal(10, 2, 2000)
        mk = lambda: [
            TenantMeter(name=f"p{i}") for i in range(2)]
        a_parts, b_parts = mk(), mk()
        for i, v in enumerate(vals):
            a_parts[i % 2].on_ttft("t", float(v))
            b_parts[i % 2].on_ttft("t", float(v))
        a = TenantMeter.merged("m", a_parts)
        b = TenantMeter.merged("m", b_parts)
        assert a._t["t"].ttft_ms._samples == b._t["t"].ttft_ms._samples

    def test_reset_clears_everything(self):
        m = TenantMeter()
        m.on_decode("a", 5)
        m.observe_poll({"a": 2}, {"a": 1}, dt=0.1, pool_pages=2)
        m.reset()
        assert m.tenants() == [] and m.polls == 0
        assert m.pool_page_seconds == 0.0 and m.noisy == []


# ===================================================================
# noisy-neighbor detection
# ===================================================================
class TestNoisyDetector:
    def _meter(self, polls=4):
        return TenantMeter(name="nd", dominance_threshold=0.6,
                           dominance_polls=polls)

    def test_lone_tenant_never_fires(self):
        """A tenant alone on the engine has no neighbours — the drain
        tail of any single-tenant trace must not page the operator."""
        m = self._meter()
        for _ in range(50):
            m.observe_poll({"a": 8}, {"a": 5}, dt=0.01, pool_pages=8)
        assert m.noisy == [] and m.noisy_total == 0

    def test_fires_once_after_consecutive_polls(self):
        m = self._meter(polls=4)
        for _ in range(10):
            m.observe_poll({"a": 1, "b": 1}, {"a": 9, "b": 1},
                           dt=0.01, pool_pages=2)
        # one episode, not one event per poll past the threshold
        qs = [ep for ep in m.noisy if ep["metric"] == "queue"]
        assert len(qs) == 1
        assert qs[0]["tenant"] == "a" and qs[0]["share"] == 0.9
        assert qs[0]["poll"] == 4     # fired the instant the streak hit

    def test_interrupted_streak_resets(self):
        m = self._meter(polls=4)
        for i in range(12):
            if i % 3 == 2:   # every third poll the flood pauses
                m.observe_poll({"a": 1, "b": 1}, {"a": 1, "b": 1},
                               dt=0.01)
            else:
                m.observe_poll({"a": 1, "b": 1}, {"a": 9, "b": 1},
                               dt=0.01)
        assert [ep for ep in m.noisy if ep["metric"] == "queue"] == []

    def test_rearms_for_a_second_episode(self):
        m = self._meter(polls=3)
        flood = lambda: m.observe_poll({"a": 1, "b": 1},
                                       {"a": 9, "b": 1}, dt=0.01)
        calm = lambda: m.observe_poll({"a": 1, "b": 1},
                                      {"a": 1, "b": 1}, dt=0.01)
        for _ in range(5):
            flood()
        for _ in range(3):
            calm()
        for _ in range(5):
            flood()
        qs = [ep for ep in m.noisy if ep["metric"] == "queue"]
        assert len(qs) == 2 and {ep["tenant"] for ep in qs} == {"a"}

    def test_page_seconds_integrate_and_conserve(self):
        m = self._meter()
        for _ in range(10):
            m.observe_poll({"a": 3, "b": 1}, {}, dt=0.5, pool_pages=4)
        t = m.totals()
        assert t["page_seconds"] == pytest.approx(20.0)    # (3+1)*0.5*10
        assert m.pool_page_seconds == pytest.approx(20.0)
        assert m.counters()["a"]["page_seconds"] == pytest.approx(15.0)


# ===================================================================
# Prometheus label rendering (framework/monitor.py satellite)
# ===================================================================
class TestPromLabels:
    def test_labeled_name_escapes_and_sorts(self):
        n = monitor.prom_labeled_name("fam", tenant='a"b\\c\nd')
        assert n == 'fam{tenant="a\\"b\\\\c\\nd"}'
        n2 = monitor.prom_labeled_name("fam", b="2", a="1")
        assert n2 == 'fam{a="1",b="2"}'
        assert monitor.prom_labeled_name("fam") == "fam"

    def test_stats_prom_renders_labels_one_type_per_family(self):
        reg = monitor.stat_registry
        try:
            reg.register(monitor.prom_labeled_name(
                "zz_lbl_tok_total", tenant="a")).set(3)
            reg.register(monitor.prom_labeled_name(
                "zz_lbl_tok_total", tenant='q"t')).set(4)
            txt = monitor.stats_prom()
            lines = [ln for ln in txt.splitlines() if "zz_lbl" in ln]
            assert lines == [
                "# TYPE paddle_tpu_zz_lbl_tok_total gauge",
                'paddle_tpu_zz_lbl_tok_total{tenant="a"} 3',
                'paddle_tpu_zz_lbl_tok_total{tenant="q\\"t"} 4',
            ]
        finally:
            reg.unregister(prefix="zz_lbl_tok_total")

    def test_flat_gauges_render_byte_identically(self):
        """A registry with no labeled keys renders exactly the
        historical flat format — the labeled path must not perturb
        label-free publishers."""
        reg = monitor.stat_registry
        try:
            reg.register("zz_flat_a").set(1)
            reg.register("zz_flat_b", "float").set(2.5)
            txt = monitor.stats_prom()
            assert ("# TYPE paddle_tpu_zz_flat_a gauge\n"
                    "paddle_tpu_zz_flat_a 1\n"
                    "# TYPE paddle_tpu_zz_flat_b gauge\n"
                    "paddle_tpu_zz_flat_b 2.5\n") in txt
        finally:
            reg.unregister(prefix="zz_flat_")

    def test_meter_publish_and_close_roundtrip(self):
        from paddle_tpu_torch.observability import events
        m = TenantMeter(name="zzmeter")
        m.on_decode("a", 7)
        was = events.enabled()
        events.set_enabled(True)
        try:
            m.publish_gauges()
            rep = monitor.stats_report()
            key = monitor.prom_labeled_name(
                "tenant_zzmeter_decode_tokens_total", tenant="a")
            assert rep[key] == 7
        finally:
            events.set_enabled(was or None)
            m.close()
        assert not any(k.startswith("tenant_zzmeter_")
                       for k in monitor.stats_report())


# ===================================================================
# engine conservation at unit scale
# ===================================================================
class TestEngineConservation:
    def _run(self, setup, paged, metering):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=8, max_len=32,
                                 kv_paged=paged)
        eng = ServingEngine(sess, max_queue=16, metering=metering)
        rng = np.random.default_rng(3)
        tenants = ["a", "a", "b", None, "b", "a"]
        reqs = [eng.submit(_prompt(rng, 5), max_new_tokens=3 + i % 3,
                           tenant=t) for i, t in enumerate(tenants)]
        eng.run()
        assert all(r.state is RequestState.DONE for r in reqs)
        outs = [list(r.output) for r in reqs]   # submit order
        emitted = sess.metrics()["tokens_emitted"]
        work = sum(len(r.tokens) - r.prefix_hit_tokens for r in reqs)
        meter = eng.meter
        eng.close()
        sess.close()
        return outs, emitted, work, meter

    @pytest.mark.parametrize("paged", [False, True])
    def test_token_sums_conserve(self, setup, paged):
        outs, emitted, work, meter = self._run(setup, paged, True)
        tot = meter.totals()
        assert tot["decode_tokens"] == emitted
        assert tot["prefill_tokens"] == work
        assert tot["requests"] == 6
        assert sorted(meter.tenants()) == [UNTAGGED, "a", "b"]
        # per-tenant split: "a" got 3 requests, untagged 1
        assert meter.counters()["a"]["requests"] == 3
        assert meter.counters()[UNTAGGED]["requests"] == 1
        if paged:
            assert tot["page_seconds"] == pytest.approx(
                meter.pool_page_seconds, rel=1e-6)
            assert meter.pool_page_seconds > 0

    def test_metering_off_is_identity(self, setup):
        """Arming the meter must not change a single emitted token —
        and metering-off engines carry no meter at all."""
        outs_off, *_, meter_off = self._run(setup, False, False)
        outs_on, *_, meter_on = self._run(setup, False, True)
        assert meter_off is None and meter_on is not None
        assert outs_off == outs_on

    def test_spec_engine_attribution(self, setup):
        """Spec-armed engine: decode sums still conserve exactly and
        accepted-draft tokens land on the right tenant."""
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=8, max_len=32,
                                 spec_decode=4, spec_draft_layers=1)
        eng = ServingEngine(sess, max_queue=8, metering=True)
        rng = np.random.default_rng(4)
        reqs = [eng.submit(_prompt(rng, 6), max_new_tokens=8,
                           tenant=t) for t in ("a", "b")]
        eng.run()
        assert all(r.state is RequestState.DONE for r in reqs)
        tot = eng.meter.totals()
        assert tot["decode_tokens"] == sess.metrics()["tokens_emitted"]
        # acceptance is a subset of emission, never negative
        assert 0 <= tot["spec_accepted_tokens"] <= tot["decode_tokens"]
        eng.close()
        sess.close()

    def test_engine_metrics_embed_tenant_block(self, setup):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=8, max_len=32)
        eng = ServingEngine(sess, max_queue=8, metering=True)
        rng = np.random.default_rng(5)
        eng.submit(_prompt(rng, 5), max_new_tokens=2, tenant="a")
        eng.run()
        m = eng.metrics()
        assert m["tenants"]["by_tenant"]["a"]["decode_tokens"] == 2
        assert json.dumps(m["tenants"]) is not None
        eng.close()
        # metering off: no block at all (the key's absence IS the flag)
        eng2 = ServingEngine(sess, max_queue=8, metering=False)
        assert "tenants" not in eng2.metrics()
        eng2.close()
        sess.close()


# ===================================================================
# tenant-tagged crash journal
# ===================================================================
class TestJournalTenant:
    def test_untenanted_records_carry_no_tenant_key(self, setup,
                                                    tmp_path):
        """Byte-compat: a journal written without tenants must be
        record-for-record identical to the pre-metering format — no
        null-valued keys."""
        cfg, params = setup
        path = str(tmp_path / "j.jsonl")
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(chaos=ChaosPlan(), journal_path=path)
        eng = ServingEngine(sess, max_queue=8, resilience=pol)
        rng = np.random.default_rng(6)
        eng.submit(_prompt(rng, 5), max_new_tokens=2, request_id="u")
        eng.submit(_prompt(rng, 5), max_new_tokens=2, request_id="t",
                   tenant="acme")
        eng.run()
        eng.close()
        subs = {}
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("ev") == "submit":
                    subs[rec["rid"]] = rec
        assert "tenant" not in subs["u"]
        assert subs["t"]["tenant"] == "acme"
        assert RequestJournal.scan(path)["t"]["tenant"] == "acme"
        sess.close()

    def test_replay_continuity_preserves_attribution(self, setup,
                                                     tmp_path):
        """Crash mid-decode, replay into a metering engine: the
        resumed request keeps its tenant and the new meter charges the
        post-crash decode to it."""
        cfg, params = setup
        path = str(tmp_path / "j.jsonl")
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=8, max_len=32)
        pol = ResiliencePolicy(chaos=ChaosPlan(), journal_path=path)
        eng = ServingEngine(sess, max_queue=8, resilience=pol)
        rng = np.random.default_rng(7)
        r = eng.submit(_prompt(rng, 5), max_new_tokens=6,
                       request_id="rr", tenant="acme")
        while len(r.output) < 2:
            eng.poll()
        sess.evict(r.slot)          # crash: journal is all that survives
        pol2 = ResiliencePolicy(chaos=ChaosPlan(), journal_path=path)
        eng2 = ServingEngine(sess, max_queue=8, resilience=pol2,
                             metering=True)
        resumed = replay_journal(eng2, path)
        assert [q.tenant for q in resumed] == ["acme"]
        eng2.run()
        nr = resumed[0]
        assert nr.state is RequestState.DONE and len(nr.output) == 6
        c = eng2.meter.counters()["acme"]
        # the resumed incarnation re-prefills its full resident prompt
        # (prompt + pre-crash output) and decodes the remaining budget
        assert c["decode_tokens"] == 6 - nr.resumed_len
        # resume() never re-counts the submission: the request was
        # counted at original submit, and a fleet-merged view would
        # double-bill the tenant otherwise
        assert c["requests"] == 0
        eng2.close()
        sess.close()


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


def test_trace_replay_matches_reference_engine(ref_weights):
    """One two-tenant serve_trace trace through the port's metered paged
    engine and the reference's, on a fake clock: equal streams, equal
    per-tenant counters (tokens, prefix hits and their bytes, requests),
    and on both sides the decode total equals ``tokens_emitted`` and the
    per-tenant page-seconds sum to the pool's."""
    jcfg, jp, tcfg, tp = ref_weights
    trace = _serve_trace()
    sides = []
    for make_sess, make_eng in (
            (lambda: GenerationSession(tp, tcfg, max_slots=3,
                                       max_prompt_len=24, max_len=40,
                                       kv_paged=True), ServingEngine),
            (lambda: JSession(jp, jcfg, max_slots=3, max_prompt_len=24,
                              max_len=40, kv_paged=True), JEngine)):
        clock = _Clock()
        sess = make_sess()
        eng = make_eng(sess, max_queue=16, prefill_chunk=8,
                       prefix_cache_blocks=8, clock=clock, metering=True)
        reqs = _replay(eng.submit, eng.poll, eng.run, clock, trace)
        meter = eng.meter
        totals = meter.totals()
        assert totals["decode_tokens"] == sess.metrics()["tokens_emitted"]
        assert totals["page_seconds"] == pytest.approx(
            meter.pool_page_seconds)
        counters = {t: {k: v for k, v in c.items() if k != "page_seconds"}
                    for t, c in meter.counters().items()}
        eng.close()
        sides.append(([list(r.output) for r in reqs], counters))
    assert sides[0] == sides[1]
    assert set(sides[0][1]) == {"g0", "g1"}
