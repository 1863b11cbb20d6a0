"""The port's request tracing on the CPU (gpt tiny, f32): the scenarios
of tests/test_tracing.py run against ``paddle_tpu_torch`` — trace
context across the retry, prefill->decode handoff and journal-replay
seams, the no-op cost of the off switch, the flight recorder's atomic
dumps, the chrome-trace flow export, ``tools/trace_report.py``'s
verdicts, JSONL rotation, and the Prometheus exporter and CLI — and one
serve_trace trace replayed through the port's engine and the
reference's with tracing on, with equal streams and span trees."""
import dataclasses
import json
import os
import sys
import tracemalloc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.models import gpt as tg

from paddle_tpu_torch.framework.monitor import (stat_set, stats_prom,
                                                write_stats_snapshot)
from paddle_tpu_torch.inference import GenerationSession as _Session
from paddle_tpu_torch.models.gpt import GPTConfig, init_params
from paddle_tpu_torch.observability import events, tracing
from paddle_tpu_torch.serving import (RequestState, ResiliencePolicy,
                                      ServingFleet, replay_journal)
from paddle_tpu_torch.serving.fleet import KVHandoff, plan_handoff

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools"))
import trace_report  # noqa: E402

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


@pytest.fixture
def traced(tmp_path):
    """Arm tracing with an isolated flight dir; restore after."""
    old = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
    os.environ["PADDLE_TPU_FLIGHT_DIR"] = str(tmp_path / "flight")
    tracing.set_enabled(True)
    tracing.reset()
    try:
        yield str(tmp_path / "flight")
    finally:
        tracing.set_enabled(None)
        tracing.reset()
        if old is None:
            os.environ.pop("PADDLE_TPU_FLIGHT_DIR", None)
        else:
            os.environ["PADDLE_TPU_FLIGHT_DIR"] = old


def _prompt(rng, n, vocab=64):
    return rng.integers(0, vocab, (n,)).astype(np.int32)


def _mk_engine(params, cfg, slots=2, **kw):
    sess = GenerationSession(params, cfg, max_slots=slots,
                             max_prompt_len=16, max_len=48)
    kw.setdefault("prefill_chunk", 4)
    return ServingEngine(sess, max_queue=16, **kw)


def _roots(tr):
    rs = [r for r in tracing.records()
          if r["name"] == "request" and r["tr"] == tr]
    return sorted(rs, key=lambda r: r["t0"])


# ===================================================================
# request lifecycle spans
# ===================================================================
class TestLifecycleSpans:
    def test_phases_contiguous_and_ttft_decomposes(self, setup,
                                                   traced):
        cfg, params = setup
        eng = _mk_engine(params, cfg)
        rng = np.random.default_rng(0)
        req = eng.submit(_prompt(rng, 8), max_new_tokens=4)
        eng.run()
        eng.close()
        assert req.trace_id is not None
        recs = [r for r in tracing.records() if r["tr"] == req.trace_id]
        names = {r["name"] for r in recs}
        assert {"request", "queue", "prefill", "decode"} <= names
        root = _roots(req.trace_id)[0]
        assert root["par"] is None and root["state"] == "done"
        # phase transitions share one stamp: queue.t1 == prefill.t0 etc
        phases = sorted([r for r in recs if r["name"] in
                         ("queue", "prefill", "decode")],
                        key=lambda r: r["t0"])
        for a, b in zip(phases, phases[1:]):
            assert a["t1"] == b["t0"]
        rep = trace_report.report(recs)
        assert rep["ok"] and rep["orphan_spans"] == 0
        assert rep["ttft_sum_violations"] == 0
        # the span TTFT matches the engine's measured TTFT
        d = trace_report._trace_ttft(recs)
        assert abs(d["ttft_s"] - req.ttft_s) < 0.05

    def test_poll_spans_carry_row_attribution(self, setup, traced):
        cfg, params = setup
        eng = _mk_engine(params, cfg)
        rng = np.random.default_rng(1)
        req = eng.submit(_prompt(rng, 8), max_new_tokens=3,
                         request_id="attr0")
        eng.run()
        eng.close()
        polls = [r for r in tracing.records() if r["name"] == "poll"]
        assert polls and any("attr0" in r.get("rids", ())
                             for r in polls)

    def test_rejected_submit_closes_trace(self, setup, traced):
        cfg, params = setup
        sess = GenerationSession(params, cfg, max_slots=1,
                                 max_prompt_len=16, max_len=48)
        eng = ServingEngine(sess, max_queue=1, prefill_chunk=4)
        rng = np.random.default_rng(2)
        eng.submit(_prompt(rng, 8), max_new_tokens=2)
        from paddle_tpu_torch.serving import QueueFull
        with pytest.raises(QueueFull) as ei:
            eng.submit(_prompt(rng, 8), max_new_tokens=2)
        rej = ei.value.request
        root = _roots(rej.trace_id)[0]
        assert root["state"] == "rejected" and root["t1"] is not None
        eng.close()


# ===================================================================
# seam propagation: retry / handoff / journal replay
# ===================================================================
class TestSeamPropagation:
    def test_retry_incarnation_links_to_evicted_root(self, setup,
                                                     traced):
        cfg, params = setup
        eng = _mk_engine(params, cfg, max_retries=2,
                         retry_backoff_s=0.0)
        rng = np.random.default_rng(3)
        req = eng.submit(_prompt(rng, 8), max_new_tokens=6)
        while not eng._by_slot:
            eng.poll()
        assert eng.requeue(req, "test_evict")
        eng.run()
        eng.close()
        roots = _roots(req.trace_id)
        assert len(roots) == 2
        assert roots[0]["state"] == "evicted"
        assert roots[1]["par"] == roots[0]["sid"]
        assert roots[1]["kind"] == "retry"
        assert roots[1]["state"] == "done"
        rep = trace_report.report(
            [r for r in tracing.records() if r["tr"] == req.trace_id])
        assert rep["ok"] and rep["max_incarnations"] == 2

    def test_handoff_carries_parent_span_across_replicas(self, setup,
                                                         traced):
        cfg, params = setup

        def mk(promote=2):
            return _mk_engine(params, cfg, prefix_cache_blocks=8,
                              prefix_promote_after=promote)
        fl = ServingFleet([("pf", mk(1), "prefill"),
                           ("d0", mk(), "decode")])
        rng = np.random.default_rng(4)
        req = fl.submit(_prompt(rng, 12), max_new_tokens=4,
                        request_id="h0")
        fl.run(deadline=300.0)
        fl.close()
        tr = req.trace_id
        recs = [r for r in tracing.records() if r["tr"] == tr]
        hand = [r for r in recs if r["name"] == "handoff"]
        assert len(hand) == 1 and hand[0]["accepted"]
        roots = _roots(tr)
        assert len(roots) == 2
        # prefill root -> handoff span -> decode root, across tracks
        assert hand[0]["par"] == roots[0]["sid"]
        assert roots[1]["par"] == hand[0]["sid"]
        assert roots[0]["track"] != roots[1]["track"]
        assert trace_report.report(recs)["ok"]

    def test_kvhandoff_object_carries_trace_ctx(self, traced):
        hand = KVHandoff(rid="x", tokens=None, generated=[],
                         max_new_tokens=4, priority=0, deadline=None,
                         span=8, plan=plan_handoff(8, 8), k=None,
                         v=None, trace=("tr-1", "sid-1"))
        assert hand.trace == ("tr-1", "sid-1")

    def test_journal_replay_resumes_same_trace(self, setup, traced,
                                               tmp_path):
        cfg, params = setup
        jpath = str(tmp_path / "journal.jsonl")
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=16, max_len=48)
        pol = ResiliencePolicy(journal_path=jpath)
        eng = ServingEngine(sess, max_queue=8, prefill_chunk=4,
                            resilience=pol)
        rng = np.random.default_rng(5)
        req = eng.submit(_prompt(rng, 8), max_new_tokens=12,
                         request_id="jr0")
        for _ in range(4):
            eng.poll()
        eng.abandon()
        pol2 = ResiliencePolicy(journal_path=str(tmp_path / "j2.jsonl"))
        eng2 = ServingEngine(sess, max_queue=8, prefill_chunk=4,
                             resilience=pol2)
        resumed = replay_journal(eng2, jpath)
        eng2.run()
        eng2.close()
        assert len(resumed) == 1
        # SAME trace id, new incarnation parented to the crashed root
        assert resumed[0].trace_id == req.trace_id
        roots = _roots(req.trace_id)
        assert len(roots) == 2
        assert roots[0]["state"] == "crashed"
        assert roots[1]["par"] == roots[0]["sid"]
        assert roots[1]["kind"] == "resume"
        assert trace_report.report(
            [r for r in tracing.records()
             if r["tr"] == req.trace_id])["ok"]

    def test_journal_records_carry_trace(self, setup, traced,
                                         tmp_path):
        cfg, params = setup
        jpath = str(tmp_path / "j.jsonl")
        sess = GenerationSession(params, cfg, max_slots=2,
                                 max_prompt_len=16, max_len=48)
        pol = ResiliencePolicy(journal_path=jpath)
        eng = ServingEngine(sess, max_queue=8, prefill_chunk=4,
                            resilience=pol)
        rng = np.random.default_rng(6)
        req = eng.submit(_prompt(rng, 8), max_new_tokens=2)
        eng.run()
        eng.close()
        from paddle_tpu_torch.serving import RequestJournal
        e = RequestJournal.scan(jpath)[req.request_id]
        assert e["trace"][0] == req.trace_id


# ===================================================================
# OFF mode: byte-identical behavior, no allocations
# ===================================================================
class TestOffModeNoop:
    def test_off_leaves_requests_untraced(self, setup):
        cfg, params = setup
        assert not tracing.enabled()
        tracing.reset()
        eng = _mk_engine(params, cfg)
        rng = np.random.default_rng(7)
        req = eng.submit(_prompt(rng, 8), max_new_tokens=2)
        eng.run()
        eng.close()
        assert req.trace_id is None and req.trace_parent is None
        assert tracing.records() == []
        assert tracing.live_count() == 0

    def test_off_hooks_allocate_nothing(self, setup):
        cfg, params = setup
        assert not tracing.enabled()

        class R:  # a Request stand-in for the hook signatures
            trace_id = None
            trace_parent = None
            request_id = "r"
            priority = 0
            retries = 0
            output = []

        r = R()
        # warm the code paths once (first call may cache bytecode)
        tracing.on_submit("t", r)
        tracing.on_admit("t", r)
        tracing.on_first_token("t", r)
        tracing.on_finish("t", r, "done")
        assert tracing.poll_begin() is None
        tracemalloc.start()
        base = tracemalloc.take_snapshot()
        for _ in range(2000):
            tracing.on_submit("t", r)
            tracing.on_admit("t", r)
            tracing.on_decoding("t", r)
            tracing.on_first_token("t", r)
            tracing.on_finish("t", r, "done")
            tracing.poll_begin()
            tracing.on_poll("t", 1, rows=0, emitted=0, t0=None)
        snap = tracemalloc.take_snapshot()
        tracemalloc.stop()
        grown = sum(d.size_diff for d in snap.compare_to(base, "lineno")
                    if d.size_diff > 0)
        # a few hundred bytes of interpreter noise is fine; per-call
        # allocation (2000 * anything) is not
        assert grown < 16 * 1024
        assert r.trace_id is None
        assert tracing.records() == []

    def test_flight_dump_disarmed_is_none(self):
        assert not tracing.enabled()
        assert tracing.flight_dump("nope") is None


# ===================================================================
# flight recorder
# ===================================================================
class TestFlightRecorder:
    def test_abandon_dumps_atomically(self, setup, traced):
        cfg, params = setup
        eng = _mk_engine(params, cfg)
        rng = np.random.default_rng(8)
        eng.submit(_prompt(rng, 8), max_new_tokens=8)
        for _ in range(3):
            eng.poll()
        eng.abandon()
        dumps = os.listdir(traced)
        assert len([p for p in dumps
                    if p.startswith("flightrec_")]) == 1
        assert not [p for p in dumps if p.endswith(".tmp")]
        path = os.path.join(
            traced, [p for p in dumps if p.startswith("flightrec_")][0])
        d = json.load(open(path))
        assert d["reason"] == "engine_abandon"
        assert d["records"] or d["open_spans"]
        # the dump parses through trace_report
        assert isinstance(
            trace_report.report(trace_report.load_spans(path)), dict)

    def test_ring_is_bounded(self, traced):
        for i in range(3000):
            tracing.mark("spam", "t", i=i)
        assert len(tracing.flight_records()) <= 2048

    def test_telemetry_events_ride_the_ring(self, traced, tmp_path):
        events.set_enabled(True)
        events.set_event_path(str(tmp_path / "ev.jsonl"))
        try:
            events.emit("unit_test_event", x=1)
        finally:
            events.set_enabled(None)
            events.set_event_path(None)
        assert any(r.get("kind") == "unit_test_event"
                   for r in tracing.flight_records())


# ===================================================================
# trace_report verdicts
# ===================================================================
class TestTraceReport:
    def test_orphan_detection(self):
        spans = [
            {"sid": "a", "tr": "t1", "par": None, "name": "request",
             "track": "x", "t0": 0.0, "t1": 1.0},
            {"sid": "b", "tr": "t1", "par": "MISSING", "name": "queue",
             "track": "x", "t0": 0.0, "t1": 0.5},
        ]
        rep = trace_report.report(spans)
        assert rep["orphan_spans"] == 1
        assert rep["disconnected_traces"] == 1
        assert not rep["ok"]

    def test_two_parentless_roots_disconnect(self):
        spans = [
            {"sid": "a", "tr": "t1", "par": None, "name": "request",
             "track": "x", "t0": 0.0, "t1": 1.0},
            {"sid": "b", "tr": "t1", "par": None, "name": "request",
             "track": "x", "t0": 2.0, "t1": 3.0},
        ]
        rep = trace_report.report(spans)
        assert rep["disconnected_traces"] == 1

    def test_decomposition_sums_with_recovery_gap(self):
        spans = [
            {"sid": "a", "tr": "t", "par": None, "name": "request",
             "track": "x", "t0": 0.0, "t1": 1.0, "state": "crashed"},
            {"sid": "q", "tr": "t", "par": "a", "name": "queue",
             "track": "x", "t0": 0.0, "t1": 0.4},
            {"sid": "p", "tr": "t", "par": "a", "name": "prefill",
             "track": "x", "t0": 0.4, "t1": 1.0},
            # 1.0 -> 2.0 is the crash window (recovery)
            {"sid": "b", "tr": "t", "par": "a", "name": "request",
             "track": "y", "t0": 2.0, "t1": 4.0, "state": "done"},
            {"sid": "q2", "tr": "t", "par": "b", "name": "queue",
             "track": "y", "t0": 2.0, "t1": 2.5},
            {"sid": "p2", "tr": "t", "par": "b", "name": "prefill",
             "track": "y", "t0": 2.5, "t1": 3.0},
            {"sid": "d2", "tr": "t", "par": "b", "name": "decode",
             "track": "y", "t0": 3.0, "t1": 4.0, "t_first": 3.25},
        ]
        rep = trace_report.report(spans)
        assert rep["ok"], rep
        d = trace_report._trace_ttft(spans)
        assert d["ttft_s"] == pytest.approx(3.25)
        ph = d["phases"]
        assert ph["queue"] == pytest.approx(0.9)
        assert ph["prefill"] == pytest.approx(1.1)
        assert ph["decode"] == pytest.approx(0.25)
        assert ph["recovery"] == pytest.approx(1.0)
        assert sum(ph.values()) == pytest.approx(d["ttft_s"])

    def test_chrome_export_flow_arrows_and_roundtrip(self, setup,
                                                     traced,
                                                     tmp_path):
        cfg, params = setup

        def mk(promote=2):
            return _mk_engine(params, cfg, prefix_cache_blocks=8,
                              prefix_promote_after=promote)
        fl = ServingFleet([("pf", mk(1), "prefill"),
                           ("d0", mk(), "decode")])
        rng = np.random.default_rng(9)
        fl.submit(_prompt(rng, 12), max_new_tokens=3)
        fl.run(deadline=300.0)
        fl.close()
        path = tracing.export_chrome(str(tmp_path / "trace.json"))
        data = json.load(open(path))
        evs = data["traceEvents"]
        # cross-track parent (decode root -> handoff span) must render
        # as an s/f flow pair
        assert any(e.get("ph") == "s" for e in evs)
        assert any(e.get("ph") == "f" for e in evs)
        rep = trace_report.report(trace_report.load_spans(path))
        assert rep["ok"] and rep["orphan_spans"] == 0


# ===================================================================
# satellites: event rotation, prom exporter
# ===================================================================
class TestEventRotation:
    def test_rotation_keeps_k_segments_and_reads_in_order(
            self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_MAX_MB", "0.001")
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_KEEP", "2")
        path = str(tmp_path / "ev.jsonl")
        events.set_enabled(True)
        events.set_event_path(path)
        try:
            for i in range(200):
                events.emit("spam", i=i, pad="x" * 64)
        finally:
            events.set_enabled(None)
            events.set_event_path(None)
        segs = sorted(os.listdir(tmp_path))
        assert "ev.jsonl.1" in segs and "ev.jsonl.2" in segs
        assert "ev.jsonl.3" not in segs
        recs = list(events.iter_events(path))
        idx = [r["i"] for r in recs]
        # oldest-kept-first, contiguous, ending at the newest event
        assert idx == list(range(idx[0], 200))

    def test_reader_skips_torn_tail(self, tmp_path):
        path = str(tmp_path / "ev.jsonl")
        events.set_enabled(True)
        events.set_event_path(path)
        try:
            for i in range(5):
                events.emit("spam", i=i)
        finally:
            events.set_enabled(None)
            events.set_event_path(None)
        with open(path, "a") as f:
            f.write('{"kind": "torn')   # a crashed writer's last line
        recs = list(events.iter_events(path))
        assert [r["i"] for r in recs] == list(range(5))

    def test_rotation_disabled_at_zero(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_MAX_MB", "0")
        path = str(tmp_path / "ev.jsonl")
        events.set_enabled(True)
        events.set_event_path(path)
        try:
            for i in range(50):
                events.emit("spam", i=i, pad="y" * 64)
        finally:
            events.set_enabled(None)
            events.set_event_path(None)
        assert sorted(os.listdir(tmp_path)) == ["ev.jsonl"]


class TestPromExporter:
    def test_prom_text_shape(self):
        stat_set("tracing_test_gauge", 7)
        txt = stats_prom()
        lines = txt.splitlines()
        assert "# TYPE paddle_tpu_tracing_test_gauge gauge" in lines
        assert "paddle_tpu_tracing_test_gauge 7" in lines
        # every sample line is "<name> <number>"
        for ln in lines:
            if ln.startswith("#") or not ln:
                continue
            name, val = ln.split(" ")
            float(val)
            assert name[0].isalpha() or name[0] == "_"

    def test_snapshot_writer_atomic(self, tmp_path):
        p = write_stats_snapshot(str(tmp_path / "s.prom"))
        assert os.path.exists(p)
        assert not os.path.exists(p + ".tmp")
        pj = write_stats_snapshot(str(tmp_path / "s.json"), fmt="json")
        assert isinstance(json.load(open(pj)), dict)
        with pytest.raises(ValueError):
            write_stats_snapshot(str(tmp_path / "s.x"), fmt="xml")

    def test_cli_render_both_formats(self):
        from paddle_tpu_torch.observability.__main__ import render
        assert isinstance(json.loads(render("json")), dict)
        assert "# TYPE" in render("prom")


# ===================================================================
# the same trace through the reference's engine
# ===================================================================
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


def _span_shape(recs):
    """Each span as (name, its parent's name, closed), in open order —
    ids and tracks are numbered per process, so they are not compared."""
    names = {r["sid"]: r["name"] for r in recs}
    return [(r["name"], names.get(r["par"]), r["t1"] is not None)
            for r in recs]


def test_trace_replay_matches_reference_engine(ref_weights, tmp_path,
                                               monkeypatch):
    """One serve_trace trace through the port's engine and the
    reference's with tracing armed in both packages, on a fake clock:
    equal streams, and the same spans with the same parents in the same
    order; every request's trace closes."""
    jcfg, jp, tcfg, tp = ref_weights
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    trace = _serve_trace()
    sides = []
    try:
        for mod, make_sess, make_eng in (
                (tracing,
                 lambda: GenerationSession(tp, tcfg, max_slots=3,
                                           max_prompt_len=24, max_len=40),
                 ServingEngine),
                (jtracing,
                 lambda: JSession(jp, jcfg, max_slots=3, max_prompt_len=24,
                                  max_len=40), JEngine)):
            mod.set_enabled(True)
            mod.reset()
            clock = _Clock()
            eng = make_eng(make_sess(), max_queue=16, prefill_chunk=8,
                           prefix_cache_blocks=8, clock=clock)
            reqs = _replay(eng.submit, eng.poll, eng.run, clock, trace)
            eng.close()
            assert mod.live_count() == 0
            sides.append(([list(r.output) for r in reqs],
                          _span_shape(mod.records())))
            mod.set_enabled(None)
    finally:
        for mod in (tracing, jtracing):
            mod.set_enabled(None)
            mod.reset()
    assert sides[0] == sides[1]
    names = {n for n, _, _ in sides[0][1]}
    assert {"request", "queue", "prefill", "decode"} <= names
