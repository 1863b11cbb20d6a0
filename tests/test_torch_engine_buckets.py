"""The port's ServingEngine batching plane on the CPU at gpt_tiny f32:
width buckets, prefill batching (``prefill_min_batch``,
``prefill_max_defer``), the starvation stall-evict and ``prewarm()``.
Against the reference engine on the same weights and traces: equal
streams, equal tick sequences (kind and width bucket), equal
``prefill_chunks`` and ``stall_evictions`` counts, and equal validation
errors. The JAX engines share one session per case kind, so each width's
programs compile once."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.framework import cuda_graph
from paddle_tpu_torch.inference import GenerationSession, generation
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.serving import RequestState, ServingEngine

torch.set_num_threads(1)
VOCAB = 256
PS = 8
SESSION = dict(max_slots=3, max_prompt_len=32, max_len=48)


@pytest.fixture(scope="module")
def weights():
    """gpt_tiny with decode_block 8, weights scaled so greedy streams vary
    token to token: (jcfg, jparams, tcfg, tparams)."""
    jcfg = dataclasses.replace(jg.gpt_tiny(), decode_block=PS)
    tcfg = tg.gpt_tiny(decode_block=PS)
    tree = jax.device_get(jg.init_params(jcfg, 7))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * 8.0
    tree["wte"] = tree["wte"] * 8.0
    tree["wpe"] = tree["wpe"] * 30.0
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            tg.params_from_numpy(tree, tcfg, device="cpu"))


def _pair(weights, **kw):
    """(port session, reference session) built alike."""
    jcfg, jp, tcfg, tp = weights
    kw = dict(SESSION, **kw)
    return (GenerationSession(tp, tcfg, device="cpu", **kw),
            JSession(jp, jcfg, **kw))


@pytest.fixture(scope="module")
def plain(weights):
    return _pair(weights)


@pytest.fixture(scope="module")
def spec(weights):
    return _pair(weights, spec_decode=2, spec_draft_layers=1)


def _trace(seed=22, n=6):
    rng = np.random.default_rng(seed)
    return [[(rng.integers(0, VOCAB, int(p)).astype(np.int32), int(m))
             for p, m in zip(rng.integers(3, 15, n), rng.integers(3, 9, n))]]


def _prefix_trace():
    """Three waves sharing a two-block prefix (second-touch promotion
    pools it after the second, the third hits)."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, VOCAB, 2 * PS).astype(np.int32)
    return [[(np.concatenate([shared, rng.integers(0, VOCAB, t)]).astype(
        np.int32), 5) for t in ts] for ts in ((3, 5), (2, 6), (4, 1))]


def _drive(sess, engine, waves):
    """Replay ``waves`` (each submitted at once, then drained), recording
    the session's tick calls as (kind, width) and after each poll the
    engine's deferral count. Returns (streams, calls, metrics)."""
    calls = []
    for name in ("fused_tick", "prefill_chunks", "spec_tick", "step",
                 "spec_step"):
        fn = getattr(sess, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, a[1] if len(a) > 1 else None))
            return _fn(*a, **k)
        setattr(sess, name, spy)
    poll = engine.poll

    def polled():
        out = poll()
        calls.append(("deferred", engine._defer_ticks))
        return out
    engine.poll = polled
    try:
        reqs = []
        for wave in waves:
            reqs += [engine.submit(p, max_new_tokens=m) for p, m in wave]
            engine.run()
        met = engine.metrics()
        engine.close()
    finally:
        for name in ("fused_tick", "prefill_chunks", "spec_tick", "step",
                     "spec_step"):
            delattr(sess, name)
    assert all(r.state.value == "done" for r in reqs)
    sess.reset_metrics()
    return [list(r.output) for r in reqs], calls, met


ENGINES = {
    "chunk4-buckets-2-4": ("plain", _trace,
                           dict(prefill_chunk=4, width_buckets=(2, 4))),
    "whole-prompt-bucket-8": ("plain", _trace, dict(width_buckets=(8,))),
    "min-batch-2-defer-2": ("plain", _trace,
                            dict(prefill_chunk=4, prefill_min_batch=2,
                                 prefill_max_defer=2)),
    "prefix-reuse": ("plain", _prefix_trace,
                     dict(prefill_chunk=4, width_buckets=(2, 4),
                          prefix_cache_blocks=8)),
    "spec-k2": ("spec", _trace, dict(prefill_chunk=4, width_buckets=(2, 4))),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_matches_reference_engine(request, case):
    kind, trace, kw = ENGINES[case]
    ours, ref = request.getfixturevalue(kind)
    got = _drive(ours, ServingEngine(ours, max_queue=16, device="cpu", **kw),
                 trace())
    want = _drive(ref, JEngine(ref, max_queue=16, **kw), trace())
    assert got[0] == want[0]
    assert got[1] == want[1]
    for key in ("prefill_chunks", "stall_evictions", "decode_ticks"):
        assert got[2][key] == want[2][key], key
    widths = {w for k, w in got[1] if w is not None and k != "deferred"}
    buckets = set(kw.get("width_buckets", ())) | {
        kw.get("prefill_chunk") or SESSION["max_prompt_len"]}
    assert widths <= buckets
    if case == "prefix-reuse":
        assert got[2]["prefix_cache"] == want[2]["prefix_cache"]
        assert got[2]["prefix_cache"]["hits"] > 0
    if kw.get("width_buckets"):
        assert len(widths) > 1, "the trace should pick several buckets"
    if case.startswith("min-batch"):
        assert ("deferred", 1) in got[1], "no admission was deferred"
    for sess in (ours, ref):
        assert sess.free_slots() == list(range(SESSION["max_slots"]))


def test_invalid_batching_arguments_raise_as_in_reference(plain):
    ours, ref = plain
    for kw in (dict(prefill_chunk=4, width_buckets=(0, 2)),
               dict(prefill_chunk=4, width_buckets=(5,)),
               dict(width_buckets=(33,)),
               dict(prefill_min_batch=0), dict(prefill_max_defer=-1)):
        with pytest.raises(ValueError) as mine:
            ServingEngine(ours, device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            JEngine(ref, **kw)
        assert str(mine.value) == str(theirs.value), kw
    eng = ServingEngine(ours, prefill_chunk=8, width_buckets=(4, 2, 8, 4),
                        device="cpu")
    assert eng.width_buckets == (2, 4, 8)
    assert ServingEngine(ours, device="cpu").width_buckets == (32,)


# ----------------------------------------------------------- starvation
def _starved(sess, engine_cls, **kw):
    """Port of tests/test_serving_engine.py's starvation set-up: a direct
    session.admit() user holds the only slot, frozen, and an engine with
    a short stall limit has one request queued."""
    rng = np.random.default_rng(32)
    [foreign] = sess.admit(rng.integers(0, VOCAB, (1, 4)).astype(np.int32))
    sess.freeze([foreign])
    eng = engine_cls(sess, max_queue=4, **kw)
    eng.STALL_LIMIT = 20
    req = eng.submit(rng.integers(0, VOCAB, 4).astype(np.int32),
                     max_new_tokens=2)
    return foreign, eng, req


def test_run_degrades_gracefully_on_starvation(weights):
    """At the stall limit run() expires the longest-held foreign slot
    (counted as a stall eviction, logged once) and serves the queue."""
    sess = _pair(weights, max_slots=1, max_prompt_len=8, max_len=32)[0]
    foreign, eng, req = _starved(sess, ServingEngine, device="cpu")
    eng.run()
    assert req.state is RequestState.DONE and len(req.output) == 2
    met = eng.metrics()
    assert met["stall_evictions"] == 1 and met["evictions"] == 2
    assert req.slot is None and sess.free_slots() == [foreign]
    eng.close()


def test_run_raises_when_eviction_frees_nothing(weights, monkeypatch):
    """When the stall eviction cannot free a slot, run() still raises
    instead of spinning; an external release unblocks it."""
    sess = _pair(weights, max_slots=1, max_prompt_len=8, max_len=32)[0]
    foreign, eng, req = _starved(sess, ServingEngine, device="cpu")
    monkeypatch.setattr(eng, "_stall_evict", lambda: False)
    with pytest.raises(RuntimeError, match="starved"):
        eng.run()
    assert eng.metrics()["stall_evictions"] == 0
    sess.evict(foreign)
    eng.run()
    assert req.state is RequestState.DONE
    eng.close()


# -------------------------------------------------------------- prewarm
def _emulate_graphs(monkeypatch):
    """CUDA graphs on the CPU: every tick goes through TickGraph; its
    capture records the body (running nothing, as a real capture) and a
    replay runs it."""
    monkeypatch.setattr(generation, "graphed", lambda device: True)

    def capture(self):
        graph = self

        class Replay:
            def replay(self):
                graph._out = graph._body()
        self._graph, self._launches = Replay(), {}

    monkeypatch.setattr(cuda_graph.TickGraph, "_capture", capture)


PREWARM = {
    "plain-sampled-dense": (dict(temperature=0.8, top_k=20),
                            dict(prefill_chunk=4, width_buckets=(2,))),
    "spec-stochastic-paged": (dict(spec_decode=3, spec_draft_layers=1,
                                   temperature=0.9, kv_paged=True),
                              dict(width_buckets=(8, 16))),
}


@pytest.mark.parametrize("case", list(PREWARM))
def test_prewarm_changes_no_stream(weights, case, monkeypatch):
    """prewarm() captures every bucket's graphs without changing any
    stream: right after it the tick state and caches equal a fresh
    session's bitwise, and a sampled replay then equals the same replay
    on a session that warmed up under traffic."""
    skw, ekw = PREWARM[case]
    _emulate_graphs(monkeypatch)
    warm, cold, fresh = (_pair(weights, **skw)[0] for _ in range(3))
    eng = ServingEngine(warm, max_queue=16, device="cpu", **ekw)
    out = eng.prewarm()
    tick = "spec_fused" if warm.spec_k else "fused"
    kinds = {"spec" if warm.spec_k else "plain"} | {
        (k, w) for w in eng.width_buckets for k in ("chunk", tick)}
    assert out == {"programs": len(kinds), "loaded": 0}
    assert set(warm._graphs) == kinds
    assert all(g.captured for g in warm._graphs.values())
    for n, t in fresh._tick_state().items():
        assert torch.equal(warm._tick_state()[n], t), n
    streams = []
    for sess, e in ((warm, eng), (cold, ServingEngine(cold, max_queue=16,
                                                      device="cpu", **ekw))):
        reqs = [e.submit(p, max_new_tokens=m, seed=i)
                for i, (p, m) in enumerate(_trace(5)[0])]
        e.run()
        streams.append([list(r.output) for r in reqs])
        e.close()
    assert streams[0] == streams[1]
    for n, t in cold._tick_state().items():
        assert torch.equal(warm._tick_state()[n], t), n


def test_background_prewarm_joins_before_the_first_tick(plain, monkeypatch):
    ours, _ = plain
    eng = ServingEngine(ours, prefill_chunk=4, device="cpu")
    thread = eng.prewarm(background=True)
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=2)
    eng.poll()
    assert not thread.is_alive() and eng._prewarm_thread is None
    assert thread.result == {"programs": 3, "loaded": 0}
    eng.run()

    def broken(**_kw):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(ours, "prewarm_programs", broken)
    eng.prewarm(background=True)
    with pytest.raises(RuntimeError, match="prewarm failed"):
        eng.poll()
    eng.close()
