"""The port's GenerationSession and ServingEngine on the CPU: the serving
semantics of tests/test_generation_session.py and
tests/test_serving_engine.py, and greedy streams equal to the JAX
session and engine on the same weights and trace (gpt_tiny, f32)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.observability.serving import _Reservoir as JReservoir
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.inference import GenerationSession
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.observability.serving import ServingMetrics, _Reservoir
from paddle_tpu_torch.distributed.ft.chaos import ChaosPlan
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.serving import (QueueFull, RequestState,
                                      ResiliencePolicy, ServingEngine)

torch.set_num_threads(1)
VOCAB = 256


@pytest.fixture(scope="module")
def setup():
    """gpt_tiny with decode_block 8 (cache lengths pad to 8), and weights
    scaled up so greedy streams vary token to token."""
    jcfg = dataclasses.replace(jg.gpt_tiny(), decode_block=8)
    tcfg = tg.gpt_tiny(decode_block=8)
    tree = jax.device_get(jg.init_params(jcfg, 7))
    for name in ("w_qkv", "w_o", "w_in", "w_out"):
        tree["blocks"][name] = tree["blocks"][name] * 8.0
    tree["wte"] = tree["wte"] * 8.0
    tree["wpe"] = tree["wpe"] * 30.0
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, tcfg, tg.params_from_numpy(tree, tcfg, device="cpu")


def _session(setup, **kw):
    _, _, cfg, params = setup
    return GenerationSession(params, kw.pop("cfg", cfg), device="cpu", **kw)


def _row_generate(setup, row, n, cfg=None):
    _, _, tcfg, tp = setup
    out = tg.generate(tp, cfg or tcfg, np.asarray(row)[None, :],
                      max_new_tokens=n, device="cpu")
    return out[0, len(row):].numpy()


def _prompt(rng, n):
    return rng.integers(0, VOCAB, (n,)).astype(np.int32)


# ================================================================ session
def test_batched_varlen_matches_per_row_and_reference_session(setup):
    jcfg, jp, _, _ = setup
    rng = np.random.default_rng(7)
    rows = [_prompt(rng, n) for n in (3, 5, 8)]
    padded = np.zeros((3, 8), np.int32)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r
    out = _session(setup, max_slots=4, max_prompt_len=8).generate(
        padded, lengths=[3, 5, 8], max_new_tokens=6)
    ref = JSession(jp, jcfg, max_slots=4, max_prompt_len=8).generate(
        padded, lengths=[3, 5, 8], max_new_tokens=6)
    np.testing.assert_array_equal(out, np.asarray(ref))
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(out[i], _row_generate(setup, r, 6))


@pytest.mark.parametrize("mode", ["full", "chunked"])
def test_session_prefill_modes_agree(setup, mode):
    cfg = dataclasses.replace(setup[2], prefill_chunk=3)
    prompt = np.random.default_rng(8).integers(0, VOCAB, (2, 5))
    out = _session(setup, cfg=cfg, max_slots=2, max_prompt_len=5,
                   prefill_mode=mode).generate(prompt, max_new_tokens=5)
    for i in range(2):
        np.testing.assert_array_equal(out[i],
                                      _row_generate(setup, prompt[i], 5))


def test_eos_early_stop_freezes_and_pads(setup):
    prompt = np.random.default_rng(9).integers(0, VOCAB, (2, 4))
    ref0 = _row_generate(setup, prompt[0], 8)
    ref1 = _row_generate(setup, prompt[1], 8)
    eos = int(ref0[2])

    def stop_at(ref):
        hits = np.flatnonzero(ref == eos)
        return int(hits[0]) if hits.size else None

    pad = 77
    out = _session(setup, max_slots=2, max_prompt_len=4, eos_token_id=eos,
                   pad_token_id=pad).generate(prompt, max_new_tokens=8)
    for row, ref in ((0, ref0), (1, ref1)):
        k = stop_at(ref)
        if k is None:
            np.testing.assert_array_equal(out[row], ref)
        else:
            np.testing.assert_array_equal(out[row, :k + 1], ref[:k + 1])
            assert (out[row, k + 1:] == pad).all()
    assert stop_at(ref0) is not None and stop_at(ref0) < 7


def test_midflight_admission_and_evict(setup):
    rng = np.random.default_rng(10)
    pA, pB, pC = (rng.integers(0, VOCAB, (1, n)) for n in (6, 3, 4))
    sess = _session(setup, max_slots=2, max_prompt_len=6)
    [sa] = sess.admit(pA)
    sess.step()
    sess.step()
    [sb] = sess.admit(pB)          # joins mid-flight
    for _ in range(4):
        sess.step()
    sess.freeze([sa, sb])
    np.testing.assert_array_equal(sess.evict(sa)[:6],
                                  _row_generate(setup, pA[0], 6))
    np.testing.assert_array_equal(sess.evict(sb)[:4],
                                  _row_generate(setup, pB[0], 4))
    assert set(sess.free_slots()) == {sa, sb}
    [sc] = sess.admit(pC)          # over the evicted slot's stale cache
    for _ in range(5):
        sess.step()
    np.testing.assert_array_equal(sess.evict(sc)[:5],
                                  _row_generate(setup, pC[0], 5))
    m = sess.metrics()
    assert m["evictions"] == 3 and m["requests_admitted"] == 3
    assert m["tokens_emitted"] == 6 + 4 + 5 and m["ttft_ms_p50"] is not None


def test_cache_full_row_freezes(setup):
    prompt = np.asarray([[5, 9, 11, 3]])
    out = _session(setup, max_slots=1, max_prompt_len=4, max_len=8,
                   pad_token_id=0).generate(prompt, max_new_tokens=10)
    np.testing.assert_array_equal(out[0, :4],
                                  _row_generate(setup, prompt[0], 4))
    assert (out[0, 4:] == 0).all()


def test_admission_control_and_later_slices(setup, monkeypatch):
    sess = _session(setup, max_slots=1, max_prompt_len=4)
    sess.admit(np.asarray([[1, 2]]))
    assert sess.try_admit(np.asarray([[3, 4]])) is None
    with pytest.raises(ValueError, match="free slots"):
        sess.admit(np.asarray([[3, 4]]))
    assert sess.telemetry.requests_rejected == 1
    with pytest.raises(ValueError, match="max_prompt_len"):
        _session(setup, max_slots=1, max_prompt_len=4).admit(
            np.asarray([[1, 2, 3, 4, 5]]))
    with pytest.raises(ValueError, match="lengths"):
        _session(setup, max_slots=2, max_prompt_len=4).admit(
            np.asarray([[1, 2]]), lengths=[3])
    assert _session(setup, max_slots=1).admit(np.zeros((0, 3))) == []
    for kw in ({"mesh": object()}, {"kv_paged": True, "mesh": object()}):
        with pytest.raises(NotImplementedError, match="slice"):
            _session(setup, max_slots=1, **kw)
    # speculative decoding is ported: from the argument and the
    # environment alike, up to the decode kernel's window of 8 rows
    assert _session(setup, max_slots=1, spec_decode=4).spec_k == 4
    with pytest.raises(ValueError, match="MAX_Q"):
        _session(setup, max_slots=1, spec_decode=9)
    with monkeypatch.context() as mp:
        mp.setenv("PADDLE_TPU_SPEC_DECODE", "4")
        assert _session(setup, max_slots=1).spec_k == 4
    # paged KV and prefix spans are this slice: from the argument and the
    # environment alike
    paged = _session(setup, max_slots=1, kv_paged=True)
    assert paged.metrics()["kv_page_size"] == setup[2].decode_block
    with monkeypatch.context() as mp:
        mp.setenv("PADDLE_TPU_KV_PAGED", "1")
        assert _session(setup, max_slots=1).kv_paged
    slot = paged.alloc_slot()
    assert paged.copy_prefix_into(slot, []) == 0
    # span export is ported: a slot holding no prompt yet still has its
    # granted pages, so an aligned export reads them
    k, v = paged.export_kv_span(slot, 8)
    assert k.shape[2] == v.shape[2] == 8
    with pytest.raises(ValueError, match="reserved"):
        sess.copy_prefix_into(0, [])


def test_alloc_release_and_chunk_validation(setup):
    sess = _session(setup, max_slots=2, max_prompt_len=16, max_len=20)
    s = sess.alloc_slot()
    assert sess.free_slots() == [1 - s] and not sess.is_active(s)
    sess.release_slot(s)
    assert len(sess.free_slots()) == 2
    s = sess.alloc_slot()
    with pytest.raises(ValueError, match="physical cache"):
        sess.prefill_chunks([(s, [1, 2], 0, False)], width=64)
    with pytest.raises(ValueError, match="past the cache"):
        sess.prefill_chunks([(s, [1, 2, 3], 18, True)], width=4)
    with pytest.raises(ValueError, match="reserved"):
        sess.prefill_chunks([(1 - s, [1], 0, True)], width=4)


def test_chunk_window_slides_near_cache_end(setup):
    """A chunk whose window would run past the cache slides left with a
    merge-write, keeping the resident prefix."""
    sess = _session(setup, max_slots=2, max_prompt_len=62, max_len=62)
    p = np.random.default_rng(12).integers(0, VOCAB, (58,))
    s = sess.alloc_slot()
    sess.prefill_chunks([(s, p[:50], 0, False)], width=50)
    sess.prefill_chunks([(s, p[50:], 50, True)], width=16)
    out = []
    while sess.is_active(s) and len(out) < 4:
        out.append(sess.step()[s])
    np.testing.assert_array_equal(out, _row_generate(setup, p, 4))


# ================================================================= engine
def _trace():
    rng = np.random.default_rng(21)
    return [(_prompt(rng, int(n)), int(m)) for n, m in
            zip(rng.integers(3, 15, 7), rng.integers(3, 9, 7))]


@pytest.mark.parametrize("chunk", [0, 4])
def test_engine_streams_equal_reference_engine(setup, chunk):
    jcfg, jp, _, _ = setup
    trace = _trace()
    outs = []
    for make_sess, make_eng in (
            (lambda: _session(setup, max_slots=3, max_prompt_len=16,
                              max_len=40),
             lambda s: ServingEngine(s, max_queue=16, prefill_chunk=chunk,
                                     device="cpu")),
            (lambda: JSession(jp, jcfg, max_slots=3, max_prompt_len=16,
                              max_len=40),
             lambda s: JEngine(s, max_queue=16, prefill_chunk=chunk))):
        eng = make_eng(make_sess())
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in trace]
        eng.run()
        assert all(r.state.value == "done" for r in reqs)
        assert [len(r.output) for r in reqs] == [m for _, m in trace]
        outs.append([list(r.output) for r in reqs])
        eng.close()
    assert outs[0] == outs[1]
    for (p, m), got in zip(trace, outs[0]):
        np.testing.assert_array_equal(got, _row_generate(setup, p, m))


def test_engine_decodes_between_chunks(setup):
    sess = _session(setup, max_slots=2, max_prompt_len=16, max_len=48)
    eng = ServingEngine(sess, max_queue=8, prefill_chunk=3, device="cpu")
    rng = np.random.default_rng(10)
    pA, pB = _prompt(rng, 3), _prompt(rng, 14)
    rA = eng.submit(pA, max_new_tokens=12)
    eng.poll()     # one-chunk prompt: finalizes AND emits its first token
    assert rA.state is RequestState.DECODING and len(rA.output) == 1
    rB = eng.submit(pB, max_new_tokens=6)
    interleaved = 0
    while rB.state in (RequestState.QUEUED, RequestState.PREFILLING):
        out = eng.poll()
        if rB.state is RequestState.PREFILLING:
            interleaved += out["emitted"]
    eng.run()
    assert interleaved >= 3
    np.testing.assert_array_equal(rA.output, _row_generate(setup, pA, 12))
    np.testing.assert_array_equal(rB.output, _row_generate(setup, pB, 6))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_priority_lanes_and_earliest_deadline_first(setup):
    rng = np.random.default_rng(1)
    sess = _session(setup, max_slots=1, max_prompt_len=8, max_len=32)
    eng = ServingEngine(sess, max_queue=8, device="cpu")
    eng.submit(_prompt(rng, 4), max_new_tokens=2)      # takes the slot
    eng.poll()
    lo = eng.submit(_prompt(rng, 4), max_new_tokens=2, priority=5)
    hi = eng.submit(_prompt(rng, 4), max_new_tokens=2, priority=1)
    hi2 = eng.submit(_prompt(rng, 4), max_new_tokens=2, priority=1)
    late = eng.submit(_prompt(rng, 4), max_new_tokens=2, priority=1,
                      deadline=1e12)
    soon = eng.submit(_prompt(rng, 4), max_new_tokens=2, priority=1,
                      deadline=1e11)
    order = []
    while any(not r.finished() for r in (lo, hi, hi2, late, soon)):
        order.extend(eng.poll()["admitted"])
    # EDF inside the lane (deadline-free last), FIFO tiebreak, then lane 5
    assert order == [soon, late, hi, hi2, lo]
    eng.close()


def test_deadline_expiry_drops_before_prefill(setup):
    rng = np.random.default_rng(0)
    sess = _session(setup, max_slots=1, max_prompt_len=8, max_len=32)
    clock = _Clock()
    eng = ServingEngine(sess, max_queue=8, clock=clock, device="cpu")
    busy = eng.submit(_prompt(rng, 4), max_new_tokens=6)
    eng.poll()
    admissions = sess.telemetry.admissions
    doomed = eng.submit(_prompt(rng, 4), max_new_tokens=2, deadline=1.0)
    live = eng.submit(_prompt(rng, 4), max_new_tokens=2)
    clock.t = 2.0
    eng.run()
    assert doomed.state is RequestState.EXPIRED and doomed.output == []
    assert busy.state is live.state is RequestState.DONE
    assert sess.telemetry.admissions == admissions + 1
    assert eng.metrics()["requests_by_state"] == {"done": 2, "expired": 1}


def test_bounded_queue_rejects_loudly_and_validates(setup, monkeypatch):
    rng = np.random.default_rng(3)
    sess = _session(setup, max_slots=1, max_prompt_len=8, max_len=16)
    eng = ServingEngine(sess, max_queue=2, device="cpu")
    eng.submit(_prompt(rng, 4), max_new_tokens=2)
    eng.submit(_prompt(rng, 4), max_new_tokens=2)
    with pytest.raises(QueueFull) as ei:
        eng.submit(_prompt(rng, 4), max_new_tokens=2)
    assert ei.value.request.state is RequestState.REJECTED
    assert eng.try_submit(_prompt(rng, 4)) is None
    assert sess.telemetry.requests_rejected == 2
    with pytest.raises(ValueError, match="no room"):
        eng.submit(_prompt(rng, 16), max_new_tokens=2)
    with pytest.raises(ValueError, match="whole-prompt"):
        eng.submit(_prompt(rng, 12), max_new_tokens=2)
    assert eng.pending == 2
    eng.close()
    assert eng.metrics()["requests_by_state"]["done"] == 2
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_prompt(rng, 4))
    # the resilience, metering and tracing planes are ported: each arms
    # from its argument, metering and tracing also from the environment
    armed = ServingEngine(sess, device="cpu", metering=True,
                          resilience=ResiliencePolicy(chaos=ChaosPlan()))
    met = armed.metrics()
    assert met["resilience"]["shed_total"] == 0 and "tenants" in met
    armed.close()
    reuse = ServingEngine(sess, device="cpu", prefix_cache_blocks=8)
    assert reuse.metrics()["prefix_cache"]["max_blocks"] == 8
    with monkeypatch.context() as mp:
        mp.setenv("PADDLE_TPU_TENANT_METERING", "1")
        metered = ServingEngine(sess, device="cpu")
        assert metered.meter is not None
        metered.close()
    with monkeypatch.context() as mp:
        mp.setenv("PADDLE_TPU_TRACING", "1")
        traced = ServingEngine(sess, device="cpu")
        req = traced.submit(_prompt(rng, 4), max_new_tokens=2)
        traced.run()
        assert req.trace_id is not None and tracing.live_count() == 0
        traced.close()
    tracing.reset()


def test_close_without_drain_cancels(setup):
    rng = np.random.default_rng(5)
    sess = _session(setup, max_slots=2, max_prompt_len=16, max_len=40)
    eng = ServingEngine(sess, max_queue=8, prefill_chunk=2, device="cpu")
    a = eng.submit(_prompt(rng, 3), max_new_tokens=20)
    b = eng.submit(_prompt(rng, 12), max_new_tokens=4)
    c = eng.submit(_prompt(rng, 4), max_new_tokens=4)
    eng.poll()
    eng.poll()
    eng.close(drain=False)
    assert a.state is RequestState.CANCELLED and len(a.output) >= 1
    assert b.state is c.state is RequestState.CANCELLED
    assert len(sess.free_slots()) == 2


def test_reservoir_and_metrics_match_reference():
    xs = np.random.default_rng(6).exponential(size=2000)
    ours, ref = _Reservoir(cap=64, seed=3), JReservoir(cap=64, seed=3)
    for x in xs:
        ours.add(x)
        ref.add(x)
    for q in (0, 50, 99, 100):
        assert ours.percentile(q) == ref.percentile(q)
    m = ServingMetrics("t", max_slots=4)
    m.admitted(2, prefill_s=0.5, occupied=2, queue_wait_s=0.1)
    m.tick(0.02, 2)
    m.tick(0.01, 0)
    snap = m.metrics()
    assert snap["tokens_emitted"] == 2 and snap["decode_ticks"] == 2
    assert snap["decode_ms_per_token"] == 10.0
    assert snap["slot_occupancy"] == 0.5
    m.reset()
    assert m.metrics()["tokens_emitted"] == 0
