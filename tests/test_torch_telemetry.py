"""Serving telemetry of the port on the CPU at gpt_tiny f32: with
PADDLE_TPU_TELEMETRY=1 and each package's JSONL sink pointed at its own
file, one engine replay (a paged spec session with chunked prefill at two
width buckets, prefix reuse, a queue-full reject, a deadline expiry and
a stall eviction) gives the same sequence of events, with the same
fields apart from wall times and stamps, on the port's engine and the
reference's; the session gauges read the same values through each
package's stat registry; and the JSONL reader skips a torn last line. A
quantized session's byte-accounting event and gauges equal the
reference's."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.inference import GenerationSession as JSession
from paddle_tpu.models import gpt as jg
from paddle_tpu.observability import events as jevents
from paddle_tpu.serving import QueueFull as JQueueFull
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.inference import GenerationSession
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.serving import QueueFull, ServingEngine

torch.set_num_threads(1)
VOCAB = 256
PS = 8
# event fields that hold a wall time or a stamp
WALL = {"ts", "prefill_ms", "queue_wait_ms", "wall_ms"}
# gauges of wall times, and the resilience slice's (failures, retries)
WALL_GAUGES = {"decode_ms_per_token", "tokens_per_sec", "ttft_ms_last",
               "ttft_ms_p50", "ttft_ms_p99"}
RESILIENCE_GAUGES = {"requests_failed", "retries_total"}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _replay(sess, make_engine, queue_full):
    """The replay, the same on both engines. Returns the session's name."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, VOCAB, 2 * PS).astype(np.int32)
    clock = _Clock()
    eng = make_engine(sess, clock)
    for wave in ((3, 5), (2, 6), (4,)):
        for t in wave:
            eng.submit(np.concatenate([shared, rng.integers(0, VOCAB, t)])
                       .astype(np.int32), max_new_tokens=4)
        eng.run()
    eng.submit(rng.integers(0, VOCAB, 5).astype(np.int32), max_new_tokens=3,
               deadline=1.0)
    clock.t = 2.0               # its deadline passes while it queues
    for _ in range(3):
        eng.submit(rng.integers(0, VOCAB, 9).astype(np.int32),
                   max_new_tokens=3)
    with pytest.raises(queue_full):
        eng.submit(rng.integers(0, VOCAB, 4).astype(np.int32))
    eng.close()
    while len(eng.prefix_cache):    # the pool's pages go back
        eng.prefix_cache._evict_one()
    # a direct user holds every slot, frozen: the starved engine evicts one
    foreign = sess.admit(rng.integers(0, VOCAB, (3, 6)).astype(np.int32))
    sess.freeze(foreign)
    eng = make_engine(sess, clock)
    eng.STALL_LIMIT = 5
    eng.submit(rng.integers(0, VOCAB, 6).astype(np.int32), max_new_tokens=2)
    eng.run()
    assert eng.metrics()["stall_evictions"] == 1
    eng.close()
    for s in foreign:
        if s not in sess.free_slots():
            sess.evict(s)
    return sess.telemetry.name


def test_event_sequences_and_gauges_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "1")
    jcfg = dataclasses.replace(jg.gpt_tiny(), decode_block=PS)
    tcfg = tg.gpt_tiny(decode_block=PS)
    tree = jax.device_get(jg.init_params(jcfg, 5))
    kw = dict(max_slots=3, max_prompt_len=32, max_len=48, kv_paged=True,
              spec_decode=2, spec_draft_layers=1)
    ekw = dict(max_queue=4, prefill_chunk=4, width_buckets=(2, 4),
               prefix_cache_blocks=8)
    runs = {}
    for tag, ev, reg, sess, make in (
            ("ref", jevents, jmonitor, JSession(
                jax.tree_util.tree_map(jnp.asarray, tree), jcfg, **kw),
             lambda s, c: JEngine(s, clock=c, **ekw)),
            ("port", events, monitor, GenerationSession(
                tg.params_from_numpy(tree, tcfg, device="cpu"), tcfg,
                device="cpu", **kw),
             lambda s, c: ServingEngine(s, clock=c, device="cpu", **ekw))):
        path = tmp_path / f"{tag}.jsonl"
        ev.set_event_path(str(path))
        try:
            name = _replay(sess, make, JQueueFull if tag == "ref"
                           else QueueFull)
        finally:
            ev.set_event_path(None)
        prefix = f"serving_{name}_"
        gauges = {k[len(prefix):]: v for k, v in reg.stats_report().items()
                  if k.startswith(prefix)}
        runs[tag] = (list(ev.iter_events(str(path))), name, gauges, path)
        if tag == "port":
            assert f"paddle_tpu_{prefix}tokens_emitted " in \
                monitor.stats_prom()
            sess.close()
            assert not any(k.startswith(prefix)
                           for k in monitor.stats_report())

    def strip(recs, name):
        """The session's records without wall times, stamps and name
        (the reference's compile records name their program)."""
        return [{k: v for k, v in r.items() if k not in WALL | {"name"}}
                for r in recs if r.get("name") == name]

    assert all(r["name"] == runs["port"][1] for r in runs["port"][0])
    ref, port = (strip(runs[t][0], runs[t][1]) for t in ("ref", "port"))
    kinds = [r["kind"] for r in port]
    assert kinds == [r["kind"] for r in ref]
    assert {"serving_admit", "serving_prefill_chunk", "serving_reject",
            "serving_expired", "serving_spec", "page_alloc", "page_free",
            "page_share", "serving_evict", "serving_stall_evict"} <= set(kinds)
    assert port == ref
    jg_, tg_ = runs["ref"][2], runs["port"][2]
    assert set(tg_) == set(jg_) - RESILIENCE_GAUGES
    for k, v in tg_.items():
        if k not in WALL_GAUGES:
            assert v == jg_[k], k
    # a writer that died mid-line leaves a torn tail: the reader skips it
    path = runs["port"][3]
    with open(path, "a") as f:
        f.write('{"ts": 1.0, "kind": "serving_ad')
    assert len(list(events.iter_events(str(path)))) == len(runs["port"][0])


@pytest.mark.parametrize("wq,bits", [("int8", 8), ("int4", 4)])
def test_quant_event_and_gauges_match_reference(tmp_path, monkeypatch, wq,
                                                bits):
    """A quantized paged session's ``serving_quant`` event and
    ``quant_*`` gauges carry the reference's fields and numbers."""
    from paddle_tpu.quantization import gpt_quant as jq
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "1")
    jcfg = dataclasses.replace(jg.gpt_tiny(), weight_quant=wq,
                               kv_cache_dtype="int8")
    tcfg = tg.gpt_tiny(weight_quant=wq, kv_cache_dtype="int8")
    jp = jq.quantize_gpt_params(jg.init_params(jcfg, 2), jcfg, bits)
    tp = tg.params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    got = {}
    for tag, ev, reg, make in (
            ("ref", jevents, jmonitor,
             lambda: JSession(jp, jcfg, max_slots=2, kv_paged=True)),
            ("port", events, monitor,
             lambda: GenerationSession(tp, tcfg, max_slots=2, kv_paged=True,
                                       device="cpu"))):
        path = tmp_path / f"{tag}.jsonl"
        ev.set_event_path(str(path))
        try:
            name = make().telemetry.name
        finally:
            ev.set_event_path(None)
        [rec] = [r for r in ev.iter_events(str(path))
                 if r["kind"] == "serving_quant"]
        assert rec.pop("name") == name
        rec.pop("ts")
        prefix = f"quant_{name}_"
        got[tag] = (rec, {k[len(prefix):]: v
                          for k, v in reg.stats_report().items()
                          if k.startswith(prefix)})
    assert got["port"] == got["ref"]
    assert got["port"][1]["weight_bits"] == bits
