"""The port's profiler against the reference's cases (tests/test_telemetry.py
and tests/test_observability.py:115) on the CPU: the scheduler's CLOSED ->
READY -> RECORD -> RETURN states equal the reference's, host spans nest and
export as valid chrome traces, RecordEvent is exception-safe and guarded
against a double end, and the merged trace holds both planes (torch's
cpu_op events stand in for the device on the CPU). The session's telemetry
spans at gpt_tiny, on with the flag and absent without it."""
import json

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as ref_profiler
from paddle_tpu_torch import profiler
from paddle_tpu_torch.profiler import ProfilerState, make_scheduler

SCHEDULES = [dict(closed=1, ready=1, record=2),
             dict(closed=0, ready=1, record=1, skip_first=3),
             dict(closed=1, ready=0, record=1, repeat=2),
             dict(closed=0, ready=0, record=3)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_scheduler_states_match_reference(kw):
    """Every step's state of the four reference schedules, equal to the
    reference's for 16 steps (periodic cycles, skip_first, repeat)."""
    ours, theirs = make_scheduler(**kw), ref_profiler.make_scheduler(**kw)
    assert [ours(i).name for i in range(16)] == \
        [theirs(i).name for i in range(16)]
    if kw == SCHEDULES[0]:
        assert [ours(i) for i in range(4)] == [
            ProfilerState.CLOSED, ProfilerState.READY,
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN]


def test_host_trace_is_valid_and_nested(tmp_path):
    prof = profiler.Profiler(timer_only=True)
    prof.start()
    with profiler.RecordEvent("outer_span"):
        with profiler.RecordEvent("inner_span"):
            torch.ones(4, 4).sum()
    prof.stop()
    out = tmp_path / "trace"
    prof.export(str(out))
    evs = json.load(open(out / "host_trace.json"))["traceEvents"]
    assert evs
    for e in evs:
        assert e["ph"] in ("X", "M") and isinstance(e["pid"], int)
        if e["ph"] == "X":
            assert isinstance(e["tid"], int)
            assert isinstance(e["ts"], (int, float))
            assert isinstance(e["dur"], (int, float))
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    outer, inner = spans["outer_span"], spans["inner_span"]
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert any(e["ph"] == "M" and e.get("args", {}).get("name")
               for e in evs)
    assert not (out / "merged_trace.json").exists()   # timer_only: no plane


def test_export_chrome_tracing_writes_under_worker_dir(tmp_path):
    handler = profiler.export_chrome_tracing(str(tmp_path), worker_name="w0")
    prof = profiler.Profiler(timer_only=True, on_trace_ready=handler)
    prof.start()
    with profiler.RecordEvent("worker_span"):
        pass
    prof.stop()
    data = json.load(open(tmp_path / "w0" / "host_trace.json"))
    assert any(e.get("name") == "worker_span" for e in data["traceEvents"])
    events = profiler.load_profiler_result(str(tmp_path / "w0" /
                                               "host_trace.json"))
    assert any(e.get("name") == "worker_span" for e in events)


def test_record_event_exception_safe():
    n = len(profiler._snapshot_host_events())
    ev = profiler.RecordEvent("never_begun")
    ev.end()                      # end without begin: no raise, no event
    with pytest.raises(RuntimeError):
        with profiler.RecordEvent("raises_inside"):
            raise RuntimeError("boom")
    ev2 = profiler.RecordEvent("double_end")
    ev2.begin()
    ev2.end()
    ev2.end()                     # idempotent
    names = [e.name for e in profiler._snapshot_host_events()[n:]]
    assert names == ["raises_inside", "double_end"]


def test_profiler_merges_host_and_device_planes(tmp_path, monkeypatch):
    """tests/test_observability.py:115 on the port: the merged trace has
    the labelled host plane, the span in it, a device plane (torch's own
    trace; cpu_op events on the CPU) rebased onto one timeline, and the
    span's record_function range on the device plane's clock around the
    ops it ran. summary() names the span."""
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", str(tmp_path / "dump"))
    prof = profiler.Profiler()
    prof.start()
    with profiler.RecordEvent("host_side_marker"):
        x = torch.ones(128, 128)
        for _ in range(3):
            x = x @ x
    prof.stop()
    out = tmp_path / "trace_out"
    prof.export(str(out))
    events = json.load(open(out / "merged_trace.json"))["traceEvents"]
    labels = [e for e in events if e.get("ph") == "M"
              and e.get("args", {}).get("name") == "paddle_tpu host plane"]
    assert labels
    host_pid = labels[0]["pid"]
    host = [e for e in events if e.get("name") == "host_side_marker"
            and e.get("pid") == host_pid]
    assert host
    device = [e for e in events
              if e.get("ph") == "X" and e.get("pid") != host_pid]
    assert device
    assert min(e["ts"] for e in host) >= min(e["ts"] for e in device) - 1e3
    rng = [e for e in device if e.get("name") == "host_side_marker"]
    assert rng, "the span's record_function range is not in the trace"
    lo, hi = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
    mms = [e for e in device if e.get("cat") == "cpu_op"
           and e.get("name") in ("aten::mm", "aten::matmul")]
    assert mms and all(lo <= e["ts"] <= hi for e in mms)
    assert "host_side_marker" in prof.summary()


def test_scheduler_windows_drive_torch_profiler(tmp_path, monkeypatch):
    """A scheduler that records steps 1 and 2 once: one torch trace
    window, on_trace_ready at RECORD -> CLOSED and at stop, and only the
    window's spans in the device plane."""
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", str(tmp_path / "dump"))
    ready = []
    prof = profiler.Profiler(scheduler=make_scheduler(
        closed=1, ready=0, record=2, repeat=1),
                             on_trace_ready=lambda p: ready.append(p._step),
                             targets=[profiler.ProfilerTarget.CPU])
    prof.start()
    for step in range(5):
        with profiler.RecordEvent(f"step_{step}"):
            torch.ones(8, 8).sum()
        prof.step()
    assert ready == [3]
    prof.stop()
    assert ready == [3, 5]
    prof.export(str(tmp_path / "out"))
    events = json.load(open(tmp_path / "out" / "merged_trace.json"))
    names = {e.get("name") for e in events["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert names == {"step_1", "step_2"}


@pytest.fixture
def telemetry(request):
    from paddle_tpu_torch.observability import events
    events.set_enabled(request.param)
    yield request.param
    events.set_enabled(None)


@pytest.mark.parametrize("telemetry", [True, False], indirect=True,
                         ids=["on", "off"])
def test_session_spans_at_gpt_tiny(telemetry):
    """The reference's session spans (generation.py: admit's prefill, the
    chunk, fused and spec ticks, the decode step), opened by the port's
    session methods under the telemetry flag and by nothing without it."""
    from paddle_tpu_torch.inference import GenerationSession
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import ServingEngine
    torch.manual_seed(0)
    cfg = gpt.gpt_tiny(n_layers=2)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    n = len(profiler._snapshot_host_events())
    sess = GenerationSession(params, cfg, max_slots=2, max_prompt_len=16,
                             device="cpu")
    sess.admit(rng.integers(0, cfg.vocab_size, (1, 6)))
    sess.step()
    eng = ServingEngine(GenerationSession(params, cfg, max_slots=2,
                                          max_prompt_len=16, device="cpu"),
                        prefill_chunk=4, device="cpu")
    for length in (9, 5):
        eng.submit(rng.integers(0, cfg.vocab_size, length),
                   max_new_tokens=3)
        eng.run()
    spec = GenerationSession(params, cfg, max_slots=2, max_prompt_len=16,
                             spec_decode=2, spec_draft_layers=1,
                             device="cpu")
    spec.admit(rng.integers(0, cfg.vocab_size, (1, 6)))
    spec.spec_step()
    eng = ServingEngine(GenerationSession(params, cfg, max_slots=2,
                                          max_prompt_len=16, spec_decode=2,
                                          spec_draft_layers=1, device="cpu"),
                        prefill_chunk=4, device="cpu")
    for length in (9, 5):
        eng.submit(rng.integers(0, cfg.vocab_size, length),
                   max_new_tokens=3)
    eng.run()
    names = [e.name for e in profiler._snapshot_host_events()[n:]
             if e.name.startswith("session/")]
    want = {"session/prefill", "session/chunk_prefill",
            "session/fused_tick", "session/decode", "session/spec_tick"}
    assert (set(names) == want) if telemetry else not names
