"""paddle.profiler: port of paddle_tpu/profiler/__init__.py.

Reference (``python/paddle/profiler/profiler.py``): host ``RecordEvent``
spans and a device tracer fused into one chrome-trace timeline. The
port's device plane is ``torch.profiler`` (kineto over CUPTI on the card,
its ``cpu_op`` events on the CPU, as the reference's CPU dump stands in
for a device), started and stopped over each RECORD window of the
scheduler as the reference starts and stops the XLA trace. A
``RecordEvent`` keeps the reference's host deque and, while a
:class:`Profiler` records, also opens ``torch.profiler.record_function``
(the counterpart of ``jax.profiler.TraceAnnotation``), so that the span
lands on kineto's clock beside the kernels it launched. The reference's
``_native`` C++ host recorder (``native_host_trace.json``) has no
counterpart yet. The ProfilerState machine (CLOSED -> READY -> RECORD ->
RETURN) mirrors profiler.py:79.
"""
from __future__ import annotations

import contextlib
import enum
import json
import os
import tempfile
import threading
import time
from collections import defaultdict, deque

import torch

# stable small per-thread ids for the chrome-trace tid field (chrome
# nests same-tid "X" spans by time containment, so spans from different
# threads must not share a tid)
_tid_lock = threading.Lock()
_tid_map: dict[int, int] = {}


def _thread_tid() -> int:
    ident = threading.get_ident()
    tid = _tid_map.get(ident)
    if tid is None:
        with _tid_lock:
            tid = _tid_map.setdefault(ident, len(_tid_map))
    return tid


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0):
    """Reference: profiler.py make_scheduler."""
    def sched(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        period = closed + ready + record
        if repeat and s >= period * repeat:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return sched


def export_chrome_tracing(dir_name: str, worker_name: str | None = None):
    """on_trace_ready handler writing chrome-trace JSON under
    ``dir_name/<worker_name>/`` (reference: profiler.export_chrome_tracing;
    worker_name defaults to a per-pid name so multi-process runs don't
    clobber each other's traces)."""
    def handler(prof):
        name = worker_name or f"worker_{os.getpid()}"
        prof.export(os.path.join(dir_name, name))
    return handler


class _HostEvent:
    __slots__ = ("name", "start", "end", "tid")

    def __init__(self, name, start, end, tid=0):
        self.name, self.start, self.end, self.tid = name, start, end, tid


# Bounded: a long-lived serving process with telemetry on spans every
# decode tick; a deque keeps the most recent window
_HOST_EVENT_CAP = int(os.environ.get("PADDLE_TPU_PROFILER_MAX_EVENTS",
                                     "200000"))
_host_events: deque = deque(maxlen=_HOST_EVENT_CAP)
# append and snapshot under one lock: iterating a deque while another
# thread appends raises RuntimeError
_events_lock = threading.Lock()
_recording = False


def _snapshot_host_events() -> list:
    with _events_lock:
        return list(_host_events)


class RecordEvent:
    """Host span marker (reference: platform/profiler/event_tracing.h).
    While a Profiler records, also a ``torch.profiler.record_function``
    range, so the span appears in the device plane's trace."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._range = None
        self._start = None
        self._tid = 0

    def begin(self):
        """Exception-safe: a failing ``record_function`` must never take
        the instrumented code down with it, and must never leave a
        half-open span (the host event still records)."""
        self._start = time.perf_counter_ns()
        self._tid = _thread_tid()
        if _recording:
            try:
                rng = torch.profiler.record_function(self.name)
                rng.__enter__()
                self._range = rng
            except Exception:  # noqa: BLE001 — the device plane is optional
                self._range = None

    def end(self):
        if self._start is not None:
            ev = _HostEvent(self.name, self._start, time.perf_counter_ns(),
                            self._tid)
            with _events_lock:
                _host_events.append(ev)
            self._start = None      # double-end / re-exit guard
        if self._range is not None:
            try:
                self._range.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
            self._range = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def _activities(targets):
    """torch.profiler activities of paddle's targets: GPU -> CUDA, CPU ->
    CPU; by default both on a card and the CPU alone without one."""
    from torch.profiler import ProfilerActivity
    if targets is None:
        targets = [ProfilerTarget.CPU]
        if torch.cuda.is_available():
            targets.append(ProfilerTarget.GPU)
    acts = []
    for t in targets:
        if t is ProfilerTarget.CPU:
            acts.append(ProfilerActivity.CPU)
        elif t is ProfilerTarget.GPU:
            acts.append(ProfilerActivity.CUDA)
    return acts


class Profiler:
    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        self._scheduler = (scheduler if callable(scheduler) else
                           (make_scheduler(closed=0, ready=0,
                                           record=scheduler[1] - scheduler[0],
                                           skip_first=scheduler[0])
                            if scheduler else (lambda s: ProfilerState.RECORD)))
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._activities = _activities(targets)
        self._options = dict(record_shapes=record_shapes,
                             profile_memory=profile_memory,
                             with_flops=with_flops)
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._trace_dir = None
        self._torch_prof = None
        self._dump = None
        self._windows = 0

    def start(self):
        global _recording
        self._state = self._scheduler(self._step)
        if self._state in (ProfilerState.RECORD,
                           ProfilerState.RECORD_AND_RETURN) \
                and not self._timer_only:
            self._begin_trace()
        _recording = True

    def _begin_trace(self):
        if self._torch_prof is not None:
            return
        self._trace_dir = os.environ.get("PADDLE_TPU_PROFILE_DIR",
                                         os.path.join(tempfile.gettempdir(),
                                                      "paddle_tpu_profile"))
        os.makedirs(self._trace_dir, exist_ok=True)
        try:
            prof = torch.profiler.profile(activities=self._activities,
                                          **self._options)
            prof.__enter__()
            self._torch_prof = prof
        except Exception:  # noqa: BLE001 — kineto takes one profiler a process
            self._torch_prof = None

    def _end_trace(self):
        """Stop the window's trace and write torch's chrome trace of it
        under the trace dir (the device plane :meth:`export` merges)."""
        prof, self._torch_prof = self._torch_prof, None
        if prof is None:
            return
        try:
            prof.__exit__(None, None, None)
            self._windows += 1
            path = os.path.join(self._trace_dir, f"torch_trace_{os.getpid()}"
                                f"_{id(self)}_{self._windows}.json")
            prof.export_chrome_trace(path)
            self._dump = path
        except Exception:  # noqa: BLE001
            pass

    def step(self, num_samples=None):
        self._step += 1
        new_state = self._scheduler(self._step)
        if new_state != self._state:
            if self._state in (ProfilerState.RECORD,
                               ProfilerState.RECORD_AND_RETURN) and \
                    new_state == ProfilerState.CLOSED:
                self._end_trace()
                if self._on_trace_ready:
                    self._on_trace_ready(self)
            elif new_state in (ProfilerState.RECORD,
                               ProfilerState.RECORD_AND_RETURN) and \
                    not self._timer_only:
                self._begin_trace()
            self._state = new_state

    def stop(self):
        global _recording
        self._end_trace()
        _recording = False
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def export(self, path: str, format: str = "json"):
        """Export host-plane spans as chrome trace JSON, plus, when a
        device trace was captured, ONE merged chrome trace carrying both
        planes (reference: chrometracing_logger.cc fuses host RecordEvents
        with the CUPTI device timeline; here the device plane is
        torch.profiler's chrome trace of the last RECORD window)."""
        os.makedirs(path, exist_ok=True)
        pid = os.getpid()
        host = _snapshot_host_events()
        events = [{"name": e.name, "ph": "X", "cat": "host", "pid": pid,
                   "tid": e.tid, "ts": e.start / 1000.0,
                   "dur": (e.end - e.start) / 1000.0}
                  for e in host]
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": "paddle_tpu host plane"}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                  "args": {"name": f"host thread {t}"}}
                 for t in sorted({e.tid for e in host})]
        with open(os.path.join(path, "host_trace.json"), "w") as f:
            json.dump({"traceEvents": meta + events,
                       "displayTimeUnit": "ms"}, f)
        dev = self._device_trace_events()
        if dev is not None:
            self._write_merged(os.path.join(path, "merged_trace.json"),
                               events, dev)

    def _device_trace_events(self):
        """Device-plane chrome events of the last recorded window
        (torch.profiler's trace), or None."""
        if not self._dump:
            return None
        try:
            with open(self._dump) as f:
                return json.load(f).get("traceEvents", [])
        except (OSError, ValueError):
            return None

    def _write_merged(self, out_path, host_events, device_events):
        """One chrome trace, two planes. The host plane keeps its own pid
        above the device pids; host timestamps (perf_counter) are REBASED
        so the earliest host span aligns with the earliest device slice.
        The ``record_function`` ranges of the spans sit on the device
        plane's own clock, beside the kernels they launched."""
        dev_pids = [e.get("pid") for e in device_events
                    if isinstance(e.get("pid"), int)]
        host_pid = (max(dev_pids) + 1) if dev_pids else 1000
        dev_ts = [e["ts"] for e in device_events
                  if e.get("ph") == "X" and isinstance(
                      e.get("ts"), (int, float))]
        host_ts = [e["ts"] for e in host_events]
        shift = (min(dev_ts) - min(host_ts)) if dev_ts and host_ts else 0.0
        merged = list(device_events)
        merged.append({"name": "process_name", "ph": "M", "pid": host_pid,
                       "args": {"name": "paddle_tpu host plane"}})
        for e in host_events:
            merged.append({**e, "pid": host_pid, "ts": e["ts"] + shift})
        with open(out_path, "w") as f:
            json.dump({"traceEvents": merged,
                       "displayTimeUnit": "ms"}, f)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        agg = defaultdict(lambda: [0, 0.0])
        for e in _snapshot_host_events():
            agg[e.name][0] += 1
            agg[e.name][1] += (e.end - e.start) / 1e6
        lines = [f"{'Name':40s} {'Calls':>8s} {'Total(ms)':>12s}"]
        for name, (calls, total) in sorted(agg.items(),
                                           key=lambda kv: -kv[1][1]):
            lines.append(f"{name[:40]:40s} {calls:8d} {total:12.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profile(*args, **kwargs):
    p = Profiler(**kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()


class benchmark:
    """Throughput timer hooks (reference: profiler/timer.py used by hapi)."""

    def __init__(self):
        self._t0 = None
        self._samples = 0

    def begin(self):
        self._t0 = time.perf_counter()
        self._samples = 0

    def step(self, num_samples=1):
        self._samples += num_samples

    def end(self):
        dt = time.perf_counter() - self._t0
        return {"ips": self._samples / dt if dt else 0.0, "seconds": dt}


class SortedKeys(enum.Enum):
    """Summary-table sort keys (reference: profiler/profiler_statistic.py
    SortedKeys)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(enum.Enum):
    """Summary table selector (reference: profiler.SummaryView)."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(dir_name: str, worker_name: str | None = None):
    """Reference: profiler.export_protobuf — on-trace-ready handler. The
    durable format is chrome-trace JSON; the handler writes that, with a
    .pb.json suffix marking the container choice."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        prof.export(os.path.join(dir_name, name + ".pb.json"))
    return handler


def load_profiler_result(filename: str):
    """Reference: profiler.load_profiler_result — parse an exported trace
    back into its event list."""
    with open(filename) as f:
        data = json.load(f)
    return data.get("traceEvents", data)


__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "SortedKeys", "SummaryView", "export_chrome_tracing",
           "export_protobuf", "load_profiler_result", "make_scheduler"]
