"""Async checkpoint manager + preemption recovery — port of
paddle_tpu/distributed/ft/manager.py on torch tensors.

Save path (``CheckpointManager.save``):

1. **device -> host** copy of the tensor dict in the caller's thread —
   the only part the train loop ever blocks on (measured and published
   as ``ckpt_last_host_blocked_ms``); tensors are copied, so an update
   in place after ``save`` returns cannot reach the write,
2. **background-thread write** into ``step_N.tmp/`` — the reference's
   numpy writer: one ``.npy`` a key, bfloat16 as raw bytes with its dtype
   in the index (the port has no Orbax writer:
   ``PADDLE_TPU_CKPT_WRITER=orbax`` raises, as the reference does where
   orbax is missing),
3. **atomic commit**: fsync the staging tree, rename to ``step_N/``,
   fsync the parent (``ft.atomic.commit_dir``), then prune by the
   ``keep=`` policy — a crash mid-save can never corrupt the newest
   complete checkpoint,
4. telemetry: save/commit/restore events (bytes, host-blocked ms,
   background-write ms, end-to-end commit latency) land in the
   StatRegistry + JSONL plane (``observability/checkpoints.py``).

One write is in flight at a time; a new ``save`` (or ``wait``/
``restore``) joins the previous one first and re-raises its error.

Restore (``restore``) reads the newest committed step (or an explicit
one) and returns CPU tensors + aux metadata. The on-disk layout is the
reference's numpy layout, so a step either package wrote restores in the
other bit for bit. Fitting the tensors to a model (shapes, dtypes)
happens above (``models.gpt.restore_train_state``).

Preemption: :func:`install_preemption_handler` hooks SIGTERM (and
optionally a SIGALRM deadline) to run a final blocking save before the
process dies, so a preempted run resumes from its very last step
instead of the last periodic checkpoint.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import signal
import sys
import threading
import time

import numpy as np
import torch

from . import atomic

__all__ = ["CheckpointManager", "latest_step", "all_steps",
           "install_preemption_handler", "PreemptionHandler"]

_STEP_PREFIX = "step_"
_META = "meta.json"
_ARRAYS = "arrays"
_AUX_PKL = "aux.pkl"
FORMAT_VERSION = 1


def _pick_writer(writer: str | None) -> str:
    w = writer or os.environ.get("PADDLE_TPU_CKPT_WRITER", "auto")
    if w == "auto":
        return "numpy"
    if w not in ("orbax", "numpy"):
        raise ValueError(f"unknown checkpoint writer {w!r}")
    if w == "orbax":
        raise RuntimeError("PADDLE_TPU_CKPT_WRITER=orbax: the port writes "
                           "the numpy layout only (no orbax writer)")
    return w


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{_STEP_PREFIX}{int(step):08d}")


def all_steps(root: str) -> list:
    """Committed step numbers under ``root``, ascending.  A step counts
    only with its ``meta.json`` present (the rename publishes the whole
    dir at once, so meta-present == complete)."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        if not name.startswith(_STEP_PREFIX) or \
                name.endswith(atomic.TMP_SUFFIX):
            continue
        try:
            step = int(name[len(_STEP_PREFIX):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(root, name, _META)):
            out.append(step)
    return sorted(out)


def latest_step(root: str):
    """Newest committed step under ``root`` (``None`` when empty)."""
    steps = all_steps(root)
    return steps[-1] if steps else None


# --------------------------------------------------------------- writers

# torch dtypes numpy has no type for: stored as raw bytes under these
# names (the names the reference's ml_dtypes arrays print)
_RAW_DTYPES = {torch.bfloat16: "bfloat16"}
_RAW_BY_NAME = {v: k for k, v in _RAW_DTYPES.items()}


def _snapshot(v):
    """A host copy of one state value that later updates cannot reach: a
    tensor copied to the CPU, or a numpy array copied."""
    if torch.is_tensor(v):
        return v.detach().to("cpu", copy=True)
    return np.array(v, copy=True)


def _nbytes(a) -> int:
    if torch.is_tensor(a):
        return a.numel() * a.element_size()
    return int(a.nbytes)


def _as_npy(a):
    """``(array to np.save, dtype name, raw)`` of a host value: numpy
    dtypes as they are; bfloat16 (a torch tensor, or an extension-dtype
    array) as its raw bytes with the dtype's name."""
    if torch.is_tensor(a):
        if a.dtype in _RAW_DTYPES:
            raw = a.contiguous().reshape(-1 if a.dim() == 0 else a.shape)
            return (raw.view(torch.uint8).numpy(), _RAW_DTYPES[a.dtype],
                    True)
        a = a.numpy()
    if a.dtype.kind == "V" or a.dtype.hasobject:
        # extension dtypes round-trip as raw bytes; npy's own descr for
        # them degrades to an anonymous void
        return np.ascontiguousarray(a).view(np.uint8), str(a.dtype), True
    return a, str(a.dtype), False


def _write_numpy(arrays_dir: str, arrays: dict) -> dict:
    """One ``.npy`` per key (keys indexed through meta — filenames never
    encode user keys).  bfloat16 is stored as raw bytes with the dtype
    recorded for the view back."""
    os.makedirs(arrays_dir, exist_ok=True)
    index = {}
    for i, key in enumerate(sorted(arrays)):
        a, dtype, raw = _as_npy(arrays[key])
        shape = list(arrays[key].shape)
        entry = {"file": f"a{i:05d}.npy", "dtype": dtype, "shape": shape}
        if raw:
            entry["raw_bytes"] = True
        np.save(os.path.join(arrays_dir, entry["file"]), a,
                allow_pickle=False)
        index[key] = entry
    return index


def _read_numpy(arrays_dir: str, index: dict) -> dict:
    """The arrays of a numpy-layout step as CPU tensors (bfloat16 from its
    raw bytes)."""
    out = {}
    for key, entry in index.items():
        a = np.load(os.path.join(arrays_dir, entry["file"]),
                    allow_pickle=False)
        t = torch.from_numpy(np.asarray(a, order="C"))
        if entry.get("raw_bytes"):
            dtype = _RAW_BY_NAME.get(entry["dtype"])
            if dtype is None:
                raise ValueError(f"checkpoint array {key!r}: raw dtype "
                                 f"{entry['dtype']!r} has no torch type")
            t = t.reshape(-1).view(dtype).reshape(entry["shape"])
        out[key] = t
    return out


_WRITERS = {"numpy": (_write_numpy, _read_numpy)}


# --------------------------------------------------------------- manager

class CheckpointManager:
    """Async, atomic, prunable step checkpoints under one directory.

    ``state`` is a FLAT dict ``{key: tensor or array}`` (device tensors
    are copied to the host in the caller's thread); ``aux`` is a small
    metadata tree — JSON-encodable parts land in ``meta.json``, the
    rest rides in ``aux.pkl``.  Restore returns ``(tensors, aux, step)``,
    the tensors on the CPU.
    """

    def __init__(self, directory: str, keep: int = 3,
                 writer: str | None = None, name: str = "ckpt"):
        self.directory = str(directory)
        self.keep = int(keep)
        self.writer = _pick_writer(writer)
        self.name = name
        os.makedirs(self.directory, exist_ok=True)
        self._thread = None
        self._bg_error = None
        self._inflight_step = None
        self._last_committed = latest_step(self.directory)
        # running counters the bench rows report even with telemetry off
        self.stats = {"saves": 0, "commits": 0, "restores": 0,
                      "bytes_last": 0, "host_blocked_ms_total": 0.0,
                      "bg_write_ms_total": 0.0, "commit_ms_last": 0.0}

    # ------------------------------------------------------------- save
    def save(self, step: int, state: dict, aux=None,
             blocking: bool = False) -> None:
        """Snapshot ``state`` to host and commit ``step_N`` — in the
        background unless ``blocking``.  Raises (here or at the next
        ``save``/``wait``/``restore``) if a previous write failed."""
        self.wait()
        t_sched = time.perf_counter()
        host = {k: _snapshot(v) for k, v in state.items()}
        host_blocked_ms = (time.perf_counter() - t_sched) * 1e3
        nbytes = sum(_nbytes(a) for a in host.values())
        self.stats["saves"] += 1
        self.stats["bytes_last"] = nbytes
        self.stats["host_blocked_ms_total"] += host_blocked_ms
        from ...observability import checkpoints as obs_ckpt
        obs_ckpt.record_save(self.name, step=int(step), bytes=nbytes,
                             host_blocked_ms=host_blocked_ms)
        if blocking:
            self._write_and_commit(int(step), host, aux, t_sched)
            return
        self._inflight_step = int(step)
        self._thread = threading.Thread(
            target=self._bg_write, args=(int(step), host, aux, t_sched),
            name=f"ckpt-write-{step}", daemon=True)
        self._thread.start()

    def _bg_write(self, step, host, aux, t_sched):
        try:
            self._write_and_commit(step, host, aux, t_sched)
        except BaseException as exc:  # surfaced by the next wait()
            self._bg_error = exc

    def _write_and_commit(self, step, host, aux, t_sched):
        t0 = time.perf_counter()
        final = _step_dir(self.directory, step)
        tmp = final + atomic.TMP_SUFFIX
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        write, _ = _WRITERS[self.writer]
        index = write(os.path.join(tmp, _ARRAYS), host)
        aux_json, aux_pickled = None, False
        if aux is not None:
            try:
                aux_json = json.loads(json.dumps(aux))
            except (TypeError, ValueError):
                with open(os.path.join(tmp, _AUX_PKL), "wb") as f:
                    pickle.dump(aux, f, protocol=4)
                aux_pickled = True
        meta = {"format": FORMAT_VERSION, "step": int(step),
                "writer": self.writer, "index": index,
                "nbytes": sum(_nbytes(a) for a in host.values()),
                "aux": aux_json, "aux_pickled": aux_pickled}
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        atomic.commit_dir(tmp, final)  # fsync + rename + fsync parent
        bg_write_ms = (time.perf_counter() - t0) * 1e3
        commit_ms = (time.perf_counter() - t_sched) * 1e3
        self._last_committed = step
        atomic.prune_steps(self.directory, self.keep, _STEP_PREFIX)
        self.stats["commits"] += 1
        self.stats["bg_write_ms_total"] += bg_write_ms
        self.stats["commit_ms_last"] = commit_ms
        from ...observability import checkpoints as obs_ckpt
        obs_ckpt.record_commit(self.name, step=step,
                               bytes=meta["nbytes"],
                               bg_write_ms=bg_write_ms,
                               commit_ms=commit_ms)

    # ------------------------------------------------------------- sync
    def wait(self, timeout: float | None = None) -> None:
        """Join the in-flight background write; re-raise its error.

        ``timeout`` (seconds) bounds the join: a wedged writer raises a
        loud :class:`TimeoutError` NAMING the stuck step instead of
        hanging shutdown indefinitely.  The thread stays tracked, so a
        later ``wait()`` can still drain it if it ever finishes."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"background checkpoint write for step "
                    f"{self._inflight_step} still running after "
                    f"{timeout}s — the writer thread is wedged (the "
                    "previous committed step is intact)")
            self._thread = None
        if self._bg_error is not None:
            exc, self._bg_error = self._bg_error, None
            raise RuntimeError(
                "background checkpoint write failed — the previous "
                "committed step is still intact") from exc

    @property
    def last_committed(self):
        return self._last_committed

    def all_steps(self) -> list:
        return all_steps(self.directory)

    # ---------------------------------------------------------- restore
    def restore(self, step: int | None = None):
        """Read a committed checkpoint -> ``(tensors, aux, step)``, the
        tensors on the CPU. ``step=None`` picks the newest committed
        one."""
        self.wait()
        if step is None:
            step = latest_step(self.directory)
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.directory!r}")
        t0 = time.perf_counter()
        final = _step_dir(self.directory, step)
        with open(os.path.join(final, _META)) as f:
            meta = json.load(f)
        if meta.get("format", 0) > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {final!r} uses format v{meta['format']} but "
                f"this build reads up to v{FORMAT_VERSION}")
        writer = meta.get("writer", "numpy")
        if writer not in _WRITERS:
            raise RuntimeError(
                f"checkpoint {final!r} was written by {writer}, which the "
                "port cannot read — re-save it with "
                "PADDLE_TPU_CKPT_WRITER=numpy")
        _, read = _WRITERS[writer]
        arrays = read(os.path.join(final, _ARRAYS), meta["index"])
        aux = meta.get("aux")
        if meta.get("aux_pickled"):
            with open(os.path.join(final, _AUX_PKL), "rb") as f:
                aux = pickle.load(f)
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["restores"] += 1
        from ...observability import checkpoints as obs_ckpt
        obs_ckpt.record_restore(self.name, step=int(meta["step"]),
                                bytes=meta.get("nbytes", 0), ms=ms)
        return arrays, aux, int(meta["step"])


# ------------------------------------------------------------ preemption

class PreemptionHandler:
    """Installed SIGTERM (and optional SIGALRM-deadline) hook that runs
    one final blocking save before the process exits."""

    def __init__(self, save_fn, signals, exit_after, exit_code):
        self.save_fn = save_fn
        self.triggered = False
        self.saved = False
        self._exit_after = exit_after
        self._exit_code = exit_code
        self._previous = {}
        for sig in signals:
            self._previous[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        if self.triggered:       # double delivery: don't save twice
            return
        self.triggered = True
        try:
            self.save_fn()
            self.saved = True
        except BaseException:
            # a failed final save must be LOUD and distinguishable: the
            # traceback goes to stderr and the exit code is 1, never the
            # clean 128+signum a successful preemption save produces
            import traceback
            traceback.print_exc()
            if not self._exit_after:
                raise
        finally:
            if self._exit_after:
                self.uninstall()
                if self.saved:
                    sys.exit(self._exit_code
                             if self._exit_code is not None
                             else 128 + signum)
                sys.exit(1)

    def uninstall(self):
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # non-main thread / teardown
                pass
        self._previous = {}


def install_preemption_handler(save_fn, signals=(signal.SIGTERM,),
                               deadline_s: float | None = None,
                               exit_after: bool = True,
                               exit_code: int | None = None
                               ) -> PreemptionHandler:
    """Run ``save_fn()`` (a final BLOCKING checkpoint save) when the
    process is told to die.

    ``signals``: which signals mean preemption (SIGTERM by default —
    what cluster schedulers send before SIGKILL).  ``deadline_s`` arms a
    SIGALRM self-timeout so a run with a known wall budget commits its
    final state before the harness's hard kill.  ``exit_after=False``
    keeps the process alive after the save (tests; loops that drain
    work first).
    """
    sigs = list(signals)
    if deadline_s is not None:
        sigs.append(signal.SIGALRM)
    handler = PreemptionHandler(save_fn, sigs, exit_after, exit_code)
    if deadline_s is not None:
        signal.alarm(max(1, int(deadline_s)))
    return handler
