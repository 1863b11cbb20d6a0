"""State-dict checkpoints with async saves — port of
paddle_tpu/distributed/checkpoint.py for one process.

``save_state_dict(state, path)`` writes ``{key: tensor}`` to
``path/state.pdparams`` atomically (a same-directory temp file, fsynced,
then renamed over the target: a crash mid-save leaves the previous file
whole). ``async_save=True`` returns once the device-to-host copy is taken
and writes in a background thread; :func:`wait_all` (called by the next
save and by ``load_state_dict``) drains it, with an optional deadline.
The reference writes through Orbax where it is installed; the port has
no Orbax and always takes the reference's other route, one pickled file
(here ``torch.save`` of CPU tensors). The train loop's step checkpoints
are ``ft.CheckpointManager``'s.
"""
from __future__ import annotations

import os
import threading
import time
import uuid

import torch

__all__ = ["save_state_dict", "load_state_dict", "wait_all"]

_FILE = "state.pdparams"
_FORMAT_KEY = "__paddle_tpu_torch_ckpt__"
FORMAT_VERSION = 1

# in-flight async saves: objects with a ``wait()`` that re-raises
_PENDING = []
_PENDING_LOCK = threading.Lock()


class _ThreadPending:
    def __init__(self, target, args):
        self._error = None

        def run():
            try:
                target(*args)
            except BaseException as exc:  # re-raised at wait()
                self._error = exc
        # NON-daemon: a clean interpreter exit joins it, so a scheduled
        # save is never silently discarded when the caller forgets
        # wait_all()
        self._thread = threading.Thread(target=run, daemon=False,
                                        name="ckpt-state-dict-write")
        self._thread.start()

    def wait(self):
        self._thread.join()
        if self._error is not None:
            raise RuntimeError("async save_state_dict write failed") \
                from self._error


def _wait_bounded(p, remaining: float):
    """Run ``p.wait()`` under a watchdog deadline: the wait runs in a
    helper thread and a wedged writer surfaces as TimeoutError instead of
    hanging the caller. The daemon helper keeps waiting harmlessly if the
    write ever completes."""
    box = {}

    def run():
        try:
            p.wait()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["err"] = exc

    t = threading.Thread(target=run, daemon=True,
                         name="ckpt-wait-watchdog")
    t.start()
    t.join(max(0.0, remaining))
    if t.is_alive():
        raise TimeoutError
    if "err" in box:
        raise box["err"]


def wait_all(timeout: float | None = None):
    """Block until every in-flight ``async_save`` write is durable;
    re-raises the first failure.  ``load_state_dict`` calls this so a
    load can never race its own process's pending save.

    ``timeout`` (seconds, across ALL pending writes) turns a wedged
    background writer into a loud :class:`TimeoutError` naming how many
    writes were still in flight; the undrained pendings go back on the
    queue so their durability is not silently dropped."""
    with _PENDING_LOCK:
        pending, _PENDING[:] = list(_PENDING), []
    deadline = None if timeout is None \
        else time.monotonic() + float(timeout)
    err = None
    for i, p in enumerate(pending):
        try:
            if deadline is None:
                p.wait()
            else:
                _wait_bounded(p, deadline - time.monotonic())
        except TimeoutError:
            stuck = pending[i:]
            with _PENDING_LOCK:
                _PENDING[:0] = stuck
            # a failure captured from an EARLIER pending must not be
            # swallowed by the timeout: chain it so the caller sees the
            # real durability loss, not just the wedged writer
            raise TimeoutError(
                f"async checkpoint write(s) still in flight after "
                f"{timeout}s — {len(stuck)} of {len(pending)} pending "
                "write(s) undrained (left queued; the writer thread "
                "may be wedged)"
                + (f"; an earlier write already FAILED: {err!r}"
                   if err is not None else "")) from err
        except BaseException as exc:  # noqa: BLE001 — keep draining
            err = err or exc
    if err is not None:
        raise err


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write(tensors: dict, path: str) -> None:
    """Atomic write of the envelope to ``path/state.pdparams``."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _FILE)
    tmp = f"{target}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    envelope = {_FORMAT_KEY: FORMAT_VERSION, "payload": tensors}
    try:
        with open(tmp, "wb") as f:
            torch.save(envelope, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(path)


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, async_save=False):
    """Save ``{key: tensor}`` (values copied to the CPU now, so a caller
    updating tensors after an async save cannot reach the write).
    ``async_save=True``: the write lands in the background
    (:func:`wait_all` or the next ``load_state_dict`` drains it). One
    process: ``process_group`` and ``coordinator_rank`` are accepted for
    the reference's signature and unused."""
    # at most one async write in flight: draining here both bounds
    # _PENDING and guarantees saves to the same path land in CALL order
    wait_all()
    tensors = {k: (v.detach().to("cpu", copy=True) if torch.is_tensor(v)
                   else torch.as_tensor(v).clone())
               for k, v in state_dict.items()}
    if async_save:
        with _PENDING_LOCK:
            _PENDING.append(_ThreadPending(_write, (tensors, str(path))))
        return
    _write(tensors, str(path))


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, shardings=None):
    """Restore into ``state_dict`` in place: a tensor entry is copied into
    (keeping its device and dtype), any other entry replaced. Pending
    async saves of this process are drained first."""
    wait_all()
    with open(os.path.join(str(path), _FILE), "rb") as f:
        envelope = torch.load(f, weights_only=True)
    version = envelope.get(_FORMAT_KEY, 0)
    if version > FORMAT_VERSION:
        raise ValueError(f"checkpoint {path!r} uses format v{version}; "
                         f"this build reads up to v{FORMAT_VERSION}")
    for k, v in envelope["payload"].items():
        if k not in state_dict:
            continue
        if torch.is_tensor(state_dict[k]):
            state_dict[k].copy_(v)
        else:
            state_dict[k] = v
    return state_dict
