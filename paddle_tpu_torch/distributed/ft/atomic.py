"""Atomic checkpoint commit protocol — a copy of
paddle_tpu/distributed/ft/atomic.py (host code, framework-neutral).

The invariant every saver of the port shares: **a crash at any point can
never corrupt the latest complete checkpoint.**  A checkpoint becomes
visible only by an atomic ``rename`` of a fully-written, fsynced
staging directory — readers either see the previous complete checkpoint
or the new complete one, never a torn mix.

Protocol (``commit_dir``):

1. build the payload under ``<final>.tmp`` (the staging dir),
2. ``fsync`` every file, then every directory, bottom-up,
3. ``rename(tmp, final)`` (atomic on POSIX within a filesystem),
4. ``fsync`` the parent directory so the rename itself is durable.

The sibling ``swap_dir`` replaces a live dir in place, with a ``.old``
backup covering the window between the two renames.

Tests inject crashes between write and rename via ``set_fault_hook``:
the hook runs after the staging dir is durable but *before* the commit
rename, exactly the window a preemption would hit.
"""
from __future__ import annotations

import os
import shutil

__all__ = ["fsync_file", "fsync_dir", "fsync_tree", "commit_dir",
           "swap_dir", "prune_steps", "set_fault_hook", "TMP_SUFFIX"]

TMP_SUFFIX = ".tmp"

# test hook: callable invoked after the staging dir is fully written and
# fsynced, immediately before the commit rename (None = no-op)
_fault_hook = None


def set_fault_hook(hook) -> None:
    """Install a crash-injection hook for tests (``None`` clears it).
    The hook runs between staging-write and commit-rename — raising from
    it simulates dying mid-save with the tmp dir on disk."""
    global _fault_hook
    _fault_hook = hook


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return  # platforms without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def fsync_tree(root: str) -> None:
    """fsync every file, then every directory, bottom-up."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for fn in filenames:
            fsync_file(os.path.join(dirpath, fn))
        fsync_dir(dirpath)


def commit_dir(tmp_dir: str, final_dir: str) -> None:
    """Atomically publish a fully-written staging dir as ``final_dir``.

    Committed steps are IMMUTABLE: if ``final_dir`` already exists it
    is a complete commit of the same step (the publish rename is
    atomic, so a visible final dir is never partial) and the staged
    duplicate is discarded — deleting the committed dir first would
    open a window where a crash destroys the newest complete
    checkpoint.  Raises whatever the injected fault hook raises,
    leaving ``tmp_dir`` on disk for inspection/recovery.
    """
    fsync_tree(tmp_dir)
    if _fault_hook is not None:
        _fault_hook()
    if os.path.isdir(final_dir):
        shutil.rmtree(tmp_dir, ignore_errors=True)
        return
    os.rename(tmp_dir, final_dir)
    fsync_dir(os.path.dirname(os.path.abspath(final_dir)))


def swap_dir(tmp_dir: str, live_dir: str, backup_dir: str) -> None:
    """Replace a LIVE directory with a staged one, keeping the previous
    contents in ``backup_dir`` across the non-atomic window between the
    two renames (a crash between them leaves a complete checkpoint in
    either ``.tmp`` or ``.old``, for the caller's recovery to promote)."""
    fsync_tree(tmp_dir)
    if _fault_hook is not None:
        _fault_hook()
    shutil.rmtree(backup_dir, ignore_errors=True)
    os.replace(live_dir, backup_dir)
    os.replace(tmp_dir, live_dir)
    parent = os.path.dirname(os.path.abspath(live_dir))
    fsync_dir(parent)
    shutil.rmtree(backup_dir, ignore_errors=True)


def prune_steps(root: str, keep: int, prefix: str = "step_") -> list:
    """Delete all but the newest ``keep`` committed step dirs, plus any
    stale staging (``.tmp``) dirs at or below the newest committed step
    — leftovers of a killed writer; an in-flight write is always for a
    step NEWER than the last commit, so those are never touched.
    Returns the pruned committed step numbers."""
    if keep is None or keep <= 0:
        return []
    steps, tmps = [], []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        if not name.startswith(prefix):
            continue
        stale = name.endswith(TMP_SUFFIX)
        num = name[len(prefix):-len(TMP_SUFFIX)] if stale \
            else name[len(prefix):]
        try:
            (tmps if stale else steps).append(int(num))
        except ValueError:
            continue
    steps.sort()
    pruned = steps[:-keep] if len(steps) > keep else []
    for s in pruned:
        shutil.rmtree(os.path.join(root, f"{prefix}{s:08d}"),
                      ignore_errors=True)
    newest = steps[-1] if steps else None
    for s in tmps:
        if newest is not None and s <= newest:
            shutil.rmtree(
                os.path.join(root, f"{prefix}{s:08d}{TMP_SUFFIX}"),
                ignore_errors=True)
    return pruned
