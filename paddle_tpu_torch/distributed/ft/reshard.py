"""Elastic resharding over ZeRO-3 flat per-dtype buckets — a copy of
paddle_tpu/distributed/ft/reshard.py (numpy slice arithmetic), for the
multi-device slice's restore.

A zero3 bucket lives on an ``n``-way mesh as ``[L, n, chunk]`` slices
with ``chunk = ceil(size / n)`` and ``n * chunk - size`` zeros of pad at
the tail.  The canonical (mesh-free) form is the unpadded flat buffer
``[L, size]`` — converting a dp2 x sh4 checkpoint into a dp4 x sh2
layout is therefore pure slice arithmetic: drop the source pad, re-pad
for the target ``n'``, re-cut into ``chunk'`` slices.  No collective,
no tracing, no dtype change.

Two forms of the same map:

- :func:`reshard` — whole-buffer (depad -> repad), for a
  fully-addressable host.
- :func:`plan_reshard` / :func:`apply_plan` — an explicit per-rank copy
  plan ``(dst_rank, dst_off, src_rank, src_off, length)``, the form a
  multi-host restore streams shard-by-shard without ever materializing
  the full flat buffer.  Tested equivalent to the whole-buffer form.
"""
from __future__ import annotations

import numpy as np

__all__ = ["chunk_for", "depad", "repad", "reshard", "plan_reshard",
           "apply_plan"]


def chunk_for(size: int, n: int) -> int:
    """Per-rank slice length for an ``n``-way sharding of ``size``."""
    return -(-int(size) // int(n))


def depad(slices, size: int):
    """``[..., n, chunk]`` sliced layout -> canonical ``[..., size]``."""
    a = np.asarray(slices)
    lead = a.shape[:-2]
    return a.reshape(lead + (-1,))[..., :size]


def repad(flat, n: int):
    """Canonical ``[..., size]`` -> ``[..., n, chunk]`` sliced layout."""
    a = np.asarray(flat)
    size = a.shape[-1]
    chunk = chunk_for(size, n)
    pad = n * chunk - size
    if pad:
        width = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        a = np.pad(a, width)
    return a.reshape(a.shape[:-1] + (n, chunk))


def reshard(slices, size: int, dst_n: int):
    """``[..., n, chunk]`` under one mesh -> ``[..., n', chunk']`` under
    another: the whole elastic restore in two reshapes."""
    return repad(depad(slices, size), dst_n)


def plan_reshard(size: int, src_n: int, dst_n: int):
    """Explicit copy plan from an ``src_n``-way to a ``dst_n``-way
    sharding of an unpadded ``size`` buffer.

    Returns ``[(dst_rank, dst_off, src_rank, src_off, length), ...]``
    covering every unpadded element exactly once — each entry is one
    contiguous host ``memcpy`` from a source shard into a target shard,
    so a restoring host only ever touches the source shards that
    overlap its own ranks.
    """
    src_chunk = chunk_for(size, src_n)
    dst_chunk = chunk_for(size, dst_n)
    plan = []
    for dst_rank in range(dst_n):
        lo = dst_rank * dst_chunk
        hi = min(lo + dst_chunk, size)
        pos = lo
        while pos < hi:
            src_rank = pos // src_chunk
            src_off = pos - src_rank * src_chunk
            length = min(hi - pos, src_chunk - src_off)
            plan.append((dst_rank, pos - lo, src_rank, src_off, length))
            pos += length
    return plan


def apply_plan(slices, size: int, dst_n: int, plan=None):
    """Run a :func:`plan_reshard` plan with per-entry contiguous copies
    (no full-buffer intermediate): ``[..., n, chunk]`` ->
    ``[..., n', chunk']``."""
    a = np.asarray(slices)
    src_n, src_chunk = a.shape[-2], a.shape[-1]
    if plan is None:
        plan = plan_reshard(size, src_n, dst_n)
    dst_chunk = chunk_for(size, dst_n)
    out = np.zeros(a.shape[:-2] + (dst_n, dst_chunk), a.dtype)
    for dst_rank, dst_off, src_rank, src_off, length in plan:
        out[..., dst_rank, dst_off:dst_off + length] = \
            a[..., src_rank, src_off:src_off + length]
    return out
