"""Serving steps as captured CUDA graphs — the port's counterpart of the
reference's compiled tick (``jax.jit`` of the session's decode and spec
ticks, ``lax.scan`` over ``generate()``'s steps).

A :class:`TickGraph` holds one tick body: a function of fixed arguments
(none, or a width bucket) that reads and writes only tensors whose
storage never changes (the caller's tick state, the caches, the weights)
and returns one tensor. On a CUDA
device its first call runs the body eagerly on a side stream — the
warm-up ``torch.cuda.graph`` needs (the kernels' libraries load, cuBLAS
makes its handles), and a real tick: its writes are the tick's own — its
second call captures the body into a CUDA graph and replays it, and every
later call replays that graph. A replay launches the whole tick as one
graph and returns the tensor the captured body returned, rewritten in
place; the caller reads it on the host once a tick.

The body's Python runs twice (warm-up, capture), so it must not depend on
host state that changes between calls: everything that changes reaches
it through fixed device storage, copied in before the call. A failed
capture or replay raises; nothing falls back to the eager tick. The
eager path stays for the CPU and for A/B runs on the card, inside
:func:`eager_ticks` (the counterpart of ``jax.disable_jit``).
:meth:`TickGraph.prepare` warms up and captures without a replay, for a
caller that brings its graphs up before traffic (and saves and restores
the state the warm-up tick writes).

Freeing a graph is a CUDA call that a capture forbids, so no graph may be
freed while another is captured. Python's cycle collector could do that
(it runs at any allocation), so it is off during a capture; and a body
that is a bound method (a session's tick) is held weakly, so the graph
makes no cycle with the object that owns it, which then frees the graph
by reference count, when its owner goes.

Memory: a capture allocates the body's temporaries and its output from
a graph memory pool, private unless ``pool=`` names one to share
(``torch.cuda.graph_pool_handle()``). Graphs may share a pool when they
never run at once and each output is read before the next replay — then
a later capture may reuse what an earlier graph frees, and the pool
holds the largest tick's temporaries instead of the sum of all.

Launch counting: a replay calls no kernel wrapper, so the capture records
the wrappers' counter difference as the graph's launch vector
(``ops.kernels.launch_counts``) and takes it back (the capture ran
nothing), and each replay adds it. The counters then count what the
device ran: the warm-up's launches once, each replay's once.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import weakref

import torch

from ..ops.kernels import launch_counts

_state = threading.local()


@contextlib.contextmanager
def eager_ticks():
    """Run every tick body eagerly, op by op, while the context is open
    (in this thread): no capture and no replay. A session's graph
    captured before stays valid and replays again after the context."""
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def graphed(device) -> bool:
    """Whether ticks on ``device`` replay graphs: CUDA, outside
    :func:`eager_ticks`."""
    return torch.device(device).type == "cuda" \
        and not getattr(_state, "depth", 0)


class TickGraph:
    """One tick body and its CUDA graph on ``device`` (see the module
    doc). Call it where :func:`graphed` holds; elsewhere call the body
    itself. On the CPU only the warm-up runs (the body, directly): there
    is nothing to capture."""

    def __init__(self, body, device, args=(), pool=None):
        if hasattr(body, "__self__"):
            method = weakref.WeakMethod(body)
            self._body = lambda: method()(*args)
        else:
            self._body = lambda: body(*args)
        self._device = torch.device(device)
        self._warm = False
        self._graph = None
        self._out = None
        self._launches = None
        # the memory pool the capture allocates from (None: a private one;
        # see the module doc on sharing) and the bytes the capture added
        # to the allocator's reserve
        self._pool = pool
        self.pool_bytes = 0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self) -> torch.Tensor:
        if self._graph is None:
            if not self._warm:
                return self._warm_up()
            self._capture()
        self._graph.replay()
        launch_counts.add(self._launches)
        return self._out

    def prepare(self) -> None:
        """Warm up (a real tick) and capture, without a replay."""
        if not self._warm:
            self._warm_up()
        if self._graph is None:
            self._capture()

    def _warm_up(self) -> torch.Tensor:
        if self._device.type != "cuda":
            out = self._body()
        else:
            cur = torch.cuda.current_stream(self._device)
            side = torch.cuda.Stream(device=self._device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self._body()
            cur.wait_stream(side)
            out.record_stream(cur)
        self._warm = True
        return out

    def _capture(self) -> None:
        before = launch_counts.snapshot()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                # read after the context's empty_cache, before the body
                reserved = torch.cuda.memory_reserved(self._device)
                out = self._body()
            self._launches = launch_counts.diff(before,
                                                launch_counts.snapshot())
        finally:
            if collecting:
                gc.enable()
            launch_counts.restore(before)
        self.pool_bytes = torch.cuda.memory_reserved(self._device) - reserved
        self._graph, self._out = graph, out
