"""Seeded random streams: port of paddle_tpu/framework/random.py.

Keys are the threefry pairs of :mod:`.prng` (host ints), so a stream
draws exactly the reference's keys:

* **Eager**: the global stateful :class:`Generator` derives key number
  ``offset`` as ``fold_in(PRNGKey(seed), offset)`` and bumps the offset,
  the reference's (seed, offset) pair.
* **Scoped**: inside ``with trace_rng(base_key):`` :func:`next_key`
  returns ``fold_in(base_key, counter)`` with a counter per scope, as the
  reference does under its jit compile boundary. ``jit.to_static`` passes
  the base key as a tensor input of the compiled program, so each call
  draws fresh keys without a recompile.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

from . import prng


class Generator:
    """Stateful RNG stream (reference: phi/core/generator.h)."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._offset = 0
        self._lock = threading.Lock()

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._offset = 0
        return self

    @property
    def initial_seed(self) -> int:
        return self._seed

    def get_state(self):
        return (self._seed, self._offset)

    def set_state(self, state):
        self._seed, self._offset = int(state[0]), int(state[1])

    def _bump(self) -> int:
        with self._lock:
            off = self._offset
            self._offset += 1
        return off

    def next_key(self) -> tuple[int, int]:
        return prng.fold_in(prng.PRNGKey(self._seed), self._bump())

    def next_seed(self) -> int:
        """A fresh int seed (for numpy-side consumers, e.g. DataLoader)."""
        rng = np.random.default_rng((self._seed, self._bump()))
        return int(rng.integers(0, 2**31 - 1))


_default_generator = Generator(0)


def default_generator() -> Generator:
    return _default_generator


def seed(s: int) -> Generator:
    """paddle.seed equivalent."""
    return _default_generator.manual_seed(s)


def get_rng_state():
    return _default_generator.get_state()


def set_rng_state(state):
    _default_generator.set_state(state)


class _TraceRNGScope(threading.local):
    def __init__(self):
        self.stack = []


_trace_scope = _TraceRNGScope()


class _TraceRNG:
    """Key derivation inside a scope: a base key and a call counter."""

    def __init__(self, base_key):
        self.base_key = base_key
        self.counter = 0

    def next_key(self):
        """A host pair from a host base key; from a tensor base key [2]
        (a compiled program's input), the int64 tensor key [2]."""
        if isinstance(self.base_key, tuple):
            k = prng.fold_in(self.base_key, self.counter)
        else:
            k = prng.fold_in_rows(self.base_key, self.counter)
        self.counter += 1
        return k


@contextlib.contextmanager
def trace_rng(base_key):
    """Install a base key: :func:`next_key` folds a per-scope counter into
    it until the scope ends."""
    _trace_scope.stack.append(_TraceRNG(base_key))
    try:
        yield
    finally:
        _trace_scope.stack.pop()


def next_key() -> tuple[int, int]:
    """A PRNG key for the current regime (the innermost scope if one is
    active, else the global generator)."""
    if _trace_scope.stack:
        return _trace_scope.stack[-1].next_key()
    return _default_generator.next_key()
