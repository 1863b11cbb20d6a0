"""Functional extraction: port of paddle_tpu/jit/functional.py.

Run a stateful Layer as a pure function of raw torch tensors,
``pure(params, buffers, key, args, kwargs) -> (outputs, new_buffers)``,
with the given values swapped into the layer's parameters and buffers for
the call. The reference traces that function with jax; here it is what
``torch.func`` style callers and ``hapi.flops`` call. ``key`` is the base
PRNG key of the call's draws (an int seed, a host pair or an int64 tensor
[2]).
"""
from __future__ import annotations

import contextlib

from ..framework import prng
from ..framework import random as _random
from ..nn.layer import Layer
from ..tensor import no_grad, unwrap, wrap


def collect_state(layer: Layer):
    params = dict(layer.named_parameters())
    buffers = {k: v for k, v in layer.named_buffers() if v is not None}
    return params, buffers


@contextlib.contextmanager
def swap_state(layer: Layer, param_vals: dict, buffer_vals: dict):
    """Temporarily replace parameter/buffer payloads with the given
    tensors. Restores them on exit and keeps the possibly mutated buffer
    payloads in ``swap_state._last_buffers``."""
    params, buffers = collect_state(layer)
    old_p = {k: p._value for k, p in params.items()}
    old_b = {k: b._value for k, b in buffers.items()}
    try:
        for k, p in params.items():
            if k in param_vals:
                p._value = param_vals[k]
        for k, b in buffers.items():
            if k in buffer_vals:
                b._value = buffer_vals[k]
        yield params, buffers
    finally:
        mutated = {k: b._value for k, b in buffers.items()}
        for k, p in params.items():
            p._value = old_p[k]
        for k, b in buffers.items():
            b._value = old_b[k]
        swap_state._last_buffers = mutated


def _base_key(key):
    return prng.PRNGKey(key) if isinstance(key, int) else key


def make_pure_fn(layer: Layer, training: bool | None = None,
                 forward_fn=None):
    """pure(params, buffers, key, args, kwargs) -> (out_vals,
    new_buffer_vals). ``forward_fn``: the unbound forward to run, by
    default the class's ``forward`` (not the instance attribute, which
    to_static may have replaced)."""
    if forward_fn is None:
        forward_fn = type(layer).forward

    def pure(param_vals, buffer_vals, key, arg_vals, kw_vals):
        t_args = wrap(arg_vals)
        t_kwargs = wrap(kw_vals)
        prev_training = layer.training
        if training is not None:
            layer.train() if training else layer.eval()
        try:
            with swap_state(layer, param_vals, buffer_vals), no_grad(), \
                    _random.trace_rng(_base_key(key)):
                out = forward_fn(layer, *t_args, **t_kwargs)
        finally:
            layer.train() if prev_training else layer.eval()
        return unwrap(out), swap_state._last_buffers

    return pure


def make_pure_callable(fn, training=None):
    """The same contract for a bare function (no layer state)."""

    def pure(param_vals, buffer_vals, key, arg_vals, kw_vals):
        t_args = wrap(arg_vals)
        t_kwargs = wrap(kw_vals)
        with no_grad(), _random.trace_rng(_base_key(key)):
            out = fn(*t_args, **t_kwargs)
        return unwrap(out), {}

    return pure
