"""Attention functionals: port of paddle_tpu/nn/functional/attention.py.

Attention without an additive mask goes through the port's flash kernels
(``ops.kernels.flash_attention``: the forward kernel, and under autograd
the dq and dk/dv kernels) on ``[B, H, S, D]``; paddle's ``[B, S, H, D]``
is transposed into that layout and back. The route follows the
reference's, and every call counts its route in :data:`routes`:

* ``"kernel"``: ``FLAGS_use_pallas_kernels`` on and the shape the
  reference's flash wrapper tiles (``ops/pallas/flash_attention.py``: Sq >=
  128, Sq and Skv multiples of 128, so a 128-row block divides both). On
  a CUDA tensor the kernel launches or raises; on a CPU tensor the wrapper
  runs its plain version.
* ``"plain_flag"``: the flag off (the user's switch to the composite).
* ``"plain_shape"``: a shape the reference's wrapper does not tile.
* ``"plain_mask"``: an additive mask, which the reference routes to its
  composite.

The counts count runs: inside a ``jit.to_static`` program each call of a
route is counted when the program runs.

A kernel that fails to build or launch raises; no route falls back.
"""
from __future__ import annotations

import math

import torch

from ...framework import flags as _flags
from ...framework import prng
from ...framework import random as _random
from ...ops.kernels import flash_attention as _fa
from ...tensor import def_op

routes = {"kernel": 0, "plain_flag": 0, "plain_shape": 0, "plain_mask": 0}


@torch.library.custom_op("paddle_tpu::count_route", mutates_args=())
def _count_route_op(route: str) -> None:
    routes[route] += 1


@_count_route_op.register_fake
def _(route):
    return None


# an ordered side effect: a compiled or exported program keeps the call
# and makes it each time it runs
_count_route_op.register_effect(torch._library.effects.EffectType.ORDERED)


def _count_route(route: str) -> None:
    """Count one call of ``route``; inside a compiled or exported program
    the ``paddle_tpu::count_route`` op counts it when the program runs."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        torch.ops.paddle_tpu.count_route(route)
    else:
        routes[route] += 1


def flash_route(q, k, mask=None) -> str:
    """The route of an attention call on q [B, H, Sq, D], k [B, H, Skv, D]
    (see the module doc)."""
    if mask is not None:
        return "plain_mask"
    if not _flags.flag("FLAGS_use_pallas_kernels"):
        return "plain_flag"
    sq, skv = q.shape[-2], k.shape[-2]
    if sq < 128 or sq % 128 or skv % 128:
        return "plain_shape"
    return "kernel"


def _attend(q, k, v, scale, causal, mask=None):
    """Attention on [B, H, S, D] by :func:`flash_route`'s route."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    route = flash_route(q, k, mask)
    _count_route(route)
    if route == "kernel":
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), scale, bool(causal))
    return _fa.xla_attention(q, k, v, scale, bool(causal), bias=mask)


@def_op("scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """q/k/v: [B, S, H, D] (paddle layout) -> [B, S, H, D]."""
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    out = _attend(q, k, v, None, is_causal, attn_mask)
    if dropout_p > 0.0 and training:
        u = prng.uniform(_random.next_key(), tuple(out.shape),
                         device=out.device)
        keep = u < float(torch.tensor(1 - dropout_p, dtype=torch.float32))
        out = torch.where(keep, out / (1 - dropout_p),
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device)).to(out.dtype)
    return out.transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, name=None):
    """paddle.nn.functional.flash_attention.flash_attention (q [B,S,H,D]);
    returns (out, None): the softmax is not materialized."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal)
    return out, None


@def_op("flash_attn_bhsd")
def flash_attn_bhsd(q, k, v, scale=None, causal=False):
    """[B, H, S, D] entry of the model code (the eager GPT)."""
    return _attend(q, k, v, scale, causal)
