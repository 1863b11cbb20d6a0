"""Activation functionals: port of paddle_tpu/nn/functional/activation.py
(reference: python/paddle/nn/functional/activation.py), each a stock torch
op on the held values."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import prng
from ...framework import random as _random
from ...framework.dtype import to_torch
from ...tensor import def_op, rebind_inplace


@def_op("relu")
def relu(x, name=None):
    return torch.relu(x)


@def_op("relu6")
def relu6(x, name=None):
    return TF.relu6(x)


@def_op("gelu")
def gelu(x, approximate=False, name=None):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


@def_op("sigmoid")
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@def_op("silu")
def silu(x, name=None):
    return TF.silu(x)


swish = silu


@def_op("tanh_act")
def tanh(x, name=None):
    return torch.tanh(x)


@def_op("softmax")
def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(to_torch(dtype))
    return torch.softmax(x, int(axis))


@def_op("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(to_torch(dtype))
    return torch.log_softmax(x, int(axis))


@def_op("softplus")
def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(beta * x)))


@def_op("softsign")
def softsign(x, name=None):
    return TF.softsign(x)


@def_op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    return TF.softshrink(x, threshold)


@def_op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@def_op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@def_op("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@def_op("hardswish")
def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@def_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


@def_op("elu")
def elu(x, alpha=1.0, name=None):
    return TF.elu(x, alpha)


@def_op("celu")
def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha)


@def_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@def_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return TF.leaky_relu(x, negative_slope)


@def_op("prelu_op")
def _prelu(x, weight, data_format="NCHW"):
    w = weight
    if w.numel() > 1:
        # per-channel: reshape for broadcast over the channel dim
        if data_format == "NCHW" and x.dim() > 2:
            w = w.reshape((1, -1) + (1,) * (x.dim() - 2))
        else:
            w = w.reshape((1,) * (x.dim() - 1) + (-1,))
    return torch.where(x >= 0, x, w * x)


def prelu(x, weight, data_format="NCHW", name=None):
    return _prelu(x, weight, data_format=data_format)


@def_op("rrelu")
def rrelu(x, lower=0.125, upper=0.3333333333, training=False, name=None):
    if training:
        slope = prng.uniform(_random.next_key(), tuple(x.shape), lower,
                             upper, device=x.device).to(x.dtype)
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


@def_op("mish")
def mish(x, name=None):
    return TF.mish(x)


@def_op("maxout")
def maxout(x, groups, axis=1, name=None):
    axis = int(axis) % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return torch.amax(x.reshape(shape), axis + 1)


@def_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@def_op("log_sigmoid")
def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


@def_op("glu")
def glu(x, axis=-1, name=None):
    return TF.glu(x, int(axis))


@def_op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    g = prng.gumbel(_random.next_key(), tuple(x.shape),
                    device=x.device).to(x.dtype)
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        idx = torch.argmax(y, axis, keepdim=True)
        hard_y = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (hard_y - y).detach() + y
    return y


def _inplace(fn):
    def f_(x, *a, **k):
        return rebind_inplace(x, fn(x, *a, **k))
    return f_


relu_ = _inplace(relu)
elu_ = _inplace(elu)
softmax_ = _inplace(softmax)
tanh_ = _inplace(tanh)
