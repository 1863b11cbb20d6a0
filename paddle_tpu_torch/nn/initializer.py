"""Weight initializers + ParamAttr: port of paddle_tpu/nn/initializer.py
(reference: ``python/paddle/nn/initializer/`` and ``param_attr.py``).

Each random initializer takes one key from ``framework.random.next_key()``
and draws through ``framework.prng`` (jax's threefry, ``uniform`` and
``normal`` bit for bit), as the reference draws with ``jax.random``; so
after ``seed(s)`` a model's float32 parameters equal the reference's bit
for bit. An initializer returns a torch tensor on the current place.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import prng
from ..framework import random as _random
from ..framework.dtype import to_torch
from ..framework.place import current_device


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv_transpose1d": 1.0, "conv_transpose2d": 1.0,
        "conv_transpose3d": 1.0, "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")
    return gains[nonlinearity]


def _normal(shape, dtype):
    """``jax.random.normal(next_key(), shape, dtype)`` (f32 drawn, cast)."""
    return prng.normal(_random.next_key(), tuple(shape), to_torch(dtype),
                       device=current_device())


def _uniform(shape, dtype, lo, hi):
    """``jax.random.uniform(next_key(), shape, dtype, lo, hi)``."""
    return prng.uniform(_random.next_key(), tuple(shape), lo, hi,
                        device=current_device()).to(to_torch(dtype))


class Initializer:
    def __call__(self, shape, dtype) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _fans(shape):
        shape = tuple(shape)
        if len(shape) == 0:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        # conv kernels [out, in, *spatial] (paddle layout)
        receptive = int(np.prod(shape[2:]))
        return shape[1] * receptive, shape[0] * receptive


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=to_torch(dtype),
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _normal(shape, dtype) * self.std + self.mean


def _erf_f32(x: float) -> float:
    return float(np.float32(math.erf(float(np.float32(x)))))


class TruncatedNormal(Initializer):
    """``jax.random.truncated_normal(key, a, b)``: u uniform over
    [erf(a/sqrt2), erf(b/sqrt2)), ``sqrt2 * erf_inv(u)`` clipped inside
    (a, b), then scaled and shifted. The two bounds' erf are formed in
    float64 and rounded (XLA's f32 erf may differ in the last bit), so a
    draw matches the reference to an ulp of its bounds, not bit for
    bit."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        sqrt2 = float(np.float32(math.sqrt(2.0)))
        lo = _erf_f32(np.float32(self.a) / np.float32(sqrt2))
        hi = _erf_f32(np.float32(self.b) / np.float32(sqrt2))
        u = prng.uniform(_random.next_key(), tuple(shape), lo, hi,
                         device=current_device())
        out = prng._erf_inv_f32(u) * sqrt2
        out = torch.clamp(out, float(np.nextafter(np.float32(self.a),
                                                  np.float32(np.inf))),
                          float(np.nextafter(np.float32(self.b),
                                             np.float32(-np.inf))))
        return (out * self.std + self.mean).to(to_torch(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _uniform(shape, dtype, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = self._fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _normal(shape, dtype) * std


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = self._fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in or self._fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _normal(shape, dtype) * (gain / math.sqrt(fi))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in or self._fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, -limit, limit)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype):
        from ..tensor import Tensor
        v = self.value
        v = v.numpy() if isinstance(v, Tensor) else np.asarray(v)
        return torch.as_tensor(v, device=current_device()).to(
            to_torch(dtype)).reshape(tuple(shape))


class Bilinear(Initializer):
    """Bilinear upsampling kernel for transposed convs: every (out, in)
    pair holds the same bilinear filter."""

    def __call__(self, shape, dtype="float32"):
        if len(shape) != 4:
            raise ValueError(f"Bilinear initializer needs a 4-D conv "
                             f"weight, got {len(shape)}-D")
        c_out, c_in, kh, kw = shape
        if kh != kw:
            raise ValueError("Bilinear initializer needs square kernels")
        f = int(np.ceil(kw / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:kh, :kw]
        filt = ((1 - np.abs(og[0] / f - c))
                * (1 - np.abs(og[1] / f - c))).astype(np.float32)
        w = np.broadcast_to(filt, tuple(shape)).copy()
        return torch.as_tensor(w, device=current_device()).to(
            to_torch(dtype))


def _to_initializer(x) -> Initializer:
    if isinstance(x, Initializer):
        return x
    if callable(x):
        class _Wrapped(Initializer):
            def __call__(self, shape, dtype):
                return x(shape, dtype)
        return _Wrapped()
    raise TypeError(f"cannot convert {type(x)} to Initializer")


class ParamAttr:
    """Reference: python/paddle/fluid/param_attr.py."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return None  # "no parameter" (e.g. bias_attr=False)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer) or callable(attr):
            return ParamAttr(initializer=_to_initializer(attr))
        raise TypeError(f"bad param attr {attr!r}")


_global_weight_init: Initializer | None = None
_global_bias_init: Initializer | None = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init
