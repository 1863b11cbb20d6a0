"""Pooling: port of paddle_tpu/nn/functional/pooling.py (reference: phi
pool kernels). Windows run on stock torch pools over an explicitly padded
input: -inf for max, zeros for average with a count of the real elements
(paddle's ``exclusive``); ``ceil_mode`` widens the upper pad so the last
partial window is kept, as the reference does."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...tensor import def_op
from .conv import _norm_tuple

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pairs(padding, n, in_sizes, ks, st, ceil_mode):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pairs = [(0, 0)] * n
        else:
            pairs = []
            for size, k, s in zip(in_sizes, ks, st):
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pairs.append((total // 2, total - total // 2))
    elif isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        pairs = [(int(padding[2 * i]), int(padding[2 * i + 1]))
                 for i in range(n)]
    else:
        pairs = [(p, p) for p in _norm_tuple(padding, n)]
    if ceil_mode:
        out = []
        for size, k, s, (lo, hi) in zip(in_sizes, ks, st, pairs):
            rem = (size + lo + hi - k) % s
            out.append((lo, hi + ((s - rem) % s if rem else 0)))
        pairs = out
    return pairs


def _pool(x, kind, kernel, stride, padding, n, data_format,
          ceil_mode=False, exclusive=True):
    ks = _norm_tuple(kernel, n)
    st = _norm_tuple(stride if stride is not None else kernel, n)
    channels_last = data_format in ("NHWC", "NLC", "NDHWC")
    if channels_last:
        x = x.movedim(-1, 1)
    pairs = _pairs(padding, n, x.shape[2:], ks, st, ceil_mode)
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    if kind == "max":
        xp = TF.pad(x, flat, value=-math.inf) if any(flat) else x
        out = _MAX[n](xp, ks, st)
    else:
        summed = _AVG[n](TF.pad(x, flat), ks, st) * float(np.prod(ks))
        if exclusive and any(flat):
            ones = TF.pad(torch.ones_like(x[:1, :1]), flat)
            counts = _AVG[n](ones, ks, st) * float(np.prod(ks))
            out = summed / counts
        else:
            out = summed / float(np.prod(ks))
    return out.movedim(1, -1) if channels_last else out


def _max_pool_mask(x, kernel_size, stride, padding, n, ceil_mode,
                   data_format):
    """(pooled, flat indices into each channel's spatial volume), the
    reference's return_mask envelope: floor mode, channels first,
    symmetric integer padding."""
    expected = {1: "NCL", 2: "NCHW", 3: "NCDHW"}[n]
    if ceil_mode or isinstance(padding, str):
        raise NotImplementedError("return_mask supports floor-mode windows "
                                  "with integer padding only")
    if data_format != expected:
        raise NotImplementedError(f"return_mask supports the channels-first "
                                  f"{expected} layout only")
    ks = _norm_tuple(kernel_size, n)
    st = _norm_tuple(stride if stride is not None else kernel_size, n)
    out, idx = _MAX[n](x, ks, st, _norm_tuple(padding, n),
                       return_indices=True)
    return out, idx.to(torch.int32)


def _max_pool(n, fmt):
    def op(x, kernel_size, stride=None, padding=0, return_mask=False,
           ceil_mode=False, data_format=fmt, name=None):
        if return_mask:
            return _max_pool_mask(x, kernel_size, stride, padding, n,
                                  ceil_mode, data_format)
        return _pool(x, "max", kernel_size, stride, padding, n, data_format,
                     ceil_mode)
    return def_op(f"max_pool{n}d")(op)


max_pool1d = _max_pool(1, "NCL")
max_pool2d = _max_pool(2, "NCHW")
max_pool3d = _max_pool(3, "NCDHW")


@def_op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, "avg", kernel_size, stride, padding, 1, data_format,
                 ceil_mode, exclusive)


@def_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    out = _pool(x, "avg", kernel_size, stride, padding, 2, data_format,
                ceil_mode, exclusive)
    if divisor_override:
        out = out * (float(np.prod(_norm_tuple(kernel_size, 2)))
                     / divisor_override)
    return out


@def_op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, "avg", kernel_size, stride, padding, 3, data_format,
                 ceil_mode, exclusive)


_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _adaptive_pool(x, output_size, n, kind, data_format):
    """paddle's adaptive windows [floor(i*in/out), ceil((i+1)*in/out)),
    which are torch's."""
    channels_last = data_format in ("NHWC", "NLC", "NDHWC")
    if channels_last:
        x = x.movedim(-1, 1)
    sizes = output_size if isinstance(output_size, (list, tuple)) \
        else (output_size,) * n
    sizes = tuple(x.shape[2 + i] if s is None else int(s)
                  for i, s in enumerate(sizes))
    out = _ADAPTIVE[(kind, n)](x, sizes)
    return out.movedim(1, -1) if channels_last else out


@def_op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "avg", "NCL")


@def_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, "avg", data_format)


@def_op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, "avg", data_format)


@def_op("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, "max", "NCL")


@def_op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, "max", "NCHW")


@def_op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 3, "max", "NCDHW")


_UNPOOL = {1: TF.max_unpool1d, 2: TF.max_unpool2d, 3: TF.max_unpool3d}


def _max_unpool(n, fmt):
    def op(x, indices, kernel_size, stride=None, padding=0,
           data_format=fmt, output_size=None, name=None):
        ks = _norm_tuple(kernel_size, n)
        st = _norm_tuple(stride if stride is not None else kernel_size, n)
        return _UNPOOL[n](x, indices.long(), ks, st, _norm_tuple(padding, n),
                          output_size=None if output_size is None
                          else tuple(output_size)[-n:])
    return def_op(f"max_unpool{n}d")(op)


max_unpool1d = _max_unpool(1, "NCL")
max_unpool2d = _max_unpool(2, "NCHW")
max_unpool3d = _max_unpool(3, "NCDHW")
