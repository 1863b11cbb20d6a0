"""Normalization functionals: port of paddle_tpu/nn/functional/norm.py
(reference: phi batch_norm/layer_norm kernels). Stock torch ops; a
training batch_norm updates the running statistics in place."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...tensor import Tensor, def_op


@def_op("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return TF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


@def_op("rms_norm")
def rms_norm(x, weight=None, epsilon=1e-06, name=None):
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    out = x * torch.rsqrt(var + epsilon).to(x.dtype)
    return out * weight if weight is not None else out


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@def_op("batch_norm_infer")
def _bn_infer(x, running_mean, running_var, weight, bias, epsilon, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    out = (x - running_mean.reshape(shape)) * torch.rsqrt(
        running_var.reshape(shape) + epsilon)
    return _affine(out, weight, bias, shape)


@def_op("batch_norm_train")
def _bn_train(x, weight, bias, epsilon, axis):
    dims = tuple(i for i in range(x.dim()) if i != axis)
    mean = torch.mean(x, dims)
    var = torch.mean(torch.square(x), dims) - torch.square(mean)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    return _affine(out, weight, bias, shape), mean, var


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch statistics in training (the running ones updated in place:
    ``r * momentum + batch * (1 - momentum)``, the variance unbiased),
    the running statistics otherwise."""
    axis = x.ndim - 1 if data_format[-1] == "C" and len(data_format) > 2 \
        else (1 if x.ndim > 1 else 0)
    if not training or use_global_stats:
        return _bn_infer(x, running_mean, running_var, weight, bias,
                         float(epsilon), axis)
    out, mean, var = _bn_train(x, weight, bias, float(epsilon), axis)
    if isinstance(running_mean, Tensor):
        m = float(momentum)
        n = x.size // x.shape[axis]
        with torch.no_grad():
            rm, rv = running_mean._value, running_var._value
            rm.copy_(rm * m + mean._value * (1 - m))
            rv.copy_(rv * m + var._value * (n / max(n - 1, 1)) * (1 - m))
    return out


@def_op("instance_norm")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    channels_last = data_format[-1] == "C" and x.dim() > 2
    if channels_last:
        x = x.movedim(-1, 1)
    dims = tuple(range(2, x.dim()))
    mean = torch.mean(x, dims, keepdim=True)
    var = torch.var(x, dims, keepdim=True, correction=0)
    out = _affine((x - mean) * torch.rsqrt(var + eps), weight, bias,
                  (1, -1) + (1,) * (x.dim() - 2))
    return out.movedim(1, -1) if channels_last else out


@def_op("group_norm")
def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    channels_last = data_format[-1] == "C" and len(data_format) > 2
    if channels_last:
        x = x.movedim(-1, 1)
    n, c = x.shape[0], x.shape[1]
    g = int(num_groups)
    grouped = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    dims = tuple(range(2, grouped.dim()))
    mean = torch.mean(grouped, dims, keepdim=True)
    var = torch.var(grouped, dims, keepdim=True, correction=0)
    out = ((grouped - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    out = _affine(out, weight, bias, (1, -1) + (1,) * (x.dim() - 2))
    return out.movedim(1, -1) if channels_last else out


@def_op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    channels_last = data_format[-1] == "C" and len(data_format) > 2
    ax = x.dim() - 1 if channels_last else 1
    sq = torch.square(x).movedim(ax, -1)
    half = size // 2
    sq = TF.pad(sq, [half, size - half - 1])
    summed = sq.unfold(-1, size, 1).sum(-1).movedim(-1, ax)
    return x / torch.pow(k + alpha * summed, beta)


@def_op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = torch.sum(torch.abs(x) ** p, int(axis), keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)
