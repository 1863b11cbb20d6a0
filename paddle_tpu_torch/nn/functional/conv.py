"""Convolutions: port of paddle_tpu/nn/functional/conv.py (reference: phi
conv kernels + python/paddle/nn/functional/conv.py). Stock torch
convolutions in NC* layout; channels-last inputs are moved there and back,
asymmetric and "SAME" padding is applied before the call, and a transposed
convolution crops its full output by the padding (paddle's weight layouts
are torch's: [out, in/g, *k], transposed [in, out/g, *k])."""
from __future__ import annotations

import numpy as np
import torch.nn.functional as TF

from ...tensor import def_op

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _norm_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _norm_padding(padding, n, in_sizes, strides, dilations, ksize):
    """Per-dim (lo, hi) pairs; "SAME" as XLA pads it (the extra one
    below), "VALID" none."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pairs = []
        for size, s, d, k in zip(in_sizes, strides, dilations, ksize):
            out = -(-size // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(int(v) for v in p) for p in padding][-n:]
    raise ValueError(f"bad padding {padding!r}")


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format, transpose=False, output_padding=0,
             output_size=None):
    strides = _norm_tuple(stride, n)
    dilations = _norm_tuple(dilation, n)
    channels_last = data_format in ("NHWC", "NLC", "NDHWC")
    if channels_last:
        x = x.movedim(-1, 1)
    pads = _norm_padding(padding, n, x.shape[2:], strides, dilations,
                         weight.shape[2:])
    if not transpose:
        sym = all(lo == hi for lo, hi in pads)
        if not sym:
            flat = []
            for lo, hi in reversed(pads):
                flat += [lo, hi]
            x = TF.pad(x, flat)
        out = _CONV[n](x, weight, bias, strides,
                       tuple(lo for lo, _ in pads) if sym else 0,
                       dilations, groups)
    else:
        if isinstance(padding, str):
            raise NotImplementedError(
                "string padding for a transposed convolution")
        opad = _norm_tuple(output_padding, n)
        out = _CONV_T[n](x, weight, None, strides, 0, opad, groups,
                         dilations)
        idx = [slice(None), slice(None)]
        for i, (lo, hi) in enumerate(pads):
            idx.append(slice(lo, out.shape[2 + i] - hi))
        out = out[tuple(idx)]
        if output_size is not None:
            tgt = _norm_tuple(output_size, n)
            out = out[(slice(None), slice(None))
                      + tuple(slice(0, t) for t in tgt)]
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * n)
    return out.movedim(1, -1) if channels_last else out


@def_op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


@def_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


@def_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


@def_op("conv1d_transpose")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format, True, output_padding, output_size)


@def_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format, True, output_padding, output_size)


@def_op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format, True, output_padding, output_size)
