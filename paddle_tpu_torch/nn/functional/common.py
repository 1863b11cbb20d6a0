"""Common functionals: port of paddle_tpu/nn/functional/common.py
(reference: python/paddle/nn/functional/common.py, input.py).

``linear`` keeps paddle's [in, out] weight (x @ W + b). Dropout masks come
from ``framework.prng``'s uniform draw with one ``next_key()`` a call, as
``jax.random.bernoulli`` draws them in the reference (keep where
u < 1 - p), so after ``seed(s)`` a mask equals the reference's bit for
bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework import prng
from ...framework import random as _random
from ...framework.dtype import to_torch
from ...tensor import def_op
from .conv import _norm_tuple


@def_op("linear")
def linear(x, weight, bias=None, name=None):
    # paddle weight layout: [in, out]
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def _keep_mask(shape, p, device):
    """``jax.random.bernoulli(next_key(), 1 - p, shape)``: a float32
    uniform draw below float32(1 - p)."""
    u = prng.uniform(_random.next_key(), tuple(shape), device=device)
    return u < float(np.float32(1.0 - p))


@def_op("dropout")
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        mask_shape = tuple(x.shape[i] if i in axes else 1
                           for i in range(x.dim()))
    else:
        mask_shape = tuple(x.shape)
    keep = _keep_mask(mask_shape, p, x.device)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)


def _channel_dropout(x, p, training, channels_first, nd):
    if not training or p == 0.0:
        return x
    if channels_first:
        mask_shape = (x.shape[0], x.shape[1]) + (1,) * nd
    else:
        mask_shape = (x.shape[0],) + (1,) * nd + (x.shape[-1],)
    keep = _keep_mask(mask_shape, p, x.device)
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


@def_op("dropout2d")
def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return _channel_dropout(x, p, training, data_format == "NCHW", 2)


@def_op("dropout3d")
def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return _channel_dropout(x, p, training, data_format == "NCDHW", 3)


@def_op("alpha_dropout")
def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = _keep_mask(x.shape, p, x.device)
    a = 1.0 / np.sqrt((1 - p) * (1 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


@def_op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


@def_op("one_hot")
def one_hot(x, num_classes, name=None):
    return TF.one_hot(x.long(), int(num_classes)).to(torch.float32)


@def_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@def_op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    dot = torch.sum(x1 * x2, int(axis))
    n1 = torch.linalg.vector_norm(x1, dim=int(axis))
    n2 = torch.linalg.vector_norm(x2, dim=int(axis))
    return dot / torch.clamp_min(n1 * n2, eps)


@def_op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-06, keepdim=False, name=None):
    d = x - y + epsilon
    return torch.sum(torch.abs(d) ** p, -1, keepdim=keepdim) ** (1.0 / p)


@def_op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    if data_format == "NCHW":
        return TF.pixel_shuffle(x, int(upscale_factor))
    return TF.pixel_shuffle(x.permute(0, 3, 1, 2),
                            int(upscale_factor)).permute(0, 2, 3, 1)


@def_op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    if data_format == "NCHW":
        return TF.pixel_unshuffle(x, int(downscale_factor))
    return TF.pixel_unshuffle(x.permute(0, 3, 1, 2),
                              int(downscale_factor)).permute(0, 2, 3, 1)


@def_op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    g = int(groups)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
            n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)


@def_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    channels_last = data_format[-1] == "C" and len(data_format) > 2
    if channels_last:
        x = x.movedim(-1, 1)
    nd = x.dim() - 2
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * nd
        size = [int(s * f) for s, f in zip(x.shape[2:], scale_factor)]
    else:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        size = [int(s) for s in (size if isinstance(size, (list, tuple))
                                 else [size])]
    tmode = {"nearest": "nearest", "bilinear": "bilinear",
             "linear": "linear", "trilinear": "trilinear",
             "bicubic": "bicubic", "area": "area"}[mode]
    kw = {} if tmode in ("nearest", "area") else {
        "align_corners": bool(align_corners)}
    out = TF.interpolate(x, size=size, mode=tmode, **kw)
    return out.movedim(1, -1) if channels_last else out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@def_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C*kh*kw, L]."""
    pads = paddings
    if not isinstance(pads, (int, np.integer)) and len(pads) == 4:
        pl = [int(p) for p in pads]   # [top, left, bottom, right]
        x = TF.pad(x, [pl[1], pl[3], pl[0], pl[2]])
        pads = 0
    pair = lambda v: _norm_tuple(v, 2)
    return TF.unfold(x, pair(kernel_sizes), dilation=pair(dilations),
                     padding=pair(pads), stride=pair(strides))


@def_op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of unfold."""
    pair = lambda v: _norm_tuple(v, 2)
    return TF.fold(x, pair(output_sizes), pair(kernel_sizes),
                   dilation=pair(dilations), padding=pair(paddings),
                   stride=pair(strides))


@def_op("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    # weight: [out, in1, in2]
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out + bias if bias is not None else out


@def_op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    f = int(c * shift_ratio)
    left = torch.cat([xr[:, 1:, :f], torch.zeros_like(xr[:, :1, :f])], 1)
    right = torch.cat([torch.zeros_like(xr[:, :1, f:2 * f]),
                       xr[:, :-1, f:2 * f]], 1)
    return torch.cat([left, right, xr[:, :, 2 * f:]], 2).reshape(
        nt, c, h, w)


@def_op("sequence_mask")
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[...] lengths -> [..., maxlen] 0/1 mask."""
    m = int(maxlen) if maxlen is not None else int(x.max())
    rng = torch.arange(m, device=x.device)
    mask = rng[None, :] < x.reshape(-1, 1)
    return mask.reshape(tuple(x.shape) + (m,)).to(to_torch(dtype))


@def_op("zeropad2d")
def zeropad2d(x, padding, data_format="NCHW", name=None):
    l, r, t, b = (int(p) for p in padding)
    if data_format == "NCHW":
        return TF.pad(x, [l, r, t, b])
    return TF.pad(x, [0, 0, l, r, t, b])


@def_op("affine_grid")
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta [N, 2, 3] -> sampling grid [N, H, W, 2]."""
    return TF.affine_grid(theta.float(), [int(s) for s in out_shape],
                          align_corners=align_corners)


@def_op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return TF.grid_sample(x, grid.to(x.dtype), mode=mode,
                          padding_mode=padding_mode,
                          align_corners=align_corners)


class sdp_kernel:
    """Context manager choosing the attention backend (reference:
    nn/functional/sdp_kernel): the flash kernels or the plain composite,
    through ``FLAGS_use_pallas_kernels``."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        self._enable_flash = enable_flash

    def __enter__(self):
        from ...framework import flags as _flags
        self._prev = _flags.flag("FLAGS_use_pallas_kernels")
        _flags.set_flags({"FLAGS_use_pallas_kernels": self._enable_flash})
        return self

    def __exit__(self, *exc):
        from ...framework import flags as _flags
        _flags.set_flags({"FLAGS_use_pallas_kernels": self._prev})
        return False


@def_op("gather_tree")
def gather_tree(ids, parents):
    """Beam-search backtrace (reference: nn/functional gather_tree;
    ids/parents: [T, B, beam]): from the last step back, each slot's token
    and then its parent beam."""
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    toks = []
    for t in range(ids.shape[0] - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, beams))
        beams = torch.gather(parents[t], 1, beams).long()
    return torch.stack(toks[::-1], 0)
