"""Search/sort/index ops: port of paddle_tpu/ops/search.py (reference:
python/paddle/tensor/search.py). Index results are int32, the reference's
fold of int64."""
from __future__ import annotations

import torch

from ..framework.dtype import to_torch
from ..tensor import Tensor, def_op


@def_op("argmax")
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    r = torch.argmax(x) if axis is None else torch.argmax(
        x, int(axis), keepdim=keepdim)
    return r.to(to_torch(dtype))


@def_op("argmin")
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    r = torch.argmin(x) if axis is None else torch.argmin(
        x, int(axis), keepdim=keepdim)
    return r.to(to_torch(dtype))


@def_op("argsort")
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.argsort(x, dim=int(axis), descending=descending,
                         stable=True)


@def_op("sort")
def sort(x, axis=-1, descending=False, stable=False, name=None):
    r = torch.sort(x, dim=int(axis), stable=True).values
    return torch.flip(r, (int(axis),)) if descending else r


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    if isinstance(k, Tensor):
        k = int(k.item())

    def _topk(v):
        r = torch.topk(v, k, dim=-1 if axis is None else int(axis),
                       largest=largest, sorted=True)
        return r.values, r.indices
    return def_op("topk")(_topk)(x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def _kth(v):
        r = torch.kthvalue(v, k, int(axis), keepdim=keepdim)
        return r.values, r.indices
    return def_op("kthvalue")(_kth)(x)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` and the LAST index of it
    (paddle's convention)."""
    def _mode(v):
        ax = int(axis) % v.dim()
        xm = v.movedim(ax, -1)
        sv = torch.sort(xm, -1).values
        counts = (sv[..., :, None] == sv[..., None, :]).sum(-1)
        best = torch.argmax(counts, -1, keepdim=True)
        val = torch.take_along_dim(sv, best, -1)[..., 0]
        n = xm.shape[-1]
        hit = torch.flip(xm == val[..., None], (-1,))
        idx = n - 1 - torch.argmax(hit.to(torch.int32), -1)
        if keepdim:
            val, idx = val.unsqueeze(ax), idx.unsqueeze(ax)
        return val, idx
    return def_op("mode")(_mode)(x)


@def_op("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    r = torch.searchsorted(sorted_sequence, values, right=right)
    return r.to(torch.int32)


@def_op("bucketize")
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return torch.bucketize(x, sorted_sequence, right=right).to(torch.int32)


@def_op("index_sample")
def index_sample(x, index):
    return torch.take_along_dim(x, index.long(), dim=1)


@def_op("histogramdd")
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    return torch.histogramdd(x, bins=bins, range=ranges, density=density,
                             weight=weights).hist
