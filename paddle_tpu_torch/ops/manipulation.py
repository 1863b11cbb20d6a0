"""Shape/layout manipulation ops: port of paddle_tpu/ops/manipulation.py
(reference: python/paddle/tensor/manipulation.py). Paddle's semantics where
torch's differ: ``transpose`` takes a permutation, ``expand`` keeps a dim
at -1, ``split`` takes section sizes (one may be -1), index tensors are
int32 and widen to int64 only inside the torch call that needs it."""
from __future__ import annotations

import builtins as _builtins

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework.dtype import to_torch
from ..tensor import Tensor, _val, def_op, to_tensor
from .attribute import shape  # noqa: F401  (paddle has it in both)

builtins_slice = _builtins.slice


def _norm_shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, (Tensor, torch.Tensor))
                 else int(s) for s in shape)


def _long(i):
    return i.long() if isinstance(i, torch.Tensor) else i


@def_op("reshape")
def reshape(x, shape, name=None):
    shape = _norm_shape(shape)
    # paddle: 0 copies the input's dim at that position
    shape = tuple(x.shape[i] if s == 0 and i < x.dim() else s
                  for i, s in enumerate(shape))
    return torch.reshape(x, shape)


@def_op("transpose")
def transpose(x, perm, name=None):
    return x.permute(*[int(p) for p in perm])


@def_op("t")
def t(x, name=None):
    if x.dim() <= 1:
        return x
    return x.transpose(-1, -2) if x.dim() == 2 else x.permute(
        *reversed(range(x.dim())))


@def_op("moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


@def_op("swapaxes")
def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(x, int(axis0), int(axis1))


transpose_ = transpose


@def_op("flatten")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


@def_op("squeeze")
def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    ax = tuple(int(a) % _builtins.max(x.dim(), 1) for a in axes)
    ax = tuple(a for a in ax if x.dim() and x.shape[a] == 1)
    return torch.squeeze(x, ax) if ax else x


@def_op("unsqueeze")
def unsqueeze(x, axis, name=None):
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        out = x
        for a in sorted(int(v) for v in axis):
            out = torch.unsqueeze(out, a)
        return out
    return torch.unsqueeze(x, int(axis))


@def_op("concat")
def concat(x, axis=0, name=None):
    return torch.cat(list(x), int(axis))


@def_op("stack")
def stack(x, axis=0, name=None):
    return torch.stack(list(x), int(axis))


@def_op("unstack")
def unstack(x, axis=0, num=None, name=None):
    return tuple(torch.unbind(x, axis))


@def_op("unbind")
def unbind(x, axis=0):
    return tuple(torch.unbind(x, axis))


def split(x, num_or_sections, axis=0, name=None):
    axis = int(axis.item()) if isinstance(axis, Tensor) else int(axis)

    @def_op("split")
    def _split(x):
        total = x.shape[axis]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(f"split: {total} does not divide into "
                                 f"{num_or_sections} sections")
            return tuple(torch.split(x, total // num_or_sections, axis))
        secs = [int(s.item()) if isinstance(s, Tensor) else int(s)
                for s in num_or_sections]
        if any(s == -1 for s in secs):
            known = _builtins.sum(s for s in secs if s != -1)
            secs = [total - known if s == -1 else s for s in secs]
        return tuple(torch.split(x, secs, axis))
    return list(_split(x))


def tensor_split(x, num_or_indices, axis=0, name=None):
    return list(def_op("tensor_split")(
        lambda v: torch.tensor_split(v, num_or_indices, int(axis)))(x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@def_op("tile")
def tile(x, repeat_times, name=None):
    return torch.tile(x, _norm_shape(repeat_times))


@def_op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, _long(repeats), dim=axis)


@def_op("expand")
def expand(x, shape, name=None):
    shape = _norm_shape(shape)
    cur = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    tgt = tuple(c if s == -1 else s for s, c in zip(shape, cur))
    return torch.broadcast_to(x, tgt)


@def_op("expand_as")
def expand_as(x, y, name=None):
    return torch.broadcast_to(x, y.shape)


@def_op("broadcast_to")
def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, _norm_shape(shape))


def broadcast_tensors(inputs, name=None):
    return list(def_op("broadcast_tensors")(
        lambda vs: torch.broadcast_tensors(*vs))(list(inputs)))


@def_op("cast")
def cast(x, dtype):
    return x.to(to_torch(dtype))


@def_op("flip")
def flip(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, tuple(int(a) for a in axis))


@def_op("roll")
def roll(x, shifts, axis=None, name=None):
    if axis is None:
        return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
    return torch.roll(x, shifts, axis)


@def_op("rot90")
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


@def_op("pad_nd")
def _pad_nd(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    nd = x.dim()
    pad = [int(p) for p in pad]
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle: the first (lo, hi) pair pads the LAST spatial dim
        k = len(pad) // 2
        width = [(0, 0)] * nd
        dims = (list(range(1, 1 + k)) if data_format.endswith("C")
                and nd > 2 else list(range(nd - k, nd)))
        for i, d in enumerate(reversed(dims)):
            width[d] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = []
        for lo, hi in reversed(width):
            flat += [lo, hi]
        return TF.pad(x, flat, mode="constant", value=value)
    # reflect / replicate / circular: gather each padded dim's source rows
    out = x
    for d, (lo, hi) in enumerate(width):
        if lo == 0 and hi == 0:
            continue
        n = out.shape[d]
        i = torch.arange(-lo, n + hi, device=x.device)
        if mode == "reflect":
            period = 2 * (n - 1)
            i = torch.remainder(i, period)
            i = torch.where(i >= n, period - i, i)
        elif mode == "replicate":
            i = i.clamp(0, n - 1)
        elif mode == "circular":
            i = torch.remainder(i, n)
        else:
            raise ValueError(f"unknown pad mode {mode!r}")
        out = torch.index_select(out, d, i)
    return out


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if isinstance(pad, Tensor):
        pad = pad.tolist()
    return _pad_nd(x, pad, mode=mode, value=value, data_format=data_format)


@def_op("gather")
def gather(x, index, axis=0, name=None):
    return torch.index_select(x, int(axis), index.reshape(-1).long())


@def_op("gather_nd")
def gather_nd(x, index, name=None):
    idx = tuple(index.long().movedim(-1, 0))
    return x[idx]


@def_op("take_along_axis")
def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(arr, indices.long(), dim=int(axis))


@def_op("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    idx = indices.long()
    values = torch.broadcast_to(values.to(arr.dtype), idx.shape)
    axis = int(axis) % arr.dim()
    if reduce == "assign":
        return arr.scatter(axis, idx, values)
    red = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
           "amax": "amax", "amin": "amin"}.get(reduce)
    if red is None:
        raise ValueError(f"unknown reduce {reduce!r}")
    return arr.scatter_reduce(axis, idx, values, red,
                              include_self=include_self)


@def_op("scatter")
def scatter(x, index, updates, overwrite=True, name=None):
    index = index.reshape(-1).long()
    if overwrite:
        return x.index_put((index,), updates)
    return x.index_put((index,), updates, accumulate=True)


@def_op("scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    idx = tuple(index.long().movedim(-1, 0))
    return x.index_put(idx, updates, accumulate=True)


@def_op("scatter_nd")
def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(_norm_shape(shape), dtype=updates.dtype,
                        device=updates.device)
    idx = tuple(index.long().movedim(-1, 0))
    return zeros.index_put(idx, updates, accumulate=True)


@def_op("index_select")
def index_select(x, index, axis=0, name=None):
    return torch.index_select(x, int(axis), index.reshape(-1).long())


@def_op("index_add")
def index_add(x, index, axis, value, name=None):
    return torch.index_add(x, int(axis) % x.dim(), index.long(), value)


@def_op("index_put")
def index_put(x, indices, value, accumulate=False, name=None):
    idx = tuple(_long(i) for i in indices)
    return x.index_put(idx, torch.as_tensor(value, dtype=x.dtype,
                                            device=x.device),
                       accumulate=accumulate)


@def_op("index_fill")
def index_fill(x, index, axis, fill_value, name=None):
    return torch.index_fill(x, int(axis) % x.dim(), index.long(),
                            fill_value)


@def_op("slice_op")
def slice(x, axes, starts, ends, name=None):
    idx = [builtins_slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[int(a)] = builtins_slice(int(s), int(e))
    return x[tuple(idx)]


@def_op("strided_slice")
def strided_slice(x, axes, starts, ends, strides, name=None):
    idx = [builtins_slice(None)] * x.dim()
    for a, s, e, st in zip(axes, starts, ends, strides):
        idx[int(a)] = builtins_slice(int(s), int(e), int(st))
    return x[tuple(idx)]


@def_op("masked_select")
def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask.bool())


@def_op("masked_fill")
def masked_fill(x, mask, value, name=None):
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) \
        else torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(mask.bool(), v, x)


@def_op("masked_scatter")
def masked_scatter(x, mask, value, name=None):
    return x.masked_scatter(torch.broadcast_to(mask.bool(), x.shape),
                            value.to(x.dtype))


@def_op("where")
def where(condition, x=None, y=None, name=None):
    if x is None or y is None:
        raise ValueError("use paddle.nonzero for 1-arg where")
    dev = condition.device
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=dev)
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, device=dev)
    return torch.where(condition.bool(), x, y)


@def_op("assign")
def assign(x, output=None):
    return x.clone()


def _diag_index(rows, cols, offset, device):
    n = _builtins.min(rows - _builtins.max(-offset, 0),
                      cols - _builtins.max(offset, 0))
    i = torch.arange(_builtins.max(n, 0), device=device)
    return i + _builtins.max(-offset, 0), i + _builtins.max(offset, 0)


@def_op("fill_diagonal")
def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    r, c = _diag_index(x.shape[-2], x.shape[-1], offset, x.device)
    out = x.clone()
    out[..., r, c] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return out


@def_op("as_real")
def as_real(x, name=None):
    return torch.view_as_real(x).clone()


@def_op("as_complex")
def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


@def_op("view")
def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return torch.reshape(x, _norm_shape(shape_or_dtype))
    return x.view(to_torch(shape_or_dtype))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def _si(v):
        size = (index_num + nshards - 1) // nshards
        lo = shard_id * size
        inside = (v >= lo) & (v < lo + size)
        return torch.where(inside, v - lo, torch.full_like(v, ignore_value))
    return def_op("shard_index")(_si)(input)


@def_op("crop")
def crop(x, shape=None, offsets=None, name=None):
    shape = _norm_shape(shape)
    offsets = [0] * x.dim() if offsets is None else [int(o) for o in offsets]
    idx = tuple(builtins_slice(o, o + (s if s != -1 else x.shape[d] - o))
                for d, (o, s) in enumerate(zip(offsets, shape)))
    return x[idx]


@def_op("unfold_op")
def unfold(x, axis, size, step, name=None):
    axis = int(axis) % x.dim()
    # torch puts the window last; the reference keeps it at the axis
    return torch.movedim(x.unfold(axis, size, step), -1, axis + 1)


@def_op("atleast_1d")
def atleast_1d(x):
    return torch.atleast_1d(x)


@def_op("atleast_2d")
def atleast_2d(x):
    return torch.atleast_2d(x)


@def_op("atleast_3d")
def atleast_3d(x):
    return torch.atleast_3d(x)


def vstack(x, name=None):
    return def_op("vstack")(lambda v: torch.vstack(v))(list(x))


def hstack(x, name=None):
    return def_op("hstack")(lambda v: torch.hstack(v))(list(x))


def dstack(x, name=None):
    return def_op("dstack")(lambda v: torch.dstack(v))(list(x))


def column_stack(x, name=None):
    return def_op("column_stack")(lambda v: torch.column_stack(v))(list(x))


def row_stack(x, name=None):
    return vstack(x)


@def_op("getitem")
def _getitem(x, idx):
    return x[idx]


def _index(i, device):
    """One index of ``x[...]`` in torch's form: int tensors widen to
    int64, lists and arrays become tensors."""
    if isinstance(i, Tensor):
        i = i._value
    if isinstance(i, (list, np.ndarray)):
        i = torch.as_tensor(np.asarray(i), device=device)
    if isinstance(i, torch.Tensor) and i.dtype not in (torch.bool,
                                                       torch.uint8):
        i = i.long()
    return i


def getitem(x, item):
    dev = x._value.device
    idx = tuple(_index(i, dev) for i in item) if isinstance(item, tuple) \
        else _index(item, dev)
    return _getitem(x, idx)


def numel(x, name=None):
    return Tensor(torch.as_tensor(_val(x).numel(), dtype=torch.int32,
                                  device=_val(x).device))


@def_op("bincount")
def bincount(x, weights=None, minlength=0, name=None):
    return torch.bincount(x.long(), weights=weights,
                          minlength=int(minlength))


@def_op("one_hot")
def one_hot(x, num_classes, name=None):
    return TF.one_hot(x.long(), int(num_classes)).to(torch.float32)


@def_op("unique_consecutive_op")
def _unique_consecutive(x):
    return torch.unique_consecutive(x)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    return _unique_consecutive(x.flatten() if axis is None else x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """np.unique on the host (a dynamic output shape), as the reference."""
    v = _val(x)
    res = np.unique(Tensor._wrap(v, True).numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        out = [to_tensor(res[0], place=v.device)]
        for r in res[1:]:
            out.append(to_tensor(r, dtype=dtype, place=v.device))
        return tuple(out)
    return to_tensor(res, place=v.device)


def nonzero(x, as_tuple=False):
    v = _val(x)
    nz = torch.nonzero(v).to(torch.int32)
    if as_tuple:
        return tuple(Tensor(c) for c in nz.unbind(1))
    return Tensor(nz)


@def_op("tensordot")
def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)) and len(axes) == 2 and \
            _builtins.all(isinstance(a, (list, tuple)) for a in axes):
        return torch.tensordot(x, y, dims=(list(axes[0]), list(axes[1])))
    if isinstance(axes, (list, tuple)):
        return torch.tensordot(x, y, dims=(list(axes), list(axes)))
    return torch.tensordot(x, y, dims=int(axes))


@def_op("unflatten")
def unflatten(x, axis, shape, name=None):
    return torch.unflatten(x, axis, [int(s) for s in shape])


def _split_np(x, num_or_indices, axis):
    if isinstance(num_or_indices, int):
        return list(torch.tensor_split(x, num_or_indices, axis))
    return list(torch.tensor_split(x, list(num_or_indices), axis))


@def_op("vsplit")
def vsplit(x, num_or_indices, name=None):
    return _split_np(x, num_or_indices, 0)


@def_op("hsplit")
def hsplit(x, num_or_indices, name=None):
    return _split_np(x, num_or_indices, 1 if x.dim() > 1 else 0)


@def_op("dsplit")
def dsplit(x, num_or_indices, name=None):
    return _split_np(x, num_or_indices, 2)


@def_op("block_diag")
def block_diag(inputs, name=None):
    return torch.block_diag(*[torch.atleast_2d(i) for i in inputs])


@def_op("cartesian_prod")
def cartesian_prod(x, name=None):
    return torch.cartesian_prod(*x)


@def_op("diag_embed")
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(input, offset, dim1, dim2)


@def_op("select_scatter")
def select_scatter(x, values, axis, index, name=None):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


@def_op("slice_scatter")
def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    out = x.clone()
    idx = [builtins_slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = builtins_slice(st, en, sd)
    out[tuple(idx)] = value.to(x.dtype)
    return out


@def_op("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2)


@def_op("as_strided")
def as_strided(x, shape, stride, offset=0, name=None):
    return torch.as_strided(x.contiguous(), shape, stride, offset).clone()


@def_op("fill_diagonal_tensor")
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    xm = torch.movedim(x, (dim1, dim2), (-2, -1)).clone()
    r, c = _diag_index(xm.shape[-2], xm.shape[-1], offset, x.device)
    ym = torch.movedim(y, 0, -1) if y.dim() == xm.dim() - 1 else y
    xm[..., r, c] = ym.to(x.dtype)
    return torch.movedim(xm, (-2, -1), (dim1, dim2))


def _setitem(self, item, value):
    """``x[item] = value``: x takes the updated value as a new leaf, as the
    reference rebuilds it with ``.at[].set`` and detaches it."""
    dev = self._value.device
    idx = tuple(_index(i, dev) for i in item) if isinstance(item, tuple) \
        else _index(item, dev)
    new = self._value.detach().clone()
    v = _val(value) if isinstance(value, Tensor) else torch.as_tensor(
        value, dtype=new.dtype, device=dev)
    new[idx] = v.to(new.dtype)
    stop = self.stop_gradient
    self._value = new
    self.stop_gradient = stop
