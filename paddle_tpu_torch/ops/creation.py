"""Tensor creation ops: port of paddle_tpu/ops/creation.py (reference:
python/paddle/tensor/creation.py). New tensors go to the current place
(``framework.place``)."""
from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..framework import dtype as _dt
from ..framework.place import current_device
from ..tensor import Tensor, def_op, to_tensor  # noqa: F401


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _tdt(dtype):
    return _dt.to_torch(dtype)


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_shape(shape), dtype=_tdt(dtype),
                             device=current_device()))


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_shape(shape), dtype=_tdt(dtype),
                              device=current_device()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor(torch.full(_shape(shape), fill_value, dtype=_tdt(dtype),
                             device=current_device()))


def _like_dtype(x, dtype):
    return _tdt(dtype) if dtype is not None else x.dtype


@def_op("ones_like")
def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=_like_dtype(x, dtype))


@def_op("zeros_like")
def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_like_dtype(x, dtype))


@def_op("full_like")
def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, fill_value, dtype=_like_dtype(x, dtype))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = [v.item() if isinstance(v, Tensor) else v
                        for v in (start, end, step)]
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else _dt.get_default_dtype())
    td = _tdt(dtype)
    if td.is_floating_point:
        # jnp.arange's float values: start + i * step in the dtype
        n = max(int(_math.ceil((end - start) / step)), 0)
        v = (torch.arange(n, dtype=torch.float64) * step + start).to(td)
        return Tensor(v.to(current_device()))
    return Tensor(torch.arange(start, end, step, dtype=td,
                               device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    start = start.item() if isinstance(start, Tensor) else start
    stop = stop.item() if isinstance(stop, Tensor) else stop
    num = int(num.item() if isinstance(num, Tensor) else num)
    return Tensor(torch.linspace(start, stop, num,
                                 dtype=_tdt(dtype or _dt.get_default_dtype()),
                                 device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor(torch.logspace(start, stop, int(num), base=base,
                                 dtype=_tdt(dtype or _dt.get_default_dtype()),
                                 device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return Tensor(torch.eye(int(num_rows), int(num_columns or num_rows),
                            dtype=_tdt(dtype), device=current_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


@def_op("assign")
def assign(x, output=None):
    if not isinstance(x, torch.Tensor):
        x = to_tensor(x)._value
    return x.clone()


@def_op("diag")
def diag(x, offset=0, padding_value=0, name=None):
    if x.dim() == 1 and padding_value != 0:
        n = x.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        return torch.where(mask, torch.diag(x, offset), base)
    return torch.diag(x, offset)


@def_op("diagflat")
def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


@def_op("tril")
def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


@def_op("triu")
def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    r = torch.tril_indices(row, col if col is not None else row, offset,
                           device=current_device())
    return Tensor(r.to(_tdt(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    r = torch.triu_indices(row, col if col is not None else row, offset,
                           device=current_device())
    return Tensor(r.to(_tdt(dtype)))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(def_op("meshgrid")(
        lambda vs: torch.meshgrid(*vs, indexing="ij"))(list(args)))


@def_op("clone")
def clone(x, name=None):
    return x.clone()


def complex(real, imag, name=None):
    return def_op("complex")(torch.complex)(real, imag)


def polar(abs_t, angle, name=None):
    return def_op("polar")(torch.polar)(abs_t, angle)


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    """Legacy fill_constant surface (reference: tensor/creation.py)."""
    return full(shape, value, dtype=dtype)


def create_tensor(dtype, name=None, persistable=False):
    """An empty 0-size tensor placeholder (reference: creation.py)."""
    return Tensor(torch.zeros((0,), dtype=_tdt(dtype),
                              device=current_device()))


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A trainable tensor (reference: creation.py create_parameter): zeros
    for a bias, else ``normal(next_key()) / sqrt(shape[0])`` unless an
    initializer is given."""
    from ..framework import prng
    from ..framework.random import next_key
    shape = _shape(shape)
    td = _tdt(dtype)
    dev = current_device()
    if default_initializer is not None:
        t = Tensor(torch.zeros(shape, dtype=td, device=dev),
                   stop_gradient=False)
        default_initializer(t)
        t.stop_gradient = False
        return t
    if is_bias:
        val = torch.zeros(shape, dtype=td, device=dev)
    else:
        fan_in = shape[0] if shape else 1
        std = 1.0 / _math.sqrt(max(fan_in, 1))
        val = prng.normal(next_key(), shape, td, device=dev) * std
    t = Tensor(val, stop_gradient=False)
    t.persistable = True
    return t


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    t = full(shape, value, dtype)
    t.persistable = persistable
    return t
