"""Comparison & logical ops: port of paddle_tpu/ops/logic.py (reference:
python/paddle/tensor/logic.py)."""
from __future__ import annotations

import torch

from ..tensor import Tensor, def_op
from .math import _tensor


def _binary(name, fn):
    @def_op(name)
    def op(x, y, name=None):
        if not isinstance(x, torch.Tensor):
            x = _tensor(x, y)
        return fn(x, _tensor(y, x))
    op.__name__ = name
    return op


equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _binary("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _binary("bitwise_right_shift",
                              torch.bitwise_right_shift)


@def_op("logical_not")
def logical_not(x, name=None):
    return torch.logical_not(x)


@def_op("bitwise_not")
def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


@def_op("equal_all")
def equal_all(x, y, name=None):
    return torch.as_tensor(x.shape == y.shape and bool(torch.equal(x, y)),
                           device=x.device)


@def_op("allclose")
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.as_tensor(torch.allclose(x, y, rtol, atol, equal_nan),
                           device=x.device)


@def_op("isclose")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol, atol, equal_nan)


@def_op("is_empty")
def is_empty(x, name=None):
    return torch.as_tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, Tensor)


@def_op("isin")
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(x, test_x, assume_unique=assume_unique, invert=invert)


@def_op("isneginf")
def isneginf(x, name=None):
    return torch.isneginf(x)


@def_op("isposinf")
def isposinf(x, name=None):
    return torch.isposinf(x)


@def_op("isreal")
def isreal(x, name=None):
    return torch.isreal(x)
