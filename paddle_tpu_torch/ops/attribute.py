"""Tensor attribute queries: port of paddle_tpu/ops/attribute.py
(reference: python/paddle/tensor/attribute.py)."""
from __future__ import annotations

import torch

from ..tensor import Tensor, unwrap


def rank(input, name=None):
    """0-D int32 tensor holding ndim."""
    v = unwrap(input)
    return Tensor(torch.as_tensor(v.dim(), dtype=torch.int32,
                                  device=v.device))


def shape(input, name=None):
    """1-D int32 tensor of the shape."""
    v = unwrap(input)
    return Tensor(torch.as_tensor(list(v.shape), dtype=torch.int32,
                                  device=v.device))


def is_complex(x, name=None):
    return bool(unwrap(x).is_complex())


def is_floating_point(x, name=None):
    return bool(unwrap(x).is_floating_point())


def is_integer(x, name=None):
    v = unwrap(x)
    return not (v.is_floating_point() or v.is_complex()
                or v.dtype == torch.bool)
