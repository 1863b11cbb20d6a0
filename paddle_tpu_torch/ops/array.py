"""TensorArray ops: port of paddle_tpu/ops/array.py (reference:
python/paddle/tensor/array.py). In dygraph an array is a Python list."""
from __future__ import annotations

import torch

from ..tensor import Tensor, unwrap


def create_array(dtype="float32", initialized_list=None):
    array = []
    if initialized_list is not None:
        array.extend(initialized_list)
    return array


def array_write(x, i, array=None):
    idx = int(unwrap(i)) if not isinstance(i, int) else i
    if array is None:
        array = []
    while len(array) <= idx:
        array.append(None)
    array[idx] = x
    return array


def array_read(array, i):
    return array[int(unwrap(i)) if not isinstance(i, int) else i]


def array_length(array):
    return Tensor(torch.as_tensor(len(array), dtype=torch.int32))


def tensor_array_to_tensor(input, axis=0, use_stack=False, name=None):
    """Concat/stack the array into one tensor; returns (tensor, sizes)."""
    from .manipulation import concat, stack
    items = [t for t in input if t is not None]
    if use_stack:
        out, sizes = stack(items, axis), [1] * len(items)
    else:
        out, sizes = concat(items, axis), [t.shape[axis] for t in items]
    return out, Tensor(torch.as_tensor(sizes, dtype=torch.int32,
                                       device=out._value.device))
