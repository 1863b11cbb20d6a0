"""Data types: port of paddle_tpu/framework/dtype.py.

The reference's dtypes are numpy dtype objects (bfloat16 from
``ml_dtypes``), and it runs with jax's 64-bit types off, so every dtype
spec folds int64 to int32 and float64 to float32 (:func:`_canonicalize`).
The port reports the same dtypes: tensors hold the folded torch type, and
int64 appears only inside the torch calls that require it (embedding
lookups, gathers, the NLL pick). :func:`to_torch` and :func:`from_torch`
map between the two spellings.
"""
from __future__ import annotations

import ml_dtypes
import numpy as np
import torch

bool_ = np.dtype(np.bool_)
uint8 = np.dtype(np.uint8)
int8 = np.dtype(np.int8)
int16 = np.dtype(np.int16)
int32 = np.dtype(np.int32)
int64 = np.dtype(np.int64)
float16 = np.dtype(np.float16)
bfloat16 = np.dtype(ml_dtypes.bfloat16)
float32 = np.dtype(np.float32)
float64 = np.dtype(np.float64)
complex64 = np.dtype(np.complex64)
complex128 = np.dtype(np.complex128)
float8_e4m3fn = np.dtype(ml_dtypes.float8_e4m3fn)
float8_e5m2 = np.dtype(ml_dtypes.float8_e5m2)

_STR_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "float": float32, "float64": float64, "double": float64,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
}

_FLOATING = {float16, bfloat16, float32, float64, float8_e4m3fn, float8_e5m2}
_INTEGER = {uint8, int8, int16, int32, int64}
_COMPLEX = {complex64, complex128}

_TO_TORCH = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_FROM_TORCH = {v: _STR_ALIASES[k] for k, v in _TO_TORCH.items()}
# the torch types the reference never holds, and what it holds instead
_FOLD = {torch.int64: torch.int32, torch.float64: torch.float32,
         torch.complex128: torch.complex64}

_default_dtype = float32


def _canonicalize(d):
    """The reference's fold with jax's 64-bit types off."""
    if d == int64:
        return int32
    if d == np.dtype(np.uint64):
        return np.dtype(np.uint32)
    if d == float64:
        return float32
    if d == complex128:
        return complex64
    return d


def convert_dtype(dtype):
    """Normalize any dtype spec (str / numpy / torch / python type) to the
    reference's (folded) numpy dtype; None is the default dtype."""
    if dtype is None:
        return _default_dtype
    if isinstance(dtype, torch.dtype):
        return _canonicalize(_FROM_TORCH[dtype])
    if isinstance(dtype, str):
        key = dtype.lower()
        if key.startswith("paddle."):
            key = key.split(".", 1)[1]
        if key in _STR_ALIASES:
            return _canonicalize(_STR_ALIASES[key])
        return _canonicalize(np.dtype(key))
    return _canonicalize(np.dtype(dtype))


def to_torch(dtype) -> torch.dtype:
    """The torch type of a dtype spec (folded as :func:`convert_dtype`)."""
    return _TO_TORCH[str(convert_dtype(dtype))]


def from_torch(dtype: torch.dtype):
    """The reference's numpy dtype of a torch type."""
    return _FROM_TORCH[dtype]


def fold_torch(dtype: torch.dtype) -> torch.dtype:
    """The torch type the reference would hold for ``dtype``."""
    return _FOLD.get(dtype, dtype)


def set_default_dtype(d):
    """paddle.set_default_dtype (python/paddle/framework/framework.py)."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(
            f"set_default_dtype only supports floating dtypes, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in _INTEGER or d == bool_


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in _COMPLEX


def finfo(dtype):
    return torch.finfo(to_torch(dtype))


def iinfo(dtype):
    return torch.iinfo(to_torch(dtype))
