"""Automatic mixed precision: port of paddle_tpu/amp/__init__.py.

``auto_cast`` installs a thread-local policy that the eager dispatch
point (``tensor.apply_op``) reads, with the reference's op lists
(:mod:`.amp_lists`), not ``torch.autocast``'s: the inputs of a white-list
op cast from f32 to the amp dtype, the inputs of a black-list op from
bf16/f16 back to f32 (O2: every op not on the black list casts down), and
the custom lists win over both. Each cast is itself an op (``amp_cast``)
that autograd records, so its gradient casts back. ``decorate(level=
"O2")`` casts the parameters in place; ``master_weight=True`` turns on the
optimizer's ``multi_precision`` (f32 master weights). :class:`GradScaler`
is the dynamic loss scaler float16 needs; with bfloat16 it is rarely
needed, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..framework.dtype import convert_dtype, to_torch
from .. import tensor as _tensor
from . import amp_lists
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.custom_white_list = set()
        self.custom_black_list = set()


_state = _AmpState()


def amp_state():
    return _state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast."""
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white_list, _state.custom_black_list)
    _state.enabled = enable
    _state.dtype = dtype
    _state.level = level
    _state.custom_white_list = set(custom_white_list or ())
    _state.custom_black_list = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white_list, _state.custom_black_list) = prev


amp_guard = auto_cast


def should_cast(op_name: str) -> bool:
    if not _state.enabled:
        return False
    if op_name in _state.custom_black_list:
        return False
    if op_name in _state.custom_white_list:
        return True
    if _state.level == "O2":
        return op_name not in amp_lists.BLACK_LIST
    return op_name in amp_lists.WHITE_LIST


def amp_dtype():
    """The amp dtype as a torch dtype."""
    return to_torch(_state.dtype)



def _amp_cast(t, dtype):
    """Gradient-recorded dtype cast, the reference's ``amp_cast`` op."""
    return _tensor.apply_op("amp_cast", lambda v: v.to(dtype), t)


def _map_tensors(obj, fn):
    if isinstance(obj, _tensor.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        out = [_map_tensors(o, fn) for o in obj]
        return out if isinstance(obj, list) else tuple(out)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def _autocast(name, args, kwargs):
    """The dispatch hook (reference ``tensor.apply_op``'s AMP block): the
    op's Tensor inputs cast by the active policy; (args, kwargs) as they
    were when nothing casts."""
    if not _state.enabled or name == "amp_cast":
        return args, kwargs
    if should_cast(name):
        low = amp_dtype()

        def cast(t):
            return _amp_cast(t, low) if t._value.dtype == torch.float32 \
                else t
    elif name in amp_lists.BLACK_LIST:
        def cast(t):
            return _amp_cast(t, torch.float32) if t._value.dtype in (
                torch.bfloat16, torch.float16) else t
    else:
        return args, kwargs
    return _map_tensors(args, cast), _map_tensors(kwargs, cast)


_tensor._autocast_hook = _autocast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate — O2 casts the floating parameters to the low
    dtype in place (each keeps its identity); ``master_weight`` (default
    on for O2) keeps f32 master weights in the optimizers."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        d = to_torch(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p._value.is_floating_point():
                        p._value.data = p._value.data.to(d)
                for layer in m.sublayers(include_self=True):
                    layer._dtype = convert_dtype(dtype)
    if optimizers is None:
        return models
    if level == "O2" and master_weight is not False:
        opts = optimizers if isinstance(optimizers, (list, tuple)) \
            else [optimizers]
        for opt in opts:
            opt._multi_precision = True
    return models, optimizers


def is_bfloat16_supported(place=None) -> bool:
    return True


def is_float16_supported(place=None) -> bool:
    return True


from . import debugging  # noqa: E402
from .debugging import (  # noqa: E402,F401
    DebugMode, TensorCheckerConfig, check_numerics, collect_operator_stats,
    compare_accuracy, disable_operator_stats_collection,
    disable_tensor_checker, enable_operator_stats_collection,
    enable_tensor_checker)

debugging_check_numerics = check_numerics
