"""Eager Tensor: port of paddle_tpu/tensor.py.

A :class:`Tensor` holds one ``torch.Tensor`` (``_value``) and paddle's
autograd flags; **torch autograd is the tape.** The reference records a
jax VJP closure per op (``apply_op``) and caches jitted VJPs per op
signature; here every op is a torch call on the held values, torch's
autograd graph records it, and ``backward`` is ``torch.autograd.backward``.
Neither the tape nor the VJP cache has a counterpart.

Paddle semantics kept on top of torch:

* ``stop_gradient`` is the inverse of ``requires_grad``: True for a new
  tensor, False for a trainable :class:`Parameter`. An op's outputs have
  ``stop_gradient=False`` when grad is enabled and one of its inexact
  inputs has ``stop_gradient=False`` (integer outputs included, as in the
  reference; they carry no gradient).
* Gradients accumulate over ``backward`` calls until ``clear_grad``.
* ``backward()`` without ``retain_graph`` consumes every node it ran, as
  the reference drops them from its tape: each op output those nodes made
  becomes a leaf (``is_leaf``; a later backward stops there and fills its
  ``grad``), so a second ``backward`` from the same output, or from a new
  graph built on the consumed one, sends nothing through it, where torch
  would raise or, for nodes with no saved tensors, accumulate again. A
  graph built *before* the backward that consumed part of it cannot be
  cut so in torch: a backward from it raises (``autograd.backward``).
* In-place ops (``x.add_(y)``, ``x[i] = v``) rebind ``x`` to the new
  value, as the reference does; an in-place op on a leaf that requires
  grad raises.
* Dtypes are the reference's: 64-bit results fold to 32 bits
  (:mod:`.framework.dtype`).
"""
from __future__ import annotations

import weakref
from typing import Callable

import numpy as np
import torch

from .framework import dtype as _dtype
from .framework import place as _place

# grad mode is torch's: the tape switch and paddle's are one switch
no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


# metadata of a torch graph node: weak references to the Tensors it made
_MADE = "paddle_made"


def _inexact(v: torch.Tensor) -> bool:
    return v.is_floating_point() or v.is_complex()


def _fold(v):
    """An op's torch result in the dtype the reference holds."""
    if isinstance(v, torch.Tensor):
        to = _dtype._FOLD.get(v.dtype)
        return v if to is None else v.to(to)
    return v


_PRINT_OPTIONS = {"precision": 8, "threshold": 1000, "edgeitems": 3,
                  "linewidth": 80, "sci_mode": None}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Configure Tensor repr formatting (reference: to_string.py)."""
    for key, val in (("precision", precision), ("threshold", threshold),
                     ("edgeitems", edgeitems), ("sci_mode", sci_mode),
                     ("linewidth", linewidth)):
        if val is not None:
            _PRINT_OPTIONS[key] = val


# the ml_dtypes types numpy cannot hand to torch: crossed as raw bits
_RAW_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
             torch.float8_e5m2: torch.uint8}


def _to_numpy(v: torch.Tensor) -> np.ndarray:
    v = v.detach()
    if v.dtype in _RAW_BITS:
        return v.view(_RAW_BITS[v.dtype]).cpu().numpy().view(
            _dtype.from_torch(v.dtype))
    return v.cpu().numpy()


class Tensor:
    """Eager tensor wrapping a ``torch.Tensor``.

    ``stop_gradient`` defaults to True like the reference
    (``paddle/fluid/eager/autograd_meta.h``); Parameters flip it to False.
    """

    # let Tensor.__r*__ win over numpy array ops
    __array_priority__ = 100

    def __init__(self, value, stop_gradient: bool = True,
                 name: str | None = None):
        if isinstance(value, Tensor):
            value = value._value
        if not isinstance(value, torch.Tensor):
            value = to_tensor(value)._value
        self._value = value
        self._stop = True
        self.name = name or ""
        self.persistable = False
        self._hooks: list[Callable] = []
        self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, value: torch.Tensor, stop: bool) -> "Tensor":
        """An op's output: the value as torch made it, with paddle's flag
        (a non-differentiable output may carry ``stop_gradient=False``
        and no graph, as in the reference)."""
        t = cls.__new__(cls)
        t._value, t._stop, t.name, t.persistable = value, stop, "", False
        t._hooks = []
        return t

    # ---- autograd flags ----
    @property
    def stop_gradient(self) -> bool:
        return self._stop

    @stop_gradient.setter
    def stop_gradient(self, stop: bool):
        stop = bool(stop)
        self._stop = stop
        v = self._value
        if stop and v.requires_grad:
            self._value = self._detached(v, False)
        elif not stop and not v.requires_grad and _inexact(v) \
                and v.grad_fn is None:
            self._value = self._detached(v, True)

    @staticmethod
    def _detached(v, requires_grad: bool):
        """``v`` as a fresh alias with its own requires_grad (a shared
        value must not change under another Tensor); a leaf keeps its
        accumulated grad."""
        new = v.detach().requires_grad_(requires_grad)
        if v.grad_fn is None and v.grad is not None:
            new.grad = v.grad
        return new

    @property
    def grad(self):
        v = self._value
        if v.grad_fn is not None and not v.retains_grad:
            return None
        return None if v.grad is None else Tensor._wrap(v.grad, True)

    @grad.setter
    def grad(self, g):
        self._value.grad = None if g is None else _val(g)

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    # ---- basic properties ----
    @property
    def value(self) -> torch.Tensor:
        return self._value

    @property
    def shape(self) -> list[int]:
        return list(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.dim()

    @property
    def size(self) -> int:
        return self._value.numel()

    @property
    def dtype(self):
        return _dtype.from_torch(self._value.dtype)

    @property
    def place(self):
        dev = self._value.device
        if dev.type == "cuda":
            return _place.CUDAPlace(dev.index or 0)
        return _place.CPUPlace(0)

    @property
    def T(self):
        from .ops import manipulation
        return manipulation.t(self)

    # ---- conversion ----
    def numpy(self) -> np.ndarray:
        return _to_numpy(self._value)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype):
        from .ops import manipulation
        return manipulation.cast(self, dtype)

    cast = astype

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._value.detach(), True)

    def detach_(self) -> "Tensor":
        self._value = self._value.detach()
        self._stop = True
        return self

    def clone(self) -> "Tensor":
        from .ops import creation
        return creation.assign(self)

    def cpu(self) -> "Tensor":
        return Tensor._wrap(self._value.cpu(), self._stop)

    def cuda(self, device_id=None, blocking=True) -> "Tensor":
        dev = torch.device("cuda", device_id or 0)
        return Tensor._wrap(self._value.to(dev), self._stop)

    def to(self, *args, **kwargs):
        """Subset of paddle Tensor.to: dtype and/or device string."""
        out = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (_place.Place, torch.device)) or (
                    isinstance(a, str)
                    and a.split(":")[0] in ("cpu", "tpu", "gpu", "cuda")):
                dev = _place.place_device(a)
                out = Tensor._wrap(out._value.to(dev), out._stop)
            else:
                out = out.astype(a)
        return out

    # ---- autograd surface ----
    def retain_grads(self):
        if self._value.grad_fn is not None:
            self._value.retain_grad()

    def register_hook(self, hook: Callable):
        """Hook on the gradient flowing into this tensor (reference:
        eager/hooks.h tensor hooks): ``hook(grad)`` may return a
        replacement."""
        self._hooks.append(hook)
        handle = (self._value.register_hook(_torch_hook(self._hooks, hook))
                  if self._value.requires_grad else None)

        class _Remover:
            def remove(_self):
                if hook in self._hooks:
                    self._hooks.remove(hook)
                if handle is not None:
                    handle.remove()
        return _Remover()

    def _become_leaf(self):
        """The reference's view of an output whose producer a backward
        consumed: a leaf that requires grad, keeping its retained grad
        and its hooks."""
        v = self._value
        new = v.detach().requires_grad_(True)
        if v.retains_grad:
            new.grad = v.grad
        for hook in self._hooks:
            new.register_hook(_torch_hook(self._hooks, hook))
        self._value = new

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from .autograd import backward
        backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self._value.grad = None

    def clear_gradient(self, set_to_zero: bool = False):
        g = self._value.grad
        if set_to_zero and g is not None:
            g.zero_()
        else:
            self._value.grad = None

    # ---- value updates outside autograd (optimizer, loading) ----
    def copy_(self, other, blocking: bool = True):
        with torch.no_grad():
            self._value.copy_(_val(other))
        return self

    def set_value(self, value):
        src = _val(value) if isinstance(value, Tensor) else torch.as_tensor(
            np.asarray(value))
        with torch.no_grad():
            self._value.copy_(src.reshape(self._value.shape))
        return self

    def get_tensor(self):
        return self

    # ---- pickling: values cross as numpy, never with a graph ----
    def __getstate__(self):
        return {"value": self.numpy(), "stop_gradient": self._stop,
                "name": self.name, "persistable": self.persistable,
                "device": str(self._value.device)}

    def __setstate__(self, state):
        arr = state["value"]
        v = _from_numpy(arr).to(state.get("device", "cpu"))
        self._value, self._stop, self._hooks = v, True, []
        self.name = state["name"]
        self.persistable = state.get("persistable", False)
        self.stop_gradient = state["stop_gradient"]

    def __deepcopy__(self, memo):
        """A copy whose value is the deep copy of this one's under the same
        memo, so a copied Layer's torch registry and paddle registry keep
        holding one object."""
        import copy
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            new.__dict__[k] = copy.deepcopy(v, memo)
        return new

    # ---- repr ----
    def __repr__(self):
        data = np.array2string(self.numpy(), precision=_PRINT_OPTIONS[
            "precision"], threshold=_PRINT_OPTIONS["threshold"],
            edgeitems=_PRINT_OPTIONS["edgeitems"],
            max_line_width=_PRINT_OPTIONS["linewidth"])
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},"
                f"\n       {data})")

    __str__ = __repr__

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __bool__(self):
        return bool(self._value)

    def __int__(self):
        return int(self._value.reshape(()).item())

    def __float__(self):
        return float(self._value.reshape(()).item())

    def __index__(self):
        return int(self._value.reshape(()).item())

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return format(str(self), spec)

    def dim(self):
        return self.ndim

    def numel(self):
        return self.size

    def element_size(self):
        return self._value.element_size()

    # operators and methods: attached by the ops package, as the
    # reference's monkey_patch_tensor does


class Parameter(Tensor):
    """Trainable tensor (reference: paddle Parameter / EagerParamBase). Its
    value is a ``torch.nn.Parameter``, the object a ``Layer`` registers with
    torch; it keeps its identity for the parameter's life (updates are in
    place), so torch's registry and paddle's always agree."""

    _name_counter = 0

    def __init__(self, value, trainable: bool = True, name: str | None = None):
        if name is None:
            Parameter._name_counter += 1
            name = f"param_{Parameter._name_counter}"
        v = _val(value) if isinstance(value, Tensor) else value
        self._value = torch.nn.Parameter(v.detach(),
                                         requires_grad=bool(trainable)
                                         and _inexact(v))
        self._stop = not trainable
        self._hooks = []
        self.name = name
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False

    @property
    def stop_gradient(self) -> bool:
        return self._stop

    @stop_gradient.setter
    def stop_gradient(self, stop: bool):
        self._stop = bool(stop)
        self._value.requires_grad_(not self._stop and _inexact(self._value))

    @property
    def trainable(self) -> bool:
        return not self._stop

    @trainable.setter
    def trainable(self, value: bool):
        self.stop_gradient = not value

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

    def __getstate__(self):
        state = super().__getstate__()
        state["param_attrs"] = {
            "optimize_attr": self.optimize_attr,
            "regularizer": self.regularizer, "need_clip": self.need_clip,
            "is_distributed": self.is_distributed}
        return state

    def __setstate__(self, state):
        v = _from_numpy(state["value"]).to(state.get("device", "cpu"))
        Parameter.__init__(self, v, not state["stop_gradient"],
                           state["name"])
        for k, a in state.get("param_attrs", {}).items():
            setattr(self, k, a)


# --------------------------------------------------------------------------
# Op application
# --------------------------------------------------------------------------
def _val(x):
    return x._value if isinstance(x, Tensor) else x


def _unwrap(obj, found: list):
    """Replace Tensors in args by their values; ``found`` collects the
    Tensors met."""
    if isinstance(obj, Tensor):
        found.append(obj)
        return obj._value
    if isinstance(obj, (list, tuple)) and obj and any(
            isinstance(o, (Tensor, list, tuple)) for o in obj):
        out = [_unwrap(o, found) for o in obj]
        return out if isinstance(obj, list) else tuple(out)
    if isinstance(obj, dict):
        return {k: _unwrap(v, found) for k, v in obj.items()}
    return obj


def _torch_hook(hooks: list, hook: Callable):
    """``hook`` as a torch tensor hook, live while it is in ``hooks``."""
    def run(g):
        if hook not in hooks:
            return None
        res = hook(Tensor._wrap(g, True))
        return None if res is None else _val(res)
    return run


def _note_made(t: Tensor) -> Tensor:
    """Record ``t`` on the graph node that made it, so that a backward
    consuming the node can turn ``t`` into a leaf. Inside a compiled
    program (``jit.to_static``) nothing is recorded: the program's outputs
    are recorded on its node when it returns."""
    if torch.compiler.is_compiling():
        return t
    fn = t._value.grad_fn
    if fn is not None:
        fn.metadata.setdefault(_MADE, []).append(weakref.ref(t))
    return t


def _wrap_out(out, stop: bool):
    if isinstance(out, torch.Tensor):
        t = Tensor._wrap(_fold(out), stop)
        return t if stop else _note_made(t)
    if isinstance(out, (list, tuple)):
        wrapped = [_wrap_out(o, stop) for o in out]
        return wrapped if isinstance(out, list) else tuple(wrapped)
    return out


# the AMP dispatch hook, ``(name, args, kwargs) -> (args, kwargs)``; the
# amp package installs it on import (reference: apply_op's AMP block)
_autocast_hook = None

# observers called with (op_name, output values) after every dispatch;
# used by amp.debugging's operator stats and tensor checker
_dispatch_observers: list = []


def _notify_observers(name, out):
    leaves = []

    def walk(o):
        if isinstance(o, Tensor):
            leaves.append(o._value)
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
        else:
            leaves.append(o)
    walk(out)
    for obs in _dispatch_observers:
        obs(name, leaves)


def apply_op(name: str, fn: Callable, *args, **kwargs):
    """Run ``fn`` (a function of torch tensors) on Tensor args and wrap its
    results. Torch's autograd records the graph; this only sets paddle's
    ``stop_gradient`` on the outputs: False when grad is enabled and an
    inexact input has ``stop_gradient=False``. Under ``amp.auto_cast`` the
    inputs are cast first, by the reference's lists; the observers of
    ``amp.debugging`` see every op's outputs."""
    if _autocast_hook is not None:
        args, kwargs = _autocast_hook(name, args, kwargs)
    found: list[Tensor] = []
    a = _unwrap(args, found)
    kw = _unwrap(kwargs, found)
    record = torch.is_grad_enabled() and any(
        not t._stop and _inexact(t._value) for t in found)
    out = _wrap_out(fn(*a, **kw), not record)
    if _dispatch_observers:
        _notify_observers(name, out)
    return out


def def_op(name: str):
    """Decorator: turn a function of torch tensors into an eager Tensor
    op."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return apply_op(name, fn, *args, **kwargs)

        wrapper.raw = fn
        return wrapper
    return deco


def rebind_inplace(x: Tensor, out: Tensor) -> Tensor:
    """Make ``x`` take over ``out``'s value and its place in the graph (an
    in-place op computed out of place). In place on a leaf that requires
    grad is an error, as in the reference."""
    if (x.is_leaf and not x.stop_gradient and _inexact(x._value)
            and torch.is_grad_enabled()):
        raise RuntimeError(
            "a leaf Tensor that requires grad cannot be used in an "
            "in-place operation (reference semantics); use the "
            "out-of-place op, or x.detach() first")
    if isinstance(x, Parameter):
        with torch.no_grad():
            x._value.copy_(out._value)
        return x
    x._value = out._value
    # a leaf rebound under no_grad keeps requiring grad, as it did
    x.stop_gradient = out._stop and x._stop
    return _note_made(x)


# --------------------------------------------------------------------------
# to_tensor and helpers
# --------------------------------------------------------------------------
def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)   # writable and contiguous, as torch wants it
    tt = _dtype._TO_TORCH.get(arr.dtype.name)
    if tt in _RAW_BITS:
        bits = _RAW_BITS[tt]
        return torch.from_numpy(arr.view(_dtype.from_torch(bits))).view(tt)
    return torch.from_numpy(arr)


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> Tensor:
    """paddle.to_tensor with the reference's dtype rules: float64 data
    becomes the default float dtype, int64 becomes int32; on ``place``
    (default: the current place)."""
    dev = _place.place_device(place)
    if isinstance(data, Tensor):
        v = data._value.detach().clone()
        if dtype is not None:
            v = v.to(_dtype.to_torch(dtype))
        t = Tensor(v.to(dev) if place is not None else v,
                   stop_gradient=stop_gradient)
        t.name = data.name
        return t
    if isinstance(data, torch.Tensor):
        v = data.detach().to(dev)
        v = v.to(_dtype.to_torch(dtype)) if dtype is not None else _fold(v)
        return Tensor(v, stop_gradient=stop_gradient)
    arr = np.asarray(data)
    if dtype is not None:
        target = _dtype.convert_dtype(dtype)
    elif arr.dtype == np.float64:
        target = _dtype.get_default_dtype()
    else:
        target = _dtype.convert_dtype(arr.dtype)
    tt = _dtype.to_torch(target)
    if str(target) in ("bfloat16", "float8_e4m3fn", "float8_e5m2") \
            and arr.dtype.name != str(target):
        v = torch.from_numpy(np.array(arr, np.float32)).to(dev).to(tt)
    else:
        v = _from_numpy(arr.astype(target)).to(dev)
    return Tensor(v, stop_gradient=stop_gradient)


def unwrap(x):
    """Tensor -> torch.Tensor, through lists, tuples and dicts."""
    return _unwrap(x, [])


def wrap(x, stop_gradient=True):
    """torch.Tensor -> Tensor, through lists and tuples."""
    return _wrap_out(x, stop_gradient)
