"""paddle.jit: port of paddle_tpu/jit/__init__.py — the compile boundary.

``to_static`` compiles with ``torch.compile`` where the reference jits with
jax: one graph per (input shapes, train/eval, grad mode, amp policy),
``full_graph=True`` (the default) as ``fullgraph=True``, so a graph break
raises instead of splitting the program. ``backend`` is torch's (None is
inductor; the CPU tests pass ``"aot_eager"``). Training goes through the
compiled graph's own backward (AOTAutograd) into the parameters' grads.
The kernels are ``torch.library`` custom ops, so a compiled graph holds
each launch as one node and counts it when it runs. Each call draws a
fresh seed on the host and passes its threefry key into the program as a
tensor (the reference passes a seed into every compiled call), so dropout
masks differ from call to call without a recompile.

``save`` writes ``path.pdparams`` (the state dict), ``path.pdmodel`` (a
``torch.export`` program of the eval forward, ``torch.export.save``) and
``path.pdmeta``; ``None``/``-1`` dims of an ``InputSpec`` export as
``torch.export.Dim``s. ``load`` returns a :class:`TranslatedLayer` that
runs the program on the card (``device="cpu"`` asks for the CPU).
"""
from __future__ import annotations

import os
import pickle
import time
import warnings

import torch

from ..framework import place as _place
from ..framework import prng
from ..framework import random as _random
from ..framework.dtype import convert_dtype, to_torch
from ..nn.layer import Layer
from ..tensor import Tensor, _wrap_out, no_grad, unwrap
from .functional import (collect_state, make_pure_callable,  # noqa: F401
                         make_pure_fn, swap_state)

__all__ = ["to_static", "not_to_static", "InputSpec", "StaticFunction",
           "save", "load", "TranslatedLayer", "enable_to_static",
           "set_code_level", "set_verbosity"]

_to_static_enabled = True


def enable_to_static(flag: bool):
    global _to_static_enabled
    _to_static_enabled = bool(flag)


class InputSpec:
    """Reference: python/paddle/static/input.py InputSpec."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=False):
        self.shape = list(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def _wrap_arg(v):
    """A compiled program's torch input as the eager Tensor the Python
    code expects (``stop_gradient`` from ``requires_grad``)."""
    if isinstance(v, torch.Tensor):
        return Tensor._wrap(v, not v.requires_grad)
    if isinstance(v, (list, tuple)):
        out = [_wrap_arg(x) for x in v]
        return out if isinstance(v, list) else tuple(out)
    if isinstance(v, dict):
        return {k: _wrap_arg(x) for k, x in v.items()}
    return v


def _wrap_result(v):
    """A compiled program's outputs as Tensors, each recorded as made by
    its graph node."""
    if isinstance(v, torch.Tensor):
        return _wrap_out(v, not v.requires_grad)
    if isinstance(v, (list, tuple)):
        out = [_wrap_result(x) for x in v]
        return out if isinstance(v, list) else tuple(out)
    if isinstance(v, dict):
        return {k: _wrap_result(x) for k, x in v.items()}
    return v


def _key_device(layer, arg_vals):
    for v in torch.utils._pytree.tree_leaves(arg_vals):
        if isinstance(v, torch.Tensor):
            return v.device
    if layer is not None:
        for p in layer.parameters():
            return p._value.device
    return _place.current_device()


class StaticFunction:
    """A Layer's forward or a function compiled by ``torch.compile``
    (reference: dy2static/program_translator.py:305). ``compiles`` counts
    the graphs compiled and ``compile_seconds`` the wall time of each call
    that compiled one."""

    def __init__(self, function, layer=None, input_spec=None,
                 build_strategy=None, backend=None, full_graph=True):
        self._function = function
        self._layer = layer
        self._input_spec = input_spec
        self._backend = backend or "inductor"
        self._full_graph = bool(full_graph)
        self._compiled = None
        self.compiles = 0
        self.compile_seconds: list[float] = []

    @property
    def _is_method(self):
        return self._layer is not None

    def _body(self, key, arg_vals, kw_vals):
        """The compiled program: the Python forward on Tensor wrappers of
        its inputs, under the call's PRNG key."""
        args, kwargs = _wrap_arg(arg_vals), _wrap_arg(kw_vals)
        with _random.trace_rng(key):
            if self._layer is not None:
                out = self._function(self._layer, *args, **kwargs)
            else:
                out = self._function(*args, **kwargs)
        return unwrap(out)

    def _backend_fn(self):
        from torch._dynamo import lookup_backend
        inner = lookup_backend(self._backend)

        def backend(gm, example_inputs):
            self.compiles += 1
            return inner(gm, example_inputs)
        return backend

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled:
            if self._layer is not None:
                return self._function(self._layer, *args, **kwargs)
            return self._function(*args, **kwargs)
        if self._compiled is None:
            self._compiled = torch.compile(
                self._body, backend=self._backend_fn(),
                fullgraph=self._full_graph, dynamic=False)
        arg_vals, kw_vals = unwrap(args), unwrap(kwargs)
        seed = _random.default_generator().next_seed()
        key = torch.tensor(prng.PRNGKey(seed), dtype=torch.int64,
                           device=_key_device(self._layer, arg_vals))
        n0, t0 = self.compiles, time.perf_counter()
        out = self._compiled(key, arg_vals, kw_vals)
        if self.compiles != n0:
            self.compile_seconds.append(time.perf_counter() - t0)
        return _wrap_result(out)

    # paddle API surface
    @property
    def code(self):
        import inspect
        return inspect.getsource(self._function)

    def concrete_program_specify_input_spec(self, *a, **k):
        return None

    def get_concrete_program(self, *a, **k):
        return None, None


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """paddle.jit.to_static — decorator or wrapper (reference:
    jit/api.py:233). A Layer's ``forward`` becomes the compiled one; its
    :class:`StaticFunction` is ``layer._static_function``."""

    def decorate(fn_or_layer):
        if isinstance(fn_or_layer, Layer):
            layer = fn_or_layer
            static_fn = StaticFunction(type(layer).forward, layer,
                                       input_spec, build_strategy, backend,
                                       full_graph)
            object.__setattr__(layer, "forward",
                               lambda *a, **kw: static_fn(*a, **kw))
            object.__setattr__(layer, "_static_function", static_fn)
            return layer
        return StaticFunction(fn_or_layer, None, input_spec, build_strategy,
                              backend, full_graph)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


# --------------------------------------------------------------------------
# save / load: a torch.export program (reference: jit.save -> StableHLO)
# --------------------------------------------------------------------------
class _EvalForward(torch.nn.Module):
    """The layer's eval forward as a module of raw tensors, the layer a
    submodule, so its parameters and buffers become the program's state:
    the paddle wrappers read the tensors torch's registry holds during
    the trace (``torch.export`` swaps those; a wrapper's own reference
    would be captured as a second, constant copy). Draws use the fixed
    key of seed 0, as the reference's export does."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *arg_vals):
        layer = self.layer
        params = dict(torch.nn.Module.named_parameters(layer, recurse=True))
        buffers = dict(torch.nn.Module.named_buffers(layer, recurse=True))
        with swap_state(layer, params, buffers), no_grad(), \
                _random.trace_rng(prng.PRNGKey(0)):
            out = type(layer).forward(layer, *_wrap_arg(arg_vals))
        return unwrap(out)


def _is_symbolic_shape_error(err) -> bool:
    """Only shape and symbolic-constraint failures earn the unified-
    symbol retry; anything else surfaces as it is."""
    from torch._dynamo.exc import UserError
    from torch.fx.experimental.symbolic_shapes import (
        ConstraintViolationError, GuardOnDataDependentSymNode)
    if isinstance(err, (UserError, ConstraintViolationError,
                        GuardOnDataDependentSymNode)):
        return True
    if not isinstance(err, (TypeError, ValueError, RuntimeError)):
        return False
    msg = str(err).lower()
    return any(k in msg for k in ("shape", "dimension", "symbolic",
                                  "constraint", "specializ"))


def save(layer, path, input_spec=None, **configs):
    """Write ``path.pdparams``, ``path.pdmodel`` (``torch.export`` of the
    eval forward) and ``path.pdmeta``. ``None``/``-1`` dims export as
    ``torch.export.Dim``s, one per (input, axis); when that export meets
    a shape constraint (inputs combined over a shared dynamic dim), the
    export is retried with one Dim per axis index, as the reference
    retries with one symbol per axis index."""
    from ..framework.io_state import save as state_save
    if configs.get("pjrt_artifacts", False):
        raise NotImplementedError(
            "jit.save(pjrt_artifacts=True): the Python-free C serving path "
            "(the reference's capi/pjrt_serving.cc) is not ported yet")
    if input_spec is None:
        raise ValueError("jit.save requires input_spec to export the program")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(layer, StaticFunction):
        layer = layer._layer
    state_save(layer.state_dict(), path + ".pdparams")
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]
    params = list(layer.parameters())
    device = params[0]._value.device if params else _place.current_device()
    # a dynamic dim's example size: 2 (torch.export specializes 0 and 1)
    examples = tuple(
        torch.zeros([2 if d is None or d == -1 else int(d) for d in s.shape],
                    dtype=to_torch(s.dtype), device=device) for s in specs)

    def dims(unify_by_axis):
        out, dynamic = [], False
        for i, s in enumerate(specs):
            spec = {}
            for j, d in enumerate(s.shape):
                if d is None or d == -1:
                    dynamic = True
                    name = f"_dyn{j}" if unify_by_axis else f"_dyn{i}_{j}"
                    spec[j] = torch.export.Dim(name)
            out.append(spec or None)
        return tuple(out), dynamic

    was_training = layer.training
    layer.eval()
    module = _EvalForward(layer)
    shapes, dynamic = dims(False)
    try:
        try:
            program = torch.export.export(
                module, examples,
                dynamic_shapes={"arg_vals": shapes} if dynamic else None,
                strict=False)
        except Exception as e:  # noqa: BLE001 — classified, narrow re-raise
            if not dynamic or not _is_symbolic_shape_error(e):
                raise
            warnings.warn(
                "jit.save: export with independent dynamic dims hit a shape "
                f"constraint ({type(e).__name__}: {str(e)[:120]}); "
                "retrying with one shared Dim per axis index", stacklevel=2)
            try:
                program = torch.export.export(
                    module, examples, dynamic_shapes={"arg_vals": dims(True)[0]},
                    strict=False)
            except Exception as e2:  # noqa: BLE001 — classified again
                if not _is_symbolic_shape_error(e2):
                    raise
                raise ValueError(
                    "jit.save could not export with dynamic input_spec dims "
                    "(tried independent Dims, then one shared Dim per axis "
                    f"index). Original error: {e}. If the model needs "
                    "related-but-unequal dynamic dims, export with concrete "
                    "shapes.") from e
    finally:
        if was_training:
            layer.train()
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(program, f)
    meta = {"input_specs": [(s.shape, str(s.dtype), s.name) for s in specs],
            "device": str(device)}
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f)


def load_program(path, device=None):
    """The saved program of ``path`` as a callable module on ``device``
    (default: the current place, the card unless ``set_device`` chose
    the CPU), and its meta."""
    dev = _place.place_device(device)
    meta = {}
    if os.path.exists(path + ".pdmeta"):
        with open(path + ".pdmeta", "rb") as f:
            meta = pickle.load(f)
    with open(path + ".pdmodel", "rb") as f:
        program = torch.export.load(f)
    if str(dev) != meta.get("device", str(dev)):
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    return program.module(), meta


class TranslatedLayer(Layer):
    """Runs a loaded ``torch.export`` program (reference:
    jit/translated_layer.py)."""

    def __init__(self, module, meta):
        super().__init__()
        # not a sublayer: the program's weights are its own state
        object.__setattr__(self, "_program", module)
        self._meta = meta

    def forward(self, *args):
        with no_grad():
            out = self._program(*unwrap(args))
        return _wrap_result(out)


def load(path, device=None, **configs):
    return TranslatedLayer(*load_program(path, device))


# dy2static logging toggles (reference: jit/dy2static/logging_utils.py);
# dynamo traces the Python itself, so they gate nothing here
_verbosity = 0
_code_level = 0


def set_verbosity(level=0, also_to_stdout=False):
    global _verbosity
    _verbosity = int(level)


def set_code_level(level=100, also_to_stdout=False):
    global _code_level
    _code_level = int(level)
