"""paddle.static: port of paddle_tpu/static/__init__.py — the static-graph
compatibility surface.

Reference: the ProgramDesc/Executor static graph. As in the reference there
is no separate graph-building mode: a "static" program is a compiled
function (``jit.to_static`` on ``torch.compile``). The module keeps the
entry points so static-style scripts run: ``enable_static`` flips a flag,
``Executor.run`` evaluates its fetch targets (callables or Tensors), and
``save_inference_model`` / ``load_inference_model`` go through
``jit.save`` / ``jit.load`` (a ``torch.export`` program). ``cuda_places``
names the card.
"""
from __future__ import annotations

from ..jit import InputSpec, load as _jit_load, save as _jit_save
from ..tensor import Tensor

_static_mode = False


def enable_static():
    global _static_mode
    _static_mode = True


def disable_static(place=None):
    global _static_mode
    _static_mode = False


def _in_static_mode():
    return _static_mode


def in_dynamic_mode():
    return not _static_mode


class Program:
    """Minimal Program facade: holds captured callables (the real program
    is the compiled graph ``jit`` owns)."""

    def __init__(self):
        self._fns = []
        self.random_seed = None

    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


_main_program = Program()
_startup_program = Program()


class program_guard:
    def __init__(self, main_program=None, startup_program=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def data(name, shape, dtype="float32", lod_level=0):
    return InputSpec(shape, dtype, name)


class Executor:
    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, **kwargs):
        # Static-style execution degenerates to eager evaluation of the
        # fetch targets, which in this framework are callables or Tensors.
        outs = []
        for f in (fetch_list or []):
            if callable(f):
                outs.append(f(**(feed or {})))
            elif isinstance(f, Tensor):
                outs.append(f.numpy())
            else:
                outs.append(f)
        return outs


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    layer = kwargs.get("layer")
    if layer is None:
        raise NotImplementedError(
            "save_inference_model requires layer=; or use "
            "paddle_tpu_torch.jit.save(layer, path, input_spec=...)")
    _jit_save(layer, path_prefix, input_spec=feed_vars)


def load_inference_model(path_prefix, executor=None, **kwargs):
    layer = _jit_load(path_prefix, device=kwargs.get("device"))
    return layer, [], []


def name_scope(prefix=None):
    import contextlib
    return contextlib.nullcontext()


class InputSpec_(InputSpec):
    pass


# amp for static graph maps onto the same dynamic amp machinery
from .. import amp as amp  # noqa: E402,F401
from . import nn  # noqa: E402,F401


# ---------------------------------------------------------------------------
# the rest of the reference's __all__: scope/vars, program state I/O,
# autodiff, metrics, places, guards, strategy shells, EMA, py_func. A
# "program" is a captured callable and its parameter state; scope vars are
# host arrays.
# ---------------------------------------------------------------------------
import contextlib as _ctx
import pickle as _pickle

import numpy as _np

Variable = Tensor   # reference static.Variable ≈ the tensor handle


# ---- scope ----------------------------------------------------------------

class _ScopeVar:
    def __init__(self):
        self._val = None

    def get_tensor(self):
        return self._val

    def set(self, value, place=None):
        self._val = _np.asarray(value)


class Scope:
    """Name -> variable store (reference: framework/scope.h)."""

    def __init__(self):
        self._vars = {}

    def var(self, name):
        return self._vars.setdefault(name, _ScopeVar())

    def find_var(self, name):
        return self._vars.get(name)


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    return _scope_stack[-1]


@_ctx.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


# ---- parameters / globals -------------------------------------------------

def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """Trainable parameter registered in the current scope (reference:
    static.create_parameter)."""
    from ..framework.dtype import convert_dtype
    from ..nn.initializer import XavierUniform
    init = default_initializer or XavierUniform()
    val = init(tuple(shape), convert_dtype(dtype))
    t = Tensor(val, stop_gradient=False)
    if name:
        global_scope().var(name).set(_np.asarray(t.numpy()))
    return t


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..ops.creation import full
    t = full(list(shape), value, dtype)
    if name:
        global_scope().var(name).set(_np.asarray(t.numpy()))
    return t


class WeightNormParamAttr:
    """Config shell (reference: static.WeightNormParamAttr) — weight
    normalization itself lives in nn.utils.weight_norm."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim, self.name = dim, name
        self.initializer = initializer
        self.trainable = trainable


# ---- autodiff -----------------------------------------------------------

def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of targets w.r.t. inputs (reference: static.gradients over
    the program; here: the eager autograd graph, same result)."""
    from ..autograd import grad as _grad
    outs = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return _grad(list(outs), list(ins), grad_outputs=target_gradients,
                 retain_graph=True, allow_unused=True)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Reference: static.append_backward returns (param, grad) pairs — all
    the trainable leaves when parameter_list is omitted. Here: one
    backward, then the leaves are read off torch's graph from ``loss``
    (each as a Tensor over the leaf's value)."""
    leaves, seen = [], set()
    fn = loss._value.grad_fn
    stack = [fn] if fn is not None else []
    while stack:
        node = stack.pop()
        for nxt, _ in node.next_functions:
            if nxt is None or nxt in seen:
                continue
            seen.add(nxt)
            if hasattr(nxt, "variable"):
                leaves.append(Tensor._wrap(nxt.variable, False))
            else:
                stack.append(nxt)
    loss.backward(retain_graph=True)
    if parameter_list is not None:
        return [(p, p.grad) for p in parameter_list]
    return [(p, p.grad) for p in leaves]


# ---- program state I/O ----------------------------------------------------

def _program_state(program):
    layer = getattr(program, "_layer", None)
    if layer is None:
        return {k: v.get_tensor() for k, v in
                global_scope()._vars.items()
                if v.get_tensor() is not None}
    return {k: _np.asarray(v.numpy())
            for k, v in layer.state_dict().items()}


def serialize_program(feed_vars=None, fetch_vars=None, program=None,
                      **kwargs):
    prog = program or default_main_program()
    return _pickle.dumps({"kind": "paddle_tpu.static.program",
                          "state": _program_state(prog)})


def deserialize_program(data):
    payload = _pickle.loads(data)
    prog = Program()
    prog._state = payload["state"]
    return prog


def serialize_persistables(feed_vars=None, fetch_vars=None, program=None,
                           **kwargs):
    prog = program or default_main_program()
    return _pickle.dumps(_program_state(prog))


def deserialize_persistables(program, data, executor=None):
    state = _pickle.loads(data)
    set_program_state(program, state)
    return program


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def save(program, model_prefix, protocol=4):
    """Persist program state (reference: static.save -> .pdparams)."""
    save_to_file(model_prefix + ".pdparams",
                 _pickle.dumps(_program_state(program), protocol=protocol))


def load(program, model_prefix, executor=None, var_list=None):
    state = _pickle.loads(load_from_file(model_prefix + ".pdparams"))
    set_program_state(program, state)


def load_program_state(model_prefix, var_list=None):
    return _pickle.loads(load_from_file(model_prefix + ".pdparams"))


def set_program_state(program, state_dict):
    layer = getattr(program, "_layer", None)
    if layer is not None:
        layer.set_state_dict(state_dict)
        return
    for k, v in state_dict.items():
        global_scope().var(k).set(v)


def normalize_program(program, feed_vars=None, fetch_vars=None, **kwargs):
    """Reference: prunes/normalizes a ProgramDesc for inference. Compiled
    programs are already minimal (the compiler drops unused ops), so this
    is the identity with arg validation."""
    if program is None:
        raise TypeError("program must not be None")
    return program


# ---- metrics --------------------------------------------------------------

def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of a batch (reference: static.accuracy)."""
    from ..ops.search import argsort
    topk = argsort(input, axis=-1, descending=True)
    lbl = label.reshape([-1, 1])
    hits = (topk[:, :k] == lbl).astype("float32").sum(axis=-1)
    return hits.mean()


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Batch AUC (reference: static.auc). Returns the same leading value
    (auc scalar); the stat arrays of the reference are internal here."""
    from ..metric import Auc
    m = Auc(num_thresholds=num_thresholds)
    m.update(_np.asarray(input.numpy()), _np.asarray(label.numpy()))
    return Tensor(_np.asarray(m.accumulate(), _np.float32))


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """CTR eval bundle (reference: static.ctr_metric_bundle): returns
    (auc, batch_auc) equivalents."""
    a = auc(input, label)
    return a, a


# ---- places / guards ------------------------------------------------------

def cpu_places(device_count=None):
    from ..framework.place import CPUPlace
    n = device_count or 1
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """The CUDA cards (all of them unless ``device_ids`` names some)."""
    import torch
    from ..framework.place import CUDAPlace
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_places: no CUDA device is available")
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def xpu_places(device_ids=None):
    raise RuntimeError("xpu_places: this build has no XPU devices")


@_ctx.contextmanager
def device_guard(device=None):
    """Reference: pins following ops to a device inside a program. Here
    tensors go to the current place, so the guard is a documented no-op
    kept for script parity."""
    yield


@_ctx.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    """IPU pipeline-shard annotation (reference: static.ipu_shard_guard);
    accepted and ignored so IPU-annotated scripts still run."""
    yield


def set_ipu_shard(call_func, index=-1, stage=-1):
    return call_func


class BuildStrategy:
    """Config shell (reference: BuildStrategy pass toggles). The compiler
    makes these decisions; attributes are accepted and recorded."""

    def __init__(self):
        self.__dict__["_opts"] = {}

    def __setattr__(self, k, v):
        self._opts[k] = v

    def __getattr__(self, k):
        try:
            return self.__dict__["_opts"][k]
        except KeyError:
            return None


class ExecutionStrategy(BuildStrategy):
    pass


class IpuStrategy(BuildStrategy):
    pass


class CompiledProgram:
    """Reference: CompiledProgram(graph, build_strategy). The compiled
    graph of ``jit`` is the real compiled program; this wrapper keeps the
    API and delegates to the wrapped program."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy

    def __getattr__(self, k):
        return getattr(self._program, k)


class IpuCompiledProgram(CompiledProgram):
    def __init__(self, program=None, scope=None, ipu_strategy=None):
        super().__init__(program)
        self._ipu_strategy = ipu_strategy

    def compile(self, feed_list=None, fetch_list=None):
        return self._program


# ---- EMA ------------------------------------------------------------------

class ExponentialMovingAverage:
    """EMA over parameters with bias correction and apply/restore
    (reference: static.ExponentialMovingAverage — shadow vars updated as
    ema = decay*ema + (1-decay)*param, applied under a context)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}
        self._step = 0
        self._params = []

    def register(self, parameters):
        """Shadow starts at ZERO; apply() divides by 1 - decay**t (the
        standard bias correction — matching the reference, whose
        ema_accum starts empty)."""
        self._params = list(parameters)
        for i, p in enumerate(self._params):
            self._shadow[i] = _np.zeros_like(_np.asarray(p.numpy()))

    def update(self, parameters=None):
        if parameters is not None and not self._params:
            self.register(parameters)
        self._step += 1
        d = self._decay
        for i, p in enumerate(self._params):
            self._shadow[i] = d * self._shadow[i] \
                + (1 - d) * _np.asarray(p.numpy())

    @_ctx.contextmanager
    def apply(self, executor=None, need_restore=True):
        """The bias-corrected averages written into the parameters (in
        place: a Parameter keeps its value object)."""
        corr = 1 - self._decay ** max(self._step, 1)
        for i, p in enumerate(self._params):
            self._backup[i] = _np.asarray(p.numpy()).copy()
            p.set_value((self._shadow[i] / corr).astype(
                self._backup[i].dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        for i, p in enumerate(self._params):
            if i in self._backup:
                p.set_value(self._backup[i])
        self._backup = {}


# ---- misc ops -------------------------------------------------------------

def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Debug print pass-through (reference: static.Print op). Eagerly
    prints and returns the input unchanged."""
    msg = message or ""
    v = _np.asarray(input.numpy())
    print(f"{msg} Tensor(shape={list(v.shape)}, dtype={v.dtype})\n"
          f"{_np.array2string(v.reshape(-1)[:summarize])}")
    return input


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Embed a host python function as an op (reference: static.py_func
    over PyFuncOp). Without backward_func the result is a constant (the
    reference registers no grad op either); with backward_func the pair
    is recorded as a PyLayer whose backward calls it."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    if backward_func is None:
        vals = [_np.asarray(t.numpy()) for t in xs]
        res = func(*vals)
        res_list = res if isinstance(res, (list, tuple)) else [res]
        outs = [Tensor(_np.asarray(r), stop_gradient=True)
                for r in res_list]
        return outs if len(outs) > 1 else outs[0]

    from ..autograd import PyLayer

    class _PyFunc(PyLayer):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            res = func(*[_np.asarray(a.numpy()) for a in args])
            return Tensor(_np.asarray(res), stop_gradient=False)

        @staticmethod
        def backward(ctx, grad):
            saved = ctx.saved_tensor
            gs = backward_func(
                *[_np.asarray(s.numpy()) for s in saved],
                _np.asarray(grad.numpy()))
            gs_list = gs if isinstance(gs, (list, tuple)) else [gs]
            outs = tuple(Tensor(_np.asarray(g)) for g in gs_list)
            return outs if len(outs) > 1 else outs[0]

    return _PyFunc.apply(*xs)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """Reference semantics: lr = learning_rate * decay_rate**(step /
    decay_steps), with the exponent floored when ``staircase``. Returns
    the dygraph-unified schedule object."""
    from ..optimizer.lr import LambdaDecay

    def factor(step):
        e = step / float(decay_steps)
        if staircase:
            e = float(int(e))
        return decay_rate ** e

    return LambdaDecay(learning_rate=learning_rate, lr_lambda=factor)
