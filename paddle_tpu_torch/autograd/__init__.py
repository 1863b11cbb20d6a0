"""Autograd public API: port of paddle_tpu/autograd/__init__.py.

Reference surface: ``python/paddle/autograd/`` — ``paddle.grad``,
``PyLayer``, ``saved_tensors_hooks``; the engine in ``paddle/fluid/eager/``.
torch's autograd engine is the port's tape walk, so ``backward`` and
``grad`` map onto ``torch.autograd.backward`` / ``torch.autograd.grad``,
:class:`PyLayer` onto ``torch.autograd.Function`` and
:class:`saved_tensors_hooks` onto torch's. The reference's
``backward_engine.py`` (a reverse walk over its tape list) has no
counterpart: torch's engine does that walk. ``autograd/functional.py``
has vjp, jvp, jacobian and hessian.

A backward without ``retain_graph`` consumes what it ran, as the
reference's walk drops every tape node it used: each node of the graph is
marked, and each Tensor such a node made becomes a leaf
(:meth:`Tensor._become_leaf`). So a later backward from a new output
built on those Tensors stops at them, fills their ``grad`` and leaves the
gradients behind them as they were, as in the reference. A graph built
before the consuming backward still reaches the consumed nodes: the walk
stops there, the gradient that arrives at each such node is captured
(``torch.autograd.grad`` at its ``GradientEdge``, which runs no node
behind it) and accumulated into the Tensors it made, and the leaves are
filled by torch's engine with ``inputs=`` limited to those a live path
reaches. A leaf reachable both ways makes torch run the consumed node
again, its incoming gradient zeroed by a pre-hook, so it adds nothing;
for that the node must still hold its saved tensors. So a backward keeps
them (torch's ``retain_graph=True``) when a node it runs has a user
outside its graph: every op's output node records the made nodes its
graph uses (``tensor._note_uses``). Otherwise torch frees them node by
node as its engine goes, as in a plain backward.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..tensor import (_ID, _MADE, _USERS, Tensor, _inexact, _note_made,
                      _val, _wrap_out, enable_grad, is_grad_enabled, no_grad,
                      set_grad_enabled)
from .functional import hessian, jacobian, jvp, vjp  # noqa: F401

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext",
           "saved_tensors_hooks", "hessian", "jacobian", "jvp", "vjp"]

# metadata key marking a graph node a backward without retain_graph ran
_CONSUMED = "paddle_consumed"
# metadata key of a consumed node: output index -> weak references to the
# Tensors that came from that output and became leaves
_OUTPUTS = "paddle_outputs"


def _roots(tensors, grad_tensors):
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None or isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors] * len(tensors) \
            if grad_tensors is None else [grad_tensors]
    roots, grads = [], []
    for t, g in zip(tensors, grad_tensors):
        if t.stop_gradient:
            raise RuntimeError(
                "backward() called on a tensor with stop_gradient=True")
        v = t._value
        if not v.requires_grad:
            continue   # no graph behind it: no gradient flows
        roots.append(v)
        grads.append(torch.ones_like(v) if g is None
                     else _val(g) if isinstance(g, Tensor)
                     else torch.as_tensor(g, dtype=v.dtype, device=v.device))
    return roots, grads


def _graph(roots):
    """The live nodes a backward from ``roots`` runs (the leaves' gradient
    sinks left out), the leaves a live path reaches, and the consumed
    nodes where the walk stopped."""
    stack = [r.grad_fn for r in roots if r.grad_fn is not None]
    seen, leaves, cut = set(stack), {}, {}
    live = []
    while stack:
        fn = stack.pop()
        if fn.metadata.get(_CONSUMED):
            cut[fn] = None
            continue
        live.append(fn)
        for nxt, _ in fn.next_functions:
            if nxt is None or nxt in seen:
                continue
            seen.add(nxt)
            if hasattr(nxt, "variable"):
                leaves[nxt] = nxt.variable
            else:
                stack.append(nxt)
    return live, list(leaves.values()), list(cut)


def _shared(nodes):
    """Whether a node of ``nodes`` (a backward's live nodes) has a user
    outside them: a graph that could reach it after it is consumed."""
    mds = [fn.metadata for fn in nodes]
    serials = {md[_ID] for md in mds if _ID in md}
    return any(u not in serials for md in mds for u in md.get(_USERS, ()))


def _consume(nodes):
    """Mark ``nodes`` consumed and make the Tensors they made leaves,
    remembering which output of the node each one was."""
    for fn in nodes:
        md = fn.metadata
        md[_CONSUMED] = True
        outs = md.setdefault(_OUTPUTS, {})
        for ref in md.pop(_MADE, ()):
            t = ref()
            if t is not None and t._value.grad_fn is fn:
                outs.setdefault(t._value.output_nr, []).append(ref)
                t._become_leaf()


def _cut_edges(cut):
    """(GradientEdge, Tensors made there) for each output of the consumed
    nodes ``cut`` that a live Tensor came from."""
    from torch.autograd.graph import GradientEdge
    edges = []
    for fn in cut:
        for nr, refs in fn.metadata.get(_OUTPUTS, {}).items():
            made = [t for t in (r() for r in refs) if t is not None]
            if made:
                edges.append((GradientEdge(fn, nr), made))
    return edges


def _zero_incoming(cut):
    """Pre-hooks that zero what reaches the consumed nodes, for a backward
    that must run them to reach a leaf a live path also reaches."""
    def zero(grads):
        return tuple(None if g is None else torch.zeros_like(g)
                     for g in grads)
    return [fn.register_prehook(zero) for fn in cut]


def _through_consumed(roots, grads, leaves, cut):
    """A backward from a graph that reaches consumed nodes: the gradient
    at each of them goes into the Tensors it made, as the reference's
    walk stops at a dropped tape node; the rest reaches the leaves a live
    path reaches."""
    edges = _cut_edges(cut)
    if edges:
        gs = torch.autograd.grad(roots, [e for e, _ in edges], grads,
                                 retain_graph=True, allow_unused=True)
        for (_, made), g in zip(edges, gs):
            if g is not None:
                for t in made:
                    torch.autograd.backward([t._value], [g])
    if not leaves:
        return
    handles = _zero_incoming(cut)
    try:
        torch.autograd.backward(roots, grads, retain_graph=True,
                                inputs=leaves)
    except RuntimeError as e:
        if "second time" not in str(e):
            raise
        raise RuntimeError(
            "backward() reaches a leaf both through a node an earlier "
            "backward() consumed and through a live path, and that node "
            "has freed its saved tensors (a graph built outside the "
            "port's ops used it); pass retain_graph=True to the earlier "
            "backward") from e
    finally:
        for h in handles:
            h.remove()


def backward(tensors: Sequence[Tensor], grad_tensors=None,
             retain_graph=False):
    """paddle.autograd.backward: gradients accumulate into the ``grad`` of
    every leaf (and of tensors that called ``retain_grads``)."""
    roots, grads = _roots(tensors, grad_tensors)
    nodes, leaves, cut = _graph(roots)
    if cut:
        _through_consumed(roots, grads, leaves, cut)
    elif roots:
        # the port's consumption marks the nodes; torch keeps their saved
        # tensors when a graph outside this one uses them
        torch.autograd.backward(roots, grads, retain_graph=(
            retain_graph or _shared(nodes)))
    if not retain_graph:
        _consume(nodes)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: gradients of ``outputs`` with respect to ``inputs``,
    returned (not accumulated into ``.grad``). ``create_graph`` gives
    gradients that are themselves differentiable. An input made by a
    node an earlier backward consumed is taken at that node's output."""
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    retain = bool(retain_graph) if retain_graph is not None else create_graph
    roots, grads = _roots(outputs, grad_outputs)
    nodes, _, cut = _graph(roots)
    targets = [t._value for t in inputs]
    handles = []
    if cut:
        at = {id(t): e for e, made in _cut_edges(cut) for t in made}
        targets = [at.get(id(t), v) for t, v in zip(inputs, targets)]
        handles = _zero_incoming(cut)
    try:
        res = torch.autograd.grad(roots, targets, grads,
                                  retain_graph=retain or _shared(nodes),
                                  create_graph=create_graph,
                                  allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    if not retain:
        _consume(nodes)
    out = []
    for g in res:
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    "One of the differentiated tensors appears unused in the "
                    "graph; set allow_unused=True to return None for it")
            out.append(None)
        else:
            out.append(_note_made(Tensor._wrap(g, not create_graph)))
    return out


class PyLayerContext:
    """Context passed to PyLayer.forward/backward (reference:
    ``paddle/fluid/eager/pylayer/py_layer_node.cc``)."""

    def __init__(self):
        self._saved = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _PyLayerMeta(type):
    def __call__(cls, *a, **kw):
        raise RuntimeError(
            f"{cls.__name__} is a PyLayer: call {cls.__name__}.apply(...) "
            "instead of instantiating it")


class _PyLayerFunction(torch.autograd.Function):
    """The torch node of one PyLayer call: runs the user's forward and
    backward on Tensors. Inputs arrive as the values of the
    differentiable Tensors; the rest ride in ``spec``."""

    @staticmethod
    def forward(ctx, spec, *diff_vals):
        cls, args, kwargs, pos = spec
        args = list(args)
        for p, v in zip(pos, diff_vals):
            args[p] = Tensor._wrap(v.detach(), False)
        pctx = PyLayerContext()
        with torch.no_grad():
            out = cls.forward(pctx, *args, **kwargs)
        ctx.pctx, ctx.cls, ctx.n = pctx, cls, len(diff_vals)
        flat = out if isinstance(out, (tuple, list)) else (out,)
        ctx.tuple_out = isinstance(out, (tuple, list))
        vals = tuple(_val(o) for o in flat)
        return vals if ctx.tuple_out else vals[0]

    @staticmethod
    def backward(ctx, *gouts):
        cts = [Tensor._wrap(g, True) for g in gouts]
        with torch.no_grad():
            gin = ctx.cls.backward(ctx.pctx, *cts)
        if not isinstance(gin, (tuple, list)):
            gin = (gin,)
        gin = [None if g is None else _val(g) for g in gin[:ctx.n]]
        gin += [None] * (ctx.n - len(gin))
        return (None, *gin)


class PyLayer(metaclass=_PyLayerMeta):
    """User-defined autograd function: static ``forward(ctx, *args)`` and
    ``backward(ctx, *grads)``, as paddle.autograd.PyLayer. ``backward``
    returns one gradient per Tensor input that requires grad."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        pos = [i for i, a in enumerate(args)
               if isinstance(a, Tensor) and not a.stop_gradient
               and _inexact(a._value)]
        if not (torch.is_grad_enabled() and pos):
            ctx = PyLayerContext()
            with torch.no_grad():
                return cls.forward(ctx, *args, **kwargs)
        spec = (cls, args, kwargs, pos)
        out = _PyLayerFunction.apply(spec, *[args[p]._value for p in pos])
        return _wrap_out(out if isinstance(out, tuple) else out, False)


class saved_tensors_hooks:
    """Pack/unpack hooks over the tensors saved for backward (reference:
    ``python/paddle/autograd/saved_tensors_hooks.py``): ``pack_hook(t)``
    runs when a tensor is saved and may return anything (a host copy, a
    narrow cast); ``unpack_hook(obj)`` returns the tensor for backward.
    Hooks see and return Tensors; torch's own hooks run them."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook, self.unpack_hook = pack_hook, unpack_hook
        self._torch = torch.autograd.graph.saved_tensors_hooks(
            lambda v: self.pack_hook(Tensor._wrap(v, True)),
            lambda obj: _val(self.unpack_hook(obj)))

    def __enter__(self):
        self._torch.__enter__()
        return self

    def __exit__(self, *exc):
        self._torch.__exit__(*exc)
        return False
