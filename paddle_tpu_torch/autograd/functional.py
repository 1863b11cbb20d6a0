"""Functional autodiff transforms: port of paddle_tpu/autograd/functional.py
(reference: ``python/paddle/autograd/functional.py`` — jacobian,
hessian, vjp, jvp).

The reference hands a pure function of arrays to jax's transforms; the
port hands the same function of torch tensors (the user's function of
Tensors, unwrapped) to ``torch.autograd.functional``, whose graph is the
one the port's Tensors record. Results come back as Tensors without a
graph, shaped as jax's: a Jacobian is ``out.shape + x.shape``, a Hessian
of several inputs a tuple of tuples.
"""
from __future__ import annotations

import torch
from torch.autograd import functional as _taf

from ..tensor import Tensor, unwrap

__all__ = ["hessian", "jacobian", "jvp", "vjp"]


def _pure(func):
    """``func`` (Tensors -> Tensors) as a function of torch tensors whose
    graph torch records."""
    def pure(*vals):
        return unwrap(func(*[Tensor._wrap(v, False) for v in vals]))
    return pure


def _out(tree):
    """torch results -> Tensors without a graph, through tuples/lists."""
    if isinstance(tree, torch.Tensor):
        return Tensor._wrap(tree.detach(), True)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_out(t) for t in tree)
    return tree


def _inputs(xs):
    single = isinstance(xs, Tensor)
    return single, tuple(t._value.detach() for t in
                         ([xs] if single else list(xs)))


def vjp(func, xs, v=None):
    """paddle.autograd.vjp(func, xs, v) -> (out, vjp_result); ``v``
    defaults to ones like the output."""
    single, vals = _inputs(xs)
    with torch.enable_grad():
        ins = tuple(x.requires_grad_(True) for x in vals)
        out = _pure(func)(*ins)
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        cot = (tuple(torch.ones_like(o) for o in outs) if v is None
               else (unwrap(v),) if isinstance(v, Tensor)
               else tuple(unwrap(list(v))))
        grads = torch.autograd.grad(outs, ins, cot, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(ins, grads)]
    return _out(out), _out(grads[0] if single else grads)


def jvp(func, xs, v=None):
    """paddle.autograd.jvp(func, xs, v) -> (out, jvp_result); ``v``
    defaults to ones like the inputs."""
    _, vals = _inputs(xs)
    tangents = (tuple(torch.ones_like(p) for p in vals) if v is None
                else (unwrap(v),) if isinstance(v, Tensor)
                else tuple(unwrap(list(v))))
    out, tan = _taf.jvp(_pure(func), vals, tangents)
    return _out(out), _out(tan)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    single, vals = _inputs(xs)
    jac = _taf.jacobian(_pure(func), vals)
    if single:
        return _out(jac[0] if isinstance(jac, (tuple, list)) else jac)
    return _out(jac)


def hessian(func, xs, create_graph=False, allow_unused=False):
    single, vals = _inputs(xs)
    hes = _taf.hessian(_pure(func), vals)
    return _out(hes[0][0] if single else hes)
