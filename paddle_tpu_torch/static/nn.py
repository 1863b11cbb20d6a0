"""paddle.static.nn: port of paddle_tpu/static/nn.py — control-flow ops and
the static-graph layer function ``fc``.

Reference: ``python/paddle/static/nn/control_flow.py`` (cond, while_loop,
switch_case, case) and ``static/nn/common.py`` (fc). Eagerly each op runs
Python control flow on the predicate's value. Under a ``torch.compile``
trace (``jit.to_static``) the predicate has no value: ``cond`` lowers to
``torch.cond`` and ``while_loop`` to torch's ``while_loop``, so the branch
stays inside the one compiled graph, as the reference's ``lax.cond`` /
``lax.while_loop`` do. ``switch_case`` and ``case`` are nested ``cond``s.

The branch and body functions work on :class:`Tensor` wrappers; at the
higher-order op's boundary their results are unwrapped to torch tensors
(Python numbers become 0-d tensors, as jax makes them arrays) and the op's
outputs are wrapped again. A branch output that is one of its inputs is
cloned, since torch's higher-order ops refuse aliased outputs.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from ..tensor import Tensor, _val, _wrap_out, unwrap

__all__ = ["cond", "while_loop", "switch_case", "case", "fc",
           "fc_parameters"]

# a Python number's dtype at the op boundary (jax's weak types: int32,
# float32, bool)
_HOST_DTYPES = ((bool, torch.bool), (int, torch.int32),
                (float, torch.float32))


def _compiling() -> bool:
    return torch.compiler.is_compiling()


def _as_value(v, device, like=None):
    """One output leaf of a branch or loop body as a torch tensor: a
    Tensor's value (cloned: outputs must not alias), a number as a 0-d
    tensor (of ``like``'s dtype where the carry fixes it)."""
    if isinstance(v, Tensor):
        v = v._value
    if isinstance(v, torch.Tensor):
        out = v.clone()
    else:
        dtype = next((d for t, d in _HOST_DTYPES if isinstance(v, t)), None)
        if dtype is None:
            raise TypeError(
                "cond/while_loop: a branch or loop body must return "
                f"Tensors or numbers, got {type(v).__name__} ({v!r})")
        out = torch.tensor(v, dtype=dtype, device=device)
    if like is not None and out.dtype != like.dtype:
        out = out.to(like.dtype)
    return out


def _device_of(*objs):
    for leaf in pytree.tree_leaves(unwrap(list(objs))):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    from ..framework import place as _place
    return _place.current_device()


def _wrap_values(vals):
    return pytree.tree_map(
        lambda v: _wrap_out(v, not v.requires_grad)
        if isinstance(v, torch.Tensor) else v, vals)


def _pred_value(pred) -> torch.Tensor:
    return _val(pred).reshape(())


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """Run ``true_fn()`` or ``false_fn()`` by a boolean scalar (reference:
    static/nn/control_flow.py cond). Differentiable through the branch
    taken, including the tensors the branches capture."""
    if true_fn is None and false_fn is None:
        raise ValueError("cond: at least one branch function is required")
    # (``is None``: dynamo cannot take the truth of a nested function)
    if true_fn is None:
        true_fn = lambda: None  # noqa: E731
    if false_fn is None:
        false_fn = lambda: None  # noqa: E731
    if not (_compiling() and isinstance(pred, (Tensor, torch.Tensor))):
        return true_fn() if bool(pred) else false_fn()
    p = _pred_value(pred)
    # torch.cond's backward miscounts its tangents when an output is not
    # floating (a bool flag of the dy2static return lowering): under grad
    # such an output crosses as a float tensor, its dtype kept as the key
    # of a one-entry dict, which the op's output structure carries
    carry_dtypes = torch.is_grad_enabled()

    def encode(v):
        v = _as_value(v, p.device)
        if not carry_dtypes or v.is_floating_point() or v.is_complex():
            return v
        return {str(v.dtype): v.to(torch.float32 if v.dtype == torch.bool
                                   else torch.float64)}

    def branch(fn):
        def run():
            return pytree.tree_map(encode, fn(),
                                   is_leaf=lambda v: v is None)
        return run
    out = torch.cond(p, branch(true_fn), branch(false_fn), ())
    if carry_dtypes:
        out = pytree.tree_map(_decode, out, is_leaf=_is_encoded)
    return _wrap_values(out)


def _is_encoded(v) -> bool:
    return isinstance(v, dict) and len(v) == 1 \
        and str(next(iter(v))).startswith("torch.")


def _decode(v):
    if not _is_encoded(v):
        return v
    (name, val), = v.items()
    return val.to(getattr(torch, name.split(".")[1]))


def _carry_grad_check(leaves):
    if torch.is_grad_enabled() and any(
            isinstance(v, Tensor) and not v.stop_gradient
            and (v._value.is_floating_point() or v._value.is_complex())
            for v in leaves):
        raise NotImplementedError(
            "while_loop is not reverse-differentiable (as the reference's "
            "XLA While, which has no transpose); detach the loop vars, wrap "
            "the loop in paddle.no_grad(), or use a fixed trip count")


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Reference: static/nn/control_flow.py while_loop. ``cond_fn`` and
    ``body_fn`` take the loop vars and ``body_fn`` returns new ones of the
    same structure, shapes and dtypes. The loop vars come back as Tensors
    (numbers included); like the reference's, the loop carries no
    gradient, and a var that requires one raises."""
    leaves, spec = pytree.tree_flatten(
        list(loop_vars) if isinstance(loop_vars, tuple) else loop_vars,
        is_leaf=lambda v: isinstance(v, Tensor))
    _carry_grad_check(leaves)
    device = _device_of(leaves)
    carry = tuple(_as_value(v, device) for v in leaves)

    def structured(vals):
        out = pytree.tree_unflatten(
            [Tensor._wrap(v, True) for v in vals], spec)
        return out

    def flat(out, like):
        out_leaves = pytree.tree_leaves(
            list(out) if isinstance(out, tuple) else out,
            is_leaf=lambda v: isinstance(v, Tensor))
        if len(out_leaves) != len(like):
            raise TypeError(
                f"while_loop: body_fn returned {len(out_leaves)} values for "
                f"{len(like)} loop vars")
        return tuple(_as_value(v, device, c) for v, c in zip(out_leaves,
                                                               like))

    with torch.no_grad():
        if _compiling():
            from torch._higher_order_ops.while_loop import \
                while_loop as _while

            def c(*vals):
                return _pred_value(cond_fn(*structured(vals)))

            def b(*vals):
                return flat(body_fn(*structured(vals)), vals)
            carry = _while(c, b, carry)
        else:
            while bool(cond_fn(*structured(carry))):
                carry = flat(body_fn(*structured(carry)), carry)
    out = structured(carry)
    return tuple(out) if isinstance(loop_vars, tuple) else out


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Reference: static/nn/control_flow.py switch_case — dispatch on an
    int scalar. ``branch_fns``: a list of callables, (index, fn) pairs or
    a dict; an index with no branch runs ``default`` (the last branch when
    none is given)."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        items = sorted((int(i), fn) for i, fn in branch_fns)
    else:
        items = list(enumerate(branch_fns))
    if default is None:
        default = items[-1][1]
    if not (_compiling() and isinstance(branch_index, (Tensor,
                                                       torch.Tensor))):
        idx = int(branch_index)
        return dict(items).get(idx, default)()
    idx = _val(branch_index).reshape(())

    def build(rest):
        if not rest:
            return default()
        (k, fn), tail = rest[0], rest[1:]
        return cond(idx == k, fn, lambda: build(tail))
    return build(items)


def case(pred_fn_pairs, default=None, name=None):
    """First predicate that holds wins (reference: control_flow.case; with
    no ``default`` the last pair's fn is the fallback)."""
    pairs = list(pred_fn_pairs)
    if not pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]

    def build(rest):
        if not rest:
            return default()
        (pred, fn), tail = rest[0], rest[1:]
        return cond(pred, fn, lambda: build(tail))
    return build(pairs)


_fc_layers: dict = {}


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Reference: static/nn/common.py fc. The Linear behind it persists
    across calls, keyed by ``name`` (an anonymous fc by its call site), so
    repeated steps reuse and can train the same weights."""
    from .. import nn as _nn
    from ..ops.manipulation import reshape
    from ..tensor import to_tensor
    xv = x if isinstance(x, Tensor) else to_tensor(x)
    lead = xv.shape[:num_flatten_dims]
    flat_in = 1
    for d in xv.shape[num_flatten_dims:]:
        flat_in *= d
    if name is None:
        import sys
        frame = sys._getframe(1)
        name = f"fc@{frame.f_code.co_filename}:{frame.f_lineno}"
    key = (name, flat_in, size)
    if key not in _fc_layers:
        _fc_layers[key] = _nn.Linear(flat_in, size, weight_attr=weight_attr,
                                     bias_attr=bias_attr)
    out = _fc_layers[key](reshape(xv, list(lead) + [flat_in]))
    if activation:
        out = getattr(_nn.functional, activation)(out)
    return out


def fc_parameters():
    """Parameters of every fc() call site (pass them to an optimizer)."""
    out = []
    for layer in _fc_layers.values():
        out.extend(layer.parameters())
    return out
