"""AST dygraph-to-static conversion of Python control flow: port of
paddle_tpu/jit/dy2static_ast.py.

Reference: ``python/paddle/jit/dy2static/`` — the AST transformers
(ifelse_transformer.py, loop_transformer.py) that rewrite ``if``/``while``
over Tensor predicates into ``cond``/``while_loop`` ops, with the
``convert_ifelse``/``convert_while_loop`` runtime dispatchers
(convert_operators.py) that keep plain Python when the predicate is a host
value.

The rewritten code targets ``static.nn.cond`` / ``static.nn.while_loop``,
which lower to ``torch.cond`` / torch's ``while_loop`` under a
``torch.compile`` trace, so a converted function compiles into ONE graph
with real data-dependent branches, where dynamo alone cannot branch on a
traced value. Eagerly the dispatchers run the Python control flow.

Scope contract (the reference's): converted constructs are ``if``/
``elif``/``else`` and ``while`` whose bodies assign plain names only;
``break``/``continue`` in a ``while`` and early ``return`` lower to
loop-carried/branch-merged flag state first (reference:
break_continue_transformer.py:88, return_transformer.py:122). ``for NAME
in range(...)`` with a non-literal bound desugars to the equivalent while
(bound snapshotted once, private induction variable, int steps only);
``for NAME in seq`` over a Tensor lowers to torch's ``scan`` over the
leading dim when the body has no break/continue/return, else to an indexed
while (reference: loop_transformer.py:505); literal-bound ranges and host
iterables keep Python semantics (unrolled under the trace). Out of
contract (Python semantics, a trace error on Tensor predicates):
attribute/subscript assignment in a converted block, ``while/else``,
``break``/``continue`` in a host ``for``, ``return`` under try/with.

Names a converted block may leave unbound are bound to :data:`UNDEFINED`
at the top of their function (dynamo cannot trace the reference's
``try: name / except NameError`` guard on an unbound local).
"""
from __future__ import annotations

import ast
import inspect
import operator
import textwrap

import numpy as np
import torch


# ------------------------------------------------------------ runtime

class _Undefined:
    """Placeholder for a name only assigned on the other branch
    (reference: dy2static UndefinedVar). Any USE raises; merely carrying
    it through the un-taken branch is fine."""

    def _boom(self, *a, **kw):
        raise NameError(
            "variable assigned on only one dy2static branch was used "
            "on a path where it is undefined")

    __getattr__ = __call__ = __bool__ = __add__ = __radd__ = _boom
    __mul__ = __rmul__ = __sub__ = __rsub__ = __getitem__ = _boom

    def __repr__(self):
        return "<dy2static undefined>"


UNDEFINED = _Undefined()


def _compiling() -> bool:
    return torch.compiler.is_compiling()


def _zeros_like_spec(spec):
    from ..tensor import Tensor
    shape, dtype, device = spec
    return Tensor._wrap(torch.zeros(shape, dtype=dtype, device=device), True)


def _abstract_outputs(fn, args):
    """(shape, dtype, device) of each Tensor output of ``fn(*args)`` (None
    for the others) without real compute: eagerly under a FakeTensorMode,
    inside a trace as ops the compiled graph never uses (dead code, which
    the compiler drops)."""
    from ..tensor import Tensor

    def run():
        with torch.no_grad():
            return tuple(fn(*args))

    if _compiling():
        outs = run()
    else:
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True):
            outs = run()
    return [(tuple(o._value.shape), o._value.dtype, o._value.device)
            if isinstance(o, Tensor) else None for o in outs]


def _patch_ret_slots(true_fn, false_fn, args, ret_slots):
    """The ``_pt_ret_val`` register may be a real value on one branch and
    None/UNDEFINED on the other (a path that has not returned yet). The
    return FLAG guards every read, so the undefined side can carry zeros
    of the defined side's shape — the reference initializes its
    RETURN_VALUE var with a zero fill the same way
    (return_transformer.py:122)."""
    try:
        ta = _abstract_outputs(true_fn, args)
        fa = _abstract_outputs(false_fn, args)
    except Exception:
        return true_fn, false_fn
    patches = {}
    for i in ret_slots:
        if i >= len(ta) or i >= len(fa):
            continue
        if ta[i] is not None and fa[i] is None:
            patches[i] = ("false", ta[i])
        elif fa[i] is not None and ta[i] is None:
            patches[i] = ("true", fa[i])
    if not patches:
        return true_fn, false_fn

    def wrap_side(fn, side):
        def patched(*a):
            out = list(fn(*a))
            for i, (s, spec) in patches.items():
                if s == side:
                    out[i] = _zeros_like_spec(spec)
            return tuple(out)
        return patched

    return wrap_side(true_fn, "true"), wrap_side(false_fn, "false")


def convert_ifelse(pred, true_fn, false_fn, args=(), ret_slots=()):
    """Dispatch: Tensor predicate -> ``static.nn.cond``; host value ->
    plain if (reference: convert_operators.py convert_ifelse). ``args``
    carries the read-write names into the branch functions (a rebound name
    is local to the nested def, so reads of the pre-branch value must
    arrive as parameters). ``ret_slots`` marks output positions holding
    the lowered-return value register (see _patch_ret_slots): only a
    traced cond, which runs both branches, needs them patched."""
    from ..tensor import Tensor
    if isinstance(pred, Tensor):
        from ..static.nn import cond
        if ret_slots and _compiling():
            true_fn, false_fn = _patch_ret_slots(true_fn, false_fn, args,
                                                 ret_slots)
        try:
            return cond(pred, lambda: true_fn(*args),
                        lambda: false_fn(*args))
        except TypeError as e:
            # an UNDEFINED sentinel is harmless while both branches
            # rebind the name; it only reaches the traced cond's outputs
            # (and this TypeError) when a branch passes it through
            if any(a is UNDEFINED for a in args):
                raise NameError(
                    "dy2static: a variable with no value before a "
                    "Tensor-predicate `if` flows out of a branch; "
                    "initialize it first (data-dependent branches "
                    "must merge defined values)") from e
            raise
    return true_fn(*args) if pred else false_fn(*args)


def convert_while_loop(cond_fn, body_fn, loop_vars, ret_slots=()):
    """Dispatch: Tensor condition -> ``static.nn.while_loop``; host
    condition -> plain Python loop (reference: convert_while_loop). A
    None/UNDEFINED return-value register in the carry is initialized to
    zeros of the body's output (its reads are flag-guarded — see
    _patch_ret_slots)."""
    from ..tensor import Tensor
    first = cond_fn(*loop_vars)
    if not isinstance(first, Tensor):
        # host condition: plain Python loop — but the carried state can
        # BECOME a Tensor mid-flight (e.g. a break predicate reads a
        # Tensor argument and the flag turns into a Tensor), so re-dispatch
        # on every iteration and hand the remaining iterations to the
        # Tensor path the moment the condition stops being a host value
        vars_ = tuple(loop_vars)
        while True:
            c = cond_fn(*vars_)
            if isinstance(c, Tensor):
                return convert_while_loop(cond_fn, body_fn, vars_,
                                          ret_slots)
            if not c:
                return vars_
            vars_ = tuple(body_fn(*vars_))
    if ret_slots:
        lv = list(loop_vars)
        try:
            outs = _abstract_outputs(body_fn, loop_vars)
            for i in ret_slots:
                if (lv[i] is None or lv[i] is UNDEFINED) \
                        and outs[i] is not None:
                    lv[i] = _zeros_like_spec(outs[i])
            loop_vars = tuple(lv)
        except Exception:
            pass
    if any(v is UNDEFINED for v in loop_vars):
        raise NameError(
            "dy2static: a loop variable of a Tensor-condition "
            "`while` has no value before the loop; initialize the "
            "loop state first (a traced loop carries concrete values)")
    from ..static.nn import while_loop
    out = while_loop(lambda *vs: cond_fn(*vs),
                     lambda *vs: body_fn(*vs), tuple(loop_vars))
    return tuple(out)


def _as_bool_like(v, ref):
    """Coerce an operand to a bool tensor matching ``ref``'s shape —
    host values broadcast to a constant mask (a Tensor lhs may meet a
    plain-Python rhs, e.g. ``(t > 0) and flag``)."""
    from ..ops.creation import full_like
    from ..tensor import Tensor
    if isinstance(v, Tensor):
        return v.astype("bool")
    return full_like(ref.astype("bool"), bool(v), dtype="bool")


def convert_logical_and(lhs_fn, rhs_fn):
    """Short-circuit-preserving ``and`` (reference: convert_logical_and).
    A Tensor lhs combines elementwise (host rhs broadcasts); a host lhs
    keeps Python short-circuit."""
    from ..tensor import Tensor
    lhs = lhs_fn()
    if isinstance(lhs, Tensor):
        return lhs.astype("bool").logical_and(
            _as_bool_like(rhs_fn(), lhs))
    return lhs and rhs_fn()


def convert_logical_or(lhs_fn, rhs_fn):
    from ..tensor import Tensor
    lhs = lhs_fn()
    if isinstance(lhs, Tensor):
        return lhs.astype("bool").logical_or(
            _as_bool_like(rhs_fn(), lhs))
    return lhs or rhs_fn()


_CMP = {"Lt": operator.lt, "LtE": operator.le, "Gt": operator.gt,
        "GtE": operator.ge, "Eq": operator.eq, "NotEq": operator.ne}


def convert_compare(lhs, rhs, op):
    """A one-operator comparison in predicate position. A numpy operand
    facing a Tensor becomes a Tensor first: dynamo cannot compare a
    Python object with a numpy value (``while i < np.float32(3.0)``)."""
    from ..tensor import Tensor
    if isinstance(lhs, Tensor) and isinstance(rhs, (np.ndarray, np.generic)):
        rhs = Tensor._wrap(torch.as_tensor(rhs, device=lhs._value.device),
                           True)
    elif isinstance(rhs, Tensor) and isinstance(lhs, (np.ndarray,
                                                      np.generic)):
        lhs = Tensor._wrap(torch.as_tensor(lhs, device=rhs._value.device),
                           True)
    return _CMP[op](lhs, rhs)


def convert_logical_not(v):
    """``not`` in predicate position (reference: convert_logical_not)."""
    from ..tensor import Tensor
    if isinstance(v, Tensor):
        return v.astype("bool").logical_not()
    return not v


def flags_clear(*flags):
    """True iff no break/continue/return flag is set. Host flags stay a
    host bool (plain-Python paths untouched); any Tensor flag promotes
    the result to a Tensor so the guard `if`/loop test converts."""
    from ..tensor import Tensor
    ref = next((f for f in flags if isinstance(f, Tensor)), None)
    if ref is None:
        return not any(bool(f) for f in flags)
    out = None
    for f in flags:
        fb = _as_bool_like(f, ref)
        out = fb if out is None else out.logical_or(fb)
    return out.logical_not()


def is_tensor(v):
    from ..tensor import Tensor
    return isinstance(v, Tensor)


def seq_len_tensor(seq):
    """Leading-dim length of a Tensor sequence AS A TENSOR — makes the
    desugared for-over-Tensor while a traced loop (no unrolling),
    reference loop_transformer.py:505."""
    from ..tensor import Tensor
    return Tensor._wrap(torch.tensor(int(seq.shape[0]), dtype=torch.int32,
                                     device=seq._value.device), True)


def seq_item(seq, i):
    """seq[i] with a possibly-traced scalar index (a gather keeps the
    access differentiable)."""
    from ..ops.manipulation import gather, reshape, squeeze
    from ..tensor import Tensor
    if isinstance(i, Tensor):
        idx = reshape(i.astype("int32"), [1])
        return squeeze(gather(seq, idx), axis=0)
    return seq[i]


def seq_item_placeholder(seq):
    """Zeros of one element's shape — pre-binds the loop target so it can
    ride the while carry (the body overwrites it before any read)."""
    from ..ops.creation import zeros
    return zeros(list(seq.shape[1:]), seq.dtype)


def copy_value(v):
    """Value copy for the loop target: ``i = ivar; ivar += 1`` must not
    alias (Tensor ``__iadd__`` rebinds in place, so a reference copy would
    see the bump)."""
    from ..tensor import Tensor
    if isinstance(v, Tensor):
        return v.clone()
    return v


def seq_last(seq):
    """Post-loop binding of the for target (Python leaves the last
    element bound); UNDEFINED when the sequence is empty."""
    return seq[-1] if int(seq.shape[0]) > 0 else UNDEFINED


def convert_for_tensor(seq, body_fn, loop_vars):
    """``for x in tensor`` with no break/continue/return in the body: a
    loop over the leading dim carrying ``loop_vars`` — torch's ``scan``
    under a trace (one compiled, differentiable loop, as the reference's
    ``lax.scan``), the Python loop eagerly."""
    from ..static.nn import _as_value
    from ..tensor import _wrap_out

    if any(v is UNDEFINED for v in loop_vars):
        raise NameError(
            "dy2static: a loop-carried variable of a Tensor `for` has no "
            "value before the loop; initialize it first (a traced loop "
            "carries concrete values)")
    if not _compiling():
        carry = tuple(loop_vars)
        for i in range(int(seq.shape[0])):
            carry = tuple(body_fn(seq[i], *carry))
        return carry
    from torch._higher_order_ops.scan import scan
    dev = seq._value.device
    init = tuple(_as_value(v, dev) for v in loop_vars)

    def wrap(v):
        return _wrap_out(v, not v.requires_grad)

    def step(carry, x):
        outs = body_fn(wrap(x), *[wrap(c) for c in carry])
        return tuple(_as_value(o, dev, c)
                     for o, c in zip(outs, carry)), x.new_zeros(())
    carry, _ = scan(step, init, seq._value)
    return tuple(wrap(c) for c in carry)


# ------------------------------------------------------- AST analysis

class _Unconvertible(Exception):
    pass


def _assigned_names(stmts):
    """Plain names assigned anywhere in ``stmts``. Raises
    _Unconvertible on constructs outside the conversion contract."""
    names: list[str] = []

    class V(ast.NodeVisitor):
        def visit_Assign(self, node):
            for t in node.targets:
                self._target(t)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            if node.value is not None:
                self._target(node.target)
            self.generic_visit(node)

        def _target(self, t):
            if isinstance(t, ast.Name):
                if t.id not in names:
                    names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    self._target(e)
            elif isinstance(t, (ast.Attribute, ast.Subscript)):
                raise _Unconvertible(
                    "attribute/subscript assignment in converted block")
            elif isinstance(t, ast.Starred):
                self._target(t.value)
            else:
                raise _Unconvertible(f"assignment target {type(t)}")

        def visit_Return(self, node):
            raise _Unconvertible("return inside converted block")

        def visit_Break(self, node):
            raise _Unconvertible("break inside converted block")

        def visit_Continue(self, node):
            raise _Unconvertible("continue inside converted block")

        # nested defs own their scope — don't descend, and their names
        # are not data outputs (the inner converter's _pt_* helpers land
        # here; returning function objects from a branch would poison
        # the cond)
        def visit_FunctionDef(self, node):
            pass

        def visit_AsyncFunctionDef(self, node):
            pass

        def visit_Lambda(self, node):
            pass

        def visit_For(self, node):
            # python-semantics inner for is fine UNLESS it breaks the
            # name contract; its targets are assignments
            self._target(node.target)
            for s in node.body + node.orelse:
                self.visit(s)

    v = V()
    for s in stmts:
        v.visit(s)
    return names


def _walk_same_scope(node):
    """ast.walk that does NOT descend into nested function/lambda
    scopes (their locals are not this scope's reads/writes)."""
    from collections import deque
    q = deque([node])
    while q:
        n = q.popleft()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            q.append(child)


def _first_use_kinds(stmts, candidates):
    """name -> 'load'|'store' for the FIRST use of each candidate in the
    statement sequence (loads within one statement are processed before
    its stores — `a = a + 1` reads a first). Nested defs/lambdas are
    their own scope and are skipped."""
    first: dict[str, str] = {}
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        loads, stores = [], []
        for n in _walk_same_scope(stmt):
            if isinstance(n, ast.Name) and n.id in candidates:
                (loads if isinstance(n.ctx, ast.Load)
                 else stores).append(n.id)
        for name in loads:
            first.setdefault(name, "load")
        for name in stores:
            first.setdefault(name, "store")
    return first


def _store_first_names(stmts, candidates):
    return {n for n, k in _first_use_kinds(stmts, candidates).items()
            if k == "store"}


def _load_first_names(stmts, candidates):
    return {n for n, k in _first_use_kinds(stmts, candidates).items()
            if k == "load"}


def _guard_stmt(name):
    """A marker that ``name`` may be unbound here; :func:`_hoist_guards`
    turns it into ``name = _pt_jst.UNDEFINED`` at the top of the function,
    so possibly-undefined names can travel as dispatcher arguments (the
    reference guards with ``try: name / except NameError``, which dynamo
    cannot trace)."""
    return ast.Expr(value=ast.Call(
        func=ast.Attribute(value=ast.Name(id="_pt_jst", ctx=ast.Load()),
                           attr=_GUARD, ctx=ast.Load()),
        args=[ast.Constant(value=name)], keywords=[]))


_GUARD = "_guard"


def _guard_name(stmt):
    if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == _GUARD
            and isinstance(stmt.value.func.value, ast.Name)
            and stmt.value.func.value.id == "_pt_jst"):
        return stmt.value.args[0].value
    return None


def _hoist_guards(fdef):
    """Replace the guard markers of ``fdef``'s own scope (and, recursively,
    of every function nested in it) by ``name = _pt_jst.UNDEFINED`` at the
    top of the function. Binding a local before its first store changes
    nothing else: Python treats the name as local in the whole function,
    so an earlier read was an UnboundLocalError already. Parameters are
    always bound; ``global``/``nonlocal`` names are not locals."""
    names: list[str] = []
    skip = {p.arg for p in (fdef.args.posonlyargs + fdef.args.args
                            + fdef.args.kwonlyargs)}
    skip |= {a.arg for a in (fdef.args.vararg, fdef.args.kwarg) if a}

    def visit(stmts):
        kept = []
        for s in stmts:
            name = _guard_name(s)
            if name is not None:
                if name not in names:
                    names.append(name)
                continue
            if isinstance(s, (ast.Global, ast.Nonlocal)):
                skip.update(s.names)
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _hoist_guards(s)
            else:
                for field in ("body", "orelse", "finalbody"):
                    if isinstance(getattr(s, field, None), list):
                        setattr(s, field, visit(getattr(s, field)) or
                                ([ast.Pass()] if field == "body" else []))
                for h in getattr(s, "handlers", ()):
                    h.body = visit(h.body) or [ast.Pass()]
            kept.append(s)
        return kept

    fdef.body = visit(fdef.body)
    inits = [ast.Assign(targets=[ast.Name(id=n, ctx=ast.Store())],
                        value=ast.Attribute(
                            value=ast.Name(id="_pt_jst", ctx=ast.Load()),
                            attr="UNDEFINED", ctx=ast.Load()))
             for n in names if n not in skip]
    fdef.body = inits + fdef.body


class _PredicateBoolOps(ast.NodeTransformer):
    """Rewrites ``and``/``or`` into short-circuit-preserving dispatcher
    calls, and one-operator comparisons into :func:`convert_compare` —
    applied to PREDICATE expressions only (reference: LogicalTransformer).
    Value-position BoolOps keep Python semantics (rewriting them would
    turn `z = a and b` into a bool mask)."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        attr = ("convert_logical_and"
                if isinstance(node.op, ast.And) else "convert_logical_or")
        out = node.values[-1]
        for lhs in reversed(node.values[:-1]):
            out = ast.Call(
                func=ast.Attribute(value=ast.Name(id="_pt_jst",
                                                  ctx=ast.Load()),
                                   attr=attr, ctx=ast.Load()),
                args=[ast.Lambda(args=_named_args([]), body=lhs),
                      ast.Lambda(args=_named_args([]), body=out)],
                keywords=[])
        return out

    def visit_Compare(self, node):
        self.generic_visit(node)
        if len(node.ops) != 1 or type(node.ops[0]).__name__ not in _CMP:
            return node
        return _jst_call("convert_compare", [
            node.left, node.comparators[0],
            ast.Constant(value=type(node.ops[0]).__name__)])

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if not isinstance(node.op, ast.Not):
            return node
        return ast.Call(
            func=ast.Attribute(value=ast.Name(id="_pt_jst", ctx=ast.Load()),
                               attr="convert_logical_not", ctx=ast.Load()),
            args=[node.operand], keywords=[])

    def visit_Lambda(self, node):
        return node     # nested scopes keep their own semantics

    def visit_FunctionDef(self, node):
        return node


# ----------------------------------------------------- lowering passes

def _assign(name, value):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=value)


def _const(v):
    return ast.Constant(value=v)


def _jst_call(attr, args):
    return ast.Call(
        func=ast.Attribute(value=ast.Name(id="_pt_jst", ctx=ast.Load()),
                           attr=attr, ctx=ast.Load()),
        args=args, keywords=[])


def _flags_clear_test(flag_names):
    return _jst_call("flags_clear",
                     [ast.Name(id=f, ctx=ast.Load()) for f in flag_names])


def _has_break_or_continue(loop_node):
    """Break/Continue statements binding to THIS loop."""
    return any(isinstance(n, (ast.Break, ast.Continue))
               for stmt in loop_node.body
               for n in _walk_stop_inner_loops(stmt))


def _walk_stop_inner_loops(node):
    """Walk without entering nested defs or nested loops (the given node
    itself may be anything, including a loop's body statement)."""
    from collections import deque
    q = deque([node])
    while q:
        n = q.popleft()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.While, ast.For)):
                continue
            q.append(child)


def _walk_stop_defs(node):
    from collections import deque
    q = deque([node])
    while q:
        n = q.popleft()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            q.append(child)


class _ForDesugar(ast.NodeTransformer):
    """for → while desugar, BEFORE flag lowering (so loop-level break/
    continue inside desugared fors lower with the while machinery).

    - ``for NAME in range(...)`` with a non-literal bound → snapshot the
      bound, private induction var, equivalent while (reference:
      loop_transformer's for→while pass).
    - ``for NAME in EXPR`` (plain name target, non-call, non-literal
      iterable) → runtime dispatch: a Tensor sequence iterates via an
      indexed while over dim 0 (→ while_loop); anything else keeps
      the original Python for (reference loop_transformer.py:505 +
      convert_operators runtime dispatch).
    """

    def __init__(self):
        self.counter = 0
        self.root = None   # enclosing FunctionDef (escape analysis)

    def _name(self, kind):
        self.counter += 1
        return f"_pt_f{kind}_{self.counter}"

    def visit_FunctionDef(self, node):
        return node        # nested defs own their control flow

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return node

    def visit_For(self, node):
        self.generic_visit(node)
        if node.orelse or not isinstance(node.target, ast.Name):
            return node
        it = node.iter
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range"):
            return self._desugar_range(node, it)
        if isinstance(it, (ast.List, ast.Tuple, ast.Set, ast.Dict,
                           ast.GeneratorExp, ast.ListComp, ast.SetComp,
                           ast.DictComp, ast.Constant, ast.Call)):
            return node    # literal container / iterator call: Python
        return self._desugar_seq(node)

    def _desugar_range(self, node, it):
        if (it.keywords or not 1 <= len(it.args) <= 3
                or any(isinstance(a, ast.Starred) for a in it.args)):
            return node
        if all(isinstance(a, ast.Constant) for a in it.args):
            return node          # literal trip count: leave to Python
        if len(it.args) == 1:
            start, stop, step = _const(0), it.args[0], _const(1)
        elif len(it.args) == 2:
            (start, stop), step = it.args, _const(1)
        else:
            start, stop, step = it.args
            if not (isinstance(step, ast.Constant)
                    and type(step.value) is int and step.value > 0):
                return node      # unknown/non-int/negative step: Python
        tgt = node.target.id
        # range semantics: the bound is captured ONCE, and the loop
        # target is assigned from a private induction variable — body
        # mutations of the target or the bound must not change the trip
        # count, and the post-loop target is the last yielded value.
        # The bump comes BEFORE the user body: flag lowering guards
        # everything after a `continue` behind flags_clear(cnt), and the
        # induction step must not be skippable (a guarded bump loops
        # forever on the first continued iteration)
        ivar, svar = self._name("iter"), self._name("stop")
        set_tgt = _assign(tgt, _jst_call(
            "copy_value", [ast.Name(id=ivar, ctx=ast.Load())]))
        bump = ast.AugAssign(target=ast.Name(id=ivar, ctx=ast.Store()),
                             op=ast.Add(), value=step)
        loop = ast.While(
            test=ast.Compare(left=ast.Name(id=ivar, ctx=ast.Load()),
                             ops=[ast.Lt()],
                             comparators=[ast.Name(id=svar,
                                                   ctx=ast.Load())]),
            body=[set_tgt, bump] + list(node.body), orelse=[])
        return [_assign(ivar, start), _assign(svar, stop), loop]

    def _loads_outside_node(self, node, name):
        """Loads of ``name`` in the function outside ``node`` (decides
        whether a store-first body name must ride the scan carry)."""
        if self.root is None:
            return 1      # unknown context: conservatively 'escapes'
        total = sum(1 for n in ast.walk(self.root)
                    if isinstance(n, ast.Name) and n.id == name
                    and isinstance(n.ctx, ast.Load))
        inside = sum(1 for n in ast.walk(node)
                     if isinstance(n, ast.Name) and n.id == name
                     and isinstance(n.ctx, ast.Load))
        return total - inside

    def _desugar_seq(self, node):
        """Runtime-dispatched tensor iteration; the Python copy keeps the
        original body (deep-copied so later passes never see shared
        nodes). Bodies free of break/continue/return lower to a scan
        (differentiable); the rest fall back to the indexed while."""
        import copy
        has_bc = any(isinstance(n, (ast.Break, ast.Continue))
                     for st in node.body
                     for n in _walk_stop_inner_loops(st))
        has_ret = any(isinstance(n, ast.Return)
                      for st in node.body for n in _walk_stop_defs(st))
        if not (has_bc or has_ret):
            out = self._desugar_seq_scan(node)
            if out is not None:
                return out
        tgt = node.target.id
        seq, ivar, lvar = (self._name("seq"), self._name("i"),
                           self._name("len"))
        item = _assign(tgt, _jst_call(
            "seq_item", [ast.Name(id=seq, ctx=ast.Load()),
                         ast.Name(id=ivar, ctx=ast.Load())]))
        bump = ast.AugAssign(target=ast.Name(id=ivar, ctx=ast.Store()),
                             op=ast.Add(), value=_const(1))
        loop = ast.While(
            test=ast.Compare(left=ast.Name(id=ivar, ctx=ast.Load()),
                             ops=[ast.Lt()],
                             comparators=[ast.Name(id=lvar,
                                                   ctx=ast.Load())]),
            body=[item, bump] + list(node.body), orelse=[])
        tensor_branch = [
            _assign(lvar, _jst_call("seq_len_tensor",
                                    [ast.Name(id=seq, ctx=ast.Load())])),
            _assign(ivar, _const(0)),
            _assign(tgt, _jst_call("seq_item_placeholder",
                                   [ast.Name(id=seq, ctx=ast.Load())])),
            loop,
        ]
        py_for = ast.For(target=ast.Name(id=tgt, ctx=ast.Store()),
                         iter=ast.Name(id=seq, ctx=ast.Load()),
                         body=copy.deepcopy(node.body), orelse=[])
        dispatch = ast.If(
            test=_jst_call("is_tensor", [ast.Name(id=seq, ctx=ast.Load())]),
            body=tensor_branch, orelse=[py_for])
        return [_assign(seq, node.iter), dispatch]

    def _desugar_seq_scan(self, node):
        """``for NAME in seq`` → nested body fn + convert_for_tensor
        (torch's scan). Carry = assigned names that are read before written
        or escape the loop; store-first non-escaping names stay body-
        local. Returns None when the body is out of contract."""
        import copy
        try:
            assigned = _assigned_names(node.body)
        except _Unconvertible:
            return None
        tgt = node.target.id
        first = _first_use_kinds(node.body, set(assigned))
        carry = [n for n in assigned
                 if n != tgt and (first.get(n) == "load"
                                  or self._loads_outside_node(node, n) > 0)]
        seq, bname = self._name("seq"), self._name("body")
        body_def = ast.FunctionDef(
            name=bname, args=_named_args([tgt] + carry),
            body=copy.deepcopy(node.body) + [ast.Return(value=ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Load()) for n in carry],
                ctx=ast.Load()))],
            decorator_list=[])
        call = _jst_call(
            "convert_for_tensor",
            [ast.Name(id=seq, ctx=ast.Load()),
             ast.Name(id=bname, ctx=ast.Load()),
             ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                             for n in carry], ctx=ast.Load())])
        assign = (ast.Assign(
            targets=[ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Store())
                                     for n in carry], ctx=ast.Store())],
            value=call) if carry else ast.Expr(value=call))
        set_last = _assign(tgt, _jst_call(
            "seq_last", [ast.Name(id=seq, ctx=ast.Load())]))
        guards = [_guard_stmt(n) for n in carry]
        tensor_branch = guards + [body_def, assign, set_last]
        py_for = ast.For(target=ast.Name(id=tgt, ctx=ast.Store()),
                         iter=ast.Name(id=seq, ctx=ast.Load()),
                         body=copy.deepcopy(node.body), orelse=[])
        dispatch = ast.If(
            test=_jst_call("is_tensor", [ast.Name(id=seq, ctx=ast.Load())]),
            body=tensor_branch, orelse=[py_for])
        return [_assign(seq, node.iter), dispatch]


class _FlagLowering:
    """Rewrites ``break``/``continue``/early ``return`` into flag state.

    - break/continue in a ``while``: loop-carried bool flags; the loop
      test gains ``flags_clear(brk[, ret]) and (test)``; statements after
      a possible flag set are guarded by ``if flags_clear(...)``
      (reference: break_continue_transformer.py:88).
    - early return: ``_pt_ret_flag``/``_pt_ret_val`` function state with
      a single ``return _pt_ret_val`` at the end; an ``if`` whose branch
      ALWAYS returns absorbs the trailing statements into its other
      branch, so the cond merges two real values instead of a value and
      a placeholder (reference: return_transformer.py:122).
    - returns inside a host ``for`` lower to flag-set + ``break``.
    """

    RET_FLAG, RET_VAL = "_pt_ret_flag", "_pt_ret_val"

    def __init__(self):
        self.counter = 0
        self.uses_ret = False
        self.ret_active = False

    def _name(self, kind):
        self.counter += 1
        return f"_pt_{kind}_{self.counter}"

    # -------------------------------------------------------- detection
    @staticmethod
    def _may_return(node):
        return any(isinstance(n, ast.Return) for n in _walk_stop_defs(node))

    @staticmethod
    def _may_break_cont(stmt):
        """Break/Continue in ``stmt`` binding to the ENCLOSING loop."""
        brk = cnt = False
        for n in _walk_stop_inner_loops(stmt):
            brk |= isinstance(n, ast.Break)
            cnt |= isinstance(n, ast.Continue)
        return brk, cnt

    def _stmt_flags(self, stmt, ctx):
        """Flag names ``stmt`` may set, given the active context."""
        flags = []
        brk, cnt = self._may_break_cont(stmt)
        if isinstance(stmt, (ast.While, ast.For)):
            brk = cnt = False      # its own loop consumes them
        if ctx.get("brk") and brk:
            flags.append(ctx["brk"])
        if ctx.get("cnt") and cnt:
            flags.append(ctx["cnt"])
        if ctx.get("ret") and self._may_return(stmt):
            flags.append(self.RET_FLAG)
        return flags

    # -------------------------------------------------------- entry
    def lower_function(self, fdef):
        has_bc = any(
            isinstance(n, ast.While) and _has_break_or_continue(n)
            for n in _walk_scope_stop_defs(fdef))
        self.ret_active = any(
            isinstance(n, (ast.If, ast.While, ast.For))
            and self._may_return(n)
            for n in _walk_scope_stop_defs(fdef))
        if not (has_bc or self.ret_active):
            return False
        ctx = {"ret": self.ret_active, "brk": None, "cnt": None,
               "in_for": False}
        body, _ = self._block(list(fdef.body), ctx)
        if self.uses_ret:
            body = ([_assign(self.RET_FLAG, _const(False)),
                     _assign(self.RET_VAL, _const(None))] + body
                    + [ast.Return(value=ast.Name(id=self.RET_VAL,
                                                 ctx=ast.Load()))])
        fdef.body = body
        return True

    # -------------------------------------------------------- blocks
    def _block(self, stmts, ctx):
        """Lower a statement list. Returns (new_stmts, always_exits)."""
        if not stmts:
            return [], False
        s, rest = stmts[0], stmts[1:]

        if isinstance(s, ast.Return) and ctx["ret"]:
            self.uses_ret = True
            out = [_assign(self.RET_FLAG, _const(True)),
                   _assign(self.RET_VAL, s.value
                           if s.value is not None else _const(None))]
            if ctx["in_for"]:
                out.append(ast.Break())
            return out, True          # rest unreachable

        if isinstance(s, ast.Break) and ctx.get("brk"):
            return [_assign(ctx["brk"], _const(True))], True

        if isinstance(s, ast.Continue) and ctx.get("cnt"):
            return [_assign(ctx["cnt"], _const(True))], True

        if isinstance(s, ast.If):
            return self._lower_if(s, rest, ctx)

        if isinstance(s, ast.While):
            return self._lower_while(s, rest, ctx)

        if isinstance(s, ast.For):
            return self._lower_for(s, rest, ctx)

        # plain statement (raw returns under try/with stay Python —
        # executing them natively still exits the function correctly)
        rest_low, r_always = self._block(rest, ctx)
        return [s] + rest_low, r_always

    def _guard_rest(self, out, rest, flags, ctx):
        if not rest:
            return out, False
        rest_low, _ = self._block(rest, ctx)
        if rest_low:
            out.append(ast.If(test=_flags_clear_test(flags),
                              body=rest_low, orelse=[]))
        return out, False

    def _lower_if(self, s, rest, ctx):
        import copy
        flags = self._stmt_flags(s, ctx)
        body_low, b_always = self._block(list(s.body), ctx)
        orelse_low, o_always = self._block(list(s.orelse), ctx)
        if not flags:
            node = ast.If(test=s.test, body=body_low or [ast.Pass()],
                          orelse=orelse_low)
            rest_low, r_always = self._block(rest, ctx)
            return [node] + rest_low, r_always
        # tail absorption: a branch that always exits pushes the trailing
        # statements into the other branch, so both cond outputs are real
        if b_always and rest:
            merged, m_always = self._block(
                list(copy.deepcopy(s.orelse)) + list(rest), ctx)
            node = ast.If(test=s.test, body=body_low,
                          orelse=merged or [ast.Pass()])
            return [node], b_always and m_always
        if o_always and s.orelse and rest:
            merged, m_always = self._block(
                list(copy.deepcopy(s.body)) + list(rest), ctx)
            node = ast.If(test=s.test, body=merged or [ast.Pass()],
                          orelse=orelse_low)
            return [node], o_always and m_always
        node = ast.If(test=s.test, body=body_low or [ast.Pass()],
                      orelse=orelse_low)
        if b_always and o_always and s.orelse:
            return [node], True
        return self._guard_rest([node], rest, flags, ctx)

    def _lower_while(self, s, rest, ctx):
        if s.orelse:               # while/else keeps Python semantics
            rest_low, r_always = self._block(rest, ctx)
            return [s] + rest_low, r_always
        has_brk = any(isinstance(n, ast.Break)
                      for st in s.body for n in _walk_stop_inner_loops(st))
        has_cnt = any(isinstance(n, ast.Continue)
                      for st in s.body for n in _walk_stop_inner_loops(st))
        may_ret = ctx["ret"] and self._may_return(s)
        brk = self._name("brk") if has_brk else None
        cnt = self._name("cnt") if has_cnt else None
        inner = {"ret": ctx["ret"], "brk": brk, "cnt": cnt,
                 "in_for": False}
        body_low, _ = self._block(list(s.body), inner)
        if cnt:
            body_low = [_assign(cnt, _const(False))] + body_low
        test = s.test
        test_flags = ([brk] if brk else []) \
            + ([self.RET_FLAG] if may_ret else [])
        if test_flags:
            test = ast.BoolOp(op=ast.And(),
                              values=[_flags_clear_test(test_flags), test])
        out = ([_assign(brk, _const(False))] if brk else []) \
            + [ast.While(test=test, body=body_low, orelse=[])]
        if may_ret:
            return self._guard_rest(out, rest, [self.RET_FLAG], ctx)
        rest_low, r_always = self._block(rest, ctx)
        return out + rest_low, r_always

    def _lower_for(self, s, rest, ctx):
        """Host for: its own break/continue stay Python; returns lower to
        flag-set + break so the loop exits, then the tail is guarded.
        The body is always recursed (nested whiles may need lowering)."""
        may_ret = ctx["ret"] and self._may_return(s)
        inner = {"ret": ctx["ret"], "brk": None, "cnt": None,
                 "in_for": True}
        body_low, _ = self._block(list(s.body), inner)
        if may_ret:
            # a return set ANYWHERE in the body (e.g. inside a nested
            # for, whose lowered break only exits that inner loop) must
            # stop THIS loop too, or later iterations re-run and
            # overwrite _pt_ret_val
            body_low.append(ast.If(
                test=ast.UnaryOp(op=ast.Not(),
                                 operand=_flags_clear_test(
                                     [self.RET_FLAG])),
                body=[ast.Break()], orelse=[]))
        node = ast.For(target=s.target, iter=s.iter, body=body_low,
                       orelse=list(s.orelse))
        if may_ret:
            return self._guard_rest([node], rest, [self.RET_FLAG], ctx)
        rest_low, r_always = self._block(rest, ctx)
        return [node] + rest_low, r_always


def _walk_scope_stop_defs(fdef):
    """Nodes of the function's own scope (no nested defs)."""
    for stmt in fdef.body:
        yield from _walk_stop_defs(stmt)


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites Tensor-capable ``if``/``while`` into dispatcher calls.

    Scheme: every name assigned in a converted block becomes BOTH a
    parameter of the branch/body functions AND an output. Call sites
    guard-initialize unbound names to the UNDEFINED sentinel, so
    pre-existing bindings flow through untouched branches unchanged and
    genuinely-undefined names fail loudly only when used."""

    def __init__(self, local_names=()):
        self.counter = 0
        self.changed = False
        self.local_names = set(local_names)
        self.root = None

    def _name(self, kind):
        self.counter += 1
        return f"_pt_{kind}_{self.counter}"

    # ---- if/elif/else ---------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        try:
            body_assigned = _assigned_names(node.body)
            else_assigned = _assigned_names(node.orelse)
        except _Unconvertible:
            return node
        out_names = body_assigned + [n for n in else_assigned
                                     if n not in body_assigned]
        tname, fname = self._name("true"), self._name("false")
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in out_names],
            ctx=ast.Load()))
        true_def = ast.FunctionDef(
            name=tname, args=_named_args(out_names),
            body=list(node.body) + [ret], decorator_list=[])
        false_body = list(node.orelse) if node.orelse else [ast.Pass()]
        false_def = ast.FunctionDef(
            name=fname, args=_named_args(out_names),
            body=false_body + [_copy_ret(ret)], decorator_list=[])
        ret_slots = [i for i, n in enumerate(out_names)
                     if n == _FlagLowering.RET_VAL]
        call = ast.Call(
            func=ast.Attribute(value=ast.Name(id="_pt_jst",
                                              ctx=ast.Load()),
                               attr="convert_ifelse", ctx=ast.Load()),
            args=[_PredicateBoolOps().visit(node.test),
                  ast.Name(id=tname, ctx=ast.Load()),
                  ast.Name(id=fname, ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                  for n in out_names], ctx=ast.Load()),
                  ast.List(elts=[_const(i) for i in ret_slots],
                           ctx=ast.Load())],
            keywords=[])
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store())
                      for n in out_names], ctx=ast.Store())],
            value=call) if out_names else ast.Expr(value=call)
        self.changed = True
        guards = [_guard_stmt(n) for n in out_names]
        return guards + [true_def, false_def, assign]

    # ---- while ----------------------------------------------------------
    def _loads_outside(self, node, name):
        """Count of ``name`` loads in the function outside ``node``
        (escape detection for loop temps). Over-counting (helper-def
        internals) is safe: it only keeps a name in the loop carry."""
        if self.root is None:
            return 1    # unknown context: conservatively 'escapes'
        total = sum(1 for n in ast.walk(self.root)
                    if isinstance(n, ast.Name) and n.id == name
                    and isinstance(n.ctx, ast.Load))
        inside = sum(1 for n in ast.walk(node)
                     if isinstance(n, ast.Name) and n.id == name
                     and isinstance(n.ctx, ast.Load))
        return total - inside

    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse:
            return node              # while/else: python semantics
        try:
            body_names = _assigned_names(node.body)
        except _Unconvertible:
            return node
        # predicate names restricted to this function's locals — a
        # module/global referenced in the test (e.g. `paddle`) must not
        # ride the loop carry
        pred_names = sorted({n.id for n in ast.walk(node.test)
                             if isinstance(n, ast.Name)
                             and isinstance(n.ctx, ast.Load)
                             and (n.id in self.local_names
                                  or n.id in body_names)})
        # body-local temps: first body use is a STORE, not read by the
        # predicate, and never loaded after the loop — they are not loop
        # state (no pre-loop value, no carry slot)
        temps = {n for n in _store_first_names(node.body, body_names)
                 if n not in pred_names
                 and self._loads_outside(node, n) == 0}
        body_names = [n for n in body_names if n not in temps]
        loop_names = body_names + [n for n in pred_names
                                   if n not in body_names]
        if not loop_names:
            return node
        cname, bname = self._name("while_cond"), self._name("while_body")
        args = _named_args(loop_names)
        cond_def = ast.FunctionDef(
            name=cname, args=args,
            body=[ast.Return(value=_PredicateBoolOps().visit(
                node.test))], decorator_list=[])
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in loop_names],
            ctx=ast.Load()))
        body_def = ast.FunctionDef(
            name=bname, args=_named_args(loop_names),
            body=list(node.body) + [ret], decorator_list=[])
        ret_slots = [i for i, n in enumerate(loop_names)
                     if n == _FlagLowering.RET_VAL]
        call = ast.Call(
            func=ast.Attribute(value=ast.Name(id="_pt_jst",
                                              ctx=ast.Load()),
                               attr="convert_while_loop",
                               ctx=ast.Load()),
            args=[ast.Name(id=cname, ctx=ast.Load()),
                  ast.Name(id=bname, ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                  for n in loop_names],
                            ctx=ast.Load()),
                  ast.List(elts=[_const(i) for i in ret_slots],
                           ctx=ast.Load())], keywords=[])
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store())
                      for n in loop_names], ctx=ast.Store())],
            value=call)
        self.changed = True
        guards = [_guard_stmt(n) for n in loop_names]
        return guards + [cond_def, body_def, assign]


def _named_args(names):
    return ast.arguments(posonlyargs=[],
                         args=[ast.arg(arg=n) for n in names],
                         vararg=None, kwonlyargs=[], kw_defaults=[],
                         kwarg=None, defaults=[])


def _copy_ret(ret):
    import copy
    return copy.deepcopy(ret)


# -------------------------------------------------------------- entry

def convert_function(fn):
    """Return ``fn`` rewritten with control-flow dispatchers, or ``fn``
    unchanged when conversion does not apply (no source, opted out,
    decorator-wrapped, or nothing to convert). Never raises: an
    unconvertible function keeps plain tracing, where a Tensor predicate
    then fails the ``fullgraph`` trace (reference: the error-then-fallback
    contract of program_translator)."""
    if getattr(fn, "_not_to_static", False):
        return fn
    if getattr(fn, "_pt_dy2static_converted", False):
        return fn
    if hasattr(fn, "__wrapped__"):
        # inspect.getsource would follow __wrapped__ and recompile the
        # inner function WITHOUT the wrapper's behavior — don't convert
        return fn
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    fdef.decorator_list = []
    # lowering passes first: for→while desugar, then break/continue/
    # return → flag state, so the converter below sees only plain
    # assignments (reference pipeline: loop_transformer →
    # break_continue/return transformers → ifelse/while conversion)
    try:
        # generic_visit: the skip-nested-defs rule must not skip the
        # root function def itself
        fd = _ForDesugar()
        fd.root = fdef
        fd.generic_visit(fdef)
        _FlagLowering().lower_function(fdef)
    except Exception:
        return fn
    # this function's local names: parameters + every plain-Name store
    a = fdef.args
    local_names = {p.arg for p in (a.posonlyargs + a.args
                                   + a.kwonlyargs)}
    if a.vararg:
        local_names.add(a.vararg.arg)
    if a.kwarg:
        local_names.add(a.kwarg.arg)
    local_names |= {n.id for n in ast.walk(fdef)
                    if isinstance(n, ast.Name)
                    and isinstance(n.ctx, ast.Store)}
    tr = _ControlFlowTransformer(local_names=local_names)
    tr.root = fdef
    tr.visit(fdef)
    if not tr.changed:
        return fn
    _hoist_guards(fdef)
    # the converted def runs inside a factory whose parameters are the
    # runtime module (``_pt_jst``) and the original closure's values, and
    # its globals are the function's own live module dict: late-bound and
    # later-defined globals resolve as for the original function, the
    # module namespace gains nothing (the factory lands in a separate
    # locals dict), and dynamo resolves the globals through the module
    freevars, cells = [], []
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        try:
            cells.append(cell.cell_contents)
            freevars.append(name)
        except ValueError:      # empty cell (recursive def)
            pass
    factory = ast.FunctionDef(
        name="_pt_factory", args=_named_args(["_pt_jst"] + freevars),
        body=[fdef, ast.Return(value=ast.Name(id=fdef.name,
                                              ctx=ast.Load()))],
        decorator_list=[])
    module = ast.Module(body=[factory], type_ignores=[])
    ast.fix_missing_locations(module)
    filename = f"<dy2static:{getattr(fn, '__qualname__', fn)}>"
    gen_src = ast.unparse(module)
    try:
        code = compile(gen_src, filename, "exec")
    except SyntaxError:
        return fn
    # register the generated source so inspect/tracebacks resolve it
    import linecache
    linecache.cache[filename] = (len(gen_src), None,
                                 gen_src.splitlines(True), filename)
    from . import dy2static_ast as _self
    loc: dict = {}
    try:
        exec(code, getattr(fn, "__globals__", None) or {}, loc)
        new_fn = loc["_pt_factory"](_self, *cells)
    except Exception:
        return fn
    try:
        new_fn._pt_dy2static_converted = True
    except Exception:
        pass
    return new_fn
