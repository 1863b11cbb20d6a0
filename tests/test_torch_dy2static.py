"""The port's dy2static (``paddle_tpu_torch.jit.dy2static_ast`` under
``jit.to_static``) against the reference's, case for case from
tests/test_dy2static_ast.py: Tensor-predicate ``if``/``while``/``for``
compile into ONE graph (``fullgraph=True``, so a graph break raises; the
``compiles`` counter counts graphs) whose results equal the reference's.
The port compiles with ``backend="aot_eager"`` (no inductor on the CPU)."""
import functools
import inspect
import sys

import numpy as np
import pytest

from torch_eager_ref import P, T, to_np, load_reference_state, seed_both


def _static(M, fn):
    if M is T:
        return T.jit.to_static(fn, backend="aot_eager")
    return P.jit.to_static(fn)


def _square_or_negate_for(M):
    def _square_or_negate(x):
        s = x.sum()
        if s > 0:
            y = x * x
        else:
            y = -x
        return y + 0.0
    return _square_or_negate


def _count_to_for(M):
    def _count_to(limit):
        i = M.to_tensor(np.float32(0.0))
        total = M.to_tensor(np.float32(0.0))
        while i < limit:
            total = total + i
            i = i + 1.0
        return total
    return _count_to


def _nested_for(M):
    def _nested(x):
        s = x.sum()
        if s > 0:
            if s > 10:
                y = x * 3
            else:
                y = x * 2
        else:
            y = x
        return y
    return _nested


def _fib_for(M):
    def fib(n):
        a = M.to_tensor(np.float32(0.0))
        b = M.to_tensor(np.float32(1.0))
        i = M.to_tensor(np.float32(0.0))
        while i < n:
            c = a + b
            a = b
            b = c
            i = i + 1.0
        return a
    return fib


def _sum_to_for(M):
    def sum_to(n):
        total = M.to_tensor(np.float32(0.0))
        for i in range(n):
            total = total + i
        return total
    return sum_to


def _module_name_in_predicate_for(M):
    def g(x):
        i = M.to_tensor(np.float32(0.0))
        while i < np.float32(3.0):
            x = x + 1.0
            i = i + 1.0
        return x
    return g


def _both_positive(a, b):
    if (a.sum() > 0) and (b.sum() > 0):
        y = a + b
    else:
        y = a - b
    return y


def _either(a, b, use_python=False):
    if use_python or (a.sum() > 0):
        y = a * 2
    else:
        y = b
    return y


def _gated(a, flag=True):
    if (a.sum() > 0) and flag:
        y = a * 2
    else:
        y = a
    return y


V2P = np.array([1.0, 2.0], np.float32)
V1P, V1N = np.array([1.0], np.float32), np.array([-1.0], np.float32)

# (name, function factory, argument lists): each list is one call, all of
# one signature, so the port compiles each function once
ONE_GRAPH = [
    ("square_or_negate", _square_or_negate_for, [[V2P], [-V2P]]),
    ("count_to", _count_to_for, [[np.float32(5.0)], [np.float32(3.0)]]),
    ("nested", _nested_for, [[V2P], [V2P * 10], [-V2P]]),
    ("fib", _fib_for, [[np.float32(7.0)], [np.float32(3.0)]]),
    ("for_over_tensor_range", _sum_to_for, [[np.int32(5)], [np.int32(3)]]),
    ("module_name_in_while_predicate", _module_name_in_predicate_for,
     [[np.float32(1.0)]]),
    ("boolop_and", lambda M: _both_positive,
     [[V1P, V1P], [V1P, V1N], [V1N, V1P]]),
    ("boolop_or_tensor", lambda M: _either, [[V1P, V1N], [V1N, V1P]]),
    ("boolop_tensor_lhs_host_rhs", lambda M: _gated, [[V1P], [V1N]]),
]


@pytest.mark.parametrize("name,factory,calls", ONE_GRAPH,
                         ids=[c[0] for c in ONE_GRAPH])
def test_converted_control_flow_one_graph_equals_the_reference(
        name, factory, calls):
    """Each call's result equals the reference's compiled one; the port
    compiles one graph for all of them (flipping the predicate takes the
    other branch inside the graph, no recompile)."""
    ref_fn, port_fn = _static(P, factory(P)), _static(T, factory(T))
    for args in calls:
        r = ref_fn(*[P.to_tensor(a) for a in args])
        t = port_fn(*[T.to_tensor(a) for a in args])
        np.testing.assert_allclose(to_np(t), to_np(r), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name}{args}")
    assert port_fn.compiles == 1


def test_the_parent_user_error_case_converts():
    """Before the AST pass, dynamo raised ``UserError: Could not guard on
    data-dependent expression`` on ``if x.sum() > 0`` of a to_static
    function; converted, it compiles into one graph."""
    fn = _static(T, _square_or_negate_for(T))
    out = fn(T.to_tensor(-V2P))
    np.testing.assert_allclose(to_np(out), V2P)
    assert fn.compiles == 1 and len(fn.compile_seconds) == 1


def test_unconverted_tensor_predicate_still_raises_at_trace():
    """Without the pass (``not_to_static`` keeps the function as written)
    the Tensor predicate fails the fullgraph trace; nothing falls back to
    eager."""
    @T.jit.not_to_static
    def keep(x):
        if x.sum() > 0:
            y = x
        else:
            y = -x
        return y

    with pytest.raises(Exception, match="data-dependent"):
        T.jit.to_static(keep, backend="aot_eager")(T.to_tensor(V2P))


def test_host_predicate_keeps_python_semantics():
    def host_branch(x, flag=True):
        if flag:
            y = x + 1
        else:
            y = x - 1
        return y

    for M in (P, T):
        fn = _static(M, host_branch)
        x = M.to_tensor(V2P)
        np.testing.assert_allclose(to_np(fn(x)), [2, 3])
        np.testing.assert_allclose(to_np(fn(x, flag=False)), [0, 1])


def test_grad_flows_through_converted_if():
    def branchy(x):
        if x.sum() > 0:
            y = (x * x).sum()
        else:
            y = (-x).sum()
        return y

    from paddle_tpu.jit.dy2static_ast import convert_function as ref_conv
    from paddle_tpu_torch.jit.dy2static_ast import convert_function
    grads = []
    for M, conv in ((P, ref_conv), (T, convert_function)):
        x = M.to_tensor(V2P, stop_gradient=False)
        conv(branchy)(x).backward()
        grads.append(to_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0])
    np.testing.assert_allclose(grads[1], [2, 4])


def _gate_for(M):
    class Gate(M.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = M.nn.Linear(2, 2)

        def forward(self, x):
            h = self.lin(x)
            if h.sum() > 0:
                out = h * 2
            else:
                out = h
            return out
    return Gate()


def test_layer_method_converts():
    """A Layer's forward with a Tensor predicate reading ``self``: the
    reference's weights, both branches, one graph."""
    seed_both(0)
    ref, port = _gate_for(P), _gate_for(T)
    load_reference_state(port, ref)
    ref, port = P.jit.to_static(ref), T.jit.to_static(port,
                                                       backend="aot_eager")
    for v in (5.0, -5.0):
        x = np.full((1, 2), v, np.float32)
        r, t = ref(P.to_tensor(x)), port(T.to_tensor(x))
        assert t.shape == [1, 2]
        np.testing.assert_allclose(to_np(t), to_np(r), rtol=1e-6, atol=1e-6)
    assert port._static_function.compiles == 1


def test_not_to_static_opts_out():
    from paddle_tpu_torch.jit.dy2static_ast import convert_function

    @T.jit.not_to_static
    def keep(x):
        if x.sum() > 0:
            y = x
        else:
            y = -x
        return y

    assert convert_function(keep) is keep


def test_unconvertible_blocks_left_alone():
    from paddle_tpu_torch.jit.dy2static_ast import convert_function

    def early(x, flag):
        if flag:
            return x + 1
        return x - 1

    conv = convert_function(early)
    x = T.to_tensor(np.array([1.0], np.float32))
    assert float(conv(x, True).numpy()) == 2.0
    assert float(conv(x, False).numpy()) == 0.0


def test_converted_fn_traces_once_with_data_dependence():
    """The graph holds the branch: flipping the input's sign flips the
    output without a second graph. (The reference counts Python runs of
    the body; under dynamo a Python counter in the body is itself guarded
    on and would force the retrace it counts, so the graphs are counted.)
    """
    def branching(x):
        s = x.sum()
        if s > 0:
            y = x * 10
        else:
            y = x * 100
        return y

    sfn = _static(T, branching)
    np.testing.assert_allclose(to_np(sfn(T.to_tensor(V1P))), [10.0])
    np.testing.assert_allclose(to_np(sfn(T.to_tensor(V1N))), [-100.0])
    assert sfn.compiles == 1


def test_single_branch_assign_keeps_prebinding():
    from paddle_tpu_torch.jit.dy2static_ast import convert_function

    def f(x, flag=False):
        y = T.to_tensor(np.float32(0.0))
        if flag:
            y = x * 2
        return y + 1

    conv = convert_function(f)
    x = T.to_tensor(np.float32(3.0))
    assert float(conv(x).numpy()) == 1.0
    assert float(conv(x, flag=True).numpy()) == 7.0


def test_while_variable_used_after_loop_survives():
    from paddle_tpu_torch.jit.dy2static_ast import convert_function

    def h(x):
        n = 3
        best = x + 100.0
        while n > 0:
            best = x * n
            n = n - 1
        return best

    conv = convert_function(h)
    assert float(conv(T.to_tensor(np.float32(2.0))).numpy()) == 2.0


def test_wrapped_function_not_converted():
    from paddle_tpu_torch.jit.dy2static_ast import convert_function

    def deco(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            return fn(*a, **kw)
        return inner

    @deco
    def d(x, flag=True):
        if flag:
            y = x + 1
        else:
            y = x - 1
        return y

    assert convert_function(d) is d
    x = T.to_tensor(np.float32(1.0))
    assert float(_static(T, d)(x).numpy()) == 2.0


def test_late_bound_global_resolves(tmp_path):
    """A converted function reads its module's live globals, and the
    conversion adds nothing to that module."""
    mod_src = (
        "SCALE = 1\n"
        "def scaled(x):\n"
        "    if x.sum() > 0:\n"
        "        y = x * SCALE\n"
        "    else:\n"
        "        y = x\n"
        "    return y\n")
    p = tmp_path / "d2smod_torch.py"
    p.write_text(mod_src)
    sys.path.insert(0, str(tmp_path))
    try:
        import d2smod_torch
        before = set(vars(d2smod_torch))
        conv = _static(T, d2smod_torch.scaled)
        x = T.to_tensor(np.array([2.0], np.float32))
        assert float(conv(x).numpy()[0]) == 2.0
        d2smod_torch.SCALE = 10
        conv2 = _static(T, d2smod_torch.scaled)
        assert float(conv2(x).numpy()[0]) == 20.0
        assert set(vars(d2smod_torch)) == before
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("d2smod_torch", None)


def test_boolop_or_host_short_circuit():
    """``use_python or ...`` with a host True keeps Python's short
    circuit: the Tensor operand is never read."""
    r = _static(P, _either)(P.to_tensor(V1N), P.to_tensor(V1P),
                            use_python=True)
    t = _static(T, _either)(T.to_tensor(V1N), T.to_tensor(V1P),
                            use_python=True)
    assert float(to_np(t)[0]) == float(to_np(r)[0]) == -2.0


def test_boolop_tensor_lhs_host_false():
    r = _static(P, _gated)(P.to_tensor(V1P), flag=False)
    t = _static(T, _gated)(T.to_tensor(V1P), flag=False)
    assert float(to_np(t)) == float(to_np(r)) == 1.0


def test_value_position_boolop_untouched():
    from paddle_tpu_torch.jit.dy2static_ast import convert_function

    def g(a, b):
        if a.sum() > 0:
            c = a + 1
        else:
            c = a - 1
        z = a and b            # value position: Python semantics
        return c, z

    conv = convert_function(g)
    c, z = conv(T.to_tensor(V1P), T.to_tensor(np.array([5.0], np.float32)))
    assert float(z.numpy()) == 5.0
    assert float(c.numpy()) == 2.0


def test_for_literal_range_stays_python():
    from paddle_tpu_torch.jit.dy2static_ast import convert_function

    def unrolled(x):
        for _ in range(3):          # literal: static unroll
            x = x + 1
        if x.sum() > 0:             # forces conversion of the function
            y = x
        else:
            y = -x
        return y

    conv = convert_function(unrolled)
    gen = inspect.getsource(conv)
    assert "convert_while_loop" not in gen
    assert "convert_ifelse" in gen
    out = conv(T.to_tensor(np.array([0.0], np.float32)))
    assert float(out.numpy()) == 3.0


def test_for_range_python_fidelity():
    from paddle_tpu_torch.jit.dy2static_ast import convert_function

    def mutating(n):
        c = 0
        for i in range(n):
            n = n - 1               # must NOT shorten the loop
            i = i + 100             # must NOT skip iterations
            c = c + 1
        return c, i

    assert convert_function(mutating)(4) == (4, 103)
