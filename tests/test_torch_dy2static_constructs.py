"""The per-construct dy2static matrix of tests/test_dy2static_constructs.py
on the port: each function, compiled by the port's ``jit.to_static``
(``backend="aot_eager"``, ``fullgraph=True``), gives the reference's eager
result and gradients; constructs the conversion contract leaves out raise
at trace time instead of falling back to eager."""
import numpy as np
import pytest

from torch_eager_ref import (P, T, check_static, load_reference_state,
                             seed_both, to_np)

rng = np.random.default_rng(17)


def A(*shape):
    return rng.standard_normal(shape).astype("float32")


# ---- TestControlFlow -------------------------------------------------------
def python_if_on_shape(M):
    def fn(x):
        if x.shape[0] > 2:
            return x * 2.0
        return x - 1.0
    return fn


def for_range_loop(M):
    def fn(x):
        acc = M.zeros_like(x)
        for i in range(4):
            acc = acc + x * float(i)
        return acc
    return fn


def while_with_static_condition(M):
    def fn(x):
        i, acc = 0, x
        while i < 3:
            acc = M.tanh(acc)
            i += 1
        return acc
    return fn


def break_continue(M):
    def fn(x):
        acc = M.zeros_like(x)
        for i in range(10):
            if i == 5:
                break
            if i % 2 == 1:
                continue
            acc = acc + x / float(i + 1)
        return acc
    return fn


def ternary_and_boolean_ops(M):
    def fn(x):
        y = x * 2.0 if x.ndim == 2 else x
        z = y + 1.0 if (y.ndim == 2 and y.shape[1] == 3) else y - 1.0
        return z
    return fn


def static_nn_cond(M):
    cond = M.static.nn.cond

    def fn(x):
        return cond(M.sum(x) > 0, lambda: x * 2.0, lambda: x * -1.0)
    return fn


def static_nn_while_loop(M):
    while_loop = M.static.nn.while_loop

    def fn(x):
        i = M.to_tensor(np.int32(0))

        def cond_fn(i, acc):
            return i < 3

        def body(i, acc):
            return i + 1, acc * 1.5
        _, out = while_loop(cond_fn, body, [i, x])
        return out
    return fn


# ---- TestContainersAndCalls ------------------------------------------------
def nested_function_and_closure(M):
    def fn(x):
        scale = 3.0

        def inner(v):
            return v * scale
        return inner(x) + inner(x * 0.5)
    return fn


def list_append_static_len(M):
    def fn(x):
        parts = []
        for i in range(3):
            parts.append(x * float(i + 1))
        return M.concat(parts, axis=0)
    return fn


def dict_of_tensors(M):
    def fn(x):
        d = {"a": x * 2.0, "b": x - 1.0}
        d["c"] = d["a"] + d["b"]
        return d["c"]
    return fn


def tuple_unpack_and_multiple_returns(M):
    def helper(x):
        return x * 2.0, x + 1.0

    def fn(x):
        a, b = helper(x)
        return a * b
    return fn


def enumerate_zip(M):
    def fn(x):
        acc = M.zeros_like(x)
        weights = [0.5, 1.0, 1.5]
        for i, (w, w2) in enumerate(zip(weights, weights)):
            acc = acc + x * w * w2 * float(i + 1)
        return acc
    return fn


# (construct, inputs of each call, whether gradients are compared)
CASES = [
    (python_if_on_shape, [[A(4, 3)]], True),
    (python_if_on_shape, [[A(2, 3)]], False),
    (for_range_loop, [[A(3, 3)]], True),
    (while_with_static_condition, [[A(2, 4)]], True),
    (break_continue, [[A(3, 2)]], True),
    (ternary_and_boolean_ops, [[A(2, 3)]], True),
    (static_nn_cond,
     [[np.abs(A(2, 2)) + 0.1], [-np.abs(A(2, 2)) - 0.1]], True),
    (static_nn_while_loop, [[A(2, 2)]], False),
    (nested_function_and_closure, [[A(2, 3)]], True),
    (list_append_static_len, [[A(2, 2)]], True),
    (dict_of_tensors, [[A(3, 2)]], True),
    (tuple_unpack_and_multiple_returns, [[A(2, 2)]], True),
    (enumerate_zip, [[A(2, 2)]], True),
]


@pytest.mark.parametrize("make,calls,grad", CASES,
                         ids=[f"{c[0].__name__}-{i}"
                              for i, c in enumerate(CASES)])
def test_construct_compiles_to_the_reference_result(make, calls, grad):
    check_static(make, calls, grad=grad)


def test_while_loop_grad_raises_clearly():
    """As the reference's: a while_loop var that requires grad raises
    NotImplementedError (the loop carries no gradient)."""
    def fn(x):
        def cond_fn(acc):
            return T.sum(T.abs(acc)) < 100.0

        def body(acc):
            return (acc * 2.0,)
        (out,) = T.static.nn.while_loop(cond_fn, body, [x])
        return out

    x = T.to_tensor(A(2, 2), stop_gradient=False)
    with pytest.raises(NotImplementedError, match="reverse-diff"):
        T.sum(fn(x)).backward()


def test_method_call_on_layer():
    def net_for(M):
        class Net(M.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = M.nn.Linear(4, 4)

            def helper(self, x):
                return M.tanh(x)

            def forward(self, x):
                return self.helper(self.fc(x))
        return Net()

    seed_both(3)
    ref, port = net_for(P), net_for(T)
    load_reference_state(port, ref)
    x = A(2, 4)
    eager = to_np(ref(P.to_tensor(x)))
    snet = T.jit.to_static(port, backend="aot_eager")
    np.testing.assert_allclose(to_np(snet(T.to_tensor(x))), eager, rtol=1e-5)


def test_shape_and_dtype_change_recompile():
    """A new shape or dtype compiles a new graph; the same one reuses it
    (the reference retraces per signature alike)."""
    sfn = T.jit.to_static(lambda x: x * 2.0, backend="aot_eager")
    sfn(T.to_tensor(A(2, 3)))
    sfn(T.to_tensor(A(2, 3)))
    assert sfn.compiles == 1
    sfn(T.to_tensor(A(4, 3)))
    assert sfn.compiles == 2
    sfn(T.to_tensor(np.ones((4, 3), np.int64)))
    assert sfn.compiles == 3


def test_python_if_on_tensor_value_out_of_contract_raises():
    """A subscript store in the branch keeps the ``if`` out of the
    conversion contract: its Tensor predicate fails the fullgraph trace
    (the reference raises jax's concretization error), never silently
    picking a branch."""
    def fn(x):
        out = {}
        if T.sum(x) > 0:
            out["y"] = x * 2.0
        else:
            out["y"] = x
        return out["y"]
    with pytest.raises(Exception, match="data-dependent"):
        T.jit.to_static(fn, backend="aot_eager")(T.to_tensor(A(2, 2)))
