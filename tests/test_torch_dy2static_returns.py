"""The early returns and for-over-Tensor constructs of
tests/test_dy2static_constructs.py on the port: the dy2static pass lowers
an early return under a Tensor predicate to a branch-merged return value
and ``for row in tensor`` to torch's ``scan`` (or an indexed while when the
body breaks), compiled into one graph (``fullgraph=True``,
``backend="aot_eager"``) whose results and gradients equal the
reference's eager ones; host predicates and host iterables keep Python
semantics."""
import numpy as np
import pytest

from torch_eager_ref import T, check_static, to_np

rng = np.random.default_rng(17)


def A(*shape):
    return rng.standard_normal(shape).astype("float32")


def FULL(v):
    return np.full((2,), v, np.float32)


def early_return_both_branches(M):
    def fn(x):
        if M.sum(x) > 0.0:
            return x * 2.0
        return x - 1.0
    return fn

def early_return_with_tail_code(M):
    def fn(x):
        y = x + 1.0
        if M.sum(y) > 3.0:
            return y * 10.0
        y = y * 2.0
        return y + 0.5
    return fn

def for_over_tensor_rows(M):
    def fn(m):
        acc = M.zeros([3], "float32")
        for row in m:
            acc = acc + row * 2.0
        return acc
    return fn

def for_over_tensor_with_break(M):
    def fn(m):
        acc = M.zeros([3], "float32")
        for row in m:
            acc = acc + row
            if M.sum(acc) > 2.0:
                break
        return acc
    return fn

def for_over_host_list_unchanged(M):
    def fn(x):
        acc = M.zeros_like(x)
        for s in [0.5, 1.5, 2.0]:
            acc = acc + x * s
        return acc
    return fn

def not_predicate_accumulation(M):
    def fn(x):
        done = M.zeros([], "bool")
        i = M.zeros([], "float32")
        while M.logical_not(done):
            x = x + 1.0
            i = i + 1.0
            done = M.sum(x) > 6.0
        return x * i
    return fn


# (construct, inputs of each call, whether gradients are compared)
CASES = [
    (early_return_both_branches, [[FULL(0.7)], [FULL(-0.7)]], True),
    (early_return_with_tail_code, [[FULL(2.0)], [FULL(-2.0)]], True),
    (for_over_tensor_rows, [[A(5, 3)]], True),
    (for_over_tensor_with_break, [[np.full((6, 3), 0.4, np.float32)]], False),
    (for_over_host_list_unchanged, [[A(2, 2)]], True),
    (not_predicate_accumulation, [[FULL(0.2)]], False),
]


@pytest.mark.parametrize("make,calls,grad", CASES,
                         ids=[f"{c[0].__name__}-{i}"
                              for i, c in enumerate(CASES)])
def test_lowered_construct_compiles_to_the_reference_result(make, calls,
                                                            grad):
    check_static(make, calls, grad=grad)


def test_host_predicate_break_and_return_still_python():
    def brk(x, n):
        acc = T.zeros_like(x)
        i = 0
        while i < 100:
            acc = acc + x
            i += 1
            if i >= n:
                break
        return acc

    def ret(x, flag):
        if flag:
            return x * 2.0
        return x - 1.0

    x = A(2, 2)
    np.testing.assert_allclose(
        to_np(T.jit.to_static(brk, backend="aot_eager")(T.to_tensor(x), 3)),
        to_np(brk(T.to_tensor(x), 3)), rtol=1e-6)
    sret = T.jit.to_static(ret, backend="aot_eager")
    for flag in (True, False):
        np.testing.assert_allclose(to_np(sret(T.to_tensor(x), flag)),
                                   to_np(ret(T.to_tensor(x), flag)),
                                   rtol=1e-6)


def test_continue_in_desugared_range_advances_induction():
    def fn(x, n):
        s = T.zeros_like(x)
        for i in range(n):
            if i % 2 == 1:
                continue
            s = s + x * i
        return s
    x = A(2)
    np.testing.assert_allclose(
        to_np(T.jit.to_static(fn, backend="aot_eager")(T.to_tensor(x), 4)),
        to_np(fn(T.to_tensor(x), 4)), rtol=1e-6)


def test_return_in_nested_host_for_first_match_wins():
    n = 0

    def fn(x):
        for i in [10, 20, 30]:
            for j in [1, 2]:
                if i + j > n:
                    return x * float(i + j)
        if T.sum(x) > 0.0:
            return x
        return -x
    x = np.full((2,), 1.0, np.float32)
    s = to_np(T.jit.to_static(fn, backend="aot_eager")(T.to_tensor(x)))
    np.testing.assert_allclose(s, to_np(fn(T.to_tensor(x))), rtol=1e-6)
    assert float(s[0]) == 11.0
