"""The flag-lowered loop constructs of tests/test_dy2static_constructs.py
on the port: break/continue, and a return inside a loop, under Tensor
predicates, lowered by the dy2static pass to loop-carried flags, ``cond``
and ``while_loop``, compile into one graph (``fullgraph=True``,
``backend="aot_eager"``) whose results equal the reference's eager ones."""
import numpy as np
import pytest

from torch_eager_ref import check_static

rng = np.random.default_rng(17)


def A(*shape):
    return rng.standard_normal(shape).astype("float32")


def FULL(v):
    return np.full((2,), v, np.float32)


def break_on_data_dependent_condition(M):
    def fn(x):
        i = M.zeros([], "float32")
        acc = M.zeros_like(x)
        while i < 100.0:
            acc = acc + x
            if M.sum(acc) > 5.0:
                break
            i = i + 1.0
        return acc
    return fn


def continue_skips_iterations(M):
    def fn(x):
        i = M.zeros([], "float32")
        acc = M.zeros_like(x)
        while i < 6.0:
            i = i + 1.0
            if M.sum(i % 2.0) < 0.5:
                continue
            acc = acc + x * i
        return acc
    return fn


def break_and_continue_same_loop(M):
    def fn(x):
        i = M.zeros([], "float32")
        acc = M.zeros_like(x)
        while i < 50.0:
            i = i + 1.0
            if M.sum(i % 2.0) < 0.5:
                continue
            if M.sum(i) > 7.0:
                break
            acc = acc + x * i
        return acc
    return fn


def nested_if_in_while_with_break(M):
    def fn(x):
        i = M.zeros([], "float32")
        acc = M.zeros_like(x)
        while i < 20.0:
            if M.sum(x) > 0.0:
                if M.sum(acc) > 4.0:
                    break
                acc = acc + M.abs(x)
            else:
                acc = acc - x
            i = i + 1.0
        return acc
    return fn


def return_inside_while(M):
    def fn(x):
        i = M.zeros([], "float32")
        while i < 10.0:
            x = x + 1.0
            if M.sum(x) > 8.0:
                return x * 10.0
            i = i + 1.0
        return x
    return fn


def break_plus_return_combo(M):
    def fn(x):
        i = M.zeros([], "float32")
        acc = M.zeros_like(x)
        while i < 30.0:
            acc = acc + x
            if M.sum(acc) > 9.0:
                break
            i = i + 1.0
        if M.sum(acc) > 5.0:
            return acc * 2.0
        return acc
    return fn


# (construct, inputs of each call, whether gradients are compared)
CASES = [
    (break_on_data_dependent_condition, [[FULL(0.7)]], False),
    (continue_skips_iterations, [[A(3)]], False),
    (break_and_continue_same_loop, [[A(2)]], False),
    (nested_if_in_while_with_break, [[FULL(0.5)], [FULL(-0.5)]], False),
    (return_inside_while, [[FULL(0.7)]], False),
    (break_plus_return_combo, [[FULL(0.8)], [FULL(0.1)]], False),
]


@pytest.mark.parametrize("make,calls,grad", CASES,
                         ids=[f"{c[0].__name__}-{i}"
                              for i, c in enumerate(CASES)])
def test_lowered_construct_compiles_to_the_reference_result(make, calls,
                                                            grad):
    check_static(make, calls, grad=grad)
