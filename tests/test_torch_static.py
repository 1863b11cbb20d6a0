"""The port's ``static`` package against the reference's: the control-flow
ops of tests/test_static_nn_bert.py (TestCond, TestWhileLoop,
TestSwitchCase, TestClosureGrads) eagerly and inside a ``jit.to_static``
graph (``torch.cond`` / ``while_loop``, ``backend="aot_eager"``), and the
facade: the mode switches, ``Executor``, the ``save_inference_model`` /
``load_inference_model`` round trip, scope, EMA, ``py_func``,
``gradients``, ``append_backward`` and ``accuracy``."""
import numpy as np
import pytest

from torch_eager_ref import P, T, to_np, load_reference_state, seed_both


def _f32(v):
    return np.float32(v)


# ---- TestCond ---------------------------------------------------------------
@pytest.mark.parametrize("op", ["lt", "gt"])
def test_cond_basic(op):
    outs = []
    for M in (P, T):
        a, b = M.to_tensor(_f32(3.0)), M.to_tensor(_f32(5.0))
        pred = a < b if op == "lt" else a > b
        outs.append(float(M.static.nn.cond(pred, lambda: a + b,
                                           lambda: a - b).numpy()))
    assert outs[1] == outs[0] == (8.0 if op == "lt" else -2.0)


def _cond_net(M):
    class Net(M.nn.Layer):
        def forward(self, x):
            return M.static.nn.cond(x.sum() > 0, lambda: x * 2,
                                    lambda: x - 1)
    return Net()


def test_cond_under_to_static_traced_pred():
    """One graph holds both branches (torch.cond); flipping the sign of
    the input takes the other one."""
    net = T.jit.to_static(_cond_net(T), backend="aot_eager")
    ref = P.jit.to_static(_cond_net(P))
    for v in (1.0, -1.0):
        x = np.full(4, v, np.float32)
        np.testing.assert_allclose(to_np(net(T.to_tensor(x))),
                                   to_np(ref(P.to_tensor(x))))
    np.testing.assert_allclose(to_np(net(T.to_tensor(np.ones(4, np.float32)
                                                     ))), np.full(4, 2.0))
    assert net._static_function.compiles == 1


@pytest.mark.parametrize("compiled", [False, True])
def test_gradient_through_cond(compiled):
    def fn(M):
        def f(x):
            return M.static.nn.cond(x.sum() > 0, lambda: x * 3,
                                    lambda: x * 5)
        return f

    grads = []
    for M in (P, T):
        f = fn(M)
        if compiled and M is T:
            f = T.jit.to_static(f, backend="aot_eager")
        x = M.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
        f(x).backward()
        grads.append(to_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0])
    np.testing.assert_allclose(grads[1], [3.0])


# ---- TestWhileLoop ----------------------------------------------------------
def _counter(M):
    def f(i, s):
        return M.static.nn.while_loop(lambda i_, s_: i_ < 10,
                                      lambda i_, s_: (i_ + 1, s_ + 2.0),
                                      (i, s))
    return f


def _vector_state(M):
    def f(i, x):
        return M.static.nn.while_loop(lambda i_, x_: i_ < 3,
                                      lambda i_, x_: (i_ + 1, x_ * 2),
                                      (i, x))
    return f


@pytest.mark.parametrize("make,init", [
    (_counter, (np.int32(0), np.float32(0.0))),
    (_vector_state, (np.int32(0), np.ones(4, np.float32)))],
    ids=["counter", "vector_state"])
@pytest.mark.parametrize("compiled", [False, True])
def test_while_loop(make, init, compiled):
    ref = make(P)(*[P.to_tensor(v) for v in init])
    f = make(T)
    if compiled:
        f = T.jit.to_static(f, backend="aot_eager")
    out = f(*[T.to_tensor(v) for v in init])
    assert isinstance(out, tuple) and len(out) == 2
    for r, t in zip(ref, out):
        assert str(t.dtype) == str(r.dtype)
        np.testing.assert_array_equal(to_np(t), to_np(r))
    if compiled:
        assert f.compiles == 1


def test_while_loop_trainable_var_raises_clearly():
    x = T.to_tensor(np.ones(4, np.float32), stop_gradient=False)
    i = T.to_tensor(np.int32(0))
    with pytest.raises(NotImplementedError):
        T.static.nn.while_loop(lambda i_, x_: i_ < 3,
                               lambda i_, x_: (i_ + 1, x_ * 2), (i, x))


# ---- TestSwitchCase ---------------------------------------------------------
def _mk(M, v):
    return lambda: M.to_tensor(np.float32(v))


def _switch(M, kind):
    def f(idx):
        if kind == "list":
            return M.static.nn.switch_case(idx, [_mk(M, 10), _mk(M, 20),
                                                 _mk(M, 30)])
        if kind == "default":
            return M.static.nn.switch_case(idx, [_mk(M, 10), _mk(M, 20)],
                                           default=_mk(M, -1))
        return M.static.nn.switch_case(idx, [(2, _mk(M, 2.0)),
                                             (5, _mk(M, 5.0))])
    return f


@pytest.mark.parametrize("kind,indices", [
    ("list", [1, 0, 2]), ("default", [7, 1]), ("pairs", [5, 2, 3])])
@pytest.mark.parametrize("compiled", [False, True])
def test_switch_case(kind, indices, compiled):
    ref = _switch(P, kind)
    f = _switch(T, kind)
    if compiled:
        f = T.jit.to_static(f, backend="aot_eager")
    for i in indices:
        r = ref(P.to_tensor(np.int32(i)))
        t = f(T.to_tensor(np.int32(i)))
        assert float(t.numpy()) == float(r.numpy()), (kind, i)
    if compiled:
        assert f.compiles == 1


def _case(M, default):
    def f(x):
        pairs = [(x < 0.1, lambda: x * 0), (x < 0.5, lambda: x * 10)]
        return M.static.nn.case(pairs, default=(lambda: x) if default
                                else None)
    return f


@pytest.mark.parametrize("default", [True, False])
@pytest.mark.parametrize("compiled", [False, True])
def test_case(default, compiled):
    f = _case(T, default)
    if compiled:
        f = T.jit.to_static(f, backend="aot_eager")
    for v in (0.05, 0.4, 0.9):
        r = _case(P, default)(P.to_tensor(np.float32(v)))
        t = f(T.to_tensor(np.float32(v)))
        np.testing.assert_allclose(float(t.numpy()), float(r.numpy()),
                                   rtol=1e-6)


# ---- TestClosureGrads -------------------------------------------------------
def _gate(M):
    class Gate(M.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = M.nn.Linear(4, 4)

        def forward(self, x):
            return M.static.nn.cond(x.sum() > 0, lambda: self.lin(x),
                                    lambda: x)
    return Gate()


@pytest.mark.parametrize("compiled", [False, True])
def test_layer_params_through_cond(compiled):
    """Parameters reached through a captured ``self`` get the reference's
    gradients through cond, eagerly and through torch.cond's backward."""
    seed_both(0)
    ref, port = _gate(P), _gate(T)
    load_reference_state(port, ref)
    if compiled:
        port = T.jit.to_static(port, backend="aot_eager")
    x = np.ones(4, np.float32)
    ref(P.to_tensor(x)).sum().backward()
    port(T.to_tensor(x)).sum().backward()
    g = to_np(port.lin.weight.grad)
    assert float(np.abs(g).sum()) > 0
    np.testing.assert_allclose(g, to_np(ref.lin.weight.grad), rtol=1e-6)
    np.testing.assert_allclose(to_np(port.lin.bias.grad),
                               to_np(ref.lin.bias.grad), rtol=1e-6)


def test_fc_reuses_parameters():
    x = T.to_tensor(np.ones((2, 6), np.float32))
    a = T.static.nn.fc(x, 3, name="shared_fc")
    b = T.static.nn.fc(x, 3, name="shared_fc")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.shape == [2, 3]
    assert len(T.static.nn.fc_parameters()) >= 2


# ---- the facade -------------------------------------------------------------
def test_mode_switches_and_exports():
    for M in (P, T):
        assert M.in_dynamic_mode()
        M.enable_static()
        assert not M.in_dynamic_mode()
        M.disable_static()
        assert M.in_dynamic_mode()
    assert T.static.cpu_places(2) == [T.CPUPlace(), T.CPUPlace()]
    assert isinstance(T.static.data("x", [None, 4]), T.jit.InputSpec)


def test_executor_and_inference_model_round_trip(tmp_path):
    seed_both(1)
    ref, net = P.nn.Linear(4, 3), T.nn.Linear(4, 3)
    load_reference_state(net, ref)
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    exe = T.static.Executor(T.CPUPlace())
    (out,) = exe.run(feed={"x": T.to_tensor(x)},
                     fetch_list=[lambda x: net(x)])
    np.testing.assert_allclose(to_np(out), to_np(ref(P.to_tensor(x))),
                               rtol=1e-6)
    path = str(tmp_path / "lin")
    spec = [T.static.InputSpec([None, 4], "float32", "x")]
    T.static.save_inference_model(path, spec, [], exe, layer=net)
    loaded, feeds, fetches = T.static.load_inference_model(path, exe)
    np.testing.assert_allclose(to_np(loaded(T.to_tensor(x))), to_np(out),
                               rtol=1e-6)
    with pytest.raises(NotImplementedError, match="layer="):
        T.static.save_inference_model(path, spec, [], exe)


def test_scope_state_and_ema():
    s = T.static.Scope()
    with T.static.scope_guard(s):
        T.static.create_parameter([2, 2], "float32", name="w")
        assert T.static.global_scope() is s
        assert s.find_var("w") is not None
    assert T.static.global_scope() is not s

    lin = T.nn.Linear(3, 2)
    ema = T.static.ExponentialMovingAverage(0.5)
    ema.register(lin.parameters())
    p = lin.parameters()[0]
    p.set_value(np.ones(p.shape, np.float32))
    ema.update()
    p.set_value(np.full(p.shape, 2.0, np.float32))
    ema.update()
    before = to_np(p).copy()
    with ema.apply():
        applied = to_np(p).copy()
    np.testing.assert_array_equal(to_np(p), before)
    # unbiased mean of [1, 2] under decay 0.5: (0.25 + 0.5*2)/0.75 = 5/3
    np.testing.assert_allclose(applied, 5.0 / 3.0, atol=1e-5)


def test_py_func_grad_gradients_and_accuracy():
    x_np = np.random.default_rng(2).standard_normal((3, 2)).astype(
        np.float32)
    x = T.to_tensor(x_np, stop_gradient=False)
    y = T.static.py_func(lambda a: a * a, x, None,
                         backward_func=lambda a, g:
                         (2 * a * g).astype(np.float32))
    y.sum().backward()
    np.testing.assert_allclose(to_np(x.grad), 2 * x_np, atol=1e-5)

    x = T.to_tensor(x_np, stop_gradient=False)
    (g,) = T.static.gradients([(x * x).sum()], [x])
    np.testing.assert_allclose(to_np(g), 2 * x_np, atol=1e-5)

    lin = T.nn.Linear(2, 1)
    pairs = T.static.append_backward(lin(x).sum())
    # every trainable leaf: the weights and x itself
    assert {tuple(p.shape) for p, _ in pairs} == {(2, 1), (1,), (3, 2)}
    for p, g in pairs:
        assert g is not None

    logits = np.array([[0.1, 0.9], [0.8, 0.2]], np.float32)
    lbl = np.array([1, 1])
    r = P.static.accuracy(P.to_tensor(logits), P.to_tensor(lbl))
    t = T.static.accuracy(T.to_tensor(logits), T.to_tensor(lbl))
    assert float(t.numpy()) == float(r.numpy()) == pytest.approx(0.5)
