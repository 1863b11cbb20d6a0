"""The port's autograd.functional (vjp, jvp, jacobian, hessian), L-BFGS,
nn.utils and regularizer against the reference's, on the CPU: the
transforms to 1e-5 on the same numpy inputs, the two problems of the
reference's TestLBFGS (tests/test_extensions_misc.py) with the same
seeded weights, weight/spectral norm's forward and gradients, and an
optimizer step under each paddle.regularizer decay."""
import numpy as np
import pytest

from torch_eager_ref import P, T, assert_close, seed_both, to_np

TOL = 1e-5
_RNG = np.random.default_rng(41)
A = _RNG.standard_normal((3,)).astype(np.float32)
B = _RNG.standard_normal((2, 3)).astype(np.float32)
V3 = _RNG.standard_normal((3,)).astype(np.float32)


def _f1(M):
    return lambda x: M.sum(M.tanh(x) * x * x)


def _f2(M):
    return lambda x, w: M.matmul(w, M.sin(x))


@pytest.mark.parametrize("transform", ["vjp", "jvp", "jacobian", "hessian"])
def test_transforms_match_reference(transform):
    """Each transform of a scalar function of one input, and (but
    hessian) of a vector function of two inputs."""
    out = {}
    for M in (P, T):
        ag = M.autograd
        x, w = M.to_tensor(A), M.to_tensor(B)
        if transform == "vjp":
            o1, g1 = ag.vjp(_f1(M), x)
            o2, g2 = ag.vjp(_f2(M), [x, w], M.to_tensor(np.ones(2,
                                                                np.float32)))
            res = [o1, g1, o2] + list(g2)
        elif transform == "jvp":
            o1, t1 = ag.jvp(_f1(M), x, M.to_tensor(V3))
            o2, t2 = ag.jvp(_f2(M), [x, w])
            res = [o1, t1, o2, t2]
        elif transform == "jacobian":
            res = [ag.jacobian(_f1(M), x)] + list(ag.jacobian(_f2(M),
                                                             [x, w]))
        else:
            h = ag.hessian(_f1(M), x)
            hh = ag.hessian(lambda x, y, M=M: M.sum(x * x * y), [x, x])
            res = [h] + [t for row in hh for t in row]
        out[M] = [to_np(r) for r in res]
    assert len(out[P]) == len(out[T])
    for a, b in zip(out[P], out[T]):
        assert_close(a, b, TOL)


def test_jacobian_hessian_of_the_reference_test():
    """tests/test_autograd.py:151: d/dt sum(t * t) at [1, 2] is [2, 4]
    and its Hessian 2 I."""
    x = T.to_tensor(np.array([1.0, 2.0], np.float32))
    f = lambda t: T.sum(t * t)    # noqa: E731
    np.testing.assert_allclose(to_np(T.autograd.jacobian(f, x)), [2.0, 4.0])
    np.testing.assert_allclose(to_np(T.autograd.hessian(f, x)),
                               2 * np.eye(2))


def _quadratic(M, line_search):
    p = M.Parameter(np.array([5.0, -3.0, 2.0], np.float32))
    opt = M.optimizer.LBFGS(learning_rate=1.0, max_iter=20, parameters=[p],
                            line_search_fn=line_search)
    target = np.array([1.0, 2.0, 3.0], np.float32)

    def closure():
        opt.clear_grad()
        diff = p - M.to_tensor(target)
        loss = (diff * diff).sum()
        loss.backward()
        return loss

    loss = opt.step(closure)
    return [to_np(p), to_np(loss)], target


def _mlp(M):
    M.seed(1)
    net = M.nn.Linear(4, 1)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((32, 4)).astype(np.float32)
    w = rng.standard_normal((4, 1)).astype(np.float32)
    Y = X @ w
    opt = M.optimizer.LBFGS(learning_rate=0.5, max_iter=10,
                            parameters=net.parameters())

    def closure():
        opt.clear_grad()
        loss = ((net(M.to_tensor(X)) - M.to_tensor(Y)) ** 2).mean()
        loss.backward()
        return loss

    l0 = float(closure().numpy())
    l1 = float(opt.step(closure).numpy())
    return [np.float32(l0), np.float32(l1)] + [to_np(p)
                                               for p in net.parameters()]


@pytest.mark.parametrize("problem", ["quadratic_strong_wolfe",
                                     "quadratic_plain", "mlp"])
def test_lbfgs_matches_reference(problem):
    """TestLBFGS's problems: the quadratic converges to its target within
    1e-4 (the reference test's bound), the MLP's loss falls below a tenth;
    parameters and losses agree with the reference's run to 1e-4."""
    if problem == "mlp":
        r, t = _mlp(P), _mlp(T)
        assert t[1] < 0.1 * t[0]
    else:
        ls = "strong_wolfe" if problem.endswith("wolfe") else None
        (r, target), (t, _) = _quadratic(P, ls), _quadratic(T, ls)
        np.testing.assert_allclose(t[0], target, atol=1e-4)
    for a, b in zip(r, t):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_parameters_vector_round_trip():
    out = {}
    for M in (P, T):
        seed_both(3)
        net = M.nn.Linear(3, 2)
        vec = M.nn.utils.parameters_to_vector(net.parameters())
        M.nn.utils.vector_to_parameters(vec * 2.0, net.parameters())
        out[M] = [to_np(vec)] + [to_np(p) for p in net.parameters()]
    for a, b in zip(out[P], out[T]):
        assert_close(a, b, TOL)
    assert out[T][0].shape == (8,)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_reference(dim):
    """weight_norm's parameters, forward and gradients (g and v), then
    remove_weight_norm's weight, against the reference's."""
    x = _RNG.standard_normal((2, 4)).astype(np.float32)
    out = {}
    for M in (P, T):
        seed_both(7)
        lin = M.nn.Linear(4, 3)
        M.nn.utils.weight_norm(lin, dim=dim)
        y = lin(M.to_tensor(x))
        M.sum(y * y).backward()
        params = dict(lin.named_parameters())
        res = [to_np(y), to_np(params["weight_g"]),
               to_np(params["weight_g"].grad),
               to_np(params["weight_v"].grad)]
        M.nn.utils.remove_weight_norm(lin)
        res += [to_np(lin.weight), to_np(lin(M.to_tensor(x)))]
        out[M] = res
        assert "weight" in dict(lin.named_parameters())
    for a, b in zip(out[P], out[T]):
        assert_close(a, b, TOL)


def test_spectral_norm_matches_reference():
    x = _RNG.standard_normal((2, 4)).astype(np.float32)
    out = {}
    for M in (P, T):
        seed_both(8)
        lin = M.nn.Linear(4, 3)
        M.nn.utils.spectral_norm(lin, n_power_iterations=2)
        out[M] = [to_np(lin(M.to_tensor(x))), to_np(lin.weight)]
        assert "weight_orig" in dict(lin.named_parameters())
    for a, b in zip(out[P], out[T]):
        assert_close(a, b, TOL)


@pytest.mark.parametrize("decay", ["L1Decay", "L2Decay"])
def test_regularizer_decays_an_sgd_step(decay):
    """paddle.regularizer's decay as weight_decay of an SGD step, against
    the reference's; it is the optimizer module's class."""
    assert getattr(T.regularizer, decay) is getattr(T.optimizer, decay)
    x = _RNG.standard_normal((2, 4)).astype(np.float32)
    out = {}
    for M in (P, T):
        seed_both(9)
        lin = M.nn.Linear(4, 3)
        opt = M.optimizer.SGD(0.1, parameters=lin.parameters(),
                              weight_decay=getattr(M.regularizer, decay)(0.3))
        M.sum(lin(M.to_tensor(x))).backward()
        opt.step()
        out[M] = [to_np(p) for p in lin.parameters()]
    for a, b in zip(out[P], out[T]):
        assert_close(a, b, TOL)
