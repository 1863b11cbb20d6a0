"""Shared pieces of the eager-surface parity tests (tests/test_torch_eager_*):
the reference package and the port side by side on the CPU, and the one
helper that carries a reference Layer's weights into the port's."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T

T.set_device("cpu")


def to_np(t) -> np.ndarray:
    """A Tensor of either package (or an array) as a float-faithful numpy
    array (bf16 widened to f32)."""
    a = np.asarray(t.numpy() if hasattr(t, "numpy") else t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def load_reference_state(port_layer, ref_layer):
    """Give ``port_layer`` the reference Layer's weights: the reference's
    ``state_dict()`` as numpy arrays, loaded by paddle's keys through
    ``set_state_dict``. Keys must match both ways."""
    state = {k: np.asarray(v.numpy()) for k, v in
             ref_layer.state_dict().items()}
    missing, unexpected = port_layer.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)
    return port_layer


def pair(arr, stop_gradient=True):
    """The same numpy input as a reference Tensor and a port Tensor."""
    return (P.to_tensor(arr, stop_gradient=stop_gradient),
            T.to_tensor(arr, stop_gradient=stop_gradient))


def assert_close(a, b, tol, what=""):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=what)


def seed_both(s):
    P.seed(s)
    T.seed(s)


def check_static(make, calls, grad=False):
    """The port's to_static of ``make(T)`` equals the reference's eager
    ``make(P)`` on each call's inputs (forward, and the gradients of
    sum(out * out) when ``grad``), through one compiled graph for each
    distinct input signature."""
    sfn = T.jit.to_static(make(T), backend="aot_eager")
    ref_fn = make(P)
    for inputs in calls:
        outs = {}
        for M, fn in ((P, ref_fn), (T, sfn)):
            ts = [M.to_tensor(x, stop_gradient=not grad) for x in inputs]
            out = fn(*ts)
            if grad:
                M.sum(out * out).backward()
            outs[M] = (to_np(out),
                       [to_np(t.grad) for t in ts] if grad else [])
        (r, rg), (t, tg) = outs[P], outs[T]
        np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-6)
        for a, b in zip(rg, tg):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5,
                                       err_msg="grad mismatch")
    signatures = {tuple((np.shape(x), np.asarray(x).dtype.name)
                        for x in inputs) for inputs in calls}
    assert sfn.compiles == len(signatures)


def zero_init(monkeypatch):
    """Build Layers of both packages with zero parameters instead of their
    seeded draws (the reference compiles each initializer per shape, the
    port draws jax's threefry on the CPU: seconds a model); the parity
    tests then load the same :func:`numpy_weights` into both."""
    from paddle_tpu.nn import layer as RL
    from paddle_tpu_torch.nn import layer as TL

    def patch(mod):
        def create_parameter(self, shape, attr=None, dtype=None,
                             is_bias=False, default_initializer=None):
            dtype = mod.convert_dtype(dtype) if dtype else self._dtype
            attr = mod.ParamAttr._to_attr(attr)
            value = np.zeros([int(s) for s in shape], dtype)
            if mod is TL:
                from paddle_tpu_torch.tensor import to_tensor
                value = to_tensor(value)._value
            return mod.Parameter(value,
                                 trainable=attr.trainable if attr else True)
        monkeypatch.setattr(mod.Layer, "create_parameter", create_parameter)
    patch(RL)
    patch(TL)


def numpy_weights(layer, seed, std=None, gain=1.0):
    """Seeded weights for every entry of ``layer.state_dict()``: running
    means 0 and variances 1, 1-D scales near 1 (``weight``) and offsets
    near 0, tensors N(0, gain^2 * 2 / fan_in) (He) or N(0, std^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in layer.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("_mean"):
            out[k] = np.zeros(shape, np.float32)
        elif k.endswith("_variance"):
            out[k] = np.ones(shape, np.float32)
        elif len(shape) <= 1:
            base = 1.0 if k.endswith("weight") else 0.0
            out[k] = (base + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            scale = std if std is not None else gain * np.sqrt(2.0 / fan_in)
            out[k] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return out


def twins(make_ref, make_port, monkeypatch, seed=0, std=None, gain=1.0):
    """A reference Layer and a port Layer with the same seeded weights."""
    zero_init(monkeypatch)
    ref, port = make_ref(), make_port()
    state = numpy_weights(port, seed, std, gain)
    for layer in (ref, port):
        missing, unexpected = layer.set_state_dict(state)
        assert not missing and not unexpected, (missing, unexpected)
    return ref, port


def _momentum(M, params, lr):
    return M.optimizer.Momentum(
        learning_rate=lr, momentum=0.9, parameters=params,
        weight_decay=M.optimizer.L2Decay(1e-4))


class NumpyMomentum:
    """PaddleClas's update (momentum 0.9, L2Decay 1e-4: ``v = 0.9 v + g +
    1e-4 p``, ``p -= lr v``) done in numpy on a Layer's parameters, for
    parity tests of models: the reference's optimizer compiles an update
    per parameter shape (seconds a model); the optimizers have their own
    parity tests."""

    def __init__(self, M, params, lr):
        self.params, self.lr = list(params), np.float32(lr)
        self.v = [np.zeros(p.shape, np.float32) for p in self.params]

    def step(self):
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            w = to_np(p)
            g = to_np(p.grad) + np.float32(1e-4) * w
            self.v[i] = np.float32(0.9) * self.v[i] + g
            p.set_value(w - self.lr * self.v[i])

    def clear_grad(self):
        for p in self.params:
            p.clear_grad()


def _bn_stats(layer):
    return {k: to_np(v) for k, v in layer.state_dict().items()
            if k.endswith("_mean") or k.endswith("_variance")}


def _run_steps(M, model, x, label, steps, lr, seed, mode, optimizer):
    getattr(model, mode)()
    opt = (optimizer or _momentum)(M, model.parameters(), lr)
    losses, first = [], None
    for step in range(steps):
        M.seed(seed + step)
        out = model(*[M.to_tensor(a) for a in x])
        out = out[0] if isinstance(out, (tuple, list)) else out
        if label is None:
            loss = M.mean(out * out)
        else:
            loss = M.nn.functional.cross_entropy(out, M.to_tensor(label))
        loss.backward()
        if step == 0:
            first = (to_np(out), {n: to_np(p.grad) for n, p in
                                  model.named_parameters()
                                  if p.grad is not None})
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, first, _bn_stats(model)


def train_parity(ref, port, x, label=None, steps=3, lr=0.1, seed=0,
                 logit_tol=1e-4, grad_tol=1e-4, loss_tol=1e-5, stat_tol=3e-4,
                 mode="train", optimizer=None):
    """The same weights in the reference and the port (in ``mode``, the
    same dropout draws through ``seed_both``): the first step's outputs
    within ``logit_tol``, every parameter's gradient within ``grad_tol`` of
    its largest reference magnitude, the losses of ``steps`` optimizer
    steps (default PaddleClas's Momentum: momentum 0.9, L2Decay 1e-4)
    within ``loss_tol`` relative, and the BatchNorm running statistics
    after them within ``stat_tol`` (they average activations of weights
    the steps moved). The loss is cross entropy with ``label``, or the mean
    square of the output. ``x`` is one input or a tuple of inputs. The
    reference runs all its steps first (interleaved, XLA's spinning
    threads slow torch's CPU kernels tenfold)."""
    x = x if isinstance(x, tuple) else (x,)
    r = _run_steps(P, ref, x, label, steps, lr, seed, mode, optimizer)
    t = _run_steps(T, port, x, label, steps, lr, seed, mode, optimizer)
    (rl, (ro, rg), rs), (tl, (to, tg), ts) = r, t
    assert_close(ro, to, logit_tol, "logits")
    # a parameter the loss does not reach has no gradient on one side and
    # zeros on the other (a compiled program's VJP gives every input one)
    for name in rg.keys() ^ tg.keys():
        g = rg.get(name, tg.get(name))
        assert not np.any(g), (name, "gradient only on one side")
    # a gradient is held to its own scale, floored at 1e-3 of the model's
    # largest: a bias that a BatchNorm follows has a gradient of zero up to
    # rounding, which no relative bound can hold
    floor = 1e-3 * max(float(np.abs(g).max()) for g in rg.values())
    for name in rg.keys() & tg.keys():
        scale = max(float(np.abs(rg[name]).max()), floor, 1e-30)
        err = float(np.abs(tg[name] - rg[name]).max()) / scale
        assert err <= grad_tol, (name, err)
    np.testing.assert_allclose(tl, rl, rtol=loss_tol, atol=loss_tol,
                               err_msg="losses")
    assert rs.keys() == ts.keys()
    for k in rs:
        np.testing.assert_allclose(ts[k], rs[k], rtol=stat_tol,
                                   atol=stat_tol, err_msg=k)
    return tl



@pytest.fixture
def few_threads():
    """Two torch threads for a test of conv nets at test sizes: as fast
    alone, and it leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
