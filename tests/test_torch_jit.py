"""The port's jit and predictor on the CPU: tests/test_jit.py's nine cases
replayed against the port (``backend="aot_eager"``: dynamo's capture and
the custom ops as inductor sees them, without its C++ code generation),
``torch.library.opcheck`` on the three flash ops, ``to_static`` of the
tiny eager GPT with ``fullgraph`` (loss and gradients as eager, one
compile, route counts counting runs), ``jit.save`` and the predictor
against the reference's predictor, and the dynamic-dim cases of
``InputSpec`` beside the reference's."""
import os
import warnings

import numpy as np
import pytest
import torch

from torch_eager_ref import P, T, load_reference_state, seed_both

BACKEND = "aot_eager"
rng = np.random.default_rng(11)


def A(*shape):
    return rng.standard_normal(shape).astype("float32")


class MLP(T.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = T.nn.Linear(8, 16)
        self.fc2 = T.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(T.nn.functional.relu(self.fc1(x)))


class RefMLP(P.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = P.nn.Linear(8, 16)
        self.fc2 = P.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(P.nn.functional.relu(self.fc1(x)))


def to_static(f):
    return T.jit.to_static(f, backend=BACKEND)


# ------------------------------------------ tests/test_jit.py, on the port
def test_to_static_function():
    @T.jit.to_static(backend=BACKEND)
    def f(x, y):
        return T.matmul(x, y) + 1.0

    a, b = A(3, 4), A(4, 5)
    out = f(T.to_tensor(a), T.to_tensor(b))
    np.testing.assert_allclose(out.numpy(), a @ b + 1, rtol=1e-5)


def test_to_static_layer_matches_eager():
    m = MLP()
    x = A(2, 8)
    eager_out = m(T.to_tensor(x)).numpy()
    static_out = to_static(m)(T.to_tensor(x)).numpy()
    np.testing.assert_allclose(static_out, eager_out, rtol=1e-5, atol=1e-6)


def test_to_static_training_grads_match():
    m1, m2 = MLP(), MLP()
    m2.set_state_dict(m1.state_dict())
    x = A(4, 8)
    out1 = m1(T.to_tensor(x))
    T.mean(out1 * out1).backward()
    m2s = to_static(m2)
    out2 = m2s(T.to_tensor(x))
    T.mean(out2 * out2).backward()
    for (n1, p1), (n2, p2) in zip(m1.named_parameters(),
                                  m2.named_parameters()):
        assert p2.grad is not None, n2
        np.testing.assert_allclose(p1.grad.numpy(), p2.grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n1)


def test_to_static_train_loop_converges():
    m = to_static(MLP())
    opt = T.optimizer.Adam(learning_rate=0.01, parameters=m.parameters())
    x, y = A(16, 8), A(16, 4)
    first = None
    for _ in range(30):
        out = m(T.to_tensor(x))
        loss = T.mean((out - T.to_tensor(y)) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if first is None:
            first = float(loss)
    assert float(loss) < first * 0.5
    assert m._static_function.compiles == 1


def test_buffer_mutation_propagates():
    class BNNet(T.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bn = T.nn.BatchNorm1D(4, data_format="NCL")

        def forward(self, x):
            return self.bn(x)

    net = to_static(BNNet())
    net(T.to_tensor(A(8, 4, 6) * 2 + 3))
    assert not np.allclose(net.bn._mean.numpy(), np.zeros(4))


def test_input_spec_and_save_load(tmp_path):
    m = MLP()
    m.eval()
    path = str(tmp_path / "model")
    T.jit.save(m, path, input_spec=[T.jit.InputSpec([1, 8], "float32")])
    assert os.path.exists(path + ".pdmodel")
    loaded = T.jit.load(path, device="cpu")
    x = A(1, 8)
    np.testing.assert_allclose(loaded(T.to_tensor(x)).numpy(),
                               m(T.to_tensor(x)).numpy(), rtol=1e-5)


def test_control_flow_via_trace():
    @T.jit.to_static(backend=BACKEND)
    def f(x):
        out = x
        for _ in range(3):
            out = out * 2
        return out

    assert f(T.to_tensor([1.0])).numpy()[0] == 8.0


def test_dropout_under_jit_uses_fresh_seeds():
    class DropNet(T.nn.Layer):
        def __init__(self):
            super().__init__()
            self.drop = T.nn.Dropout(0.5)

        def forward(self, x):
            return self.drop(x)

    net = to_static(DropNet())
    x = T.ones([1000])
    m1, m2 = net(x).numpy(), net(x).numpy()
    assert not np.allclose(m1, m2)            # a fresh mask each call
    assert net._static_function.compiles == 1  # and no recompile


def test_predictor_roundtrip(tmp_path):
    m = MLP()
    m.eval()
    path = str(tmp_path / "infer")
    T.jit.save(m, path, input_spec=[T.jit.InputSpec([2, 8], "float32")])
    cfg = T.inference.Config(path)
    cfg.disable_gpu()
    pred = T.inference.create_predictor(cfg)
    x = A(2, 8)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(x)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(out, m(T.to_tensor(x)).numpy(), rtol=1e-5)


# ------------------------------------------------------- the flash ops
def test_opcheck_on_the_three_flash_ops():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((1, 2, 64, 16), generator=g)
                   for _ in range(4))
    lse = torch.logsumexp(q @ k.transpose(-1, -2) * 0.25, -1)
    di = torch.randn((1, 2, 64), generator=g)
    grads = tuple(t.clone().requires_grad_() for t in (q, k, v))
    for op, args in ((fa.OPS[0], (*grads, 0.25, True, True)),
                     (fa.OPS[0], (q, k, v, 0.25, False, False)),
                     (fa.OPS[1], (q, k, v, do, lse, di, 0.25, True)),
                     (fa.OPS[2], (q, k, v, do, lse, di, 0.25, True))):
        torch.library.opcheck(op, args)


def test_to_static_gpt_fullgraph_matches_eager():
    """gpt_tiny at S = 128 (the kernel route; on the CPU its plain body):
    one compile with fullgraph, the same loss and gradients as eager,
    route counts that count runs (2 layers a forward, 2 forwards)."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.functional import attention
    cfg = gpt.gpt_tiny(max_seq=128, n_layers=2)
    T.seed(0)
    eager, static = gpt.GPT(cfg), gpt.GPT(cfg)
    static.set_state_dict(eager.state_dict())
    to_static(static)
    tok = rng.integers(0, cfg.vocab_size, (2, 129))
    x = T.to_tensor(tok[:, :-1])
    y = T.to_tensor(tok[:, 1:].reshape(-1))
    attention.routes.update(dict.fromkeys(attention.routes, 0))
    losses = []
    for m in (eager, static, static):
        loss = T.nn.functional.cross_entropy(
            T.reshape(m(x), [-1, cfg.vocab_size]), y)
        loss.backward()
        losses.append(float(loss))
    assert losses[0] == losses[1] == losses[2]
    for pe, ps in zip(eager.parameters(), static.parameters()):
        np.testing.assert_allclose(2 * pe.grad.numpy(), ps.grad.numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert static._static_function.compiles == 1
    assert attention.routes == {"kernel": 3 * cfg.n_layers,
                                "plain_flag": 0, "plain_shape": 0,
                                "plain_mask": 0}


# ----------------------------------------- save / predictor / dynamic dims
def _mlp_pair():
    seed_both(5)
    ref, port = RefMLP(), MLP()
    load_reference_state(port, ref)
    ref.eval()
    port.eval()
    return ref, port


def _predict(M, path, x):
    cfg = M.inference.Config(path)
    if M is T:
        cfg.disable_gpu()
    pred = M.inference.create_predictor(cfg)
    return pred.run([x])[0]


def test_predictor_matches_the_reference_predictor(tmp_path):
    ref, port = _mlp_pair()
    x = A(2, 8)
    outs = {}
    for M, m in ((P, ref), (T, port)):
        path = str(tmp_path / M.__name__)
        M.jit.save(m, path, input_spec=[M.jit.InputSpec([2, 8], "float32")])
        outs[M] = _predict(M, path, x)
    np.testing.assert_allclose(outs[T], outs[P], rtol=1e-5, atol=1e-5)
    clone = T.inference.create_predictor(_cpu_config(tmp_path / "paddle_tpu_torch")).clone()
    np.testing.assert_allclose(clone.run([x])[0], outs[T], rtol=0, atol=0)


def _cpu_config(path):
    cfg = T.inference.Config(str(path))
    cfg.disable_gpu()
    return cfg


class TwoIn(T.nn.Layer):
    def forward(self, x, y):
        return x + y


class RefTwoIn(P.nn.Layer):
    def forward(self, x, y):
        return x + y


def test_dynamic_batch_dim_serves_any_batch(tmp_path):
    ref, port = _mlp_pair()
    for M, m in ((P, ref), (T, port)):
        M.jit.save(m, str(tmp_path / M.__name__),
                   input_spec=[M.jit.InputSpec([None, 8], "float32")])
    for n in (3, 5):
        x = A(n, 8)
        np.testing.assert_allclose(_predict(T, str(tmp_path / T.__name__), x),
                                   _predict(P, str(tmp_path / P.__name__), x),
                                   rtol=1e-5, atol=1e-5)


def test_shared_dynamic_dim_retries_unified(tmp_path):
    """Two inputs added over one dynamic batch dim: independent dims meet
    the constraint, both sides warn and retry with one dim per axis."""
    for M, m in ((P, RefTwoIn()), (T, TwoIn())):
        spec = [M.jit.InputSpec([None, 4], "float32")] * 2
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            M.jit.save(m, str(tmp_path / M.__name__), input_spec=spec)
        assert any("retrying" in str(x.message) for x in w), M
    x, y = A(3, 4), A(3, 4)
    cfg = _cpu_config(tmp_path / T.__name__)
    out = T.inference.create_predictor(cfg).run([x, y])[0]
    np.testing.assert_allclose(out, x + y, rtol=1e-6)


def test_dynamic_sequence_dim_of_the_gpt_raises_as_the_reference(tmp_path):
    """The flash route depends on Sq % 128, so a symbolic sequence dim
    meets a guard: both sides give up with the same ValueError."""
    import dataclasses

    from paddle_tpu.models import gpt as rg
    from paddle_tpu_torch.models import gpt as tg
    seed_both(0)
    ref = rg.GPT(dataclasses.replace(rg.gpt_tiny(), max_seq=128, n_layers=1))
    port = tg.GPT(tg.gpt_tiny(max_seq=128, n_layers=1))
    for M, m in ((P, ref), (T, port)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError, match="could not export"):
                M.jit.save(m, str(tmp_path / M.__name__),
                           input_spec=[M.jit.InputSpec([1, None], "int64")])


def test_pjrt_artifacts_wait_for_the_c_serving_path(tmp_path):
    with pytest.raises(NotImplementedError, match="C serving"):
        T.jit.save(MLP(), str(tmp_path / "m"),
                   input_spec=[T.jit.InputSpec([1, 8])], pjrt_artifacts=True)


def test_enable_to_static_false_runs_eagerly():
    m = to_static(MLP())
    T.jit.enable_to_static(False)
    try:
        m(T.to_tensor(A(2, 8)))
    finally:
        T.jit.enable_to_static(True)
    assert m._static_function.compiles == 0
