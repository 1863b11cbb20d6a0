"""The port's eager models against the reference's: LeNet's Adam losses, the
eager GPT at gpt_tiny (init bitwise under seed, logits, AdamW losses, the
dropout masks), the eager face against the port's functional face on one
set of weights, save/load of a model and its optimizer, and the MNIST
training loop of tests/test_e2e_mnist.py run with
``import paddle_tpu_torch as paddle`` on synthetic digits."""
import numpy as np

from torch_eager_ref import (P, T, assert_close, load_reference_state,
                             seed_both)

_RNG = np.random.default_rng(41)
DIGITS = _RNG.standard_normal((5, 8, 1, 28, 28)).astype(np.float32)
DLAB = _RNG.integers(0, 10, (5, 8)).astype(np.int64)
TOK = _RNG.integers(0, 256, (2, 129)).astype(np.int64)


def test_lenet_adam_losses_match_the_reference():
    from paddle_tpu.models import LeNet as RefLeNet
    from paddle_tpu_torch.models import LeNet
    seed_both(7)
    ref, port = RefLeNet(), LeNet()
    load_reference_state(port, ref)
    losses = {}
    for M, model in ((P, ref), (T, port)):
        opt = M.optimizer.Adam(1e-3, parameters=model.parameters())
        loss_fn = M.nn.CrossEntropyLoss()
        out = []
        for x, y in zip(DIGITS, DLAB):
            loss = loss_fn(model(M.to_tensor(x)), M.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
        losses[M] = out
    np.testing.assert_allclose(losses[T], losses[P], rtol=1e-5, atol=1e-5)


def _gpts(**kw):
    from paddle_tpu.models import gpt as rg
    from paddle_tpu_torch.models import gpt as tg
    import dataclasses
    seed_both(0)
    return (rg.GPT(dataclasses.replace(rg.gpt_tiny(), **kw)),
            tg.GPT(tg.gpt_tiny(**kw)))


def _xent(M, model, tok):
    logits = model(M.to_tensor(tok[:, :-1]))
    return M.nn.functional.cross_entropy(
        M.reshape(logits, [-1, logits.shape[-1]]),
        M.to_tensor(tok[:, 1:].reshape(-1)))


def test_eager_gpt_init_logits_and_adamw_steps():
    """gpt_tiny with max_seq 128: S = 128 takes the flash route (the
    kernel's plain version on the CPU), n_layers calls a forward."""
    from paddle_tpu_torch.nn.functional import attention
    ref, port = _gpts(max_seq=128)
    rs, ts = ref.state_dict(), port.state_dict()
    assert list(rs) == list(ts)
    for k in rs:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(rs[k].numpy()),
                                      err_msg=k)
    before = attention.routes["kernel"]
    assert_close(ref(P.to_tensor(TOK[:, :-1])),
                 port(T.to_tensor(TOK[:, :-1])), 1e-4, "logits")
    assert attention.routes["kernel"] - before == port.cfg.n_layers
    losses = {}
    for M, model in ((P, ref), (T, port)):
        opt = M.optimizer.AdamW(1e-3, parameters=model.parameters())
        out = []
        for _ in range(3):
            loss = _xent(M, model, TOK)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
        losses[M] = out
    np.testing.assert_allclose(losses[T], losses[P], rtol=1e-5, atol=1e-5)


def test_eager_gpt_dropout_masks_equal_the_reference():
    ref, port = _gpts(dropout=0.1)
    seed_both(3)
    a = ref(P.to_tensor(TOK[:, :33]))
    b = port(T.to_tensor(TOK[:, :33]))
    assert_close(a, b, 1e-4, "training logits under dropout")
    ref.eval()
    port.eval()
    assert_close(ref(P.to_tensor(TOK[:, :33])),
                 port(T.to_tensor(TOK[:, :33])), 1e-4, "eval logits")


def test_eager_face_equals_the_functional_face():
    import torch
    from paddle_tpu_torch.models import gpt as tg
    cfg = tg.gpt_tiny()
    params = tg.init_params(cfg, 0, device="cpu")
    model = tg.GPT(cfg)
    missing, unexpected = model.set_state_dict(tg.eager_state_dict(params))
    assert not missing and not unexpected
    with torch.no_grad():
        want = tg.forward(params, cfg, torch.as_tensor(TOK[:, :64]))
    got = model(T.to_tensor(TOK[:, :64]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_save_load_round_trip_of_model_and_optimizer(tmp_path):
    from paddle_tpu_torch.models import LeNet
    T.seed(2)
    model = LeNet()
    opt = T.optimizer.AdamW(1e-3, parameters=model.parameters())
    x, y = T.to_tensor(DIGITS[0]), T.to_tensor(DLAB[0])
    T.nn.CrossEntropyLoss()(model(x), y).backward()
    opt.step()
    opt.clear_grad()
    T.save(model.state_dict(), str(tmp_path / "m.pdparams"))
    T.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    twin = LeNet()
    # optimizer state is keyed by parameter name, as a fresh process that
    # builds the model again names it
    for p, q in zip(model.parameters(), twin.parameters()):
        q.name = p.name
    twin.set_state_dict(T.load(str(tmp_path / "m.pdparams"), place="cpu"))
    twin_opt = T.optimizer.AdamW(1e-3, parameters=twin.parameters())
    twin_opt.set_state_dict(T.load(str(tmp_path / "m.pdopt")))
    np.testing.assert_array_equal(twin(x).numpy(), model(x).numpy())
    for M_model, M_opt in ((model, opt), (twin, twin_opt)):
        T.nn.CrossEntropyLoss()(M_model(x), y).backward()
        M_opt.step()
        M_opt.clear_grad()
    for a, b in zip(model.parameters(), twin.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    arrays = T.load(str(tmp_path / "m.pdparams"), return_numpy=True)
    assert isinstance(arrays["fc.0.weight"], np.ndarray)


def _digits(rng, n):
    """Synthetic 28x28 digits: one fixed recipe (a blob pattern) a class
    plus noise."""
    recipes = np.random.default_rng(0).standard_normal((10, 1, 28, 28))
    labels = rng.integers(0, 10, n)
    imgs = recipes[labels] + 0.5 * rng.standard_normal((n, 1, 28, 28))
    return imgs.astype(np.float32), labels.astype(np.int64)


def test_mnist_loop_runs_on_the_port():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.models import LeNet
    paddle.seed(0)
    model = LeNet()
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    losses, accs = [], []
    for _ in range(30):
        x, y = _digits(rng, 32)
        img, label = paddle.to_tensor(x), paddle.to_tensor(y)
        out = model(img)
        loss = loss_fn(out, label)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        accs.append((out.numpy().argmax(-1) == label.numpy()).mean())
    assert np.mean(losses[:3]) > np.mean(losses[-3:])
    assert np.mean(accs[-3:]) > 0.5, accs[-3:]
