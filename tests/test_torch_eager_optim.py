"""The port's optimizers and LR schedulers against the reference's: a small
MLP with the reference's weights, 3 steps of each optimizer (AdamW with
L2Decay-free decoupled decay and ClipGradByGlobalNorm, Adam with L2Decay),
parameters to 1e-6; each scheduler's get_lr() sequence equal."""
import numpy as np
import pytest

from torch_eager_ref import P, T, load_reference_state, pair, seed_both

_RNG = np.random.default_rng(31)
XS = _RNG.standard_normal((3, 8, 6)).astype(np.float32)
YS = _RNG.integers(0, 4, (3, 8)).astype(np.int64)


def _mlp(M):
    return M.nn.Sequential(M.nn.Linear(6, 16), M.nn.ReLU(),
                           M.nn.Linear(16, 4))


OPTIMIZERS = [
    ("SGD", lambda M, ps: M.optimizer.SGD(0.1, parameters=ps)),
    ("Momentum_nesterov", lambda M, ps: M.optimizer.Momentum(
        0.05, 0.9, parameters=ps, use_nesterov=True)),
    ("Adam_L2Decay", lambda M, ps: M.optimizer.Adam(
        0.01, parameters=ps, weight_decay=M.optimizer.L2Decay(0.01))),
    ("AdamW_clip", lambda M, ps: M.optimizer.AdamW(
        0.01, parameters=ps, weight_decay=0.1,
        grad_clip=M.nn.ClipGradByGlobalNorm(0.5))),
    ("Adamax", lambda M, ps: M.optimizer.Adamax(0.01, parameters=ps)),
    ("Adagrad", lambda M, ps: M.optimizer.Adagrad(0.05, parameters=ps)),
    ("RMSProp_centered", lambda M, ps: M.optimizer.RMSProp(
        0.01, parameters=ps, momentum=0.5, centered=True)),
    ("Lamb", lambda M, ps: M.optimizer.Lamb(0.01, parameters=ps)),
    ("Momentum_L1_groups", lambda M, ps: M.optimizer.Momentum(
        0.05, parameters=[{"params": ps[:2], "learning_rate": 0.5},
                          {"params": ps[2:]}],
        weight_decay=M.optimizer.L1Decay(0.01))),
]


@pytest.mark.parametrize("name,make", OPTIMIZERS,
                         ids=[c[0] for c in OPTIMIZERS])
def test_three_steps_match_the_reference(name, make):
    seed_both(9)
    ref, port = _mlp(P), _mlp(T)
    load_reference_state(port, ref)
    opt_r = make(P, ref.parameters())
    opt_t = make(T, port.parameters())
    for x, y in zip(XS, YS):
        for M, model, opt in ((P, ref, opt_r), (T, port, opt_t)):
            loss = M.nn.functional.cross_entropy(model(M.to_tensor(x)),
                                                 M.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
    for (k, a), (_, b) in zip(ref.state_dict().items(),
                              port.state_dict().items()):
        np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for p in port.parameters():
        assert p.grad is None
    assert opt_t.state_dict()["@step"] == 3


def _scheds(M):
    lr = M.optimizer.lr
    return [
        lr.NoamDecay(64, 4), lr.PiecewiseDecay([2, 4], [0.1, 0.05, 0.01]),
        lr.NaturalExpDecay(0.1, 0.5), lr.InverseTimeDecay(0.1, 0.5),
        lr.PolynomialDecay(0.1, 5, cycle=True), lr.LinearWarmup(
            lr.CosineAnnealingDecay(0.1, 6), 3, 0.0, 0.1),
        lr.ExponentialDecay(0.1, 0.9), lr.MultiStepDecay(0.1, [2, 5]),
        lr.StepDecay(0.1, 2), lr.LambdaDecay(0.1, lambda e: 0.9 ** e),
        lr.CosineAnnealingDecay(0.1, 4), lr.OneCycleLR(0.1, 10)]


def test_lr_schedulers_give_equal_sequences():
    for r, t in zip(_scheds(P), _scheds(T)):
        assert type(r).__name__ == type(t).__name__
        seq_r, seq_t = [], []
        for _ in range(8):
            seq_r.append(r.get_lr() if not hasattr(r, "last_lr")
                         else r())
            seq_t.append(t.get_lr() if not hasattr(t, "last_lr")
                         else t())
            r.step()
            t.step()
        assert seq_t == seq_r, type(t).__name__


def test_scheduler_drives_the_optimizer_and_state_round_trips(tmp_path):
    seed_both(4)
    port = _mlp(T)
    sched = T.optimizer.lr.StepDecay(0.1, 1, gamma=0.5)
    opt = T.optimizer.Adam(sched, parameters=port.parameters())
    x, y = pair(XS[0])[1], T.to_tensor(YS[0])
    for _ in range(2):
        T.nn.functional.cross_entropy(port(x), y).backward()
        opt.step()
        opt.clear_grad()
        sched.step()
    assert opt.get_lr() == pytest.approx(0.025)
    T.save(opt.state_dict(), str(tmp_path / "o.pdopt"))
    fresh = T.optimizer.Adam(T.optimizer.lr.StepDecay(0.1, 1, gamma=0.5),
                             parameters=port.parameters())
    fresh.set_state_dict(T.load(str(tmp_path / "o.pdopt")))
    assert fresh.get_lr() == pytest.approx(0.025)
    assert fresh.state_dict()["@step"] == 2
    for k, v in opt.state_dict().items():
        if hasattr(v, "numpy"):
            np.testing.assert_array_equal(fresh.state_dict()[k].numpy(),
                                          v.numpy())
