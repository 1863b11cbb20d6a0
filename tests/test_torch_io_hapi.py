"""The port's io, vision.datasets, metric and hapi against the reference's on
the CPU: sampler and batch orders from one seed (0, 2 thread and 2 process
workers), default_collate_fn, Model.fit / evaluate / predict of LeNet on
the synthetic MNIST, the metrics on equal numpy inputs, the callbacks
(EarlyStopping, ModelCheckpoint, LRScheduler) stepping alike, summary,
and the new entry points' default to the card."""
import os

import numpy as np
import pytest
import torch

from torch_eager_ref import P, T, load_reference_state, seed_both, to_np

_RNG = np.random.default_rng(5)


class _Digits:
    """A small map-style dataset of (image, label) numpy pairs, built the
    same way on both sides."""

    def __init__(self, M, n=40):
        base = M.io.Dataset
        rng = np.random.default_rng(3)
        x = rng.standard_normal((n, 1, 28, 28)).astype(np.float32)
        y = rng.integers(0, 10, n).astype(np.int64)

        class DS(base):
            def __getitem__(self, i):
                return x[i], y[i]

            def __len__(self):
                return n
        self.ds = DS()


def _order(M, workers, monkeypatch, threads):
    if threads:
        monkeypatch.setenv("PADDLE_TPU_THREAD_WORKERS", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_THREAD_WORKERS", raising=False)
    M.seed(21)
    loader = M.io.DataLoader(_Digits(M).ds, batch_size=8, shuffle=True,
                             num_workers=workers)
    return [to_np(y).tolist() for _, y in loader] + [
        to_np(y).tolist() for _, y in loader]      # two epochs


@pytest.mark.parametrize("workers,threads", [(0, False), (2, True),
                                             (2, False)],
                         ids=["inline", "2-threads", "2-processes"])
def test_batch_orders_equal_the_reference(workers, threads, monkeypatch):
    want = _order(P, 0, monkeypatch, False)
    got = _order(T, workers, monkeypatch, threads)
    assert got == want
    assert len(got) == 10 and sorted(sum(got[:5], [])) != sum(got[:5], [])


def test_samplers_equal_the_reference():
    data = list(range(23))
    for M in (P, T):
        M.seed(4)
    outs = []
    for M in (P, T):
        M.seed(4)
        outs.append((
            list(M.io.RandomSampler(data)),
            list(M.io.BatchSampler(data, shuffle=True, batch_size=5)),
            list(M.io.DistributedBatchSampler(data, 4, num_replicas=1,
                                              rank=0, shuffle=True)),
            list(M.io.WeightedRandomSampler(np.arange(1, 24), 8)),
            [len(s) for s in M.io.random_split(data, [0.5, 0.5])]))
    assert outs[0] == outs[1]


def test_default_collate_fn_equals_the_reference():
    batch = [(np.full((2, 3), i, np.float32), i, float(i) / 2,
              {"a": np.arange(i, i + 2)}) for i in range(4)]
    ref = P.io.default_collate_fn(batch)
    port = T.io.default_collate_fn(batch)
    assert len(ref) == len(port) == 4
    for r, p in zip(ref[:3], port[:3]):
        assert str(r.dtype) == str(p.dtype)
        np.testing.assert_array_equal(to_np(p), to_np(r))
    np.testing.assert_array_equal(to_np(port[3]["a"]), to_np(ref[3]["a"]))
    stacked = T.io.default_collate_fn([T.to_tensor([1.0, 2.0])] * 3)
    assert stacked.shape == [3, 2] and stacked._value.device.type == "cpu"


class _Record(object):
    def __init__(self, base):
        class Rec(base):
            def __init__(self):
                self.losses = []
                self.lrs = []

            def on_batch_end(self, mode, step, logs=None):
                self.losses.append(logs["loss"])
                self.lrs.append(self.model._optimizer.get_lr())
        self.cb = Rec()


def _fit(M, tmp_path, epochs=2, num_iters=None, patience=0):
    from paddle_tpu.models import LeNet as RefLeNet
    from paddle_tpu_torch.models import LeNet
    seed_both(0)
    nets = (RefLeNet(), LeNet())
    load_reference_state(nets[1], nets[0])
    net = nets[0] if M is P else nets[1]
    sched = M.optimizer.lr.StepDecay(1e-3, step_size=3, gamma=0.5)
    model = M.Model(net)
    model.prepare(M.optimizer.Adam(sched, parameters=net.parameters()),
                  M.nn.CrossEntropyLoss(), M.metric.Accuracy())
    rec = _Record(M.callbacks.Callback).cb
    stop = M.callbacks.EarlyStopping(monitor="loss", patience=patience)
    cbs = [rec, M.callbacks.LRScheduler(), stop,
           M.callbacks.ModelCheckpoint(save_dir=str(tmp_path / M.__name__))]
    M.seed(1)
    train = M.vision.datasets.MNIST(mode="train")
    train.images, train.labels = train.images[:128], train.labels[:128]
    model.fit(train, batch_size=32, epochs=epochs, verbose=0,
              callbacks=cbs, num_iters=num_iters)
    return model, rec, stop


def test_model_fit_evaluate_predict_equal_the_reference(tmp_path):
    runs = {M: _fit(M, tmp_path, epochs=2) for M in (P, T)}
    (rm, rr, rs), (tm, tr, ts) = runs[P], runs[T]
    assert len(tr.losses) == len(rr.losses) == 8
    np.testing.assert_allclose(tr.losses, rr.losses, rtol=1e-5, atol=1e-5)
    assert tr.lrs == rr.lrs and tr.lrs[-1] < tr.lrs[0]
    assert (ts.wait, ts.best is None) == (rs.wait, rs.best is None)
    assert sorted(os.listdir(tmp_path / "paddle_tpu_torch")) == \
        sorted(os.listdir(tmp_path / "paddle_tpu"))
    test = {M: M.vision.datasets.MNIST(mode="test") for M in (P, T)}
    for M in (P, T):
        test[M].images, test[M].labels = (test[M].images[:64],
                                          test[M].labels[:64])
    ev = {M: runs[M][0].evaluate(test[M], batch_size=32, verbose=0)
          for M in (P, T)}
    assert ev[T].keys() == ev[P].keys() == {"acc", "loss"}
    assert abs(ev[T]["acc"] - ev[P]["acc"]) <= 1e-6
    assert abs(ev[T]["loss"] - ev[P]["loss"]) <= 1e-5
    pr = {M: runs[M][0].predict(test[M], batch_size=32, stack_outputs=True,
                                verbose=0) for M in (P, T)}
    np.testing.assert_allclose(pr[T][0], pr[P][0], rtol=1e-4, atol=1e-5)
    # save / load round trip of the trained model and its optimizer
    from paddle_tpu_torch.models import LeNet
    tm.save(str(tmp_path / "final"))
    x = [T.to_tensor(test[T].images[:4, None].astype(np.float32) / 255)]
    again = T.Model(LeNet())
    again.prepare(T.optimizer.Adam(1e-3, parameters=again.parameters()))
    again.load(str(tmp_path / "final"))
    np.testing.assert_array_equal(tm.predict_batch(x)[0],
                                  again.predict_batch(x)[0])
    assert again._optimizer.state_dict()["@step"] == 8


def test_early_stopping_stops_both_alike(tmp_path):
    """patience 0 with a loss that does not fall every epoch: both sides
    stop after the same epoch."""
    steps = {}
    for M in (P, T):
        model, rec, stop = _fit(M, tmp_path, epochs=4)
        steps[M] = (len(rec.losses), model.stop_training, stop.wait)
    assert steps[T] == steps[P]


def test_metrics_equal_the_reference():
    pred = _RNG.random((64, 10)).astype(np.float32)
    lab = _RNG.integers(0, 10, (64, 1)).astype(np.int64)
    prob = _RNG.random(64).astype(np.float32)
    blab = _RNG.integers(0, 2, 64).astype(np.int64)
    res = {}
    for M in (P, T):
        acc = M.metric.Accuracy(topk=(1, 3))
        r = [acc.update(acc.compute(M.to_tensor(pred), M.to_tensor(lab)))]
        r.append(acc.accumulate())
        assert acc.name() == ["acc_top1", "acc_top3"]
        for cls in (M.metric.Precision, M.metric.Recall):
            m = cls()
            m.update(prob, blab)
            r.append(m.accumulate())
        auc = M.metric.Auc()
        auc.update(np.stack([1 - prob, prob], 1), blab)
        r.append(auc.accumulate())
        r.append(float(M.metric.accuracy(M.to_tensor(pred),
                                         M.to_tensor(lab), k=2)))
        res[M] = r
    for a, b in zip(res[P], res[T]):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=1e-6)


def test_summary_equals_the_reference(capsys):
    from paddle_tpu.models import LeNet as RefLeNet
    from paddle_tpu_torch.models import LeNet
    out = []
    for M, net in ((P, RefLeNet()), (T, LeNet())):
        res = M.summary(net, (1, 1, 28, 28))
        out.append((res, capsys.readouterr().out))
    assert out[0] == out[1]
    assert T.flops(LeNet(), [1, 1, 28, 28]) > 0


def test_vision_datasets_equal_the_reference():
    for name, kw in (("MNIST", {"mode": "test"}),
                     ("Cifar10", {"mode": "test"}),
                     ("Flowers", {"mode": "valid"}),
                     ("VOC2012", {"mode": "test"})):
        r = getattr(P.vision.datasets, name)(**kw)
        t = getattr(T.vision.datasets, name)(**kw)
        assert len(r) == len(t), name
        for i in (0, len(r) - 1):
            for a, b in zip(r[i], t[i]):
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_entry_points_default_to_the_card_and_raise_without_it(
        tmp_path, monkeypatch):
    """DataLoader batches, Model, jit.load and create_predictor put their
    tensors on the card unless the CPU is asked for; without a card they
    raise."""
    m = T.nn.Linear(8, 4)
    path = str(tmp_path / "lin")
    T.jit.save(m, path, input_spec=[T.jit.InputSpec([2, 8])])
    from paddle_tpu_torch.framework import place
    monkeypatch.setattr(place, "_current_place", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = _Digits(T).ds
    with pytest.raises(RuntimeError, match="CUDA|card|cuda"):
        next(iter(T.io.DataLoader(ds, batch_size=4)))
    with pytest.raises(RuntimeError, match="CUDA|card|cuda"):
        T.jit.load(path)
    with pytest.raises(RuntimeError, match="CUDA|card|cuda"):
        T.inference.create_predictor(T.inference.Config(path))
    model = T.Model(m)
    model.prepare(loss=T.nn.MSELoss())
    with pytest.raises(RuntimeError, match="CUDA|card|cuda"):
        model.fit(ds, batch_size=4, verbose=0)
    assert T.jit.load(path, device="cpu")(
        T.to_tensor(np.ones((2, 8), np.float32), place="cpu")).shape == [2, 4]
