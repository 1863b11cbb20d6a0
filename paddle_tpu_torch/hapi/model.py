"""paddle.Model: port of paddle_tpu/hapi/model.py (reference:
hapi/model.py:1741 fit). The network, its optimizer and its batches live
on the current place (the card unless ``set_device("cpu")`` chose the
CPU): the DataLoader's collate makes each batch's Tensors there."""
from __future__ import annotations

import numpy as np

from ..tensor import no_grad
from ..nn.layer import Layer
from .callbacks import CallbackList, ProgBarLogger


class Model:
    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics else [])

    # ---- single-step ----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = self.network(*inputs)
        losses = []
        if self._loss:
            labels_l = labels if isinstance(labels, (list, tuple)) else [labels]
            loss = self._loss(outputs, *labels_l)
            losses.append(loss)
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        metrics = []
        for m in self._metrics:
            labels_l = labels if isinstance(labels, (list, tuple)) else [labels]
            res = m.update(m.compute(outputs, *labels_l))
            metrics.append(res)
        return ([l.numpy() for l in losses], metrics) if metrics else \
            [l.numpy() for l in losses]

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = self.network(*inputs)
        losses = []
        if self._loss and labels is not None:
            labels_l = labels if isinstance(labels, (list, tuple)) else [labels]
            losses.append(self._loss(outputs, *labels_l))
        metrics = []
        for m in self._metrics:
            labels_l = labels if isinstance(labels, (list, tuple)) else [labels]
            metrics.append(m.update(m.compute(outputs, *labels_l)))
        return ([l.numpy() for l in losses], metrics) if metrics else \
            [l.numpy() for l in losses]

    @no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        out = self.network(*inputs)
        if isinstance(out, (list, tuple)):
            return [o.numpy() for o in out]
        return [out.numpy()]

    # ---- loops -----------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from ..io import DataLoader, Dataset
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        cbks = CallbackList(callbacks or ([ProgBarLogger(log_freq, verbose)]
                                          if verbose else []))
        cbks.set_model(self)
        cbks.on_begin("train", {"epochs": epochs,
                                "steps": self._maybe_len(train_loader),
                                "metrics": self._metric_names()})
        it = 0
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_batch_begin("train", step, logs)
                ins, labs = self._unpack(batch)
                res = self.train_batch(ins, labs)
                logs = self._logs(res)
                cbks.on_batch_end("train", step, logs)
                it += 1
                if num_iters and it >= num_iters:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size,
                              num_workers=num_workers, verbose=0)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            if self.stop_training or (num_iters and it >= num_iters):
                break
        cbks.on_end("train", logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        from ..io import DataLoader, Dataset
        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = eval_data
        for m in self._metrics:
            m.reset()
        logs = {}
        for step, batch in enumerate(loader):
            ins, labs = self._unpack(batch)
            res = self.eval_batch(ins, labs)
            logs = self._logs(res)
        out = {}
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, list) else [vals]
            out.update(dict(zip(names, vals)))
        if "loss" in logs:
            out["loss"] = logs["loss"]
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        from ..io import DataLoader, Dataset
        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = test_data
        outputs = []
        for batch in loader:
            ins, _ = self._unpack(batch)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs]) for i in
                    range(n_out)]
        return outputs

    # ---- persistence -----------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io_state import save
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io_state import load
        self.network.set_state_dict(load(path + ".pdparams"))
        import os
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)

    # ---- helpers ---------------------------------------------------------
    @staticmethod
    def _maybe_len(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names += n if isinstance(n, list) else [n]
        return names

    @staticmethod
    def _unpack(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) == 2:
                return batch[0], batch[1]
            return batch[:-1], batch[-1]
        return batch, None

    def _logs(self, res):
        if isinstance(res, tuple):
            losses, metrics = res
        else:
            losses, metrics = res, []
        logs = {}
        if losses:
            logs["loss"] = float(np.asarray(losses[0]).reshape(-1)[0])
        for m, v in zip(self._metrics, metrics):
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = v if isinstance(v, list) else [v]
            logs.update({n: float(np.asarray(x)) for n, x in zip(names, vals)})
        return logs
