"""paddle.metric: port of paddle_tpu/metric/__init__.py (reference:
python/paddle/metric/metrics.py). ``compute`` runs on the Tensors' device;
``update`` and ``accumulate`` keep their sums on the host, as the
reference does."""
from __future__ import annotations

import numpy as np

from ..tensor import Tensor


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        from ..ops.search import topk as topk_op
        from ..ops import manipulation as M
        _, idx = topk_op(pred, self.maxk, axis=-1)
        if label.ndim == 1 or (label.ndim == 2 and label.shape[-1] == 1):
            lab = label.reshape([-1, 1])
            correct = (idx == lab)
        else:  # one-hot
            lab = label.argmax(axis=-1).reshape([-1, 1])
            correct = (idx == lab)
        return M.cast(correct, "float32")

    def update(self, correct, *args):
        arr = correct.numpy() if isinstance(correct, Tensor) else np.asarray(correct)
        accs = []
        num = arr.shape[0]
        for k in self.topk:
            c = arr[:, :k].sum()
            self.total[self.topk.index(k)] += c
            self.count[self.topk.index(k)] += num
            accs.append(c / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (preds.numpy() if isinstance(preds, Tensor) else np.asarray(preds)) > 0.5
        l = (labels.numpy() if isinstance(labels, Tensor) else np.asarray(labels)).astype(bool)
        self.tp += int(np.sum(p & l))
        self.fp += int(np.sum(p & ~l))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (preds.numpy() if isinstance(preds, Tensor) else np.asarray(preds)) > 0.5
        l = (labels.numpy() if isinstance(labels, Tensor) else np.asarray(labels)).astype(bool)
        self.tp += int(np.sum(p & l))
        self.fn += int(np.sum(~p & l))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = preds.numpy() if isinstance(preds, Tensor) else np.asarray(preds)
        l = (labels.numpy() if isinstance(labels, Tensor) else np.asarray(labels)).reshape(-1)
        pos_prob = p[:, 1] if p.ndim == 2 else p.reshape(-1)
        bins = np.clip((pos_prob * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (tot_pos + new_pos) / 2
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return float(auc / denom) if denom else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    from ..ops.search import topk as topk_op
    from ..ops import manipulation as M
    from ..ops import math as m
    _, idx = topk_op(input, k, axis=-1)
    lab = label.reshape([-1, 1])
    correct_t = m.any(idx == lab, axis=-1)
    return m.mean(M.cast(correct_t, "float32"))
