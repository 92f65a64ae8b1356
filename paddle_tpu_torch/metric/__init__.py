"""Metrics: counterpart of ``paddle_tpu/metric/__init__.py``.

The same host-side numpy arithmetic as the JAX module, so the same
predictions and labels give the same results, not merely close ones;
a tensor argument is read back to the host first. ``accuracy`` is the
functional form on tensors (the device's own top-k by a stable sort,
as ``jnp.argsort``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
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
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        top = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        return top == label_np[..., None]

    def update(self, correct, *args):
        correct = _np(correct)
        n = correct.shape[0]
        res = []
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(axis=-1).sum()
            self.total[i] += float(c)
            self.count[i] += n
            res.append(float(c) / n)
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        y = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fp += int(((p == 1) & (y == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        y = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fn += int(((p == 0) & (y == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


# numpy 2 names the trapezoid rule ``trapezoid`` (``trapz`` is its old,
# deprecated alias); the two compute the same sum
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        y = _np(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        for b, lab in zip(bins, y):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over thresholds descending
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        return float(_trapezoid(pos_cum / tot_pos, neg_cum / tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` largest scores
    (a float32 scalar tensor on the input's device)."""
    topk_idx = torch.argsort(-input, dim=-1, stable=True)[..., :k]
    y = label
    if y.dim() == input.dim():
        y = y[..., 0]
    hit = (topk_idx == y[..., None].to(topk_idx.dtype)).any(dim=-1)
    return hit.to(torch.float32).mean()
