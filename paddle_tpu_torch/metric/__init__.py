"""Metrics (counterpart of paddle_tpu/metric; reference:
python/paddle/metric/metrics.py — Metric, Accuracy, Precision, Recall,
Auc).  The port's own copy: the same host arithmetic in numpy, with torch
tensors (on any device) read as numpy first."""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """``x`` as numpy: a tensor is copied to the host (16-bit floats as
    float32)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.is_floating_point() and t.dtype != torch.float64:
            t = t.float()
        return t.numpy()
    return np.asarray(x)


__all__ = ["accuracy", "Metric", "Accuracy", "Precision", "Recall", "Auc"]


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Optional pre-processing hook run on device outputs."""
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        pred_idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        if label.ndim == pred.ndim:  # one-hot or [N,1] index
            if label.shape[-1] == pred.shape[-1]:
                label = np.argmax(label, -1)
            else:
                label = label.squeeze(-1)
        correct = (pred_idx == label[..., None])
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        n = correct.reshape(-1, correct.shape[-1]).shape[0]
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(-1).sum()
            self.total[i] += c
            self.count[i] += n
        accs = self.total / np.maximum(self.count, 1)
        return accs[0] if len(self.topk) == 1 else accs

    def accumulate(self):
        accs = self.total / np.maximum(self.count, 1)
        return float(accs[0]) if len(self.topk) == 1 else accs.tolist()

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
        preds = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return [self._name]


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return [self._name]


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2:
            preds = preds[:, -1]
        labels = _np(labels).reshape(-1)
        bins = np.minimum((preds * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            p = self._stat_pos[i]
            n = self._stat_neg[i]
            auc += n * (tot_pos + p / 2.0)
            tot_pos += p
            tot_neg += n
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return float(auc / (tot_pos * tot_neg))

    def name(self):
        return [self._name]


def accuracy(input, label, k: int = 1, correct=None, total=None, name=None):
    """Functional parity: paddle.metric.accuracy — top-k accuracy of
    ``input`` [N, C] probabilities/logits vs ``label`` [N] or [N, 1].

    The reference's ``correct``/``total`` out-tensors have no functional
    analog here; passing them raises instead of silently ignoring."""
    if correct is not None or total is not None:
        raise ValueError(
            "metric.accuracy: correct/total out-tensors are not supported "
            "by the functional form; read the returned accuracy")
    input = torch.as_tensor(input)
    label = torch.as_tensor(label, device=input.device).reshape(-1)
    topk = torch.argsort(-input, dim=-1, stable=True)[:, :k]
    hit = torch.any(topk == label[:, None], dim=-1)
    return hit.float().mean()
