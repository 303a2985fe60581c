"""``paddle.metric`` of the port — the counterpart of
``paddle_tpu/metric/__init__.py``: ``Metric``, ``Accuracy`` (:32),
``Precision`` (:78), ``Recall`` (:103), ``Auc`` (:128) and ``accuracy``
(:172).

A metric works in two halves, as in the reference.  ``compute`` runs on
the device, on the network's output and the labels as tensors (for
``Accuracy`` the (..., k) hit mask of the k best classes: an ``argmax``
for k 1, a ``torch.topk`` above it); ``update`` reads
what ``compute`` returned to the host and keeps the reference's numpy
state, so ``update`` and ``accumulate`` give the reference's results to
the last digit on the same inputs.  The read in ``update`` waits for the
step that made its input: ``Model`` calls it once per batch
(``_update_metrics``).  Inputs may be tensors or numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _tensor(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries along the last axis, (...,
    k): an ``argmax`` for k 1 (one reduction pass over the logits), else
    ``torch.topk``."""
    if k == 1:
        return x.argmax(-1, keepdim=True)
    return torch.topk(x, k, dim=-1).indices


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
        """Optional device-side pre-reduction before update()."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred = _tensor(pred)
        lbl = _tensor(label, pred.device)
        idx = _top_indices(pred, self.maxk)
        if lbl.dim() == idx.dim():
            lbl = lbl.squeeze(-1) if lbl.shape[-1] == 1 else lbl.argmax(-1)
        return idx == lbl[..., None]

    def update(self, correct, *args):
        c = _numpy(correct)
        accs = []
        for i, k in enumerate(self.topk):
            hit = c[..., :k].any(axis=-1).sum()
            self.total[i] += hit
            self.count[i] += c.reshape(-1, c.shape[-1]).shape[0]
            accs.append(float(hit) / max(c.reshape(-1, c.shape[-1]).shape[0],
                                         1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        out = [t / max(c, 1e-12) for t, c in zip(self.total, self.count)]
        return out[0] if len(out) == 1 else out

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _numpy(preds).reshape(-1)
        lab = _numpy(labels).reshape(-1)
        pred_pos = (p > 0.5).astype(np.int64)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fp += int(((pred_pos == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _numpy(preds).reshape(-1)
        lab = _numpy(labels).reshape(-1)
        pred_pos = (p > 0.5).astype(np.int64)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fn += int(((pred_pos == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _numpy(preds)
        lab = _numpy(labels).reshape(-1)
        p = p[:, -1] if p.ndim == 2 else p.reshape(-1)
        bins = np.round(p * self.num_thresholds).astype(np.int64)
        bins = np.clip(bins, 0, self.num_thresholds)
        for b, y in zip(bins, lab):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds descending
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(np.trapezoid(tpr, fpr)) if hasattr(np, "trapezoid") \
            else float(np.trapz(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy of ``input`` against ``label``: a 0-d float32 tensor
    on ``input``'s device (reference ``operators/metrics/accuracy_op``)."""
    x = _tensor(input)
    lbl = _tensor(label, x.device)
    idx = _top_indices(x, k)
    if lbl.dim() == idx.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    return (idx == lbl[..., None]).any(dim=-1).float().mean()
