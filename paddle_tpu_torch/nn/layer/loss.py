"""Loss layers — the counterpart of ``paddle_tpu/nn/layer/loss.py``
(``CrossEntropyLoss`` :14)."""
from __future__ import annotations

from torch import nn

from ...ops.loss import cross_entropy

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    """:func:`~paddle_tpu_torch.ops.loss.cross_entropy` as a layer, with
    the reference's arguments; ``forward(input, label)``."""

    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", soft_label: bool = False,
                 axis: int = -1, use_softmax: bool = True,
                 label_smoothing: float = 0.0):
        super().__init__()
        self.weight = weight
        self.kw = dict(ignore_index=ignore_index, reduction=reduction,
                       soft_label=soft_label, axis=axis,
                       use_softmax=use_softmax,
                       label_smoothing=label_smoothing)

    def forward(self, input, label):
        return cross_entropy(input, label, weight=self.weight, **self.kw)
