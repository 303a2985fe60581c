"""Loss layers — the counterpart of ``paddle_tpu/nn/layer/loss.py``
(``CrossEntropyLoss`` :14)."""
from __future__ import annotations

from ...core.tensor import unwrap
from ...ops import nn_ops
from ..layer_base import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    """Cross entropy as a layer, with the reference's arguments;
    ``forward(input, label)``.  It is written on torch tensors (``Model``
    hands it the network's torch outputs; Tensors passed in come back as
    a Tensor) and dispatches the eager core's ``cross_entropy`` op, so
    the op's span, AMP cast and checks are the dygraph loop's."""

    _torch_native = True

    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", soft_label: bool = False,
                 axis: int = -1, use_softmax: bool = True,
                 label_smoothing: float = 0.0, name=None):
        super().__init__()
        self.weight = weight
        self.kw = dict(ignore_index=ignore_index, reduction=reduction,
                       soft_label=soft_label, axis=axis,
                       use_softmax=use_softmax,
                       label_smoothing=label_smoothing)

    def forward(self, input, label):
        return unwrap(nn_ops.cross_entropy(input, label,
                                           weight=self.weight, **self.kw))
