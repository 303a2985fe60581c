"""Loss layers — the counterpart of ``paddle_tpu/nn/layer/loss.py``
(:14-204): ``CrossEntropyLoss`` and the other 15, each over its
``nn.functional`` op (``ops/nn_ops.py``).

Each is written on torch tensors (``_torch_native``): ``Model`` hands a
loss the network's torch outputs, and Tensors passed in come back as a
Tensor.  The ops dispatch under the reference's names, so a loss's span,
AMP cast and checks are the dygraph loop's."""
from __future__ import annotations

from ...core.tensor import unwrap
from ...ops import nn_ops
from ..layer_base import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "HuberLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "CTCLoss", "SoftmaxWithCrossEntropy",
           "HSigmoidLoss"]


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


class _Loss(Layer):
    """A loss layer: ``forward`` is its op on the given tensors with the
    layer's keywords, unwrapped."""

    _torch_native = True
    _op = None

    def __init__(self, **kw):
        super().__init__()
        self.kw = kw

    def forward(self, *tensors):
        return unwrap(type(self)._op(*tensors, **self.kw))


class SoftmaxWithCrossEntropy(_Loss):
    _op = staticmethod(nn_ops.softmax_with_cross_entropy)

    def __init__(self, soft_label=False, ignore_index=-100, axis=-1):
        super().__init__(soft_label=soft_label, ignore_index=ignore_index,
                         axis=axis)


class MSELoss(_Loss):
    _op = staticmethod(nn_ops.mse_loss)

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class L1Loss(_Loss):
    _op = staticmethod(nn_ops.l1_loss)

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class NLLLoss(_Loss):
    _op = staticmethod(nn_ops.nll_loss)

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction)


class BCELoss(_Loss):
    _op = staticmethod(nn_ops.binary_cross_entropy)

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class BCEWithLogitsLoss(_Loss):
    _op = staticmethod(nn_ops.binary_cross_entropy_with_logits)

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight=weight, reduction=reduction,
                         pos_weight=pos_weight)


class KLDivLoss(_Loss):
    _op = staticmethod(nn_ops.kl_div)

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class SmoothL1Loss(_Loss):
    _op = staticmethod(nn_ops.smooth_l1_loss)

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction=reduction, delta=delta)


class HuberLoss(_Loss):
    _op = staticmethod(nn_ops.huber_loss)

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(delta=delta, reduction=reduction)


class MarginRankingLoss(_Loss):
    _op = staticmethod(nn_ops.margin_ranking_loss)

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class HingeEmbeddingLoss(_Loss):
    _op = staticmethod(nn_ops.hinge_embedding_loss)

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class CosineEmbeddingLoss(_Loss):
    _op = staticmethod(nn_ops.cosine_embedding_loss)

    def __init__(self, margin=0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class TripletMarginLoss(_Loss):
    _op = staticmethod(nn_ops.triplet_margin_loss)

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin=margin, p=p, epsilon=epsilon, swap=swap,
                         reduction=reduction)


class CTCLoss(_Loss):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__(blank=blank, reduction=reduction)

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return unwrap(nn_ops.ctc_loss(log_probs, labels, input_lengths,
                                      label_lengths,
                                      norm_by_times=norm_by_times,
                                      **self.kw))


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid head: the (num_classes - 1, feature_size)
    weights of the internal tree nodes (the reference's checkpoint
    layout) and their bias.  Written on Tensors, so that its ``weight``
    is a ``Parameter`` (``Model``'s torch tensors are wrapped on the
    way in)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.weight = self.create_parameter([num_classes - 1, feature_size],
                                            attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return nn_ops.hsigmoid_loss(
            input, label, self.num_classes, self.weight, self.bias,
            path_table=path_table, path_code=path_code)
