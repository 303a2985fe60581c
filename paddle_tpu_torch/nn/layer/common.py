"""Common layers — the counterpart of ``paddle_tpu/nn/layer/common.py``:
``Linear`` (weight ``[in, out]``), ``Embedding``, the dropouts,
``Flatten``, ``Identity``, the padding layers, ``Bilinear``,
``CosineSimilarity`` and ``PairwiseDistance``.

Waiting for the conv leg (``ROADMAP.md`` §A item 10): ``Upsample``,
``UpsamplingBilinear2D``, ``UpsamplingNearest2D``, ``Unfold``,
``PixelShuffle``, ``PixelUnshuffle`` and ``ChannelShuffle``, which call
``ops.conv``.
"""
from __future__ import annotations

from ...ops import manipulation, nn_ops
from .. import initializer as I
from ..layer_base import Layer
from ..param_attr import ParamAttr

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Identity", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "Bilinear", "CosineSimilarity",
           "PairwiseDistance"]


class Linear(Layer):
    """``y = x W + b`` with ``W`` of shape ``[in_features, out_features]``
    (reference ``python/paddle/nn/layer/common.py`` Linear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        wa = ParamAttr._to_attr(weight_attr)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=wa,
            default_initializer=getattr(wa, "initializer", None) or
            I.XavierNormal())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_features], attr=ParamAttr._to_attr(bias_attr),
                is_bias=True)

    def forward(self, x):
        return nn_ops.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self._in_features}, out={self._out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._sparse = sparse
        self._padding_idx = padding_idx if padding_idx is None or \
            padding_idx >= 0 else num_embeddings + padding_idx
        wa = ParamAttr._to_attr(weight_attr)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=wa,
            default_initializer=getattr(wa, "initializer", None) or
            I.Normal(0.0, 1.0))
        if self._padding_idx is not None:
            self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return nn_ops.embedding(x, self.weight, padding_idx=self._padding_idx,
                                sparse=self._sparse)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return nn_ops.dropout(x, p=self.p, axis=self.axis,
                              training=self.training, mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.dropout2d(x, p=self.p, training=self.training,
                                data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.dropout3d(x, p=self.p, training=self.training,
                                data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return nn_ops.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return manipulation.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return manipulation.pad(x, self.padding, mode=self.mode,
                                value=self.value,
                                data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features],
            attr=ParamAttr._to_attr(weight_attr))
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=ParamAttr._to_attr(bias_attr), is_bias=True)

    def forward(self, x1, x2):
        return nn_ops.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return nn_ops.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return nn_ops.pairwise_distance(x, y, self.p, self.epsilon,
                                        self.keepdim)
