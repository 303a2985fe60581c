"""Normalization layers — the counterpart of
``paddle_tpu/nn/layer/norm.py`` (reference
``python/paddle/nn/layer/norm.py``), over ``ops/norm_ops.py``.

``SyncBatchNorm`` reduces its statistics across a data-parallel axis in
the reference; the port has no mesh yet (``ROADMAP.md`` §A item 8), so
it runs as ``BatchNorm2D`` on one device, as the reference's does outside
a mesh.  ``SpectralNorm`` divides a weight it is given by its largest
singular value (power iteration from its ``weight_u`` / ``weight_v``
buffers, drawn from numpy's global stream as the reference's are; the
result carries no gradient, as the reference's).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor, unwrap
from ...ops import activation as _act
from ...ops import norm_ops
from .. import initializer as I
from ..layer_base import Layer
from ..param_attr import ParamAttr

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "RMSNorm", "SpectralNorm"]


def _scale_and_bias(layer, shape, weight_attr, bias_attr):
    if weight_attr is False:
        layer.weight = None
    else:
        layer.weight = layer.create_parameter(
            shape, attr=ParamAttr._to_attr(weight_attr),
            default_initializer=I.Constant(1.0))
    if bias_attr is False:
        layer.bias = None
    else:
        layer.bias = layer.create_parameter(
            shape, attr=ParamAttr._to_attr(bias_attr), is_bias=True)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _scale_and_bias(self, [num_features], weight_attr, bias_attr)
        dev = self.weight.place.torch_device() if self.weight is not None \
            else None
        self.register_buffer("_mean", I.Constant(0.0)([num_features],
                                                      device=dev))
        self.register_buffer("_variance", I.Constant(1.0)([num_features],
                                                          device=dev))

    def forward(self, x):
        return norm_ops.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    """The legacy ``fluid.dygraph.BatchNorm`` signature."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(_act, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL" else "NHWC"
                         if data_format == "NLC" else data_format,
                         use_global_stats)
        self._orig_format = data_format

    def forward(self, x):
        return norm_ops.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon,
            data_format="NCL" if self._orig_format in ("NCL", "NCHW")
            else "NLC", use_global_stats=self._use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm; on one device, ``BatchNorm2D``."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format)
            out.set_state_dict(layer.state_dict())
        for name, sub in list(layer._modules.items()):
            converted = cls.convert_sync_batchnorm(sub)
            if converted is not sub:
                out.add_sublayer(name, converted)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _scale_and_bias(self, self._normalized_shape, weight_attr, bias_attr)

    def forward(self, x):
        return norm_ops.layer_norm(x, self._normalized_shape, self.weight,
                                   self.bias, self._epsilon)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=ParamAttr._to_attr(weight_attr),
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return norm_ops.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        _scale_and_bias(self, [num_channels], weight_attr, bias_attr)

    def forward(self, x):
        return norm_ops.group_norm(x, self._num_groups, self._epsilon,
                                   self.weight, self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        _scale_and_bias(self, [num_features], weight_attr, bias_attr)

    def forward(self, x):
        return norm_ops.instance_norm(x, weight=self.weight, bias=self.bias,
                                      eps=self._epsilon,
                                      data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return norm_ops.local_response_norm(x, *self.args)



class SpectralNorm(Layer):
    """``forward(weight)``: ``weight / σ``, σ its largest singular value
    along ``dim`` from ``power_iters`` steps of power iteration, the
    vectors kept in the buffers (reference ``spectral_norm_op``)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.register_buffer("weight_u", Tensor(
            np.random.normal(0, 1, [h]).astype("float32")))
        self.register_buffer("weight_v", Tensor(
            np.random.normal(0, 1, [w]).astype("float32")))

    @torch.no_grad()
    def forward(self, weight):
        w = unwrap(weight).detach()
        mat = w.movedim(self._dim, 0).reshape(w.shape[self._dim], -1)
        ubuf, vbuf = unwrap(self.weight_u), unwrap(self.weight_v)
        u, v = ubuf, vbuf
        for _ in range(self._power_iters):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        sigma = u @ mat @ v
        ubuf.copy_(u)
        vbuf.copy_(v)
        return Tensor(w / sigma)
