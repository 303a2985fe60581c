"""Activation layers — the port's copy of
``paddle_tpu/nn/layer/activation.py`` (reference
``python/paddle/nn/layer/activation.py``), over ``ops/activation.py``."""
from __future__ import annotations

from ...ops import activation as _act
from ..layer_base import Layer
from ..param_attr import ParamAttr
from .. import initializer as I

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax", "LogSoftmax",
           "LeakyReLU", "ELU", "CELU", "SELU", "Silu", "Swish", "Mish",
           "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
           "Tanhshrink", "Softplus", "Softsign", "LogSigmoid", "PReLU",
           "RReLU", "GLU", "Maxout", "ThresholdedReLU"]


def _simple(op, *static):
    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return op(x, *static)
    return _Act


ReLU = _simple(_act.relu)
ReLU6 = _simple(_act.relu6)
Sigmoid = _simple(_act.sigmoid)
Tanh = _simple(_act.tanh)
Silu = _simple(_act.silu)
Swish = _simple(_act.swish)
Mish = _simple(_act.mish)
Hardswish = _simple(_act.hardswish)
Softsign = _simple(_act.softsign)
LogSigmoid = _simple(_act.log_sigmoid)
Tanhshrink = _simple(_act.tanhshrink)
for _cls, _n in [(ReLU, "ReLU"), (ReLU6, "ReLU6"), (Sigmoid, "Sigmoid"),
                 (Tanh, "Tanh"), (Silu, "Silu"), (Swish, "Swish"),
                 (Mish, "Mish"), (Hardswish, "Hardswish"),
                 (Softsign, "Softsign"), (LogSigmoid, "LogSigmoid"),
                 (Tanhshrink, "Tanhshrink")]:
    _cls.__name__ = _n
    _cls.__qualname__ = _n


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return _act.gelu(x, approximate=self.approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _act.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _act.log_softmax(x, axis=self.axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return _act.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return _act.elu(x, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return _act.celu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return _act.selu(x, self.scale, self.alpha)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return _act.hardsigmoid(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return _act.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return _act.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return _act.softshrink(x, self.threshold)


class Softplus(Layer):
    def __init__(self, beta=1, threshold=20, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return _act.softplus(x, self.beta, self.threshold)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=ParamAttr._to_attr(weight_attr),
            default_initializer=I.Constant(init))

    def forward(self, x):
        return _act.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return _act.rrelu(x, self.lower, self.upper,
                                    training=self.training)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _act.glu(x, self.axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return _act.maxout(x, self.groups, self.axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return _act.thresholded_relu(x, self.threshold)
