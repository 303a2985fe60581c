"""Activation functions — the counterpart of
``paddle_tpu/ops/activation.py``.

Each is a torch call under dispatch, in the reference's formula where
torch's function would differ at a boundary (``leaky_relu`` takes the
identity branch at 0, as ``jax.nn.leaky_relu`` does; ``hardswish``,
``elu``, ``softplus`` are written out).  ``rrelu`` in training and
``gumbel_softmax`` draw from the port's device streams.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..random import default_generator
from ._common import dispatch, t

__all__ = [
    "relu", "relu_", "relu6", "gelu", "sigmoid", "tanh", "softmax",
    "log_softmax", "silu", "swish", "hardswish", "hardsigmoid", "hardtanh",
    "hardshrink", "softshrink", "tanhshrink", "leaky_relu", "elu", "celu",
    "selu", "softplus", "softsign", "mish", "prelu", "rrelu", "glu",
    "maxout", "thresholded_relu", "log_sigmoid", "gumbel_softmax",
    "temperature_softmax",
]


def _unary(op_name, fn):
    def op(x, name=None):
        return dispatch(op_name, fn, (t(x),), {})
    op.__name__ = op.__qualname__ = op_name
    return op


def _softplus(a):
    return torch.logaddexp(a, torch.zeros_like(a))


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", lambda a: torch.clamp(a, 0.0, 6.0))
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
silu = _unary("silu", F.silu)
softsign = _unary("softsign", F.softsign)
log_sigmoid = _unary("log_sigmoid", F.logsigmoid)
mish = _unary("mish", lambda a: a * torch.tanh(_softplus(a)))
tanhshrink = _unary("tanhshrink", lambda a: a - torch.tanh(a))


def relu_(x, name=None):
    x._data = relu(x)._data
    return x


def gelu(x, approximate=False, name=None):
    mode = "tanh" if approximate else "none"
    return dispatch("gelu", lambda a: F.gelu(a, approximate=mode), (t(x),),
                    {})


def softmax(x, axis=-1, dtype=None, name=None):
    x = t(x)
    if dtype is not None:
        x = x.astype(dtype)
    return dispatch("softmax", lambda a: torch.softmax(a, dim=axis), (x,),
                    {})


def temperature_softmax(x, temperature=1.0, axis=-1):
    return dispatch("temperature_softmax",
                    lambda a: torch.softmax(a / temperature, dim=axis),
                    (t(x),), {})


def log_softmax(x, axis=-1, dtype=None, name=None):
    x = t(x)
    if dtype is not None:
        x = x.astype(dtype)
    return dispatch("log_softmax", lambda a: torch.log_softmax(a, dim=axis),
                    (x,), {})


def swish(x, name=None):
    return silu(x)


def hardswish(x, name=None):
    return dispatch("hardswish",
                    lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0,
                    (t(x),), {})


def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    return dispatch("hardsigmoid",
                    lambda a: torch.clamp(slope * a + offset, 0.0, 1.0),
                    (t(x),), {})


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return dispatch("hardtanh", lambda a: torch.clamp(a, min, max), (t(x),),
                    {})


def hardshrink(x, threshold=0.5, name=None):
    return dispatch("hardshrink",
                    lambda a: torch.where(a.abs() > threshold, a,
                                          torch.zeros_like(a)), (t(x),), {})


def softshrink(x, threshold=0.5, name=None):
    def kernel(a):
        z = torch.zeros_like(a)
        return torch.where(a > threshold, a - threshold,
                           torch.where(a < -threshold, a + threshold, z))
    return dispatch("softshrink", kernel, (t(x),), {})


def leaky_relu(x, negative_slope=0.01, name=None):
    return dispatch("leaky_relu",
                    lambda a: torch.where(a >= 0, a, negative_slope * a),
                    (t(x),), {})


def elu(x, alpha=1.0, name=None):
    return dispatch("elu",
                    lambda a: torch.where(a > 0, a, alpha * torch.expm1(a)),
                    (t(x),), {})


def celu(x, alpha=1.0, name=None):
    return dispatch(
        "celu", lambda a: torch.where(a > 0, a, alpha * torch.expm1(a / alpha)),
        (t(x),), {})


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return dispatch(
        "selu",
        lambda a: scale * torch.where(a > 0, a, alpha * torch.expm1(a)),
        (t(x),), {})


def softplus(x, beta=1, threshold=20, name=None):
    return dispatch(
        "softplus",
        lambda a: torch.where(beta * a > threshold, a,
                              _softplus(beta * a) / beta), (t(x),), {})


def prelu(x, weight, data_format="NCHW", name=None):
    def kernel(a, w):
        if w.numel() > 1 and a.dim() > 1:
            shape = [1] * a.dim()
            ch_axis = 1 if data_format.startswith("NC") else a.dim() - 1
            shape[ch_axis] = w.numel()
            w = w.reshape(shape)
        return torch.where(a > 0, a, w * a)
    return dispatch("prelu", kernel, (t(x), t(weight)), {})


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=False, name=None):
    x = t(x)
    if training:
        a = x._data
        slope = torch.empty(a.shape, dtype=a.dtype, device=a.device).uniform_(
            lower, upper, generator=default_generator.device(a.device))
    else:
        slope = (lower + upper) / 2.0
    return dispatch("rrelu", lambda a: torch.where(a >= 0, a, slope * a),
                    (x,), {})


def glu(x, axis=-1, name=None):
    def kernel(a):
        a1, a2 = torch.chunk(a, 2, dim=axis)
        return a1 * torch.sigmoid(a2)
    return dispatch("glu", kernel, (t(x),), {})


def maxout(x, groups, axis=1, name=None):
    def kernel(a):
        shape = list(a.shape)
        c = shape[axis]
        shape[axis:axis + 1] = [c // groups, groups]
        return torch.amax(a.reshape(shape), dim=axis + 1)
    return dispatch("maxout", kernel, (t(x),), {})


def thresholded_relu(x, threshold=1.0, name=None):
    return dispatch("thresholded_relu",
                    lambda a: torch.where(a > threshold, a,
                                          torch.zeros_like(a)), (t(x),), {})


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    x = t(x)
    a = x._data
    u = torch.rand(a.shape, dtype=a.dtype, device=a.device,
                   generator=default_generator.device(a.device))
    tiny = torch.finfo(a.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))

    def kernel(a):
        y = torch.softmax((a + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            y = (y_hard - y).detach() + y
        return y
    return dispatch("gumbel_softmax", kernel, (x,), {})
