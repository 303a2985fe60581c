"""Weight initializers — the counterpart of ``paddle_tpu/nn/initializer.py``
(reference ``python/paddle/fluid/initializer.py``): Constant, Uniform,
Normal, TruncatedNormal, Xavier, Kaiming, Bilinear, Assign, Orthogonal,
Dirac and ``calculate_gain``.

Each initializer is a callable ``(shape, dtype, device=None)`` that
returns a torch tensor on ``device`` (the current place when None),
drawing from the port's stream of that device
(:data:`~paddle_tpu_torch.random.default_generator`, reseeded by
``paddle_tpu_torch.seed``).  The draws are held to their statistics and
to determinism under ``seed``, not to JAX's bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dtype import dtype_to_torch
from ..core.place import current_place
from ..core.tensor import Tensor
from ..random import default_generator

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Bilinear", "Orthogonal", "Dirac", "calculate_gain"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
             "selu": 3.0 / 4}
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return gains.get(nonlinearity, 1.0)


def _empty(shape, dtype, device):
    dev = current_place().torch_device() if device is None \
        else torch.device(device)
    return torch.empty(tuple(int(s) for s in shape),
                       dtype=dtype_to_torch(dtype), device=dev)


def _gen(t: torch.Tensor) -> torch.Generator:
    return default_generator.device(t.device)


class Initializer:
    def __call__(self, shape, dtype="float32", device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        return _empty(shape, dtype, device).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        return t.normal_(self.mean, self.std, generator=_gen(t))


class TruncatedNormal(Initializer):
    """``mean + std * z`` with ``z`` standard normal truncated to
    [-2, 2], as ``jax.random.truncated_normal(-2, 2)``."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=_gen(t))
        return t.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        return t.uniform_(self.low, self.high, generator=_gen(t))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None):
        fan_in, fan_out = _fans(shape)
        fan_in = self._fan_in or fan_in
        fan_out = self._fan_out or fan_out
        std = self._gain * math.sqrt(2.0 / (fan_in + fan_out))
        t = _empty(shape, dtype, device)
        return t.normal_(0.0, std, generator=_gen(t))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None):
        fan_in, fan_out = _fans(shape)
        fan_in = self._fan_in or fan_in
        fan_out = self._fan_out or fan_out
        limit = self._gain * math.sqrt(6.0 / (fan_in + fan_out))
        t = _empty(shape, dtype, device)
        return t.uniform_(-limit, limit, generator=_gen(t))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self._fan_in = fan_in
        self._slope = negative_slope
        self._nl = nonlinearity

    def __call__(self, shape, dtype="float32", device=None):
        fan_in = self._fan_in or _fans(shape)[0]
        std = calculate_gain(self._nl, self._slope) / math.sqrt(fan_in)
        t = _empty(shape, dtype, device)
        return t.normal_(0.0, std, generator=_gen(t))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self._fan_in = fan_in
        self._slope = negative_slope
        self._nl = nonlinearity

    def __call__(self, shape, dtype="float32", device=None):
        fan_in = self._fan_in or _fans(shape)[0]
        limit = calculate_gain(self._nl, self._slope) * math.sqrt(
            3.0 / fan_in)
        t = _empty(shape, dtype, device)
        return t.uniform_(-limit, limit, generator=_gen(t))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        v = self.value
        v = v._data.detach() if isinstance(v, Tensor) else \
            torch.as_tensor(np.asarray(v))
        return t.copy_(v.reshape(t.shape).to(t.dtype))


class Bilinear(Initializer):
    """The bilinear upsampling kernel for a transposed conv (reference
    ``initializer.BilinearInitializer``)."""

    def __call__(self, shape, dtype="float32", device=None):
        c_out, c_in, kh, kw = shape
        f = math.ceil(kw / 2.0)
        center = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:kh, :kw]
        filt = (1 - abs(og[0] / f - center)) * (1 - abs(og[1] / f - center))
        weight = np.zeros(shape, dtype=np.float32)
        for i in range(c_out):
            weight[i, min(i, c_in - 1)] = filt
        return _empty(shape, dtype, device).copy_(torch.from_numpy(weight))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        flat = torch.empty((max(rows, cols), min(rows, cols)),
                           dtype=torch.float32, device=t.device)
        flat.normal_(generator=_gen(t))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return t.copy_((self.gain * q[:rows, :cols]).reshape(t.shape))


class Dirac(Initializer):
    def __call__(self, shape, dtype="float32", device=None):
        out = np.zeros(shape, np.float32)
        c = min(shape[0], shape[1])
        centers = [s // 2 for s in shape[2:]]
        for i in range(c):
            out[(i, i) + tuple(centers)] = 1.0
        return _empty(shape, dtype, device).copy_(torch.from_numpy(out))
