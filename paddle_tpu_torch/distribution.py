"""Probability distributions — the counterpart of
``paddle_tpu/distribution.py``: ``Distribution``, ``Uniform``, ``Normal``
and ``Categorical`` with ``sample``, ``entropy``, ``log_prob``, ``probs``
and ``kl_divergence``.

Densities go through the port's tensor functions, so autograd records
them, and samples are reparameterised as the reference's (:78-84,
:114-120): ``low + u (high - low)`` and ``loc + eps scale``, so a
gradient reaches the parameters.  Draws come from the port's default
generator on the distribution's device, or, for a nonzero ``seed``, from
a ``torch.Generator`` seeded with it there.  torch's bits are not JAX's:
samples are held to their statistics, never to the reference's draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import ops as P
from .core.tensor import Tensor, to_tensor
from .ops._common import INT
from .random import default_generator

__all__ = ["Distribution", "Uniform", "Normal", "Categorical"]


def _f32(x):
    """Python scalars, lists and Tensors as a floating Tensor."""
    t = to_tensor(x)
    if not t._data.is_floating_point():
        t = t.astype("float32")
    return t


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if shape is None:
        shape = ()
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    return tuple(int(s) for s in shape)


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    if seed:
        return torch.Generator(device=dev).manual_seed(int(seed))
    return default_generator.device(dev)


class Distribution:
    """The base class (reference ``distribution.py:42``)."""

    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError


class Uniform(Distribution):
    """Uniform on ``[low, high)``: ``pdf(x) = 1 / (high - low)``."""

    def __init__(self, low, high, name=None):
        self.low = _f32(low)
        self.high = _f32(high)
        self.name = name or "Uniform"
        self._batch_shape = tuple(torch.broadcast_shapes(
            tuple(self.low.shape), tuple(self.high.shape)))

    def sample(self, shape=(), seed=0):
        dev = self.low._data.device
        u = torch.rand(_shape(shape) + self._batch_shape,
                       dtype=torch.float32, device=dev,
                       generator=_generator(dev, seed))
        return P.add(self.low, P.multiply(Tensor(u),
                                          P.subtract(self.high, self.low)))

    def _inside(self, value):
        lb = P.cast(P.less_equal(self.low, value), value.dtype)
        ub = P.cast(P.less_than(value, self.high), value.dtype)
        return P.multiply(lb, ub)

    def log_prob(self, value):
        value = _f32(value)
        return P.subtract(P.log(self._inside(value)),
                          P.log(P.subtract(self.high, self.low)))

    def probs(self, value):
        value = _f32(value)
        return P.divide(self._inside(value), P.subtract(self.high, self.low))

    def entropy(self):
        return P.log(P.subtract(self.high, self.low))


_HALF_LOG_2PI = 0.5 * float(np.log(2.0 * np.pi))


class Normal(Distribution):
    """Normal with mean ``loc`` and standard deviation ``scale``."""

    def __init__(self, loc, scale, name=None):
        self.loc = _f32(loc)
        self.scale = _f32(scale)
        self.name = name or "Normal"
        self._batch_shape = tuple(torch.broadcast_shapes(
            tuple(self.loc.shape), tuple(self.scale.shape)))

    def sample(self, shape=(), seed=0):
        dev = self.loc._data.device
        eps = torch.randn(_shape(shape) + self._batch_shape,
                          dtype=torch.float32, device=dev,
                          generator=_generator(dev, seed))
        return P.add(self.loc, P.multiply(Tensor(eps), self.scale))

    def _const(self, value):
        return P.full([], value, "float32")

    def entropy(self):
        zeros = P.zeros(list(self._batch_shape), "float32")
        return P.add(P.add(self._const(0.5 + _HALF_LOG_2PI),
                           P.log(self.scale)), zeros)

    def log_prob(self, value):
        value = _f32(value)
        var = P.multiply(self.scale, self.scale)
        diff = P.subtract(value, self.loc)
        return P.subtract(
            P.divide(P.multiply(diff, diff), P.scale(var, -2.0)),
            P.add(P.log(self.scale), self._const(_HALF_LOG_2PI)))

    def probs(self, value):
        return P.exp(self.log_prob(value))

    def kl_divergence(self, other):
        """KL(self || other) of two Normals (reference
        ``distribution.py:596``)."""
        if not isinstance(other, Normal):
            raise TypeError("kl_divergence expects a Normal")
        ratio = P.divide(self.scale, other.scale)
        ratio = P.multiply(ratio, ratio)
        t1 = P.divide(P.subtract(self.loc, other.loc), other.scale)
        t1 = P.multiply(t1, t1)
        return P.scale(P.subtract(P.add(ratio, t1),
                                  P.add(self._const(1.0), P.log(ratio))),
                       0.5)


class Categorical(Distribution):
    """Categorical over the last axis of ``logits``."""

    def __init__(self, logits, name=None):
        self.logits = _f32(logits)
        self.name = name or "Categorical"
        self._num_events = int(self.logits.shape[-1])

    def _norm_probs(self):
        return P.softmax(self.logits, axis=-1)

    def sample(self, shape=()):
        """Category indices of shape ``shape + batch``, int32 (the
        reference's int64 with x64 off)."""
        shape = _shape(shape)
        logits = self.logits._data.detach()
        batch = tuple(logits.shape[:-1])
        probs = torch.softmax(logits.reshape(-1, self._num_events), -1)
        n = math.prod(shape)
        draw = torch.multinomial(probs, n, replacement=True,
                                 generator=_generator(logits.device, 0))
        draw = draw.T.reshape(shape + batch)
        return Tensor(draw.to(INT))

    def entropy(self):
        p = self._norm_probs()
        logp = P.log_softmax(self.logits, axis=-1)
        return P.scale(P.sum(P.multiply(p, logp), axis=-1), -1.0)

    def kl_divergence(self, other):
        if not isinstance(other, Categorical):
            raise TypeError("kl_divergence expects a Categorical")
        logp = P.log_softmax(self.logits, axis=-1)
        logq = P.log_softmax(other.logits, axis=-1)
        return P.sum(P.multiply(self._norm_probs(), P.subtract(logp, logq)),
                     axis=-1)

    def probs(self, value):
        """The probabilities of the category indices ``value``."""
        p = self._norm_probs()
        value = to_tensor(value).astype("int64")
        if p.ndim == 1:
            return P.gather(p, value)
        got = P.take_along_axis(p, P.unsqueeze(value, axis=-1), axis=-1)
        return P.squeeze(got, axis=-1)

    def log_prob(self, value):
        return P.log(self.probs(value))
