"""Tensor creation ops — the counterpart of ``paddle_tpu/ops/creation.py``.

Every op makes its tensor on the current place (``core/place.py``): the
card unless ``set_device("cpu")``.  Random ops draw from the port's
device streams (:data:`~paddle_tpu_torch.random.default_generator`,
reseeded by ``paddle_tpu_torch.seed``); their bits differ from JAX's, so
they are held to their statistics and to determinism.  Integer results
default to int32 where the reference asks for int64 (x64 off), and a
floating result without a dtype takes ``FLAGS_default_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import default_float, dtype_to_torch
from ..core.tensor import Tensor
from ..random import default_generator
from ._common import INT, device, dispatch, t

__all__ = [
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "linspace", "eye", "rand", "randn", "randint",
    "randperm", "uniform", "normal", "bernoulli", "multinomial", "assign",
    "clone", "diag", "tril", "triu", "meshgrid", "numel",
]


def _dt(dtype, default=None):
    if dtype is not None:
        return dtype_to_torch(dtype)
    return default if default is not None else default_float()


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _gen(dev):
    return default_generator.device(dev)


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_shape(shape), dtype=_dt(dtype),
                              device=device()))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_shape(shape), dtype=_dt(dtype),
                             device=device()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor(torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                             device=device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    x = t(x)
    dt = _dt(dtype, x.dtype)
    return dispatch("fill_zeros_like",
                    lambda a: torch.zeros_like(a, dtype=dt), (x,), {})


def ones_like(x, dtype=None, name=None):
    x = t(x)
    dt = _dt(dtype, x.dtype)
    return dispatch("ones_like",
                    lambda a: torch.ones_like(a, dtype=dt), (x,), {})


def full_like(x, fill_value, dtype=None, name=None):
    x = t(x)
    dt = _dt(dtype, x.dtype)
    if isinstance(fill_value, (Tensor, torch.Tensor)):
        return dispatch(
            "fill_any_like",
            lambda a, fv: torch.zeros_like(a, dtype=dt) + fv.to(dt),
            (x, t(fill_value)), {})
    return dispatch("fill_any_like",
                    lambda a: torch.full_like(a, fill_value, dtype=dt),
                    (x,), {})


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start

    def _v(v):
        return v.item() if isinstance(v, Tensor) else v
    start, end, step = _v(start), _v(end), _v(step)
    if dtype is None:
        dtype = "float32" if any(isinstance(v, float)
                                 for v in (start, end, step)) else "int32"
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=device()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor(torch.linspace(float(start), float(stop), int(num),
                                 dtype=_dt(dtype), device=device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return Tensor(torch.eye(int(num_rows), int(num_columns or num_rows),
                            dtype=_dt(dtype), device=device()))


def rand(shape, dtype=None, name=None):
    dev = device()
    return Tensor(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                             generator=_gen(dev)))


def randn(shape, dtype=None, name=None):
    dev = device()
    return Tensor(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                              generator=_gen(dev)))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = device()
    return Tensor(torch.randint(int(low), int(high), _shape(shape),
                                dtype=_dt(dtype, INT), device=dev,
                                generator=_gen(dev)))


def randperm(n, dtype=None, name=None):
    dev = device()
    return Tensor(torch.randperm(int(n), dtype=_dt(dtype, INT), device=dev,
                                 generator=_gen(dev)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = device()
    gen = torch.Generator(device=dev).manual_seed(int(seed)) if seed \
        else _gen(dev)
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return Tensor(out.uniform_(float(min), float(max), generator=gen))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._data if isinstance(mean, Tensor) else mean
        s = std._data if isinstance(std, Tensor) else std
        like = m if isinstance(m, torch.Tensor) else s
        dev = like.device
        shp = torch.broadcast_shapes(
            m.shape if isinstance(m, torch.Tensor) else (),
            s.shape if isinstance(s, torch.Tensor) else ())
        z = torch.randn(shp, dtype=like.dtype, device=dev,
                        generator=_gen(dev))
        return Tensor(z * s + m)
    dev = device()
    shp = _shape(shape if shape is not None else (1,))
    z = torch.randn(shp, dtype=default_float(), device=dev,
                    generator=_gen(dev))
    return Tensor(z * std + mean)


def bernoulli(x, name=None):
    x = t(x)
    a = x._data.detach()
    return Tensor(torch.bernoulli(a, generator=_gen(a.device)).to(a.dtype))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = t(x)
    a = x._data.detach()
    out = torch.multinomial(a.float(), int(num_samples),
                            replacement=replacement, generator=_gen(a.device))
    return Tensor(out.to(INT))


def assign(x, output=None):
    x = t(x)
    out = dispatch("assign", lambda a: a.clone(), (x,), {})
    if output is not None:
        output.set_value(out._data)
        return output
    return out


def clone(x, name=None):
    return assign(x)


def diag(x, offset=0, padding_value=0, name=None):
    x = t(x)
    if x.ndim == 1 and padding_value != 0:
        n = x.shape[0] + abs(offset)

        def impl(a):
            base = torch.full((n, n), padding_value, dtype=a.dtype,
                              device=a.device)
            return base + torch.diag(a - padding_value, offset)
        return dispatch("diag", impl, (x,), {})
    return dispatch("diag", lambda a: torch.diag(a, offset), (x,), {})


def tril(x, diagonal=0, name=None):
    return dispatch("tril", lambda a: torch.tril(a, diagonal), (t(x),), {})


def triu(x, diagonal=0, name=None):
    return dispatch("triu", lambda a: torch.triu(a, diagonal), (t(x),), {})


def meshgrid(*args, **kwargs):
    items = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    tensors = [t(a) for a in items]
    return list(dispatch("meshgrid",
                         lambda *a: torch.meshgrid(*a, indexing="ij"),
                         tensors, {}))


def numel(x, name=None):
    x = t(x)
    return Tensor(torch.tensor(x._data.numel(), dtype=INT,
                               device=x._data.device))
