"""Elementwise and scalar math ops — the counterpart of
``paddle_tpu/ops/math.py``.

Every op is a torch call under :func:`~paddle_tpu_torch.core.dispatch.
dispatch`, so torch autograd records it.  Binary ops take the
reference's scalar coercion (``_coerce_pair`` :27: a Python scalar
takes a floating tensor's type) and JAX's type promotion
(``_common.promote``).  The in-place variants raise on a tensor that
requires grad while grad is on, as the reference does, and otherwise
write into the tensor.
"""
from __future__ import annotations

import torch

from ..core import autograd
from ..core.tensor import Tensor
from ._common import dispatch, pair, promote, t

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "matpow", "maximum", "minimum", "fmax", "fmin",
    "abs", "neg", "reciprocal", "sign", "sqrt", "rsqrt", "square", "exp",
    "expm1", "log", "log2", "log10", "log1p", "floor", "ceil", "round",
    "trunc", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "atan2", "erf", "erfinv", "clip",
    "scale", "lerp", "addmm", "stanh", "rad2deg", "deg2rad", "frac",
    "digamma", "lgamma", "multiply_", "add_", "subtract_", "clip_",
    "logit", "nan_to_num", "angle", "conj", "real", "imag", "trace",
    "kron", "outer", "inner", "heaviside", "diff", "logaddexp",
]


def _unary(op_name, fn):
    def op(x, name=None):
        return dispatch(op_name, fn, (t(x),), {})
    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = f"Elementwise {op_name}."
    return op


def _promoted(fn):
    def kernel(a, b):
        return fn(*promote(a, b))
    return kernel


def _binary(op_name, fn):
    kernel = _promoted(fn)

    def op(x, y, name=None):
        x, y = pair(x, y)
        return dispatch(op_name, kernel, (x, y), {})
    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = f"Broadcasting elementwise {op_name}."
    return op


def _float_in(fn):
    """``fn`` on a floating input: integer and bool inputs are cast to
    float32 first, as JAX's transcendental functions do."""
    def kernel(a):
        if not (a.is_floating_point() or a.is_complex()):
            a = a.to(torch.float32)
        return fn(a)
    return kernel


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = remainder
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
heaviside = _binary("heaviside", torch.heaviside)
logaddexp = _binary("logaddexp", torch.logaddexp)
pow = _binary("pow", torch.pow)
matpow = pow

abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)
reciprocal = _unary("reciprocal", _float_in(torch.reciprocal))
sign = _unary("sign", torch.sign)
sqrt = _unary("sqrt", _float_in(torch.sqrt))
rsqrt = _unary("rsqrt", _float_in(torch.rsqrt))
square = _unary("square", torch.square)
exp = _unary("exp", _float_in(torch.exp))
expm1 = _unary("expm1", _float_in(torch.expm1))
log = _unary("log", _float_in(torch.log))
log2 = _unary("log2", _float_in(torch.log2))
log10 = _unary("log10", _float_in(torch.log10))
log1p = _unary("log1p", _float_in(torch.log1p))
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
sin = _unary("sin", _float_in(torch.sin))
cos = _unary("cos", _float_in(torch.cos))
tan = _unary("tan", _float_in(torch.tan))
asin = _unary("asin", _float_in(torch.asin))
acos = _unary("acos", _float_in(torch.acos))
atan = _unary("atan", _float_in(torch.atan))
sinh = _unary("sinh", _float_in(torch.sinh))
cosh = _unary("cosh", _float_in(torch.cosh))
tanh = _unary("tanh", _float_in(torch.tanh))
asinh = _unary("asinh", _float_in(torch.asinh))
acosh = _unary("acosh", _float_in(torch.acosh))
atanh = _unary("atanh", _float_in(torch.atanh))
erf = _unary("erf", _float_in(torch.erf))
erfinv = _unary("erfinv", _float_in(torch.erfinv))
digamma = _unary("digamma", _float_in(torch.digamma))
lgamma = _unary("lgamma", _float_in(torch.lgamma))
rad2deg = _unary("rad2deg", _float_in(torch.rad2deg))
deg2rad = _unary("deg2rad", _float_in(torch.deg2rad))
frac = _unary("frac", lambda a: a - torch.trunc(a))
angle = _unary("angle", _float_in(torch.angle))
conj = _unary("conj", lambda a: torch.conj(a).resolve_conj()
              if a.is_complex() else a)
real = _unary("real", lambda a: torch.real(a) if a.is_complex() else a)
imag = _unary("imag", lambda a: torch.imag(a) if a.is_complex() else a * 0)


def _scalar(v):
    return v.item() if isinstance(v, (Tensor, torch.Tensor)) else v


def clip(x, min=None, max=None, name=None):
    x = t(x)
    lo, hi = _scalar(min), _scalar(max)

    def kernel(a):
        if lo is None and hi is None:
            return a.clone()
        return torch.clamp(a, min=lo, max=hi)
    return dispatch("clip", kernel, (x,), {})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = t(x)
    s = _scalar(scale)

    def kernel(a):
        return a * s + bias if bias_after_scale else (a + bias) * s
    out = dispatch("scale", kernel, (x,), {})
    if act is not None:
        from . import activation
        out = getattr(activation, act)(out)
    return out


def lerp(x, y, weight, name=None):
    x, y = pair(x, y)
    if isinstance(weight, (Tensor, torch.Tensor)):
        return dispatch("lerp", lambda a, b, w: a + w * (b - a),
                        (x, y, t(weight)), {})
    return dispatch("lerp", lambda a, b: a + weight * (b - a), (x, y), {})


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return dispatch("addmm",
                    lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                    (t(input), t(x), t(y)), {})


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return dispatch("stanh", lambda a: scale_b * torch.tanh(scale_a * a),
                    (t(x),), {})


def logit(x, eps=None, name=None):
    def kernel(a):
        p = torch.clamp(a, eps, 1 - eps) if eps else a
        return torch.log(p / (1 - p))
    return dispatch("logit", kernel, (t(x),), {})


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return dispatch("nan_to_num",
                    lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf,
                                               neginf=neginf), (t(x),), {})


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    def kernel(a):
        out = torch.diagonal(a, offset, axis1, axis2).sum(-1)
        return out if out.dtype == a.dtype or a.is_floating_point() \
            else out.to(torch.int32)
    return dispatch("trace", kernel, (t(x),), {})


def kron(x, y, name=None):
    x, y = pair(x, y)
    return dispatch("kron", _promoted(torch.kron), (x, y), {})


def outer(x, y, name=None):
    x, y = pair(x, y)
    return dispatch("outer", _promoted(
        lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1))), (x, y), {})


def inner(x, y, name=None):
    x, y = pair(x, y)
    return dispatch("inner", _promoted(torch.inner), (x, y), {})


def diff(x, n=1, axis=-1, name=None):
    return dispatch("diff", lambda a: torch.diff(a, n=n, dim=axis),
                    (t(x),), {})


# -- in-place variants ------------------------------------------------------
def _inplace_guard(x, opname):
    """An in-place update of a tensor that requires grad raises while grad
    is on (reference ``ops/extras.py:175``)."""
    if autograd.is_grad_enabled() and not x.stop_gradient:
        raise RuntimeError(
            f"{opname}: in-place update of a tensor that requires grad is "
            "unsupported; use the out-of-place op or wrap in "
            "paddle.no_grad()")


def _inplace(op, name):
    def op_(x, *args, **kwargs):
        _inplace_guard(x, name)
        out = op(x, *args, **kwargs)
        return x._write(out._data) if x._data.dtype == out._data.dtype \
            else _rebind(x, out)
    op_.__name__ = op_.__qualname__ = name
    op_.__doc__ = f"In-place {name[:-1]}."
    return op_


def _rebind(x, out):
    x._data = out._data
    return x


add_ = _inplace(add, "add_")
subtract_ = _inplace(subtract, "subtract_")
multiply_ = _inplace(multiply, "multiply_")
clip_ = _inplace(clip, "clip_")
