"""The products of ``paddle_tpu/ops/linalg.py`` that ``Tensor``'s methods
name: ``matmul`` (:34), ``mm``, ``bmm``, ``mv``, ``dot``, ``t``,
``norm`` (:75) and ``dist`` (:95).  The rest of the module (the
decompositions, solves, ``einsum``, ...) is ``ROADMAP.md`` §A item 5b.

``FLAGS_matmul_precision`` is read at each product, as the reference
reads it (:29): ``"default"``, ``"highest"`` and ``"float32"`` keep fp32
products in full fp32 (``device.resolve_device`` pins
``allow_tf32 = False`` on the card); ``"high"``, ``"tensorfloat32"`` and
``"bfloat16"`` let the card take fp32 products in TF32.
"""
from __future__ import annotations

import contextlib

import torch

from ..utils import flags
from ._common import dispatch, promote
from ._common import t as _t

__all__ = ["matmul", "mm", "bmm", "dot", "t", "transpose_matmul", "norm",
           "dist", "mv"]

_TF32 = ("high", "tensorfloat32", "bfloat16")


@contextlib.contextmanager
def _precision(a: torch.Tensor):
    """Products inside run at ``FLAGS_matmul_precision`` on the card."""
    if not a.is_cuda or flags.get_flag("FLAGS_matmul_precision") not in _TF32:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def kernel(a, b):
        a, b = promote(a, b)
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        if a.is_cuda and not (a.is_floating_point() or a.is_complex()):
            # the card has no integer product: float64 holds these sums
            # exactly below 2**53, and the cast wraps as int32 arithmetic
            out = torch.matmul(a.double(), b.double()).to(torch.int64)
            return out.to(a.dtype)
        with _precision(a):
            return torch.matmul(a, b)
    return dispatch("matmul", kernel, (_t(x), _t(y)), {})


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


def dot(x, y, name=None):
    def kernel(a, b):
        a, b = promote(a, b)
        out = torch.sum(a * b, dim=-1)
        return out.to(torch.int32) if out.dtype == torch.int64 else out
    return dispatch("dot", kernel, (_t(x), _t(y)), {})


def t(input, name=None):
    input = _t(input)
    if input.ndim < 2:
        return input
    from .manipulation import transpose
    return transpose(input, perm=[1, 0])


transpose_matmul = t


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = _t(x)
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def kernel(a):
        dims = tuple(range(a.dim())) if ax is None else ax
        if p == "fro":
            return torch.sqrt(torch.sum(torch.square(a), dim=dims,
                                        keepdim=keepdim))
        if p == float("inf"):
            return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
        return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=dims,
                                   keepdim=keepdim), 1.0 / p)
    return dispatch("norm", kernel, (x,), {})


def dist(x, y, p=2, name=None):
    def kernel(a, b):
        d = torch.abs(a - b)
        if p == float("inf"):
            return torch.amax(d)
        if p == float("-inf"):
            return torch.amin(d)
        if p == 0:
            return torch.sum((d != 0).to(d.dtype))
        return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)
    return dispatch("dist", kernel, (_t(x), _t(y)), {})

