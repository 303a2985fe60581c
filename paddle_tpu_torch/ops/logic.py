"""Comparison, logical and predicate ops — the counterpart of
``paddle_tpu/ops/logic.py``.  No gradient flows through them; a Python
scalar operand takes the tensor's type first (``_pair`` :37)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ._common import no_grad_dispatch, promote, t

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_xor", "logical_not", "isnan", "isinf",
    "isfinite", "is_empty", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not",
]


def _pair(x, y):
    x = t(x)
    if isinstance(y, (Tensor, torch.Tensor)):
        return x, t(y)
    if isinstance(y, (int, float, bool)):
        return x, Tensor(torch.tensor(y, device=x._data.device).to(x.dtype))
    return x, t(y, x)


def _cmp(op_name, fn):
    def kernel(a, b):
        return fn(*promote(a, b))

    def op(x, y, name=None):
        return no_grad_dispatch(op_name, kernel, _pair(x, y))
    op.__name__ = op.__qualname__ = op_name
    return op


def _unary(op_name, fn):
    def op(x, name=None):
        return no_grad_dispatch(op_name, fn, (t(x),))
    op.__name__ = op.__qualname__ = op_name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)

logical_not = _unary("logical_not", torch.logical_not)
bitwise_not = _unary("bitwise_not", torch.bitwise_not)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)


def equal_all(x, y, name=None):
    def kernel(p, q):
        if p.shape != q.shape:
            return torch.zeros((), dtype=torch.bool, device=p.device)
        p, q = promote(p, q)
        return torch.eq(p, q).all()
    return no_grad_dispatch("equal_all", kernel, _pair(x, y))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    def kernel(p, q):
        p, q = promote(p, q)
        return torch.isclose(p, q, rtol=rtol, atol=atol,
                             equal_nan=equal_nan).all()
    return no_grad_dispatch("allclose", kernel, _pair(x, y))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    def kernel(p, q):
        p, q = promote(p, q)
        return torch.isclose(p, q, rtol=rtol, atol=atol, equal_nan=equal_nan)
    return no_grad_dispatch("isclose", kernel, _pair(x, y))


def is_empty(x, name=None):
    return no_grad_dispatch(
        "is_empty", lambda a: torch.tensor(a.numel() == 0, device=a.device),
        (t(x),))
