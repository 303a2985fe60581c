"""Helpers shared by the tensor-function modules (``creation``,
``math``, ``reduction``, ``logic``, ``manipulation``, ``activation``,
``norm_ops``, ``linalg``, ``nn_ops``): operands as Tensors, the
reference's scalar coercion and JAX's type promotion, and the current
place's device."""
from __future__ import annotations

from typing import Sequence

import torch

from ..core import autograd
from ..core.dispatch import dispatch
from ..core.place import current_place
from ..core.tensor import Tensor, as_tensor

__all__ = ["dispatch", "t", "pair", "promote", "device", "axes",
           "no_grad_dispatch", "int_result", "INT"]

INT = torch.int32                 # the reference's int64 with x64 off


def t(x, like=None) -> Tensor:
    """An operand as a Tensor (``core.tensor.as_tensor``)."""
    return as_tensor(x, None if like is None else like._data)


def pair(x, y):
    """The reference's ``_coerce_pair`` (``ops/math.py:27``): ``x`` as a
    Tensor; a Python scalar ``y`` takes ``x``'s type when ``x`` is
    floating, else ``to_tensor``'s (int32, float32), on ``x``'s device."""
    if not isinstance(x, (Tensor, torch.Tensor)) and \
            isinstance(y, (Tensor, torch.Tensor)):
        y = t(y)
        x = t(x, y)
        return x, y
    x = t(x)
    if isinstance(y, (Tensor, torch.Tensor)):
        return x, t(y)
    if isinstance(y, (int, float, bool)) and x.dtype.is_floating_point:
        return x, Tensor(torch.tensor(y, dtype=x.dtype,
                                      device=x._data.device))
    return x, t(y, x)


def promote(*arrays: torch.Tensor):
    """The arrays in their common type (JAX's promotion: a 0-d operand
    counts as fully as any other, unlike torch's)."""
    dt = arrays[0].dtype
    for a in arrays[1:]:
        dt = torch.promote_types(dt, a.dtype)
    return tuple(a if a.dtype == dt else a.to(dt) for a in arrays)


def device() -> torch.device:
    """The current place's device (``NoCudaDevice`` without a card and
    without ``set_device("cpu")``)."""
    return current_place().torch_device()


def axes(axis):
    """A paddle axis argument (int, list, tuple, Tensor) as an int, a
    tuple of ints or None."""
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def no_grad_dispatch(op_name, fn, tensors: Sequence[Tensor], kwargs=None):
    """An op the reference computes outside its tape: dispatched without
    recording a gradient (its outputs are ``stop_gradient``)."""
    with autograd.no_grad():
        return dispatch(op_name, fn, tensors, kwargs or {})


def int_result(out: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A sum-like result of an integer or bool input in the reference's
    type: int32 (torch widens to int64)."""
    if not (a.is_floating_point() or a.is_complex()) and \
            out.dtype == torch.int64:
        return out.to(INT)
    return out
