"""The functional transforms — the counterpart of
``paddle_tpu/autograd_functional.py``: :func:`vjp`, :func:`jvp`,
:func:`jacobian`, :func:`hessian` and :func:`vhp` of a function written
on the port's Tensors, through ``torch.autograd.functional`` (which
differentiates whatever torch autograd records, so every op of the eager
core works inside).  Defaults and layouts are the reference's: ``v``
defaults to ones; several inputs give a tuple of Jacobians, and the
Hessian a nested tuple; results are detached, as the reference's are
new arrays.
"""
from __future__ import annotations

import torch
import torch.autograd.functional as taf

from .core.tensor import Tensor, to_tensor

__all__ = ["vjp", "jvp", "jacobian", "hessian", "vhp"]


def _on_torch(func):
    """``func`` on Tensors as a function of torch tensors."""
    def f(*arrays):
        out = func(*[Tensor(a) for a in arrays])
        if isinstance(out, (tuple, list)):
            return tuple(o._data for o in out)
        return out._data
    return f


def _arrays(xs):
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    return tuple(to_tensor(x)._data.detach() for x in xs)


def _wrap(o):
    if isinstance(o, tuple):
        return tuple(_wrap(x) for x in o)
    return Tensor(o.detach())


def _given(v):
    v = v if isinstance(v, (list, tuple)) else [v]
    return tuple(to_tensor(t)._data for t in v)


def vjp(func, xs, v=None):
    """``(func(xs), [v^T J for each input])``; ``v`` defaults to ones
    shaped as the output."""
    arrays = _arrays(xs)
    f = _on_torch(func)
    with torch.enable_grad():
        ins = tuple(a.clone().requires_grad_(True) for a in arrays)
        out = f(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        vs = tuple(torch.ones_like(o) for o in outs) if v is None \
            else _given(v)
        grads = torch.autograd.grad(outs, ins, vs, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(ins, grads)]
    return _wrap(out), [Tensor(g.detach()) for g in grads]


def jvp(func, xs, v=None):
    """``(func(xs), J v)``; ``v`` defaults to ones shaped as the
    inputs."""
    arrays = _arrays(xs)
    tangents = tuple(torch.ones_like(a) for a in arrays) if v is None \
        else _given(v)
    out, tangent_out = taf.jvp(_on_torch(func), arrays, tangents)
    return _wrap(out), _wrap(tangent_out)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """The Jacobian, of shape ``out.shape + x.shape`` for one input, a
    tuple of them for several."""
    arrays = _arrays(xs)
    jac = taf.jacobian(_on_torch(func), arrays)
    if len(arrays) == 1:
        return _wrap(jac[0] if isinstance(jac, tuple) else jac)
    return _wrap(tuple(jac))


def hessian(func, xs, create_graph=False, allow_unused=False):
    """The Hessian of a scalar function: ``x.shape + x.shape`` for one
    input, a nested tuple (input by input) for several."""
    arrays = _arrays(xs)
    h = taf.hessian(_on_torch(func), arrays)
    if len(arrays) == 1:
        return _wrap(h[0][0] if isinstance(h, tuple) else h)
    return _wrap(tuple(tuple(row) for row in h))


def vhp(func, inputs, v=None):
    """``(func(inputs), [v^T H for each input])``, H the Hessian of the
    sum of ``func``'s output; ``v`` defaults to ones."""
    arrays = _arrays(inputs)
    vs = tuple(torch.ones_like(a) for a in arrays) if v is None \
        else _given(v)
    f = _on_torch(func)
    with torch.enable_grad():
        ins = tuple(a.clone().requires_grad_(True) for a in arrays)
        out = f(*ins)
        grads = torch.autograd.grad(out.sum(), ins, create_graph=True)
        hv = torch.autograd.grad(grads, ins, vs, allow_unused=True)
    hv = [torch.zeros_like(a) if h is None else h for a, h in zip(ins, hv)]
    return Tensor(out.detach()), [Tensor(h.detach()) for h in hv]
