"""Eager autograd — the counterpart of ``paddle_tpu/core/autograd.py``
(grad mode :27-76, ``backward`` :130, ``grad`` :216, ``PyLayer`` :286).

Autograd is torch autograd; there is no second tape.  The reference's
semantics are the spec:

- ``backward()`` on a tensor that does not require grad raises, and so
  does a non-scalar ``backward()`` with no ``grad_tensor``;
- a second ``backward()`` of the same tensor raises without
  ``retain_graph`` (torch itself raises only where the graph saved
  tensors, so the root remembers its first backward) and accumulates
  with it;
- gradients accumulate into leaves across calls, and none reaches an
  input marked ``stop_gradient``.

``grad`` is ``torch.autograd.grad``.  :class:`PyLayer` and
:class:`PyLayerContext` map onto ``torch.autograd.Function``, with
:class:`~paddle_tpu_torch.core.tensor.Tensor`\\ s in ``forward`` and
``backward``.  ``no_grad``, ``enable_grad`` and ``set_grad_enabled`` are
torch's grad mode.

Hooks: the reference fires a tensor's hook once per incoming edge
(:199-203); torch fires it once, on the sum.  A linear hook gives the
same gradient either way; a non-linear one on a tensor used twice
differs (``ROADMAP.md`` §C).
"""
from __future__ import annotations

import functools
import torch

from .tensor import Tensor, unwrap, wrap

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "backward", "grad", "PyLayer", "PyLayerContext"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    """Set grad mode (a call), or, as torch's, a context manager."""
    return torch.set_grad_enabled(bool(mode))


class _GradMode:
    """A context manager and decorator over torch's grad mode."""

    def __init__(self, mode: bool):
        self._mode = mode

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _GradMode(self._mode):
                return fn(*args, **kwargs)
        return wrapper


def no_grad(fn=None):
    """``paddle.no_grad``: a context manager, or a decorator with or
    without parentheses."""
    guard = _GradMode(False)
    return guard(fn) if fn is not None else guard


def enable_grad(fn=None):
    guard = _GradMode(True)
    return guard(fn) if fn is not None else guard


def backward(tensor, grad_tensor=None, retain_graph: bool = False):
    """Reverse-mode from ``tensor``, accumulating into leaves' ``.grad``."""
    t = unwrap(tensor)
    if not t.requires_grad:
        raise RuntimeError(
            "backward() called on a tensor that does not require grad")
    if grad_tensor is None:
        if t.numel() != 1:
            raise RuntimeError(
                "grad_tensor must be provided for non-scalar backward()")
        seed = torch.ones_like(t)
    else:
        seed = unwrap(grad_tensor)
        if not isinstance(seed, torch.Tensor):
            seed = torch.as_tensor(seed, dtype=t.dtype, device=t.device)
    if t.__dict__.get("_pt_backward_done"):
        raise RuntimeError(
            "the grad graph of this tensor is already freed; pass "
            "retain_graph=True to backward() to reuse it")
    if t.grad_fn is None:
        # a leaf that requires grad: d(t)/d(t) is the seed
        t.grad = seed.detach().clone() if t.grad is None \
            else t.grad + seed
        return
    torch.autograd.backward(t, seed, retain_graph=bool(retain_graph))
    if not retain_graph:
        t.__dict__["_pt_backward_done"] = True


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` w.r.t. ``inputs`` as
    Tensors, leaving ``.grad`` untouched."""
    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        gouts = [None] * len(outs)
    else:
        gouts = grad_outputs if isinstance(grad_outputs, (list, tuple)) \
            else [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    seeds = []
    for o, g in zip(outs, gouts):
        o = unwrap(o)
        if g is None:
            if o.numel() != 1:
                raise RuntimeError(
                    "grad_outputs must be provided for a non-scalar output")
            seeds.append(torch.ones_like(o))
        else:
            seeds.append(unwrap(g))
    res = torch.autograd.grad([unwrap(o) for o in outs],
                              [unwrap(i) for i in ins], seeds,
                              retain_graph=bool(retain_graph),
                              create_graph=bool(create_graph),
                              allow_unused=bool(allow_unused))
    return [None if g is None else Tensor(g) for g in res]


# --------------------------------------------------------------------------
# PyLayer (reference python/paddle/autograd/py_layer.py)
# --------------------------------------------------------------------------
class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    saved_tensors = saved_tensor


def _function_of(cls) -> type:
    """The ``torch.autograd.Function`` behind a PyLayer subclass."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, spec, *flat):
            args, kwargs, slots, info = spec
            vals = list(args)
            for pos, t in zip(slots, flat):
                vals[pos] = Tensor(t)
            pctx = PyLayerContext()
            ctx.pctx = pctx
            out = cls.forward(pctx, *vals, **kwargs)
            info["tuple"] = isinstance(out, (tuple, list))
            outs = tuple(out) if info["tuple"] else (out,)
            return tuple(unwrap(o) for o in outs)

        @staticmethod
        def backward(ctx, *gouts):
            cots = [Tensor(g) if g is not None else None for g in gouts]
            gin = cls.backward(ctx.pctx, *cots)
            if not isinstance(gin, (tuple, list)):
                gin = (gin,)
            return (None,) + tuple(None if g is None else unwrap(g)
                                   for g in gin)

    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    """A user-defined autograd op: subclass with static
    ``forward(ctx, ...)`` and ``backward(ctx, *out_grads)``, both on
    Tensors; ``backward`` returns one gradient per Tensor input."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        slots = [i for i, a in enumerate(args)
                 if isinstance(a, (Tensor, torch.Tensor))]
        flat = [unwrap(args[i]) for i in slots]
        rest = tuple(None if i in slots else a for i, a in enumerate(args))
        info = {}
        outs = _function_of(cls).apply((rest, kwargs, slots, info), *flat)
        wrapped = tuple(wrap(o) for o in outs)
        return wrapped if info["tuple"] else wrapped[0]
