"""``Tensor``, ``Parameter`` and ``to_tensor`` — the counterparts of
``paddle_tpu/core/tensor.py`` (``Tensor`` :44, ``Parameter`` :299,
``to_tensor`` :323).

A :class:`Tensor` wraps a ``torch.Tensor`` in ``_data``, as the
reference wraps a ``jax.Array``.  It is not a ``torch.Tensor`` subclass:
paddle's ``shape`` (a list), ``size`` (a property), ``dim`` and ``dtype``
clash with torch's own, which torch's Python code calls.  Autograd is
torch's (``core/autograd.py``): ``stop_gradient`` is ``not
_data.requires_grad`` and ``grad`` is a :class:`Tensor` view of
``_data.grad`` (a :class:`~.selected_rows.SelectedRows` view of a sparse
embedding's row-sparse gradient).

A :class:`Parameter` wraps a ``torch.nn.Parameter``.  There is exactly
one wrapper per torch parameter (:meth:`Parameter.of`), and its paddle
attributes (``name``, ``persistable``, ``optimize_attr``,
``regularizer``, ``need_clip``, ``is_distributed``, ``placements``) live
on the torch parameter, where the port's optimizers and clips read them.

Mutation follows the reference where torch autograd allows it:
``__setitem__`` (:284) rebinds ``_data`` to an out-of-place update; on a
``Parameter``, and in ``set_value`` / ``copy_`` / ``fill_`` / ``zero_`` /
``scale_`` on a leaf, the write goes in place under ``no_grad`` so the
torch tensor a ``Layer`` or an optimizer holds stays the same object.

``numpy()`` detaches and copies to the host.  A bfloat16 tensor comes
back as a float32 array: the reference returns ``ml_dtypes.bfloat16``
arrays, and the card's machine has no ``ml_dtypes`` (a narrowing).
"""
from __future__ import annotations

import copy
import itertools
from typing import Optional

import numpy as np
import torch

from .dtype import canonical_dtype, default_float, dtype_to_torch
from .place import Place, _parse, current_place, place_of

__all__ = ["Tensor", "Parameter", "to_tensor"]

_names = itertools.count()
# paddle attributes a Parameter keeps on its torch parameter
PARAM_ATTRS = ("name", "persistable", "optimize_attr", "regularizer",
               "need_clip", "is_distributed", "placements")


def _next_name(prefix="tensor"):
    return f"{prefix}_{next(_names)}"


def _numpy_dtype(arr: np.ndarray):
    """The torch dtype ``to_tensor`` gives a numpy array: 64-bit types
    narrowed, float64 to the default floating type."""
    if arr.dtype == np.float64:
        return default_float()
    return dtype_to_torch(arr.dtype)


class Tensor:
    __slots__ = ("_data", "_name", "persistable", "trainable",
                 "__weakref__")

    def __init__(self, data, stop_gradient: Optional[bool] = None,
                 name: Optional[str] = None):
        if isinstance(data, Tensor):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = to_tensor(data)._data
        self._data = data
        self._name = name
        self.persistable = False
        if stop_gradient is not None:
            self.stop_gradient = stop_gradient
        self.trainable = not self.stop_gradient

    # ------------------------------------------------------------------
    # metadata
    # ------------------------------------------------------------------
    @property
    def name(self) -> str:
        if self._name is None:
            self._name = _next_name()
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def dim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def place(self) -> Place:
        return place_of(self._data)

    @property
    def is_leaf(self) -> bool:
        return self._data.is_leaf

    @property
    def T(self):
        from ..ops import manipulation
        return manipulation.transpose(self, perm=list(range(self.ndim))[::-1])

    def numel(self) -> int:
        return self._data.numel()

    def element_size(self) -> int:
        return self._data.element_size()

    # ------------------------------------------------------------------
    # autograd state (torch autograd)
    # ------------------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        d = self._data
        if value:
            if d.requires_grad:
                if d.is_leaf:
                    d.requires_grad_(False)
                else:
                    self._data = d.detach()
        elif not d.requires_grad and (d.is_floating_point()
                                      or d.is_complex()):
            if d.is_leaf:
                d.requires_grad_(True)
            else:
                self._data = d.detach().requires_grad_(True)

    @property
    def grad(self):
        """The gradient as a Tensor; a row-sparse one (a sparse
        embedding's) as a :class:`~.selected_rows.SelectedRows` view."""
        g = self._data.grad
        if g is None:
            return None
        if g.is_sparse:
            from .selected_rows import SelectedRows
            return SelectedRows.of(g)
        return Tensor(g)

    @grad.setter
    def grad(self, value):
        from .selected_rows import SelectedRows
        if isinstance(value, SelectedRows):
            value = value.to_torch()
        self._data.grad = None if value is None else unwrap(value)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from . import autograd
        autograd.backward(self, grad_tensor, retain_graph)

    def clear_gradient(self, set_to_zero: bool = False):
        g = self._data.grad
        if set_to_zero and g is not None:
            if g.is_sparse:
                # dense zeros, as the reference leaves (:145-151): the
                # next gradient then accumulates densely
                self._data.grad = torch.zeros(g.shape, dtype=g.dtype,
                                              device=g.device)
            else:
                g.zero_()
        else:
            self._data.grad = None

    clear_grad = clear_gradient

    def register_hook(self, hook):
        """``hook(grad)`` runs on the gradient reaching this tensor (torch
        calls it once, on the sum over its uses; ``ROADMAP.md`` §C); a
        returned tensor replaces the gradient."""
        def torch_hook(g):
            out = hook(Tensor(g))
            return None if out is None else unwrap(out)
        return self._data.register_hook(torch_hook)

    def detach(self) -> "Tensor":
        return Tensor(self._data.detach(), name=self.name + "_detached")

    def clone(self) -> "Tensor":
        from ..ops import creation
        return creation.assign(self)

    # ------------------------------------------------------------------
    # host interop
    # ------------------------------------------------------------------
    def numpy(self) -> np.ndarray:
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy().copy() if d.device.type == "cpu" \
            else d.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._data.shape[0]

    def __repr__(self):
        grad_txt = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype="
                f"{canonical_dtype(self.dtype)}, place={self.place}"
                f"{grad_txt},\n       {self.numpy()!r})")

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def _write(self, value: torch.Tensor):
        """Write ``value`` into this tensor: in place under no_grad on a
        leaf of the same shape (a Parameter, a buffer, a user's tensor),
        else by rebinding ``_data`` to a new leaf."""
        d = self._data
        value = value.to(device=d.device, dtype=d.dtype)
        if d.is_leaf and tuple(value.shape) == tuple(d.shape):
            with torch.no_grad():
                d.copy_(value)
        else:
            self._data = value.detach().clone().requires_grad_(
                d.requires_grad)
        return self

    def set_value(self, value):
        if not isinstance(value, (Tensor, torch.Tensor)):
            value = torch.as_tensor(np.asarray(value))
        return self._write(unwrap(value))

    def copy_(self, other, blocking: bool = True):
        return self.set_value(other)

    def fill_(self, value):
        return self._write(torch.full_like(self._data.detach(), value))

    def zero_(self):
        return self._write(torch.zeros_like(self._data.detach()))

    def scale_(self, scale: float):
        return self._write(self._data.detach() * scale)

    # ------------------------------------------------------------------
    # dtype / device movement
    # ------------------------------------------------------------------
    def astype(self, dtype) -> "Tensor":
        from ..ops import manipulation
        return manipulation.cast(self, dtype=dtype)

    cast = astype

    def to(self, *args, **kwargs):
        dtype = kwargs.get("dtype")
        device = kwargs.get("device")
        for a in args:
            if isinstance(a, (Place, torch.device)):
                device = a
            elif isinstance(a, str):
                if a.split(":")[0] in ("cpu", "gpu", "cuda"):
                    device = a
                else:
                    dtype = a
            elif isinstance(a, torch.dtype):
                dtype = a
        out = self
        if device is not None:
            dev = _parse(device).torch_device()
            out = Tensor(out._data.to(dev))
        if dtype is not None:
            out = out.astype(dtype)
        return out

    def cpu(self):
        return self.to("cpu")

    def cuda(self, device_id=None, blocking=True):
        return self.to(f"gpu:{device_id or 0}")

    def pin_memory(self):
        return Tensor(self._data.detach().cpu().pin_memory()
                      if torch.cuda.is_available() else self._data.cpu())

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def __getitem__(self, idx):
        from .dispatch import dispatch
        idx = _unwrap_index(idx)
        return dispatch("getitem", _getitem, (self,), {"idx": idx})

    def __setitem__(self, idx, value):
        idx = _unwrap_index(idx)
        d = self._data
        v = unwrap(value) if isinstance(value, (Tensor, torch.Tensor)) \
            else torch.as_tensor(value)
        v = v.to(device=d.device, dtype=d.dtype)
        if isinstance(self, Parameter) or (d.is_leaf and d.requires_grad):
            with torch.no_grad():
                d[idx] = v
            return
        out = d.clone()
        out[idx] = v
        self._data = out

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def _sync(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self


def _unwrap_index(idx):
    """Tensor indices (bool masks, integer arrays) as torch tensors;
    tuples and lists recurse."""
    if isinstance(idx, Tensor):
        return idx._data
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i) for i in idx)
    if isinstance(idx, np.ndarray):
        return torch.as_tensor(idx)
    return idx


def _getitem(x: torch.Tensor, *, idx):
    """``x[idx]`` with numpy's semantics where torch's differ: slices of
    negative step read the flipped dimension."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    if not any(isinstance(p, slice) and p.step is not None and p.step < 0
               for p in parts):
        return x[idx]
    consumed = sum(0 if (p is None or p is Ellipsis) else
                   (p.dim() if isinstance(p, torch.Tensor)
                    and p.dtype == torch.bool else 1) for p in parts)
    dim, new = 0, []
    for p in parts:
        if p is Ellipsis:
            dim += x.dim() - consumed
            new.append(p)
            continue
        if p is None:
            new.append(p)
            continue
        if isinstance(p, slice) and p.step is not None and p.step < 0:
            n = x.shape[dim]
            r = range(*p.indices(n))
            x = x.flip(dim)
            start = n - 1 - r.start if len(r) else 0
            p = slice(start, start + len(r) * -p.step, -p.step)
        new.append(p)
        dim += p.dim() if isinstance(p, torch.Tensor) and \
            p.dtype == torch.bool else 1
    return x[tuple(new)]


class Parameter(Tensor):
    """A trainable tensor owned by a ``Layer`` (reference :299), the one
    wrapper of its ``torch.nn.Parameter``."""

    __slots__ = ()

    def __init__(self, data, trainable: bool = True,
                 name: Optional[str] = None):
        if isinstance(data, Tensor):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = to_tensor(data)._data
        if not isinstance(data, torch.nn.Parameter):
            data = torch.nn.Parameter(data.detach(), requires_grad=trainable)
        self._data = data
        self._name = None
        d = data.__dict__
        d["_pt_wrapper"] = self
        d.setdefault("name", name or _next_name("param"))
        d.setdefault("persistable", True)
        d.setdefault("optimize_attr", {"learning_rate": 1.0})
        d.setdefault("regularizer", None)
        d.setdefault("need_clip", True)
        d.setdefault("is_distributed", False)
        d.setdefault("placements", None)

    @staticmethod
    def of(tp: torch.nn.Parameter) -> "Parameter":
        """The wrapper of the torch parameter ``tp`` (made at first use)."""
        w = tp.__dict__.get("_pt_wrapper")
        return w if w is not None else Parameter(tp)

    def _attr(name):   # noqa: N805 -- builds the properties below
        def get(self):
            return self._data.__dict__.get(name)

        def set_(self, value):
            self._data.__dict__[name] = value
        return property(get, set_)

    name = _attr("name")
    persistable = _attr("persistable")
    optimize_attr = _attr("optimize_attr")
    regularizer = _attr("regularizer")
    need_clip = _attr("need_clip")
    is_distributed = _attr("is_distributed")
    placements = _attr("placements")
    del _attr

    @property
    def trainable(self) -> bool:
        return self._data.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self._data.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        return Parameter.of(clone_param(self._data, memo))

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def clone_param(tp: torch.nn.Parameter, memo) -> torch.nn.Parameter:
    """``copy.deepcopy`` of a torch parameter with its paddle attributes
    (torch's own deepcopy of a parameter drops them)."""
    if id(tp) in memo:
        return memo[id(tp)]
    new = tp.__deepcopy__(memo)
    for k in PARAM_ATTRS:
        if k in tp.__dict__:
            new.__dict__[k] = copy.deepcopy(tp.__dict__[k], memo)
    return new


def unwrap(x):
    """The torch tensor of a Tensor; anything else as it is."""
    return x._data if isinstance(x, Tensor) else x


def wrap(t: torch.Tensor) -> Tensor:
    """A Tensor sharing ``t`` (its Parameter wrapper when ``t`` is a torch
    parameter), its grad state as it is."""
    if isinstance(t, torch.nn.Parameter):
        return Parameter.of(t)
    return Tensor(t)


def as_tensor(x, like: Optional[torch.Tensor] = None) -> Tensor:
    """An op's operand as a Tensor: a Tensor as it is, a torch tensor
    shared (gradients flow through it), other data made with
    :func:`to_tensor` on ``like``'s device (the current place without
    one)."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return wrap(x)
    return to_tensor(x, place=None if like is None else place_of(like))


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> Tensor:
    """``paddle.to_tensor``: a new leaf on ``place`` (the current place
    when None).  Python ints give int32 and floats the default floating
    type, numpy's 64-bit types their 32-bit ones (the reference with x64
    off)."""
    if isinstance(data, Tensor):
        out = data
        if dtype is not None and dtype_to_torch(dtype) != out.dtype:
            out = out.astype(dtype)
        if not stop_gradient:
            out = Tensor(out._data.detach(), stop_gradient=False)
        return out
    dev = (_parse(place) if place is not None else current_place()
           ).torch_device()
    tdt = dtype_to_torch(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach()
        t = t.to(device=dev, dtype=tdt or dtype_to_torch(t.dtype))
        if t.data_ptr() == data.data_ptr() and t.numel():
            t = t.clone()
    else:
        arr = np.asarray(data)
        t = torch.tensor(arr if arr.dtype != np.float64 or tdt is not None
                         else arr.astype(np.float32),
                         dtype=tdt or _numpy_dtype(arr), device=dev)
    return Tensor(t, stop_gradient=stop_gradient)
