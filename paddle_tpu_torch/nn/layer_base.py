"""``nn.Layer`` — the counterpart of ``paddle_tpu/nn/layer_base.py``
(``Layer`` :34; reference ``python/paddle/fluid/dygraph/layers.py:81``).

:class:`Layer` subclasses ``torch.nn.Module``: its parameters and buffers
live in torch's registries as ``torch.nn.Parameter``\\ s and buffers, so
``.to()``, ``torch.func.functional_call``, CUDA-graph capture and
``torch.nn.Module.state_dict`` see them as they see any module's.  The
paddle API wins where the names clash: ``parameters()`` and
``named_parameters()`` return lists of the port's
:class:`~paddle_tpu_torch.core.tensor.Parameter`\\ s, ``buffers()`` and
``named_buffers()`` of Tensors, ``state_dict()`` maps structured names to
them, ``register_buffer`` takes ``persistable``, and attribute access
returns the wrappers.  torch's own callers (``functional_call``, torch's
``state_dict`` recursion, ``parameters(recurse=...)``) pass torch's
keywords and get torch's answers.  Port code that needs torch's view of a
network reaches it through :func:`torch_view`, never by duck typing.

The boundary: ``Layer.__call__`` gives back the kind it was given.  A
layer written on Tensors (the default; the reference's layers and users'
subclasses) receives Tensors: torch tensors passed in are wrapped, and
the outputs unwrapped again.  A layer written on torch tensors
(``_torch_native = True``: ``CrossEntropyLoss``, the fused layers)
receives torch tensors, and Tensors passed in come back as Tensors.
Forward pre- and post-hooks are torch's (the same signatures as
paddle's), so they see what ``forward`` sees.

Weights keep paddle's layout (``Linear.weight`` is ``[in, out]``), so the
reference's ``state_dict()`` as numpy arrays loads into the same-built
port layer through :meth:`Layer.set_state_dict` with no renaming and no
transposes.
"""
from __future__ import annotations

import collections
import copy
from typing import Dict, Optional

import numpy as np
import torch

from ..core.dtype import canonical_dtype, dtype_to_torch
from ..core.place import Place, _parse
from ..core.tensor import Parameter, Tensor, clone_param, to_tensor, \
    unwrap, wrap

__all__ = ["Layer", "torch_view", "apply_param_attr"]


def apply_param_attr(p: Parameter, attr) -> Parameter:
    """A ``ParamAttr``'s name, learning-rate scale, regularizer, clip flag
    and trainability, set on the parameter ``p``."""
    if attr.name:
        p.name = attr.name
    p.optimize_attr = dict(p.optimize_attr or {},
                           learning_rate=attr.learning_rate)
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    if attr.trainable is False:
        p.trainable = False
    return p


def _map(fn, obj):
    """``fn`` over every tensor leaf of a nest of tuples, lists, dicts and
    named tuples."""
    if isinstance(obj, (Tensor, torch.Tensor)):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map(fn, v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, v) for v in obj)
    if isinstance(obj, dict):
        return type(obj)((k, _map(fn, v)) for k, v in obj.items())
    return obj


def _any(pred, obj) -> bool:
    if isinstance(obj, (Tensor, torch.Tensor)):
        return pred(obj)
    if isinstance(obj, (tuple, list)):
        return any(_any(pred, v) for v in obj)
    if isinstance(obj, dict):
        return any(_any(pred, v) for v in obj.values())
    return False


def _is_tensor(x) -> bool:
    return isinstance(x, Tensor)


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def _to_tensor_wrap(x):
    return wrap(x) if isinstance(x, torch.Tensor) else x


class Layer(torch.nn.Module):
    """The module system: registration by attribute, structured names,
    hooks, ``train`` / ``eval``, ``state_dict`` / ``set_state_dict``,
    dtype and device movement, and the functional-state bridge."""

    #: written on torch tensors (True) or on Tensors (False)
    _torch_native = False

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        torch.nn.Module.__init__(self)
        self._dtype = canonical_dtype(dtype)
        self._name_scope = name_scope or self.__class__.__name__.lower()
        self._buffer_wrappers: Dict[str, Tensor] = {}

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            value = value._data
        elif isinstance(value, Tensor):
            bufs = self.__dict__.get("_buffers")
            if bufs is not None and name in bufs:
                value = value._data
        torch.nn.Module.__setattr__(self, name, value)

    def __getattr__(self, name):
        d = self.__dict__
        params = d.get("_parameters")
        if params is not None and name in params:
            v = params[name]
            if v is None or self._torch_native:
                return v
            return wrap(v) if isinstance(v, torch.nn.Parameter) \
                else Tensor(v)
        bufs = d.get("_buffers")
        if bufs is not None and name in bufs:
            v = bufs[name]
            if v is None or self._torch_native:
                return v
            w = d["_buffer_wrappers"].get(name)
            if w is None or w._data is not v:
                w = Tensor(v, name=name)
                d["_buffer_wrappers"][name] = w
            return w
        return torch.nn.Module.__getattr__(self, name)

    def add_parameter(self, name: str, parameter):
        if parameter is None:
            self.register_parameter(name, None)
            return None
        self.register_parameter(name, unwrap(parameter))
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = unwrap(tensor if isinstance(tensor, Tensor)
                            else to_tensor(tensor))
        torch.nn.Module.register_buffer(self, name, tensor,
                                        persistent=persistable)

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None):
        """A new :class:`Parameter` of ``shape`` on the current place,
        initialised by ``default_initializer``, the attribute's
        initializer, zeros for a bias or XavierNormal, with the
        attribute's name, learning-rate scale, regularizer, clip flag and
        trainability.  Assign it to an attribute to register it."""
        from . import initializer as I
        from .param_attr import ParamAttr
        attr = ParamAttr._to_attr(attr)
        dtype = dtype or self._dtype
        if default_initializer is not None:
            init = default_initializer
        elif attr and attr.initializer is not None:
            init = attr.initializer
        else:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        p = Parameter(init(shape, dtype), trainable=True)
        if attr:
            apply_param_attr(p, attr)
        return p

    # ------------------------------------------------------------------
    # traversal (paddle's answers; torch's for torch's own keywords)
    # ------------------------------------------------------------------
    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, **torch_kw):
        if torch_kw:
            return torch.nn.Module.named_parameters(self, prefix,
                                                    **torch_kw)
        return [(n, wrap(p)) for n, p in torch.nn.Module.named_parameters(
            self, prefix, recurse=include_sublayers)]

    def parameters(self, include_sublayers: bool = True, **torch_kw):
        if torch_kw:
            return torch.nn.Module.parameters(self, **torch_kw)
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "",
                      include_sublayers: bool = True, **torch_kw):
        if torch_kw:
            return torch.nn.Module.named_buffers(self, prefix, **torch_kw)
        out = []
        for name, buf in torch.nn.Module.named_buffers(
                self, prefix, recurse=include_sublayers):
            owner, _, leaf = name[len(prefix) + 1 if prefix else 0:
                                  ].rpartition(".")
            layer = self.get_submodule(owner) if owner else self
            w = getattr(layer, leaf) if isinstance(layer, Layer) else buf
            out.append((name, wrap(w) if isinstance(w, torch.Tensor)
                        else w))
        return out

    def buffers(self, include_sublayers: bool = True, **torch_kw):
        if torch_kw:
            return torch.nn.Module.buffers(self, **torch_kw)
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        out = []
        for name, mod in self.named_modules(prefix=prefix):
            if mod is self and not include_self:
                continue
            out.append((name, mod))
        return out

    def sublayers(self, include_self: bool = False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # ------------------------------------------------------------------
    # hooks (torch's; paddle's post hook is torch's forward hook)
    # ------------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)

    # ------------------------------------------------------------------
    # call: the boundary between Tensors and torch tensors
    # ------------------------------------------------------------------
    def __call__(self, *inputs, **kwargs):
        args = (inputs, kwargs)
        if self._torch_native:
            given = _any(_is_tensor, args)
            if given:
                inputs, kwargs = _map(unwrap, args)
            out = torch.nn.Module.__call__(self, *inputs, **kwargs)
            return _map(_to_tensor_wrap, out) if given else out
        given = _any(_is_torch, args) and not _any(_is_tensor, args)
        if given:
            inputs, kwargs = _map(_to_tensor_wrap, args)
        out = torch.nn.Module.__call__(self, *inputs, **kwargs)
        return _map(unwrap, out) if given else out

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # state dict
    # ------------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   use_hook: bool = True, **torch_kw):
        """Structured name -> Parameter / persistable buffer (Tensors)."""
        if torch_kw:
            return torch.nn.Module.state_dict(
                self, destination=destination, **torch_kw)
        dest = destination if destination is not None \
            else collections.OrderedDict()
        for name, t in torch.nn.Module.state_dict(self,
                                                  keep_vars=True).items():
            if not include_sublayers and "." in name:
                continue
            dest[name] = wrap(t)
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s values (Tensors, torch tensors or numpy
        arrays) into this layer's parameters and buffers, in place;
        returns ``(missing, unexpected)`` names.  A shape mismatch raises
        ``ValueError``."""
        own = torch.nn.Module.state_dict(self, keep_vars=True)
        missing, unexpected = [], []
        for name, value in state_dict.items():
            if name not in own:
                unexpected.append(name)
                continue
            target = own[name]
            v = unwrap(value)
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            if tuple(v.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for '{name}': checkpoint "
                    f"{tuple(v.shape)} vs model {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(v.to(device=target.device, dtype=target.dtype))
        for name in own:
            if name not in state_dict:
                missing.append(name)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ------------------------------------------------------------------
    # dtype / device movement
    # ------------------------------------------------------------------
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)``, as paddle, or
        torch's positional forms; only floating tensors change type."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        kwargs.pop("non_blocking", None)
        for a in args:
            if isinstance(a, (Place, torch.device)):
                device = a
            elif isinstance(a, torch.dtype):
                dtype = a
            elif isinstance(a, str):
                if a.split(":")[0] in ("cpu", "gpu", "cuda"):
                    device = a
                else:
                    dtype = a
        move = {}
        if device is not None:
            move["device"] = _parse(device).torch_device()
        dt = None if dtype is None else dtype_to_torch(dtype)
        if dt is not None:
            move["dtype"] = dt
        if move:
            torch.nn.Module.to(self, **move)
        if dt is not None:
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = canonical_dtype(dt)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # ------------------------------------------------------------------
    # functional state bridge
    # ------------------------------------------------------------------
    def functional_state(self):
        """``({name: torch tensor}, {name: torch tensor})``: the
        parameters and buffers as ``torch.func.functional_call`` takes
        them."""
        return (dict(torch.nn.Module.named_parameters(self)),
                dict(torch.nn.Module.named_buffers(self)))

    def load_functional_state(self, params=None, buffers=None):
        """Copy tensors (as :meth:`functional_state` returns them) into the
        live parameters and buffers, in place."""
        prefs, brefs = self.functional_state()
        with torch.no_grad():
            for refs, new in ((prefs, params), (brefs, buffers)):
                for n, a in (new or {}).items():
                    refs[n].copy_(unwrap(a))

    def full_name(self):
        return self._name_scope

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def __deepcopy__(self, memo):
        for tp in torch.nn.Module.parameters(self):
            clone_param(tp, memo)
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        state = {k: v for k, v in self.__dict__.items()
                 if k != "_buffer_wrappers"}
        new.__dict__.update(copy.deepcopy(state, memo))
        new.__dict__["_buffer_wrappers"] = {}
        return new


class _TorchView:
    """torch's view of a Layer: its torch accessors."""

    __slots__ = ("module",)

    def __init__(self, module: Layer):
        self.module = module

    def parameters(self, recurse: bool = True):
        return torch.nn.Module.parameters(self.module, recurse)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        return torch.nn.Module.named_parameters(
            self.module, prefix, recurse, remove_duplicate)

    def buffers(self, recurse: bool = True):
        return torch.nn.Module.buffers(self.module, recurse)

    def named_buffers(self, prefix: str = "", recurse: bool = True,
                      remove_duplicate: bool = True):
        return torch.nn.Module.named_buffers(
            self.module, prefix, recurse, remove_duplicate)

    def state_dict(self, *args, **kwargs):
        return torch.nn.Module.state_dict(self.module, *args, **kwargs)


def torch_view(module):
    """torch's view of ``module``: for a :class:`Layer`, an object whose
    ``parameters`` / ``named_parameters`` / ``buffers`` /
    ``named_buffers`` / ``state_dict`` are ``torch.nn.Module``'s (torch
    tensors); any other module is its own view."""
    return _TorchView(module) if isinstance(module, Layer) else module
