"""The last ``paddle.*`` tensor functions — the counterpart of
``paddle_tpu/ops/extras.py``: the in-place variants (``exp_`` ...
``scale_``), the tensor arrays (``create_array``, ``array_read``,
``array_write``, ``array_length``: a Python list of Tensors, as in the
reference) and the utilities (``add_n``, ``broadcast_*``, ``multiplex``,
``scatter_nd`` ...).

An in-place variant raises on a tensor that needs a gradient while grad
is on (the reference's guard, :175-184); inside ``no_grad`` it writes in
place where the shape stays (a leaf keeps its torch tensor) and rebinds
the Tensor where it changes (``squeeze_``, ``unsqueeze_``, ``flatten_``).
``uniform_`` and ``standard_normal`` draw from the port's generators
(``paddle_tpu_torch.seed``; ``uniform_`` with a ``seed`` from its own):
torch's bits are not JAX's, so they are held to their statistics and to
determinism, as dropout is.
"""
from __future__ import annotations

import numpy as np
import torch

from . import creation, manipulation
from . import math as _math
from ..core.tensor import Tensor
from ._common import INT, dispatch, t

__all__ = [
    "add_n", "broadcast_shape", "broadcast_tensors", "diagflat", "diagonal",
    "floor_mod", "increment", "is_tensor", "multiplex", "rank", "shape",
    "scatter_nd", "standard_normal", "set_printoptions",
    "create_array", "array_read", "array_write", "array_length",
    "exp_", "ceil_", "floor_", "round_", "reciprocal_", "rsqrt_", "sqrt_",
    "tanh_", "squeeze_", "unsqueeze_", "flatten_", "uniform_", "scatter_",
    "scale_", "check_shape",
]

_inplace_guard = _math._inplace_guard


def add_n(inputs, name=None):
    """The sum of a list of tensors (a new tensor even for one)."""
    if isinstance(inputs, (Tensor, torch.Tensor)):
        inputs = [inputs]
    tensors = [t(x) for x in inputs]
    if len(tensors) == 1:
        return dispatch("add_n", lambda a: a + 0, tensors, {})
    return dispatch("add_n", lambda *xs: sum(xs[1:], xs[0]), tensors, {})


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(inputs, name=None):
    tensors = [t(x) for x in inputs]
    shape = torch.broadcast_shapes(*[tuple(x.shape) for x in tensors])
    return list(dispatch("broadcast_tensors", lambda *xs: tuple(
        torch.broadcast_to(x, shape) for x in xs), tensors, {}))


def diagflat(x, offset=0, name=None):
    return dispatch("diagflat", lambda a: torch.diagflat(a, offset),
                    (t(x),), {})


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch("diagonal", lambda a: torch.diagonal(
        a, offset, axis1, axis2), (t(x),), {})


def floor_mod(x, y, name=None):
    return _math.mod(x, y)


def increment(x, value=1.0, name=None):
    """``x += value`` in place (the reference's increment op)."""
    _inplace_guard(x, "increment")
    d = x._data.detach()
    return x._write(d + torch.tensor(value, dtype=d.dtype, device=d.device))


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)


def multiplex(inputs, index, name=None):
    """Row ``i`` of ``inputs[index[i]]`` for each ``i``."""
    def kernel(ix, *xs):
        stacked = torch.stack(xs)
        ix = ix.reshape(-1).long()
        return stacked[ix, torch.arange(stacked.shape[1],
                                        device=stacked.device)]
    return dispatch("multiplex", kernel, [t(index)] + [t(x) for x in inputs],
                    {})


def rank(x, name=None):
    x = t(x)
    return Tensor(torch.tensor(x.ndim, dtype=INT, device=x._data.device))


def shape(x, name=None):
    x = t(x)
    return Tensor(torch.tensor(x.shape, dtype=INT, device=x._data.device))


def scatter_nd(index, updates, shape, name=None):
    """``updates`` added into zeros of ``shape`` at ``index`` (its last
    axis indexes the leading dimensions)."""
    out_shape = tuple(int(s) for s in shape)

    def kernel(ix, up):
        zeros = torch.zeros(out_shape, dtype=up.dtype, device=up.device)
        return zeros.index_put(tuple(ix.long().movedim(-1, 0)), up,
                               accumulate=True)
    return dispatch("scatter_nd", kernel, (t(index), t(updates)), {})


def standard_normal(shape, dtype=None, name=None):
    return creation.randn(shape, dtype=dtype)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Options of a Tensor's repr, which prints through numpy (as the
    reference's does)."""
    kwargs = {"precision": precision, "threshold": threshold,
              "edgeitems": edgeitems, "linewidth": linewidth}
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    if sci_mode is not None:
        kwargs["suppress"] = not sci_mode
    np.set_printoptions(**kwargs)


# -- tensor arrays (a Python list) -------------------------------------------
def create_array(dtype="float32", initialized_list=None):
    return list(initialized_list) if initialized_list else []


def _index(i) -> int:
    return int(i.item()) if isinstance(i, Tensor) else int(i)


def array_write(x, i, array=None):
    x, i = t(x), _index(i)
    if i < 0:
        raise ValueError(f"array_write index must be >= 0, got {i}")
    if array is None:
        array = []
    while len(array) <= i:
        array.append(None)
    array[i] = x
    return array


def array_read(array, i):
    return array[_index(i)]


def array_length(array):
    return Tensor(torch.tensor(len(array), dtype=INT,
                               device=creation.device()))


# -- in-place variants --------------------------------------------------------
exp_ = _math._inplace(_math.exp, "exp_")
ceil_ = _math._inplace(_math.ceil, "ceil_")
floor_ = _math._inplace(_math.floor, "floor_")
round_ = _math._inplace(_math.round, "round_")
reciprocal_ = _math._inplace(_math.reciprocal, "reciprocal_")
rsqrt_ = _math._inplace(_math.rsqrt, "rsqrt_")
sqrt_ = _math._inplace(_math.sqrt, "sqrt_")
tanh_ = _math._inplace(_math.tanh, "tanh_")
squeeze_ = _math._inplace(manipulation.squeeze, "squeeze_")
unsqueeze_ = _math._inplace(manipulation.unsqueeze, "unsqueeze_")
flatten_ = _math._inplace(manipulation.flatten, "flatten_")
scatter_ = _math._inplace(manipulation.scatter, "scatter_")
scale_ = _math._inplace(_math.scale, "scale_")


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    """``x`` filled in place with U[min, max) draws: from a generator of
    ``seed`` when it is not 0, else from the port's stream."""
    _inplace_guard(x, "uniform_")
    d = x._data.detach()
    gen = torch.Generator(device=d.device).manual_seed(int(seed)) if seed \
        else creation._gen(d.device)
    return x._write(torch.empty_like(d).uniform_(float(min), float(max),
                                                 generator=gen))


def check_shape(shape):
    """A shape argument's dims must be >= -1 (-1: inferred)."""
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    for s in shape:
        if isinstance(s, (int, np.integer)) and s < -1:
            raise ValueError(f"invalid dim {s} in shape {shape}; dims must "
                             "be >= -1 (-1 = inferred)")
    return True
