"""Operators of the port.

The hand-written CUDA kernels and their torch-level wrappers:
``flash_attention`` (the flash-attention forward and backward with their
plain PyTorch versions), ``flash_attention_qkv`` (the same kernels on a
packed projection), ``softmax_xent`` (the fused LM-head loss),
``fused_ln`` / ``fused_ops`` (the post-LN epilogue), ``multi_tensor_update``
(the optimizers' update), ``nn_misc`` (attention and dropout on torch
tensors) and ``loss`` (cross entropy on torch tensors).

The ``paddle.*`` tensor functions of the eager core, on
:class:`~paddle_tpu_torch.core.tensor.Tensor`\\ s (the counterpart of
``paddle_tpu/ops/__init__.py``): ``creation``, ``math``, ``reduction``,
``logic``, ``manipulation``, ``activation``, ``norm_ops``, ``linalg``'s
products, ``nn_ops`` (the Tensor entry points of the reference's
``nn_misc`` and ``loss``) and ``extras`` (in-place variants, tensor
arrays, utilities).  Importing this package attaches their method
surface and operators to ``Tensor`` (``_attach``, reference :39-129).
"""
from __future__ import annotations

from . import (activation, creation, extras, linalg, logic, manipulation,
               math, nn_ops, norm_ops, reduction)
from .activation import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .nn_ops import *  # noqa: F401,F403
from .norm_ops import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403

from ..core.tensor import Tensor

#: the modules whose functions make up ``paddle_tpu_torch.<name>``
TENSOR_MODULES = (creation, math, reduction, manipulation, logic, linalg,
                  activation, norm_ops, nn_ops, extras)


def _attach():
    m, r, mp, lg, la, act = math, reduction, manipulation, logic, linalg, \
        activation
    method_map = {
        # math
        "add": m.add, "subtract": m.subtract, "multiply": m.multiply,
        "divide": m.divide, "floor_divide": m.floor_divide, "mod": m.mod,
        "remainder": m.remainder, "pow": m.pow, "abs": m.abs, "neg": m.neg,
        "sqrt": m.sqrt, "rsqrt": m.rsqrt, "square": m.square, "exp": m.exp,
        "log": m.log, "sign": m.sign, "floor": m.floor, "ceil": m.ceil,
        "round": m.round, "sin": m.sin, "cos": m.cos, "tan": m.tan,
        "tanh": m.tanh, "clip": m.clip, "scale": m.scale,
        "reciprocal": m.reciprocal, "maximum": m.maximum,
        "minimum": m.minimum, "erf": m.erf, "lerp": m.lerp,
        "trunc": m.trunc, "frac": m.frac, "add_": m.add_,
        "subtract_": m.subtract_, "multiply_": m.multiply_,
        "clip_": m.clip_,
        # reductions
        "sum": r.sum, "mean": r.mean, "max": r.max, "min": r.min,
        "prod": r.prod, "all": r.all, "any": r.any, "argmax": r.argmax,
        "argmin": r.argmin, "cumsum": r.cumsum, "cumprod": r.cumprod,
        "logsumexp": r.logsumexp, "std": r.std, "var": r.var,
        "median": r.median,
        # manipulation
        "reshape": mp.reshape, "reshape_": mp.reshape_,
        "transpose": mp.transpose, "squeeze": mp.squeeze,
        "unsqueeze": mp.unsqueeze, "flatten": mp.flatten,
        "expand": mp.expand, "expand_as": mp.expand_as, "tile": mp.tile,
        "broadcast_to": mp.broadcast_to, "gather": mp.gather,
        "gather_nd": mp.gather_nd, "scatter": mp.scatter, "split": mp.split,
        "chunk": mp.chunk, "unbind": mp.unbind, "flip": mp.flip,
        "roll": mp.roll, "topk": mp.topk, "sort": mp.sort,
        "argsort": mp.argsort, "unique": mp.unique, "nonzero": mp.nonzero,
        "index_select": mp.index_select, "masked_select": mp.masked_select,
        "tolist_op": mp.tolist, "take_along_axis": mp.take_along_axis,
        "put_along_axis": mp.put_along_axis, "moveaxis": mp.moveaxis,
        "repeat_interleave": mp.repeat_interleave,
        # logic
        "equal": lg.equal, "not_equal": lg.not_equal,
        "greater_than": lg.greater_than, "greater_equal": lg.greater_equal,
        "less_than": lg.less_than, "less_equal": lg.less_equal,
        "logical_and": lg.logical_and, "logical_or": lg.logical_or,
        "logical_not": lg.logical_not, "logical_xor": lg.logical_xor,
        "allclose": lg.allclose, "isclose": lg.isclose, "isnan": lg.isnan,
        "isinf": lg.isinf, "isfinite": lg.isfinite,
        "equal_all": lg.equal_all,
        # linalg (cholesky and inverse wait for item 5b)
        "matmul": la.matmul, "mm": la.mm, "bmm": la.bmm, "dot": la.dot,
        "norm": la.norm, "dist": la.dist,
        # activation-ish
        "sigmoid": act.sigmoid, "softmax": act.softmax, "relu": act.relu,
    }
    for name, fn in method_map.items():
        if not hasattr(Tensor, name):
            setattr(Tensor, name, fn)

    Tensor.__add__ = lambda s, o: m.add(s, o)
    Tensor.__radd__ = lambda s, o: m.add(s, o)
    Tensor.__sub__ = lambda s, o: m.subtract(s, o)
    Tensor.__rsub__ = lambda s, o: m.subtract(_coerce(o, s), s)
    Tensor.__mul__ = lambda s, o: m.multiply(s, o)
    Tensor.__rmul__ = lambda s, o: m.multiply(s, o)
    Tensor.__truediv__ = lambda s, o: m.divide(s, o)
    Tensor.__rtruediv__ = lambda s, o: m.divide(_coerce(o, s), s)
    Tensor.__floordiv__ = lambda s, o: m.floor_divide(s, o)
    Tensor.__mod__ = lambda s, o: m.remainder(s, o)
    Tensor.__pow__ = lambda s, o: m.pow(s, o)
    Tensor.__rpow__ = lambda s, o: m.pow(_coerce(o, s), s)
    Tensor.__neg__ = lambda s: m.neg(s)
    Tensor.__abs__ = lambda s: m.abs(s)
    Tensor.__matmul__ = lambda s, o: la.matmul(s, o)
    Tensor.__rmatmul__ = lambda s, o: la.matmul(_coerce(o, s), s)
    Tensor.__eq__ = lambda s, o: lg.equal(s, o)
    Tensor.__ne__ = lambda s, o: lg.not_equal(s, o)
    Tensor.__lt__ = lambda s, o: lg.less_than(s, o)
    Tensor.__le__ = lambda s, o: lg.less_equal(s, o)
    Tensor.__gt__ = lambda s, o: lg.greater_than(s, o)
    Tensor.__ge__ = lambda s, o: lg.greater_equal(s, o)
    Tensor.__invert__ = lambda s: lg.logical_not(s)
    Tensor.__and__ = lambda s, o: lg.bitwise_and(s, o)
    Tensor.__or__ = lambda s, o: lg.bitwise_or(s, o)
    Tensor.__xor__ = lambda s, o: lg.bitwise_xor(s, o)
    # __eq__ kills hashability; tensors hash by identity, as in paddle
    Tensor.__hash__ = object.__hash__


def _coerce(o, like):
    """The left operand of a reflected op (reference ``_coerce`` :132): a
    Python scalar takes a floating tensor's type, on its device."""
    import torch
    from ._common import t
    if isinstance(o, Tensor):
        return o
    if isinstance(o, (int, float, bool)) and like.dtype.is_floating_point:
        return Tensor(torch.tensor(o, dtype=like.dtype,
                                   device=like._data.device))
    return t(o, like)


_attach()
del _attach
