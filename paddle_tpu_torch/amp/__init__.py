"""Automatic mixed precision — the counterpart of
``paddle_tpu/amp/__init__.py``: the op lists (:24-37), ``classify_op``
(:39), ``auto_cast`` / ``amp_guard`` (:78), the casting rule of
``amp_cast_inputs`` (:121), ``decorate`` (:147) and ``GradScaler``
(:171).  The low type defaults to bfloat16, as in the reference.

The reference casts an op's inputs in its dispatcher, by op name.  The
port has no dispatcher, and ``torch.autocast`` would apply PyTorch's
lists (which differ between CPU and CUDA), take no custom lists and not
see the port's own ops.  So ``auto_cast`` pushes one casting hook, a
``torch.overrides.TorchFunctionMode`` that maps the torch calls the
port's modules make to the reference's op names (:data:`TORCH_OPS`:
``F.linear`` is ``linear``, ``torch.matmul`` and ``@`` are ``matmul``,
``F.layer_norm`` is ``layer_norm``, ``+`` is ``add``, ...) and casts
their floating inputs as the reference's rule does: under O1 the white
list to the low type and the black list to fp32, grey ops untouched;
under O2 everything but the black list to the low type.  The port's own
op wrappers, which stand for one reference op each, take the hook by
:func:`amp_op`: their inputs are cast under their reference name and
their bodies run with the hook passed through, as the reference's
dispatcher never sees the inside of an op.  A call the map does not name
runs as it is.

:data:`RECORD`, when a list, receives ``(op name, input dtypes, cast
dtypes)`` for every op the hook sees, floating inputs only: the tests
hold it to what the reference's ``amp_cast_inputs`` does with the same
model.
"""
from __future__ import annotations

import functools
import threading
import warnings
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ..ops.amp_ops import update_loss_scaling_
from ..ops.multi_tensor_update import multi_tensor_unscale

__all__ = ["auto_cast", "amp_guard", "amp_op", "GradScaler", "AmpScaler",
           "decorate", "WHITE_LIST", "BLACK_LIST", "classify_op",
           "amp_cast_inputs", "TORCH_OPS", "to_dtype"]

# ops that benefit from low precision (the matrix units)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "einsum", "mm", "bmm",
    "addmm", "scaled_dot_product_attention", "conv2d_transpose",
}
# numerically sensitive ops kept in fp32
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "reduce_sum", "reduce_mean", "cross_entropy",
    "softmax_with_cross_entropy", "bce", "bce_with_logits", "nll_loss",
    "kl_div", "layer_norm", "batch_norm", "instance_norm", "group_norm",
    "norm", "cumsum", "logsumexp", "softmax", "log_softmax", "erfinv",
    "rsqrt", "mse_loss",
}

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
# the floating names of the reference's dtype aliases (core/dtype.py:30)
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16, "float32": torch.float32,
           "fp32": torch.float32, "float": torch.float32}


def classify_op(op_type: str, custom_white_list=None,
                custom_black_list=None) -> str:
    """``"white"``, ``"black"`` or ``"grey"`` for one op name: a custom
    entry moves the op out of the opposite default list."""
    white, black = _lists(custom_white_list, custom_black_list)
    if op_type in white:
        return "white"
    if op_type in black:
        return "black"
    return "grey"


def _lists(custom_white_list, custom_black_list):
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    return white, black


def to_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"bfloat16"``,
    ``"float16"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype).lower()]
    except KeyError:
        raise ValueError(f"unknown AMP dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


class _AmpState:
    __slots__ = ("enable", "dtype", "level", "white", "black")

    def __init__(self, enable, dtype, level, white, black):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.white = white
        self.black = black


_state = threading.local()
# the hook's answer for each op as (op name, input dtypes, cast dtypes),
# floating inputs only, when this is a list
RECORD: Optional[List[tuple]] = None


def _amp_state() -> Optional[_AmpState]:
    return getattr(_state, "amp", None)


def _target(op_name: str, st: _AmpState) -> Optional[torch.dtype]:
    """The type the rule casts ``op_name``'s floating inputs to, or None
    (the reference's ``amp_cast_inputs`` :121)."""
    if st.level == "O2":
        return torch.float32 if op_name in st.black else st.dtype
    if op_name in st.white:
        return st.dtype
    if op_name in st.black:
        return torch.float32
    return None          # grey under O1: promotion decides


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.dtype in _FLOATS and x.dtype != dtype else x
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dtype) for v in x)
    return x


def _floats(values) -> tuple:
    out = []
    for v in values:
        if isinstance(v, torch.Tensor) and v.dtype in _FLOATS:
            out.append(v.dtype)
        elif isinstance(v, (list, tuple)):
            out.extend(_floats(v))
    return tuple(out)


def amp_cast_inputs(op_name: str, args, kwargs=None):
    """``(args, kwargs)`` of the op ``op_name`` with its floating tensors
    cast as the active AMP state's rule says (unchanged without one)."""
    kwargs = kwargs or {}
    st = _amp_state()
    if st is None:
        return args, kwargs
    dt = _target(op_name, st)
    if dt is None:
        return args, kwargs
    return (tuple(_cast(a, dt) for a in args),
            {k: _cast(v, dt) for k, v in kwargs.items()})


def _ops_table() -> Dict[Callable, str]:
    T = torch.Tensor
    names = {
        # white
        "matmul": (torch.matmul, T.matmul, T.__matmul__, T.__rmatmul__),
        "linear": (F.linear,),
        "einsum": (torch.einsum,),
        "mm": (torch.mm, T.mm),
        "bmm": (torch.bmm, T.bmm),
        "addmm": (torch.addmm, T.addmm),
        "conv1d": (F.conv1d,), "conv2d": (F.conv2d,), "conv3d": (F.conv3d,),
        "conv2d_transpose": (F.conv_transpose2d,),
        "scaled_dot_product_attention": (F.scaled_dot_product_attention,),
        # black
        "exp": (torch.exp, T.exp), "log": (torch.log, T.log),
        "log2": (torch.log2, T.log2), "log10": (torch.log10, T.log10),
        "log1p": (torch.log1p, T.log1p), "expm1": (torch.expm1, T.expm1),
        "pow": (torch.pow, T.pow, T.__pow__, T.__rpow__),
        "square": (torch.square, T.square),
        "reduce_sum": (torch.sum, T.sum), "reduce_mean": (torch.mean, T.mean),
        "cross_entropy": (F.cross_entropy,), "nll_loss": (F.nll_loss,),
        "kl_div": (F.kl_div,), "bce": (F.binary_cross_entropy,),
        "bce_with_logits": (F.binary_cross_entropy_with_logits,),
        "mse_loss": (F.mse_loss,), "layer_norm": (F.layer_norm,),
        "batch_norm": (F.batch_norm,), "instance_norm": (F.instance_norm,),
        "group_norm": (F.group_norm,),
        "norm": (torch.norm, T.norm, torch.linalg.norm,
                 torch.linalg.vector_norm),
        "cumsum": (torch.cumsum, T.cumsum),
        "logsumexp": (torch.logsumexp, T.logsumexp),
        "softmax": (torch.softmax, F.softmax, T.softmax),
        "log_softmax": (torch.log_softmax, F.log_softmax, T.log_softmax),
        "erfinv": (torch.erfinv, T.erfinv), "rsqrt": (torch.rsqrt, T.rsqrt),
        # grey ops that change values in the port's GPT and fused layers:
        # cast under O2 and under the custom lists
        "embedding": (F.embedding,),
        "add": (torch.add, T.add, T.__add__, T.__radd__),
        "gelu": (F.gelu,), "relu": (F.relu, torch.relu, T.relu),
    }
    return {fn: name for name, fns in names.items() for fn in fns}


# torch callables the hook casts, by the reference op name each stands for
TORCH_OPS: Dict[Callable, str] = _ops_table()


class _CastMode(TorchFunctionMode):
    """The casting hook: each torch call named in :data:`TORCH_OPS` gets
    its floating inputs cast by the active state's rule, except inside a
    port op (:func:`amp_op`)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not getattr(_state, "inside_op", 0):
            name = TORCH_OPS.get(func)
            if name is not None:
                args, kwargs = _cast_op(name, args, kwargs)
        return func(*args, **kwargs)


def _cast_op(name, args, kwargs):
    """The hook's cast of one op, recorded in :data:`RECORD` when it is a
    list."""
    before = (*args, *kwargs.values())
    args, kwargs = amp_cast_inputs(name, args, kwargs)
    if RECORD is not None:
        RECORD.append((name, _floats(before),
                       _floats((*args, *kwargs.values()))))
    return args, kwargs


def amp_op(op_name: str):
    """Decorator for a port op wrapper that stands for the reference op
    ``op_name``: under an active AMP state its tensor arguments are cast
    by the rule for ``op_name`` and its body runs with the casting hook
    passed through."""
    def wrap(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            if _amp_state() is None:
                return fn(*args, **kwargs)
            args, kwargs = _cast_op(op_name, args, kwargs)
            _state.inside_op = getattr(_state, "inside_op", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                _state.inside_op -= 1
        return op
    return wrap


class auto_cast:
    """Context manager (and decorator): ops run in mixed precision.

    O1: the white list in ``dtype``, the black list in fp32, the rest in
    the types their inputs promote to.  O2: everything but the black list
    in ``dtype``.  The state is per thread; ``enable=False`` turns AMP off
    inside an enclosing ``auto_cast``."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self._init_kwargs = dict(enable=enable,
                                 custom_white_list=custom_white_list,
                                 custom_black_list=custom_black_list,
                                 level=level, dtype=dtype)
        white, black = _lists(custom_white_list, custom_black_list)
        self._new = _AmpState(enable, to_dtype(dtype), level, white, black)

    def __enter__(self):
        self._prev = _amp_state()
        _state.amp = self._new if self._new.enable else None
        # one hook per thread: an inner auto_cast changes only the state
        self._mode = None
        if not getattr(_state, "hooked", False):
            self._mode = _CastMode()
            self._mode.__enter__()
            _state.hooked = True
        return self

    def __exit__(self, *exc):
        if self._mode is not None:
            _state.hooked = False
            self._mode.__exit__(*exc)
        _state.amp = self._prev
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with auto_cast(**self._init_kwargs):
                return fn(*a, **k)
        return wrapper


amp_guard = auto_cast


class restored:
    """Context manager: run under ``state`` (an ``_amp_state()`` taken
    earlier, or None), as inside the auto_cast that made it; a region
    recomputed in the backward re-enters its forward's state so."""

    def __init__(self, state: Optional[_AmpState]):
        self._new = state

    def __enter__(self):
        self._prev = _amp_state()
        _state.amp = self._new
        self._mode = None
        if self._new is not None and not getattr(_state, "hooked", False):
            self._mode = _CastMode()
            self._mode.__enter__()
            _state.hooked = True
        return self

    def __exit__(self, *exc):
        if self._mode is not None:
            _state.hooked = False
            self._mode.__exit__(*exc)
        _state.amp = self._prev
        return False


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration: the models' fp32 parameters cast to ``dtype`` in
    place (the same ``Parameter`` objects, so an optimizer built on them
    keeps them), and each optimizer's fp32 master weights turned on
    (``multi_precision``, or ``master_weight`` when it is given).
    Returns ``models`` without optimizers, else ``(models, optimizers)``,
    each as it was passed (one, or a list).  ``level`` and ``save_dtype``
    are taken and not read, as in the reference."""
    low = to_dtype(dtype)
    for m in models if isinstance(models, (list, tuple)) else [models]:
        for p in m.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(low)
    if optimizers is None:
        return models
    for opt in optimizers if isinstance(optimizers, (list, tuple)) \
            else [optimizers]:
        opt._multi_precision = True if master_weight is None \
            else master_weight
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (the reference's ``GradScaler`` :171).

    bfloat16 has float32's exponent range, so under a bf16 ``auto_cast``
    (or for a bf16 loss) :meth:`scale` passes the loss through, warns
    once, and ``unscale_`` and ``update`` do nothing for that step; fp16
    keeps the whole state machine on device tensors, which move to the
    loss's device at the first :meth:`scale`: ``unscale_`` is the unscale
    pass (:func:`~paddle_tpu_torch.ops.multi_tensor_update.
    multi_tensor_unscale`, one kernel launch per gradient type on the
    card, in place) and
    ``update`` :func:`~paddle_tpu_torch.ops.amp_ops.update_loss_scaling_`
    in place.  ``step`` reads the flag on the host to skip the
    optimizer's step, as the reference's eager API does
    (``self._found_inf = bool(found)``); ``Model``'s fp16 steps skip on
    the device instead."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = torch.tensor(float(init_loss_scaling))
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = torch.zeros((), dtype=torch.int32)
        self._bad = torch.zeros((), dtype=torch.int32)
        self._found_inf = False
        self._found_dev = None          # the unscale pass's device flag
        self._tables = {}               # its device tables (grad_tables)
        self._already_unscaled = False
        self._skip_scaling = False      # latched by a bf16 scale()
        self._bf16_warned = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return float(self._scale)

    def _bf16_active(self, var) -> bool:
        st = _amp_state()
        return (st is not None and st.dtype == torch.bfloat16) or \
            getattr(var, "dtype", None) == torch.bfloat16

    def scale(self, var):
        if not self._enable:
            return var
        if self._bf16_active(var):
            if not self._bf16_warned:
                self._bf16_warned = True
                warnings.warn(
                    "GradScaler: bfloat16 has the float32 exponent "
                    "range — loss scaling is skipped (the scaler is a "
                    "pass-through for bf16; it stays armed for fp16)")
            self._skip_scaling = True
            return var
        self._skip_scaling = False
        self._to(var.device)
        return var * self._scale.to(var.dtype)

    def _to(self, device) -> None:
        """The state on ``device`` (moved once, at the first scale)."""
        if self._scale.device != device:
            self._scale, self._good, self._bad = (
                t.to(device) for t in (self._scale, self._good, self._bad))
            self._found_dev = None
        if self._found_dev is None:
            self._found_dev = torch.zeros((), dtype=torch.bool,
                                          device=device)

    def unscale_(self, optimizer):
        if not self._enable or self._already_unscaled or \
                self._skip_scaling:
            return
        grads = [p.grad for _, p in (optimizer._params or [])
                 if p.grad is not None]
        self._to(grads[0].device if grads else self._scale.device)
        multi_tensor_unscale(grads, self._scale, self._found_dev,
                             self._tables)
        self._found_inf = bool(self._found_dev)
        self._already_unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        self._already_unscaled = False
        if not (self._enable and self._dynamic) or self._skip_scaling:
            return
        self._to(self._scale.device)
        self._found_dev.fill_(self._found_inf)
        update_loss_scaling_(self._found_dev, self._scale, self._good,
                             self._bad, self._incr_every_n_steps,
                             self._decr_every_n, self._incr_ratio,
                             self._decr_ratio)
        self._found_inf = False

    def state_dict(self):
        return {"scale": float(self._scale), "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": int(self._good), "bad_steps": int(self._bad)}

    def load_state_dict(self, state):
        dev = self._scale.device
        self._scale = torch.tensor(float(state["scale"]), device=dev)
        self._good = torch.tensor(int(state.get("good_steps", 0)),
                                  dtype=torch.int32, device=dev)
        self._bad = torch.tensor(int(state.get("bad_steps", 0)),
                                 dtype=torch.int32, device=dev)
        self._incr_ratio = state.get("incr_ratio", self._incr_ratio)
        self._decr_ratio = state.get("decr_ratio", self._decr_ratio)
        self._incr_every_n_steps = state.get(
            "incr_every_n_steps", self._incr_every_n_steps)
        self._decr_every_n = state.get(
            "decr_every_n_nan_or_inf", self._decr_every_n)


AmpScaler = GradScaler
