"""Op dispatch and the kernel registry — the counterpart of
``paddle_tpu/core/dispatch.py`` (``register_kernel`` / ``get_kernel``
:54-76, ``dispatch`` :255, ``defop`` :355).

An op's kernel is a function on torch tensors.  :func:`dispatch` runs it
on the ``_data`` of its Tensor arguments and wraps the outputs; torch
autograd records the gradient.  Around the kernel it:

- refuses under ``enable_static()`` (static capture is ``ROADMAP.md``
  A7, §A item 11);
- casts the floating inputs under AMP through
  :func:`~paddle_tpu_torch.amp.amp_cast_inputs` by the reference's op
  name, and runs the kernel with the AMP hook passed through (the
  reference's dispatcher never sees inside an op);
- writes an ``op::<name>`` span under the ``dispatch`` category and the
  ``dispatch.count`` / ``dispatch.op.<name>`` / ``dispatch.time_ns``
  metrics through the tracer (``profiler/tracer.py``) when it is on;
- runs ``FLAGS_check_nan_inf``'s per-op check (``FloatingPointError``
  naming the op) and ``FLAGS_benchmark``'s synchronisation; both wait for
  the card, which a CUDA-graph capture cannot, so under a capture either
  flag raises;
- on an out-of-memory error writes memscope's dump with context
  ``dispatch:<op>`` and re-raises;
- tags op errors as :func:`~paddle_tpu_torch.core.errors.tag_op_error`
  does.

The reference's eager jit cache (:101-252) has no counterpart: torch
runs eagerly without tracing, so ``FLAGS_eager_jit_cache`` is unread and
``dispatch.jit_cache.*`` is not published.  The registry keeps the
reference's backend key, with the one backend ``"torch"``; the kernels
that reach the hand-written CUDA kernels (attention, the update) do so
by the tensors' device, so ``FLAGS_use_pallas`` is unread as well.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..profiler import tracer as _tracer
from ..utils import flags as _flags
from .errors import UnimplementedError, tag_op_error

__all__ = ["register_kernel", "get_kernel", "dispatch", "defop",
           "enable_static", "disable_static", "in_dynamic_mode"]

_REGISTRY: Dict[Tuple[str, str], Callable] = {}
_static = False
# FLAGS_check_nan_inf or FLAGS_benchmark, cached (set_flags updates it)
debug_ops_active = False


def _on_flags():
    global debug_ops_active
    debug_ops_active = bool(_flags.get_flag("FLAGS_check_nan_inf")
                           or _flags.get_flag("FLAGS_benchmark"))


_flags.on_change(_on_flags)
_on_flags()


def register_kernel(op_name: str, backend: str = "torch"):
    """Decorator: register an implementation for (op_name, backend)."""
    def deco(fn):
        _REGISTRY[(op_name, backend)] = fn
        return fn
    return deco


def get_kernel(op_name: str, backend: Optional[str] = None) -> Callable:
    fn = _REGISTRY.get((op_name, backend or "torch"))
    if fn is None:
        fn = _REGISTRY.get((op_name, "torch"))
    if fn is None:
        raise KeyError(f"no kernel registered for op '{op_name}'")
    return fn


def enable_static():
    """``paddle.enable_static``: ops then refuse (static capture is not
    ported: ``ROADMAP.md`` A7, §A item 11)."""
    global _static
    _static = True


def disable_static(place=None):
    global _static
    _static = False


def in_dynamic_mode() -> bool:
    return not _static


def _capturing() -> bool:
    """Whether this thread's stream is capturing a CUDA graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _check_outputs(op_name: str, outs):
    """FLAGS_check_nan_inf's per-op guard (reference
    ``nan_inf_utils_detail.cc:559``) and FLAGS_benchmark's per-op
    synchronisation (``operator.cc:1210``)."""
    check = _flags.get_flag("FLAGS_check_nan_inf")
    if _capturing():
        raise RuntimeError(
            f"op '{op_name}': FLAGS_check_nan_inf and FLAGS_benchmark "
            "wait for the card after every op, which a CUDA-graph capture "
            "cannot; turn them off for a captured step")
    if check:
        for i, o in enumerate(outs):
            if o.is_floating_point() or o.is_complex():
                bad = ~torch.isfinite(o.detach())
                if bool(bad.any()):
                    kind = "NaN" if bool(torch.isnan(o.detach()).any()) \
                        else "Inf"
                    raise FloatingPointError(
                        f"op '{op_name}' output {i} contains {kind} "
                        "(FLAGS_check_nan_inf enabled)")
    elif any(o.is_cuda for o in outs):
        torch.cuda.synchronize()


def dispatch(op_name: str, fn: Callable, tensor_args: Sequence,
             kwargs: dict):
    """Run ``fn(*torch_tensors, **kwargs)`` on the Tensors
    ``tensor_args`` and wrap its outputs (a tensor or a tuple of them)."""
    from .tensor import wrap
    if _static:
        raise UnimplementedError(
            f"op '{op_name}' under enable_static(): static graph capture is "
            "not ported yet (ROADMAP.md A7, §A item 11)")
    t0 = _tracer.now_ns() if _tracer.active else 0
    arrays = [t._data for t in tensor_args]
    from .. import amp as _amp
    st = _amp._amp_state()
    try:
        if st is None:
            out = fn(*arrays, **kwargs)
        else:
            arrays, _ = _amp._cast_op(op_name, tuple(arrays), {})
            _amp._state.inside_op = getattr(_amp._state, "inside_op", 0) + 1
            try:
                out = fn(*arrays, **kwargs)
            finally:
                _amp._state.inside_op -= 1
    except Exception as e:
        from ..profiler import memscope as _memscope
        if _memscope.active and _memscope.is_oom(e):
            _memscope.oom_dump(e, context=f"dispatch:{op_name}")
        tag_op_error(op_name, e)
    tuple_output = isinstance(out, (tuple, list))
    outs = tuple(out) if tuple_output else (out,)
    if debug_ops_active:
        _check_outputs(op_name, outs)
    wrapped = tuple(wrap(o) for o in outs)
    if t0:
        _tracer.on_dispatch(op_name, t0)
    return wrapped if tuple_output else wrapped[0]


def defop(op_name: str, n_tensor_args: Optional[int] = None):
    """Build a user-facing op from a kernel on torch tensors: the wrapper
    takes Tensors, torch tensors or array-likes for its first
    ``n_tensor_args`` positional parameters and static attributes as
    keywords."""
    def deco(fn):
        register_kernel(op_name)(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from .tensor import as_tensor
            kwargs.pop("name", None)
            n = n_tensor_args if n_tensor_args is not None else len(args)
            if args[n:]:
                raise TypeError(
                    f"{op_name}: positional static attrs not supported; "
                    "pass them as keywords")
            tensors = [as_tensor(a) for a in args[:n]]
            return dispatch(op_name, get_kernel(op_name), tensors, kwargs)
        return wrapper
    return deco
