"""Dtype registry — the counterpart of ``paddle_tpu/core/dtype.py``.

String dtypes (``"float32"``, ``"fp16"``, ``"bf16"``, ``"int64"``, ...),
numpy dtypes and torch dtypes all map onto torch dtypes.  The types
follow the reference as it runs, with JAX's x64 off (``:42``): a 64-bit
request gives the 32-bit type (``int64`` is ``int32``, ``float64`` is
``float32``, ``complex128`` is ``complex64``), so tensor dtypes are
honest and every op's result type is the reference's.

``FLAGS_default_dtype`` (``utils/flags.py``) names the default floating
type, which creation ops and :func:`~paddle_tpu_torch.core.tensor.to_tensor`
of Python floats take (:func:`default_float`).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dtype_to_torch", "canonical_dtype", "float32", "float64",
           "float16", "bfloat16", "int8", "int16", "int32", "int64",
           "uint8", "bool_", "complex64", "complex128", "is_floating_dtype",
           "is_integer_dtype", "default_float"]

float32 = torch.float32
float64 = torch.float64
float16 = torch.float16
bfloat16 = torch.bfloat16
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64, "double": torch.float64,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "long": torch.int64,
    "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
# the 32-bit type XLA uses for each 64-bit one with x64 off (:42)
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}
_NAMES = {v: k for k, v in _ALIASES.items()
          if k in ("float32", "float64", "float16", "bfloat16", "int8",
                   "int16", "int32", "int64", "uint8", "bool", "complex64",
                   "complex128")}
_PY = {float: torch.float32, int: torch.int64, bool: torch.bool,
       complex: torch.complex64}


def dtype_to_torch(dtype):
    """A user dtype (str, numpy dtype or type, torch dtype, Python type)
    as the torch dtype the port uses for it; None stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        dt = dtype
    elif isinstance(dtype, str):
        key = dtype.lower()
        if key not in _ALIASES:
            raise ValueError(f"unknown dtype '{dtype}'")
        dt = _ALIASES[key]
    elif dtype in _PY:
        dt = _PY[dtype]
    else:
        name = np.dtype(dtype).name
        if name not in _ALIASES:
            raise ValueError(f"unknown dtype '{dtype}'")
        dt = _ALIASES[name]
    return _NARROW.get(dt, dt)


def canonical_dtype(dtype) -> str:
    """The canonical paddle name of a dtype (``"float32"``, ``"int32"``,
    ``"bfloat16"``, ...)."""
    return _NAMES[dtype_to_torch(dtype)]


def is_floating_dtype(dtype) -> bool:
    return dtype_to_torch(dtype).is_floating_point


def is_integer_dtype(dtype) -> bool:
    dt = dtype_to_torch(dtype)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def default_float() -> torch.dtype:
    """The default floating type, ``FLAGS_default_dtype`` (read at each
    call, so ``set_flags`` takes effect at once)."""
    from ..utils import flags
    return dtype_to_torch(flags.get_flag("FLAGS_default_dtype"))
