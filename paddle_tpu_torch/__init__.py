"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package beside the JAX reference (``paddle_tpu``), never importing it.
It serves the flagship GPT (``models``, ``generation``, ``serving``),
trains it through the compiled-trainer path (``models.gpt_spmd``) and
through ``Model`` (``hapi``, with ``summary`` and ``flops``) with the
port's losses (``nn``, ``ops.loss``), optimizers (``optimizer``) and
regularizers (``regularizer``), and runs the fused transformer encoder
layers (``incubate.nn``).  Attention, the LM head and the fused post-LN
epilogue run through hand-written CUDA kernels (``csrc/``) built with
nvcc at first use.  Entry points run on the card unless given
``device="cpu"``.  :func:`seed` reseeds the port's random state
(``random``); :func:`set_flags` and :func:`get_flags` set and read the
reference's runtime flags (``utils.flags``).

The eager core (``core``) is paddle's dygraph API: :class:`Tensor`,
:class:`Parameter` and :func:`to_tensor` on torch tensors with torch
autograd, the places (:func:`set_device`: the card unless ``"cpu"``), the
op dispatch, every ported tensor function as ``paddle_tpu_torch.<name>``
(``ops``), ``nn.Layer`` and its layers up to ``nn.TransformerEncoder``
(``nn``), ``autograd`` and ``device``.
"""
from . import (amp, autograd, device, io, metric, nn, ops,  # noqa: F401
               optimizer, regularizer)
from .core import errors  # noqa: F401
from .core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                            no_grad, set_grad_enabled)
from .core.dispatch import (disable_static, enable_static,  # noqa: F401
                            in_dynamic_mode)
from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa: F401
                         float16, float32, float64, int8, int16, int32,
                         int64, uint8)
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                         device_count, get_device, is_compiled_with_cuda,
                         set_device)
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .device import NoCudaDevice, resolve_device  # noqa: F401
from .hapi import Model, flops, summary  # noqa: F401
from .nn.param_attr import ParamAttr  # noqa: F401
from .utils.flags import get_flags, set_flags  # noqa: F401


def _export_tensor_functions():
    """Every ported tensor function as ``paddle_tpu_torch.<name>``."""
    names = []
    for mod in ops.TENSOR_MODULES:
        for name in mod.__all__:
            if name not in globals():
                globals()[name] = getattr(mod, name)
                names.append(name)
    return names


TENSOR_FUNCTIONS = _export_tensor_functions()

__all__ = ["Model", "NoCudaDevice", "flops", "get_flags", "regularizer",
           "resolve_device", "seed", "set_flags", "summary", "Tensor",
           "Parameter", "to_tensor", "ParamAttr", "errors", "no_grad",
           "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad",
           "set_device", "get_device", "device_count",
           "is_compiled_with_cuda", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "get_rng_state", "set_rng_state",
           "enable_static", "disable_static", "in_dynamic_mode", "nn",
           "autograd", "device", "amp", "io", "metric", "optimizer",
           "float32", "float64", "float16", "bfloat16", "int8", "int16", "int32", "int64", "uint8", "bool_",
           "complex64", "complex128"] + TENSOR_FUNCTIONS
