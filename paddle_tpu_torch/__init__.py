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
"""
from . import regularizer
from .device import NoCudaDevice, resolve_device
from .hapi import Model, flops, summary
from .random import seed
from .utils.flags import get_flags, set_flags

__all__ = ["Model", "NoCudaDevice", "flops", "get_flags", "regularizer",
           "resolve_device", "seed", "set_flags", "summary"]
