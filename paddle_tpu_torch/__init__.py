"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package beside the JAX reference (``paddle_tpu``), never importing it.
It serves the flagship GPT (``models``, ``generation``, ``serving``),
trains it through the compiled-trainer path (``models.gpt_spmd``) and
through ``Model`` (``hapi``) with the port's losses (``nn``, ``ops.loss``)
and optimizers (``optimizer``).  Attention and the LM head run through
hand-written CUDA kernels (``csrc/``) built with nvcc at first use.
Entry points run on the card unless given ``device="cpu"``.
"""
from .device import NoCudaDevice, resolve_device
from .hapi import Model

__all__ = ["Model", "NoCudaDevice", "resolve_device"]
