"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package beside the JAX reference (``paddle_tpu``), never importing it.
This slice serves the flagship GPT: the eager model (``models``), its
fixed-capacity KV cache, seeded sampling and generation session
(``generation``), and the continuous-batching engine (``serving``).  The
attention of the un-cached forward and of the prefill runs through a
hand-written CUDA kernel (``csrc/flash_attn_fwd.cu``) built with nvcc at
first use.  Entry points run on the card unless given ``device="cpu"``.
"""
from .device import NoCudaDevice, resolve_device

__all__ = ["NoCudaDevice", "resolve_device"]
