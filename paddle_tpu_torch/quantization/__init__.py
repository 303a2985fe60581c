"""Int8 quantization — the part of ``paddle_tpu/quantization`` that the
paged KV cache uses (the reference's ``quantize_int8_jnp`` and
``dequantize_int8_jnp``).

Symmetric abs-max quantization per slice along ``axis``: the scale is
``max(amax, 1e-8) / 127`` and the values are rounded half to even
(``torch.round``, as ``jnp.round``) and clipped to ±127, so on the same
fp32 input the int8 bytes and the scales equal the reference's bit for
bit.  The rest of the package (post-training quantization, QAT, the int8
layers) is still to be ported (``ROADMAP.md`` §A item 10).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8"]


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scales fp32)``: per-slice abs-max scales along ``axis``
    (kept out of the scales' shape)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which can land an ulp off the true quotient
    scales = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scales), -127, 127).to(torch.int8)
    return q, scales.squeeze(axis)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: the scales broadcast back along
    ``axis``."""
    return q.to(torch.float32) * scales.unsqueeze(axis)
