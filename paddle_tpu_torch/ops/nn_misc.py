"""Attention entry point — the counterpart of
``paddle_tpu/ops/nn_misc.py:scaled_dot_product_attention``, routed as the
reference routes it: without a mask, the flash-attention forward (the
kernel for CUDA tensors, its plain version for CPU tensors); with an
additive mask, plain masked math (the reference's ``_sdpa_xla``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention"]


def _sdpa_math(q, k, v, attn_mask, causal: bool, scale: Optional[float]):
    """Masked attention math over ``(B, S, H, D)``; causal entries are
    filled with the dtype's most negative finite value, as the reference
    does."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
    logits = logits + attn_mask
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        allow = torch.ones((sq, sk), dtype=torch.bool,
                           device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~allow, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Inputs ``(B, S, H, D)``; ``attn_mask`` is additive and broadcasts
    to ``(B, H, Sq, Sk)``."""
    if attn_mask is None:
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale)
    return _sdpa_math(query, key, value, attn_mask, is_causal, scale)
