"""Attention and dropout — the counterparts of
``paddle_tpu/ops/nn_misc.py``'s ``scaled_dot_product_attention`` (:183)
and ``dropout`` (:72).

Attention is routed as the reference routes it (``_sdpa_pallas`` :168):
without a mask or dropout, the flash attention of :mod:`.flash_attention`
(the kernels for CUDA tensors, their plain versions for CPU tensors,
differentiable either way; it keeps causal attention with more queries
than keys on plain math, as the reference does); with an additive mask or
attention dropout, plain math (the reference's ``_sdpa_xla``).

Dropout masks come from the device stream of the port's random state
(:data:`~paddle_tpu_torch.random.default_generator`, reseeded by
:func:`paddle_tpu_torch.seed`).  torch's and JAX's random bits differ, so
these masks are held to their statistics and to determinism, not to the
reference's bits.

Under :func:`~paddle_tpu_torch.amp.auto_cast` each is one op of the
reference's lists (:func:`~paddle_tpu_torch.amp.amp_op`): attention is
white (bf16 attention runs the bf16 kernels), dropout grey."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..amp import amp_op
from ..random import default_generator, logged
from .flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention", "dropout"]


def _keep(shape, p: float, device) -> torch.Tensor:
    """Bernoulli(1 - p) keep mask of ``shape`` from the device stream (the
    mask its forward drew, in a region the remat recomputes)."""
    gen = default_generator.device(device)
    return logged(lambda: torch.rand(shape, generator=gen,
                                     device=device) < (1.0 - p))


@amp_op("dropout")
def dropout(x: torch.Tensor, p: float = 0.5, *,
            training: bool = True) -> torch.Tensor:
    """The reference's dropout in its default mode, ``upscale_in_train``:
    identity when not ``training`` or at ``p == 0``; in training each
    element is kept with probability ``1 - p`` and divided by ``1 - p``."""
    if not training or p == 0.0:
        return x
    keep = _keep(x.shape, p, x.device)
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def _sdpa_math(q, k, v, attn_mask, causal: bool, scale: Optional[float],
               dropout_p: float = 0.0):
    """Attention math over ``(B, S, H, D)``, with an optional additive mask
    and dropout on the probabilities; causal entries are filled with the
    dtype's most negative finite value, as the reference does."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
    if attn_mask is not None:
        logits = logits + attn_mask
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        allow = torch.ones((sq, sk), dtype=torch.bool,
                           device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~allow, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = _keep(probs.shape, dropout_p, probs.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@amp_op("scaled_dot_product_attention")
def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None, name=None
                                 ) -> torch.Tensor:
    """Inputs ``(B, S, H, D)``; ``attn_mask`` is additive and broadcasts
    to ``(B, H, Sq, Sk)``; ``dropout_p`` applies only when ``training``."""
    p = float(dropout_p) if training else 0.0
    if attn_mask is None and p == 0.0:
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale)
    return _sdpa_math(query, key, value, attn_mask, is_causal, scale, p)
