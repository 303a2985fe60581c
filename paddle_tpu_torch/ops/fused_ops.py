"""The fused post-LN epilogue — the counterpart of
``paddle_tpu/ops/fused_ops.py``: ``LayerNorm(residual + dropout(x +
bias))`` as one op.

The forward is :func:`~paddle_tpu_torch.ops.fused_ln.fused_ln` and the
backward, the reference's ``_fused_bwd`` (:62), is
:func:`~paddle_tpu_torch.ops.fused_ln.fused_ln_bwd`: the hand-written
kernels for CUDA tensors, their plain versions for CPU tensors.  The
backward recomputes the dropout mask from (seed, index), so no mask is
stored.  x and the residual may differ in type (under AMP O1 the first
layer's residual is fp32 and x bf16); the output is in x's type.  Under
:func:`~paddle_tpu_torch.amp.auto_cast` the op is grey, as in the
reference: O2 casts its floating inputs to the low type, O1 leaves them.

Each call draws its hash seed on the host from the port's random state
(:data:`~paddle_tpu_torch.random.default_generator`), in the reference's
range ``[0, 2**31 - 1)``, so the step never waits for the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..amp import amp_op
from ..random import default_generator
from . import fused_ln as _fl

__all__ = ["fused_bias_dropout_residual_layer_norm",
           "FusedBiasDropoutResidualLN"]


class FusedBiasDropoutResidualLN(torch.autograd.Function):
    """:func:`~paddle_tpu_torch.ops.fused_ln.fused_ln` forward and
    :func:`~paddle_tpu_torch.ops.fused_ln.fused_ln_bwd` backward at the
    saved inputs with the same seed, each looked up in its module at each
    call."""

    @staticmethod
    def forward(ctx, x, residual, bias, gamma, beta, seed, p, eps):
        ctx.save_for_backward(x, residual, bias, gamma, beta)
        ctx.seed, ctx.p, ctx.eps = seed, p, eps
        return _fl.fused_ln(x, residual, bias, gamma, beta, seed, p=p,
                            eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = _fl.fused_ln_bwd(g.contiguous(), *ctx.saved_tensors,
                                 ctx.seed, p=ctx.p, eps=ctx.eps)
        return (*(gr if need else None for gr, need in
                  zip(grads, ctx.needs_input_grad)), None, None, None)


def _next_seed() -> int:
    return default_generator.next_seed()


@amp_op("fused_bias_dropout_residual_layer_norm")
def fused_bias_dropout_residual_layer_norm(
        x: torch.Tensor, residual: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        ln_scale: Optional[torch.Tensor] = None,
        ln_bias: Optional[torch.Tensor] = None, dropout_rate: float = 0.5,
        ln_epsilon: float = 1e-5, training: bool = True, name=None
        ) -> torch.Tensor:
    """``LayerNorm(residual + dropout(x + bias))`` over the last axis of
    ``(…, D)`` inputs, with the reference's defaults (:89): bias zeros in
    x's type, ``ln_scale`` ones and ``ln_bias`` zeros in fp32, no dropout
    when not ``training``.  A seed is drawn on every call, as in the
    reference."""
    D = int(x.shape[-1])
    dev = x.device
    if bias is None:
        bias = torch.zeros((D,), dtype=x.dtype, device=dev)
    if ln_scale is None:
        ln_scale = torch.ones((D,), dtype=torch.float32, device=dev)
    if ln_bias is None:
        ln_bias = torch.zeros((D,), dtype=torch.float32, device=dev)
    p = float(dropout_rate) if training else 0.0
    seed = _next_seed()
    flat = x.reshape(-1, D)
    res = residual.reshape(-1, D)
    if dev.type == "cuda":
        flat, res = flat.contiguous(), res.contiguous()
    out = FusedBiasDropoutResidualLN.apply(flat, res, bias, ln_scale,
                                           ln_bias, seed, p,
                                           float(ln_epsilon))
    return out.reshape(x.shape)
