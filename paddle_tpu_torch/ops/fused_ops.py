"""The fused post-LN epilogue — the counterpart of
``paddle_tpu/ops/fused_ops.py``: ``LayerNorm(residual + dropout(x +
bias))`` as one op.

The forward is :func:`~paddle_tpu_torch.ops.fused_ln.fused_ln`: the
hand-written kernel for CUDA tensors, its plain version for CPU tensors.
The backward is the reference's ``_fused_bwd`` (:62): autograd over the
plain math :func:`_fused_math`, with the dropout mask recomputed from
(seed, index), so no mask is stored.  The reference has no backward
kernel; one is queued in ``ROADMAP.md``.

Each call draws its hash seed on the host from the port's random state
(:data:`~paddle_tpu_torch.random.default_generator`), in the reference's
range ``[0, 2**31 - 1)``, so the step never waits for the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..random import default_generator
from . import fused_ln as _fl

__all__ = ["fused_bias_dropout_residual_layer_norm",
           "FusedBiasDropoutResidualLN"]

# the reference's pure math (:29), shared by the CPU forward and the
# backward's recompute: the kernel's plain version
_fused_math = _fl.fused_ln_ref


class FusedBiasDropoutResidualLN(torch.autograd.Function):
    """:func:`~paddle_tpu_torch.ops.fused_ln.fused_ln` forward (looked up
    in its module at each call); the backward differentiates
    :func:`_fused_math` at the saved inputs with the same seed."""

    @staticmethod
    def forward(ctx, x, residual, bias, gamma, beta, seed, p, eps):
        ctx.save_for_backward(x, residual, bias, gamma, beta)
        ctx.seed, ctx.p, ctx.eps = seed, p, eps
        return _fl.fused_ln(x, residual, bias, gamma, beta, seed, p=p,
                            eps=eps)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _fused_math(*leaves, ctx.seed, p=ctx.p, eps=ctx.eps)
        grads = torch.autograd.grad(out, leaves, g)
        return (*(gr if need else None for gr, need in
                  zip(grads, ctx.needs_input_grad)), None, None, None)


def _next_seed() -> int:
    return default_generator.next_seed()


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
