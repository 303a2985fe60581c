"""Gradient clipping — the counterpart of ``paddle_tpu/nn/clip.py``:
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``.

An optimizer built with ``grad_clip=`` clips its parameters' gradients
in place at the start of every ``step()``: after the fp16 loss scaler
has unscaled them (``Model``'s ``_backward_and_step``), before the update,
as the reference's optimizer does.  A parameter whose ``need_clip``
attribute is false keeps its gradient, and is left out of the global
norm.

Every clip runs on the gradients' device with multi-tensor launches and
reads nothing back to the host, so a step captured in a CUDA graph holds
its clip:

- ``ClipGradByValue``: ``clamp`` to ``[min, max]`` (``min`` defaults to
  ``-max``);
- ``ClipGradByNorm``: each gradient times ``min(clip_norm /
  max(‖g‖₂, 1e-12), 1)``, its norm in its own type;
- ``ClipGradByGlobalNorm``: every gradient times ``min(clip_norm /
  max(‖G‖₂, 1e-12), 1)``, where ``‖G‖₂`` is the square root of the sum
  of the squares of all of them, summed in fp32 (one
  ``torch._foreach_norm`` over the gradients in fp32, then the norm of
  those norms); the product is formed in fp32 and rounded to the
  gradient's type.

Called on ``(param, grad)`` pairs, a clip returns new pairs and leaves
the given gradients as they were, as the reference's does.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _clippable(params_grads) -> List[torch.Tensor]:
    return [g for p, g in params_grads
            if g is not None and getattr(p, "need_clip", True)]


class ClipGradBase:
    def __call__(self, params_grads: Sequence[Tuple]) -> List[Tuple]:
        """``(param, grad)`` pairs -> new pairs with clipped copies."""
        out = [(p, None if g is None else g.detach().clone())
               for p, g in params_grads]
        self._clip_(out)
        return out

    @torch.no_grad()
    def _clip_(self, params_grads: Sequence[Tuple]) -> None:
        """Clip the gradients of ``params_grads`` in place."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    @torch.no_grad()
    def _clip_(self, params_grads):
        grads = _clippable(params_grads)
        if grads:
            torch._foreach_clamp_min_(grads, self.min)
            torch._foreach_clamp_max_(grads, self.max)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def _clip_(self, params_grads):
        grads = _clippable(params_grads)
        if not grads:
            return
        norms = torch._foreach_norm(grads, 2)
        for g, n in zip(grads, norms):
            g.mul_((self.clip_norm / n.clamp_min(1e-12)).clamp_max(1.0))


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _scale(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """``min(clip_norm / max(‖G‖₂, 1e-12), 1)`` as a 0-d fp32 tensor
        on the gradients' device."""
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        total = torch.stack(norms).square().sum().sqrt()
        return (self.clip_norm / total.clamp_min(1e-12)).clamp_max(1.0)

    @torch.no_grad()
    def _clip_(self, params_grads):
        grads = _clippable(params_grads)
        if grads:
            torch._foreach_mul_(grads, self._scale(grads))
