"""Cross entropy — the counterpart of ``paddle_tpu/ops/loss.py:38
cross_entropy``, in plain PyTorch (the reference has no Pallas kernel
here).

Semantics as the reference's: hard labels of shape ``(…, 1)`` or ``(…)``
(or soft labels with ``soft_label=True``), ``ignore_index`` rows counted
as zero loss and left out of the ``"mean"`` (which divides by the summed
weights of the valid rows, :69-73), per-class ``weight``, and
``label_smoothing`` mixing the one-hot target with the uniform one.  The
log-softmax runs in fp32.  A hard label picks its log-probability by
gather instead of a one-hot product, which is the same sum with the zero
terms left out and needs no ``(…, V)`` target tensor.  Under
:func:`~paddle_tpu_torch.amp.auto_cast` it is a black-list op: its
floating inputs are cast to fp32 (:func:`~paddle_tpu_torch.amp.amp_op`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..amp import amp_op

__all__ = ["cross_entropy"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none'; got "
                     f"{reduction!r}")


@amp_op("cross_entropy")
def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross entropy of ``input`` (logits, or probabilities when
    ``use_softmax=False``) against ``label``, reduced by ``reduction``."""
    x = input.float()
    logp = torch.log_softmax(x, dim=axis) if use_softmax else \
        torch.log(x.clamp_min(1e-30))
    nclass = logp.shape[axis]
    if soft_label:
        soft = label.to(logp.dtype)
        if label_smoothing > 0.0:
            soft = soft * (1.0 - label_smoothing) + label_smoothing / nclass
        return _reduce(-(soft * logp).sum(dim=axis), reduction)

    idx = label
    if idx.dim() == logp.dim() and idx.shape[axis] == 1:
        idx = idx.squeeze(axis)
    idx = idx.long()
    valid = idx != ignore_index
    safe = idx.clamp(0, nclass - 1)
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    # a label outside [0, nclass) has an all-zero one-hot in the reference
    in_range = (idx >= 0) & (idx < nclass)
    loss = -torch.where(in_range, picked, torch.zeros_like(picked))
    if label_smoothing > 0.0:
        loss = loss * (1.0 - label_smoothing) \
            - logp.sum(dim=axis) * (label_smoothing / nclass)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    w = None if weight is None else weight.to(loss.device, loss.dtype)[safe]
    if w is not None:
        loss = loss * w
    if reduction == "mean":
        denom = (w if w is not None else torch.ones_like(loss)) * valid
        return loss.sum() / denom.sum().clamp_min(1e-12)
    return _reduce(loss, reduction)
