"""AMP support ops — the counterparts of ``paddle_tpu/ops/amp_ops.py``:
``check_finite_and_unscale`` (:16) and ``update_loss_scaling`` (:32), the
dynamic loss-scale state machine, on device tensors and without reading
anything back to the host.

A step that is captured in a CUDA graph reads and writes its state by
address, so it takes the in-place forms: the unscale pass
:func:`~paddle_tpu_torch.ops.multi_tensor_update.multi_tensor_unscale`
(``csrc/multi_tensor_update.cu`` on the card) and
:func:`update_loss_scaling_`.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import multi_tensor_update as _mtu

__all__ = ["check_finite_and_unscale", "update_loss_scaling",
           "update_loss_scaling_"]


def check_finite_and_unscale(xs: Sequence[torch.Tensor],
                             scale: torch.Tensor
                             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Each of ``xs`` unscaled, and a 0-d bool tensor that is true when any
    of them holds a non-finite value.  CUDA tensors of the kernel's types
    (fp32, bf16, fp16) are copied and go through the unscale pass, which
    multiplies by ``1/scale`` rounded to each tensor's type (the
    reference's jitted step): for a scale that is a power of two whose
    inverse the type holds, that is exactly the division by ``scale`` of
    the reference op, which every other tensor takes (on the CPU, or of
    another type)."""
    if xs and all(x.is_cuda and x.dtype in _mtu.GRAD_CODES for x in xs):
        outs = [x.clone(memory_format=torch.contiguous_format) for x in xs]
        found = torch.zeros((), dtype=torch.bool, device=xs[0].device)
        _mtu.multi_tensor_unscale(
            outs, scale.to(xs[0].device, torch.float32), found)
        return outs, found
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for x in xs:
        found = found | ~torch.isfinite(x).all().to(found.device)
        outs.append(x / scale.to(x.device))
    return outs, found


def update_loss_scaling(found_inf, prev_loss_scaling, num_good_steps,
                        num_bad_steps, incr_every_n_steps: int,
                        decr_every_n_nan_or_inf: int, incr_ratio: float,
                        decr_ratio: float):
    """One step of the dynamic loss-scale state machine: ``(scale,
    good_steps, bad_steps)`` as 0-d tensors (fp32, int32, int32).  A
    non-finite step resets the good count; ``decr_every_n_nan_or_inf``
    of them in a row scale down by ``decr_ratio`` (not below 1);
    ``incr_every_n_steps`` finite ones in a row scale up by
    ``incr_ratio``; either resets both counts."""
    found = torch.as_tensor(found_inf, dtype=torch.bool)
    scale = torch.as_tensor(prev_loss_scaling, dtype=torch.float32)
    good = torch.as_tensor(num_good_steps, dtype=torch.int32)
    bad = torch.as_tensor(num_bad_steps, dtype=torch.int32)
    new_bad = torch.where(found, bad + 1, torch.zeros_like(bad))
    new_good = torch.where(found, torch.zeros_like(good), good + 1)
    should_decr = new_bad >= decr_every_n_nan_or_inf
    should_incr = new_good >= incr_every_n_steps
    new_scale = torch.where(
        should_decr, torch.clamp_min(scale * decr_ratio, 1.0),
        torch.where(should_incr, scale * incr_ratio, scale))
    reset = should_incr | should_decr
    new_good = torch.where(reset, torch.zeros_like(new_good), new_good)
    new_bad = torch.where(reset, torch.zeros_like(new_bad), new_bad)
    return (new_scale, new_good.to(torch.int32), new_bad.to(torch.int32))


def update_loss_scaling_(found_inf: torch.Tensor, scale: torch.Tensor,
                         good: torch.Tensor, bad: torch.Tensor,
                         incr_every_n_steps: int,
                         decr_every_n_nan_or_inf: int, incr_ratio: float,
                         decr_ratio: float) -> None:
    """:func:`update_loss_scaling` written into ``scale``, ``good`` and
    ``bad`` (0-d fp32, int32, int32 tensors on one device) in place: a
    dozen scalar ops on the device, captured with the step."""
    new = update_loss_scaling(found_inf, scale, good, bad,
                              incr_every_n_steps, decr_every_n_nan_or_inf,
                              incr_ratio, decr_ratio)
    for t, v in zip((scale, good, bad), new):
        t.copy_(v)
