"""Device resolution — the counterpart of ``paddle_tpu/core/place.py``.

The port runs on a CUDA card.  Every entry point resolves its ``device``
argument here: ``None`` means the card, and the CPU is used only when the
caller asks for it by name (``device="cpu"``, as the tests do).  With no
card and no explicit CPU request, resolution raises; nothing carries on
quietly on the CPU.

Resolving a CUDA device also pins fp32 matrix products to full fp32
(``allow_tf32 = False`` for matmuls and cuDNN): the serving path is fp32,
like the reference's eager GPT.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["NoCudaDevice", "resolve_device"]


class NoCudaDevice(RuntimeError):
    """A CUDA device was needed and this machine has none."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; ``"cuda[:n]"`` -> that
    card.  Raises :class:`NoCudaDevice` when a card is asked for (or
    implied) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device is available; the port runs on the card — "
            "pass device='cpu' explicitly to run its plain CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
