"""Device resolution and ``paddle.device`` — the counterparts of
``paddle_tpu/core/place.py``'s device choice and of
``paddle_tpu/device/__init__.py`` (``set_device`` / ``get_device`` and
the ``is_compiled_with_*`` probes, reference
``python/paddle/device/__init__.py``).

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

__all__ = ["NoCudaDevice", "resolve_device", "set_device", "get_device",
           "device_count", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device", "is_compiled_with_cuda",
           "is_compiled_with_npu", "is_compiled_with_xpu",
           "get_cudnn_version", "XPUPlace", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "synchronize"]


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


from ..core.place import (  # noqa: E402
    CPUPlace, CUDAPinnedPlace, CUDAPlace, device_count, get_device,
    is_compiled_with_cuda, set_device)


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as an int, None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.backends.cudnn.version()


def XPUPlace(dev_id):
    raise RuntimeError("this framework is not built for XPU; use "
                       "set_device('gpu')")


def get_all_device_type():
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())] + ["cpu"]


def get_available_custom_device():
    return []


def synchronize(device=None):
    """Wait until the queued work of the card (``device``, or every card)
    is done; nothing without a card."""
    if not torch.cuda.is_available():
        return
    if device is None:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        return
    torch.cuda.synchronize(resolve_device(
        str(device).replace("gpu", "cuda")))
