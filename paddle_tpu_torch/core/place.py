"""Places — the counterpart of ``paddle_tpu/core/place.py`` (``Place``
:35, the place classes :72-89, ``set_device`` :139, ``get_device`` :159,
``device_count`` :173), after the reference's ``platform/place.h``.

A place is a ``torch.device``: :class:`CUDAPlace` stands where the
reference has ``TPUPlace``.  The current place is the card unless the
caller asks for the CPU (``set_device("cpu")``, as the tests do); it is
set for the process, as Paddle's ``set_device`` sets it.  With no card
and no explicit CPU request the first tensor made raises
:class:`~paddle_tpu_torch.device.NoCudaDevice` (:meth:`Place.torch_device`
resolves through :func:`~paddle_tpu_torch.device.resolve_device`, which
also pins fp32 products to full fp32 on the card); nothing carries on
quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "set_device", "get_device", "device_count",
           "is_compiled_with_cuda", "place_of", "current_place"]


class Place:
    """Identity of a device: (device_type, device_id)."""

    device_type: str = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def is_cpu_place(self) -> bool:
        return self.device_type == "cpu"

    def is_gpu_place(self) -> bool:
        return self.device_type == "gpu"

    def __eq__(self, other) -> bool:
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self._device_id == other._device_id)

    def __hash__(self) -> int:
        return hash((self.device_type, self._device_id))

    def __repr__(self) -> str:
        return f"Place({self.device_type}:{self._device_id})"

    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this place; a CUDA place on a machine
        without a card raises ``NoCudaDevice``."""
        from ..device import resolve_device
        if self.device_type == "gpu":
            return resolve_device(f"cuda:{self._device_id}")
        return torch.device("cpu")


class CPUPlace(Place):
    device_type = "cpu"


class CUDAPlace(Place):
    device_type = "gpu"


class CUDAPinnedPlace(Place):
    """Host memory pinned for copies to the card; tensors made here live
    on the host."""

    device_type = "cpu_pinned"

    def is_cpu_place(self) -> bool:
        return True


_place: Optional[Place] = None


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    device = str(device).lower()
    kind, _, idx = device.partition(":")
    idx = int(idx) if idx else 0
    if kind in ("gpu", "cuda"):
        return CUDAPlace(idx)
    if kind == "cpu":
        return CPUPlace(idx)
    raise ValueError(f"device '{device}' not supported; this framework "
                     "targets 'gpu' and 'cpu'")


def set_device(device) -> Place:
    """``paddle.set_device``: ``"gpu"``, ``"gpu:N"`` (or ``"cuda[:N]"``)
    or ``"cpu"``; a CUDA place needs a card (``NoCudaDevice`` otherwise)."""
    global _place
    place = _parse(device)
    place.torch_device()
    _place = place
    return place


def current_place() -> Place:
    """The place new tensors go to: the one :func:`set_device` set, else
    the first card."""
    return _place if _place is not None else CUDAPlace(0)


def get_device() -> str:
    place = current_place()
    return f"{place.device_type}:{place.get_device_id()}"


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def place_of(t: torch.Tensor) -> Place:
    """The place of a torch tensor."""
    if t.device.type == "cuda":
        return CUDAPlace(t.device.index or 0)
    return CPUPlace(0)
