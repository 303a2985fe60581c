"""Layers of the port (``paddle_tpu/nn/layer/``): the loss layers."""
from .loss import CrossEntropyLoss

__all__ = ["CrossEntropyLoss"]
