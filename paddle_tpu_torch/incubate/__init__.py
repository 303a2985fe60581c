"""``paddle.incubate`` of the port (``paddle_tpu/incubate/``): so far the
fused transformer layers of :mod:`.nn`."""
from . import nn  # noqa: F401

__all__ = ["nn"]
