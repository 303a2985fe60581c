"""Layers of ``paddle.incubate.nn`` in the port."""
from . import fused_transformer  # noqa: F401
