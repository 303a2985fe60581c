"""``paddle.hapi`` of the port: the batch-level ``Model`` API, and
``summary`` and ``flops``."""
from .model import Model
from .summary import flops, summary

__all__ = ["Model", "summary", "flops"]
