"""``paddle.hapi`` of the port: the batch-level ``Model`` API."""
from .model import Model

__all__ = ["Model"]
