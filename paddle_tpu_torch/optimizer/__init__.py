"""``paddle.optimizer`` of the port: ``Optimizer``, ``SGD``, ``Adam`` and
``AdamW``."""
from .optimizers import SGD, Adam, AdamW, Optimizer

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]
