"""``paddle.optimizer`` of the port: ``Optimizer``, ``SGD``, ``Adam`` and
``AdamW``, and the learning-rate schedulers (``optimizer.lr``)."""
from . import lr
from .optimizers import SGD, Adam, AdamW, Optimizer

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "lr"]
