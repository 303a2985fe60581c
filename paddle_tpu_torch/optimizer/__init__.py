"""``paddle.optimizer`` of the port: ``Optimizer``, ``SGD``, ``Momentum``,
``LarsMomentum`` (``Lars``), ``Adam``, ``AdamW``, ``Adamax``, ``Adagrad``,
``Adadelta``, ``RMSProp``, ``Lamb``, ``Ftrl`` and ``DecayedAdagrad``, and
the learning-rate schedulers (``optimizer.lr``)."""
from . import lr
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         DecayedAdagrad, Ftrl, Lamb, Lars, LarsMomentum,
                         Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "LarsMomentum",
           "Ftrl", "DecayedAdagrad", "lr"]
