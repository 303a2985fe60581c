"""Weight-decay regularizers — the counterpart of
``paddle_tpu/regularizer.py``: ``L1Decay`` (:31) and ``L2Decay`` (:41).

An optimizer takes one through ``weight_decay`` (a number there means
``L2Decay`` of that coefficient), or a parameter carries its own as a
``regularizer`` attribute, which wins over the optimizer's.  The decay is
the penalty's gradient, added to the parameter's gradient inside the
update (on the fp32 master where the optimizer keeps one), on the device:
``grad(param)`` reads nothing back to the host, so a captured step holds
it.
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    coeff: float = 0.0

    def grad(self, param: torch.Tensor) -> torch.Tensor:
        """The penalty's gradient with respect to ``param``."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """The penalty ``coeff · sum|w|``; its gradient ``coeff · sign(w)``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def grad(self, param):
        return self.coeff * torch.sign(param)


class L2Decay(WeightDecayRegularizer):
    """The penalty ``0.5·coeff·sum(w²)``; its gradient ``coeff·w``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def grad(self, param):
        return self.coeff * param
