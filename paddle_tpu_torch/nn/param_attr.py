"""``ParamAttr`` — the port's copy of ``paddle_tpu/nn/param_attr.py``
(reference ``python/paddle/fluid/param_attr.py``): a parameter's name,
initializer, learning-rate scale, regularizer, trainability and whether
the gradient clip applies to it."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        """``None`` -> a default ``ParamAttr``; a ``ParamAttr`` as it is; a
        string -> its name; ``False`` stays ``False`` (no parameter); an
        initializer -> a ``ParamAttr`` with it; a list, each.  Anything
        else raises ``TypeError``."""
        from .initializer import Initializer
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"a parameter attribute must be a ParamAttr, an "
                        f"initializer, a name, False or None; got "
                        f"{type(arg).__name__}")
