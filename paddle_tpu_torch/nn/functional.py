"""``paddle.nn.functional`` of the port — the counterpart of
``paddle_tpu/nn/functional.py`` for what is ported: the activations
(``ops/activation.py``), the normalizations (``ops/norm_ops.py``), the
Tensor entry points of the reference's ``nn_misc`` and ``loss``
(``ops/nn_ops.py``: ``linear``, ``embedding``, the dropouts,
``scaled_dot_product_attention`` and its alias ``flash_attention``, every
loss, ``sequence_mask`` ... ``nce``), ``pad`` and the in-place ``elu_``,
``softmax_``, ``tanh_``.

Waiting: the conv, pooling and vision functions and ``affine_grid``
(``ROADMAP.md`` §A item 10), ``fused_conv_bn`` and ``gather_tree``.
"""
from __future__ import annotations

from ..ops.activation import *  # noqa: F401,F403
from ..ops.manipulation import pad  # noqa: F401
from ..ops.math import _inplace_guard
from ..ops.math import tanh as _tanh
from ..ops.nn_ops import *  # noqa: F401,F403
from ..ops.nn_ops import scaled_dot_product_attention as flash_attention  # noqa: F401,E501
from ..ops.norm_ops import *  # noqa: F401,F403


def _inplace(fn, name):
    def op(x, *args, **kwargs):
        kwargs.pop("name", None)
        _inplace_guard(x, name)
        x._data = fn(x, *args, **kwargs)._data
        return x
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"In-place {name[:-1]}."
    return op


elu_ = _inplace(elu, "elu_")  # noqa: F405
softmax_ = _inplace(softmax, "softmax_")  # noqa: F405
tanh_ = _inplace(_tanh, "tanh_")
