"""``paddle.nn.functional`` of the port — the counterpart of
``paddle_tpu/nn/functional.py`` for what is ported: the activations
(``ops/activation.py``), the normalizations (``ops/norm_ops.py``), the
Tensor entry points of the reference's ``nn_misc`` and ``loss``
(``ops/nn_ops.py``: ``linear``, ``embedding``, the dropouts,
``scaled_dot_product_attention`` and its alias ``flash_attention``, every
loss, ``sequence_mask`` ... ``nce``), ``pad`` and the in-place ``elu_``,
``softmax_``, ``tanh_``, and :func:`gather_tree`, the beam-search
backtrace.

Waiting: the conv, pooling and vision functions and ``affine_grid``
(``ROADMAP.md`` §A item 10) and ``fused_conv_bn``.
"""
from __future__ import annotations

import torch

from ..ops._common import dispatch
from ..ops._common import t as _t
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


def gather_tree(ids, parents):
    """The beams' full sequences from their step ids and parents, both
    ``[T, B, beam]`` (reference ``nn/functional.py:165-187``): walking
    back from the last step, each beam takes its id and moves to its
    parent."""
    def kernel(i, p):
        beam = torch.arange(i.shape[-1], dtype=torch.int64,
                            device=i.device).expand(i.shape[1:])
        outs = []
        for t in range(i.shape[0] - 1, -1, -1):
            outs.append(torch.gather(i[t], -1, beam))
            beam = torch.gather(p[t], -1, beam).to(torch.int64)
        return torch.stack(outs[::-1])
    return dispatch("gather_tree", kernel, (_t(ids), _t(parents)), {})
