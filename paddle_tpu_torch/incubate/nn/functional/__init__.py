"""Fused transformer functional ops — the counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``.

The layouts are the reference's: the packed qkv weight
``[3, H, Dh, D]`` (bias ``[3, H, Dh]``), linear weights ``(in, out)``.
Attention goes through
:func:`~paddle_tpu_torch.ops.nn_misc.scaled_dot_product_attention`, which
takes the flash-attention kernels without a mask or attention dropout.
In the post-LN arrangement each block ends in
:func:`~paddle_tpu_torch.ops.fused_ops.fused_bias_dropout_residual_layer_norm`,
the fused epilogue kernel; the pre-LN arrangement normalises first with
``F.layer_norm`` and ends in a plain bias, dropout and residual add, as the
reference does.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ....ops.fused_ops import fused_bias_dropout_residual_layer_norm
from ....ops.nn_misc import dropout, scaled_dot_product_attention

__all__ = ["fused_multi_head_attention", "fused_feedforward",
           "fused_bias_dropout_residual_layer_norm"]

# relu and gelu as torch's own (gelu the exact-erf form); every other name
# the reference takes resolves through ``_activation``
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu, "gelu": F.gelu}


def _maybe_ln(x, scale, bias, eps):
    return F.layer_norm(x, (int(x.shape[-1]),), scale, bias, eps)


def _activation(name: str):
    """The activation the reference takes as ``getattr(P, activation)``
    (:102): ``relu`` and ``gelu`` from :data:`ACTIVATIONS`, any other name
    among the port's tensor functions (``ops.TENSOR_MODULES``,
    ``ops/activation.py`` first), on torch tensors; a name that is none of
    them raises ``AttributeError``, as the reference's ``getattr``."""
    fn = ACTIVATIONS.get(name)
    if fn is not None:
        return fn
    from .... import ops
    for mod in (ops.activation,) + ops.TENSOR_MODULES:
        if name in mod.__all__:
            op = getattr(mod, name)
            return lambda a: op(a)._data
    raise AttributeError(f"the port's tensor functions have no activation "
                         f"{name!r}")


def fused_multi_head_attention(
        x: torch.Tensor, qkv_weight: torch.Tensor,
        linear_weight: torch.Tensor, pre_layer_norm: bool = False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon: float = 1e-5, qkv_bias=None, linear_bias=None,
        attn_mask=None, dropout_rate: float = 0.5,
        attn_dropout_rate: float = 0.5, ln_epsilon: float = 1e-5,
        training: bool = True, name=None) -> torch.Tensor:
    """Self-attention block of ``x (B, T, D)``:
    ``LN(x + dropout(linear(MHA(x))))`` (post-LN), or
    ``x + dropout(linear(MHA(LN(x))))`` with ``pre_layer_norm``."""
    _, H, Dh, D = (int(s) for s in qkv_weight.shape)
    residual = x
    h = _maybe_ln(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon) \
        if pre_layer_norm else x
    # [B, T, D] x [3, H, Dh, D] -> [B, T, 3, H, Dh]
    w = qkv_weight.permute(3, 0, 1, 2).reshape(D, 3 * H * Dh)
    qkv = torch.matmul(h, w)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(3 * H * Dh)
    B, T = int(x.shape[0]), int(x.shape[1])
    q, k, v = qkv.reshape(B, T, 3, H, Dh).unbind(2)
    ctx = scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, training=training)
    out = torch.matmul(ctx.reshape(B, T, H * Dh), linear_weight)
    if not pre_layer_norm:
        return fused_bias_dropout_residual_layer_norm(
            out, residual, bias=linear_bias, ln_scale=ln_scale,
            ln_bias=ln_bias, dropout_rate=dropout_rate,
            ln_epsilon=ln_epsilon, training=training)
    if linear_bias is not None:
        out = out + linear_bias
    return residual + dropout(out, p=dropout_rate, training=training)


def fused_feedforward(
        x: torch.Tensor, linear1_weight: torch.Tensor,
        linear2_weight: torch.Tensor, linear1_bias=None, linear2_bias=None,
        ln1_scale=None, ln1_bias=None, ln2_scale=None, ln2_bias=None,
        dropout1_rate: float = 0.5, dropout2_rate: float = 0.5,
        activation: str = "relu", ln1_epsilon: float = 1e-5,
        ln2_epsilon: float = 1e-5, pre_layer_norm: bool = False,
        training: bool = True, name=None) -> torch.Tensor:
    """FFN block: ``LN(x + dropout2(linear2(dropout1(act(linear1(x))))))``
    (post-LN), or the pre-LN form."""
    act = _activation(activation)
    residual = x
    h = _maybe_ln(x, ln1_scale, ln1_bias, ln1_epsilon) \
        if pre_layer_norm else x
    h = torch.matmul(h, linear1_weight)
    if linear1_bias is not None:
        h = h + linear1_bias
    h = dropout(act(h), p=dropout1_rate, training=training)
    h = torch.matmul(h, linear2_weight)
    if not pre_layer_norm:
        return fused_bias_dropout_residual_layer_norm(
            h, residual, bias=linear2_bias, ln_scale=ln2_scale,
            ln_bias=ln2_bias, dropout_rate=dropout2_rate,
            ln_epsilon=ln2_epsilon, training=training)
    if linear2_bias is not None:
        h = h + linear2_bias
    return residual + dropout(h, p=dropout2_rate, training=training)
