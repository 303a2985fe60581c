"""Fused transformer layers — the counterpart of
``paddle_tpu/incubate/nn/layer/fused_transformer.py``.

``torch.nn.Module``s with the reference's parameter names, shapes
(the packed qkv weight ``[3, H, Dh, D]``, linear weights ``(in, out)``)
and initialisers: Xavier-normal weights with the reference's fans
(``nn/initializer.py:24``), zero biases, LayerNorm scales 1 and biases 0,
drawn from the device stream of the port's random state on ``device``
(the card unless ``device="cpu"``).  Weights of the reference carry over
unchanged through
:func:`~paddle_tpu_torch.models.convert.fused_transformer_state_from_paddle_tpu`.
The refusals are the reference's too: ``need_weights``, cross-attention
and an incremental ``cache``.  ``weight_attr`` and ``bias_attr`` take a
:class:`~paddle_tpu_torch.nn.ParamAttr` (or what ``ParamAttr._to_attr``
takes): the weights take ``weight_attr``'s initializer, and the
parameters its name, learning-rate scale, regularizer, clip flag and
trainability, as the reference's ``create_parameter`` gives them; the
LayerNorm parameters take no attribute but the bias-dropout layer's
scale, whose initializer stays 1 (reference :160-165).  The layers stay
torch modules written on torch tensors.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ....core.tensor import Parameter
from ....device import resolve_device
from ....nn.layer_base import apply_param_attr
from ....nn.param_attr import ParamAttr
from ....random import default_generator
from .. import functional as F

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer",
           "FusedBiasDropoutResidualLayerNorm"]


def _fans(shape: Sequence[int]):
    """The reference's fan-in and fan-out of a weight shape."""
    shape = tuple(shape)
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _attr(arg):
    """A fused layer's ``weight_attr`` / ``bias_attr`` as a ParamAttr;
    ``False`` (no parameter) raises, as the fused kernels need them all."""
    attr = ParamAttr._to_attr(arg)
    if attr is False:
        raise ValueError("the fused layers need every parameter: "
                         "weight_attr / bias_attr cannot be False")
    return attr


class _Fused(nn.Module):
    """Parameter creation shared by the fused layers."""

    def __init__(self, device, weight_attr=None, bias_attr=None):
        super().__init__()
        self._device = resolve_device(device)
        self._weight_attr = _attr(weight_attr)
        self._bias_attr = _attr(bias_attr)

    def _param(self, name: str, shape, init: str, attr=None) -> None:
        """Register ``name``: initialised by ``attr``'s initializer where
        it has one (not for the scales of 1), else by ``init``; then the
        attribute's settings on the parameter."""
        t = torch.empty(tuple(shape), dtype=torch.float32,
                        device=self._device)
        with torch.no_grad():
            if attr is not None and attr.initializer is not None and \
                    init != "one":
                t.copy_(attr.initializer(shape, "float32",
                                         device=self._device))
            elif init == "xavier":
                fan_in, fan_out = _fans(shape)
                gen = default_generator.device(self._device)
                t.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                          generator=gen)
            else:
                t.fill_(1.0 if init == "one" else 0.0)
        p = nn.Parameter(t)
        if attr is not None:
            apply_param_attr(Parameter.of(p), attr)
        self.register_parameter(name, p)


class FusedMultiHeadAttention(_Fused):
    """Fused self-attention block (reference :19)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.5,
                 attn_dropout_rate: Optional[float] = 0.5, kdim=None,
                 vdim=None, normalize_before: bool = False,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        if embed_dim <= 0 or num_heads <= 0:
            raise ValueError("embed_dim and num_heads must be positive")
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        if need_weights:
            raise ValueError("need_weights=True is not supported by the "
                             "fused kernel (reference parity)")
        super().__init__(device, weight_attr, bias_attr)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                                  else attn_dropout_rate)
        self.normalize_before = normalize_before
        H, Dh, D = num_heads, self.head_dim, embed_dim
        self._param("qkv_weight", (3, H, Dh, D), "xavier",
                    self._weight_attr)
        self._param("qkv_bias", (3, H, Dh), "zero", self._bias_attr)
        self._param("linear_weight", (D, D), "xavier", self._weight_attr)
        self._param("linear_bias", (D,), "zero", self._bias_attr)
        self._param("pre_ln_scale", (D,), "one")
        self._param("pre_ln_bias", (D,), "zero")
        self._param("ln_scale", (D,), "one")
        self._param("ln_bias", (D,), "zero")

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError("incremental cache not supported")
        if (key is not None and key is not query) or \
                (value is not None and value is not query):
            raise NotImplementedError(
                "the fused kernel only supports self-attention (reference "
                "fused_attention_op parity); pass query alone")
        return F.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            qkv_bias=self.qkv_bias, linear_bias=self.linear_bias,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            training=self.training)


class FusedFeedForward(_Fused):
    """Fused FFN block (reference :77)."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "relu",
                 act_dropout_rate: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, *, device=None):
        super().__init__(device, weight_attr, bias_attr)
        F._activation(activation)
        self.d_model = d_model
        self.dim_feedforward = dim_feedforward
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.normalize_before = normalize_before
        w, b = self._weight_attr, self._bias_attr
        self._param("linear1_weight", (d_model, dim_feedforward), "xavier",
                    w)
        self._param("linear1_bias", (dim_feedforward,), "zero", b)
        self._param("linear2_weight", (dim_feedforward, d_model), "xavier",
                    w)
        self._param("linear2_bias", (d_model,), "zero", b)
        self._param("ln1_scale", (d_model,), "one")
        self._param("ln1_bias", (d_model,), "zero")
        self._param("ln2_scale", (d_model,), "one")
        self._param("ln2_bias", (d_model,), "zero")

    def forward(self, src, cache=None):
        return F.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.activation,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(nn.Module):
    """Encoder layer = fused attention + fused FFN (reference :120)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "relu",
                 attn_dropout_rate: Optional[float] = None,
                 act_dropout_rate: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, *, device=None):
        super().__init__()
        common = dict(normalize_before=normalize_before,
                      weight_attr=weight_attr, bias_attr=bias_attr,
                      device=device)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate), **common)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation,
            act_dropout_rate=(dropout_rate if act_dropout_rate is None
                              else act_dropout_rate), **common)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedBiasDropoutResidualLayerNorm(_Fused):
    """``LayerNorm(residual + dropout(x + bias))`` as a layer (reference
    :147)."""

    def __init__(self, embed_dim: int, dropout_rate: float = 0.5,
                 weight_attr=None, bias_attr=None, epsilon: float = 1e-5,
                 name=None, *, device=None):
        super().__init__(device, weight_attr, bias_attr)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self._param("linear_bias", (embed_dim,), "zero", self._bias_attr)
        self._param("ln_scale", (embed_dim,), "one", self._weight_attr)
        self._param("ln_bias", (embed_dim,), "zero")

    def forward(self, x, residual):
        return F.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self.epsilon, training=self.training)

    def extra_repr(self):
        return f"embed_dim={self.embed_dim}, p={self.dropout_rate}"
