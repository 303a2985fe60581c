"""Transformer layers — the counterpart of
``paddle_tpu/nn/layer/transformer.py`` (:38-395; reference
``python/paddle/nn/layer/transformer.py``): ``MultiHeadAttention`` with
its ``Cache``, ``StaticCache`` and ``FixedCache``, the encoder and decoder
layers and stacks, and ``Transformer``.

Attention goes through
:func:`~paddle_tpu_torch.ops.nn_ops.scaled_dot_product_attention`: with
no mask and no attention dropout, CUDA tensors run the hand-written
flash-attention kernels (rows 1 / 2 forward, rows 6-9 backward), as the
reference's runs its Pallas kernels (:119).  A mask (bool: True attends;
or additive) or attention dropout takes the plain math.
"""
from __future__ import annotations

import collections
import copy

import torch

from ...core.tensor import Tensor, as_tensor, unwrap
from ...ops import activation as _act
from ...ops import creation, manipulation, nn_ops
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool (True attends) or integer mask as an additive float mask; a
    float mask cast to ``dtype``."""
    if attn_mask is None:
        return None
    m = as_tensor(attn_mask)
    a = m._data
    if a.dtype == torch.bool or not a.is_floating_point():
        neg = torch.finfo(torch.float32).min
        return Tensor(torch.where(a.bool(), 0.0, neg).to(dtype))
    return m if a.dtype == dtype else m.astype(dtype)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    #: fixed-capacity decode cache: ``(B, max_length, H, D)`` k/v buffers
    #: and per-row ``lengths``; each step writes at the lengths and masks
    #: the slots past them (inference only).
    FixedCache = collections.namedtuple("FixedCache", ["k", "v", "lengths"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        b, s = x.shape[0], x.shape[1]
        return manipulation.reshape(x, [b, s, self.num_heads, self.head_dim])

    def gen_cache(self, key, value=None, type=None, max_length=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        b = key.shape[0]
        if type == MultiHeadAttention.FixedCache:
            if max_length is None:
                raise ValueError(
                    "FixedCache is pre-allocated: pass max_length "
                    "(prompt + max new tokens)")
            shape = [b, int(max_length), self.num_heads, self.head_dim]
            return self.FixedCache(creation.zeros(shape),
                                   creation.zeros(shape),
                                   creation.zeros([b], dtype="int32"))
        k = creation.zeros([b, 0, self.num_heads, self.head_dim])
        v = creation.zeros([b, 0, self.num_heads, self.head_dim])
        return self.Cache(k, v)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.FixedCache):
            return self._forward_fixed(q, key, value, attn_mask, cache)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = manipulation.concat([cache.k, k], axis=1)
                v = manipulation.concat([cache.v, v], axis=1)
                cache = self.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        out = nn_ops.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(manipulation.reshape(out, [b, s, self.embed_dim]))
        outs = [out]
        if self.need_weights:
            outs.append(None)        # the flash path keeps no probabilities
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def _forward_fixed(self, q, key, value, attn_mask, cache):
        """Write this call's keys and values at each row's ``lengths`` into
        copies of the buffers, and attend over the whole capacity under
        the length mask (composed with ``attn_mask``)."""
        from ...generation.kv_cache import attention_mask, write_kv
        k_new = self._shape(self.k_proj(key))
        v_new = self._shape(self.v_proj(value))
        starts = unwrap(cache.lengths)
        kbuf = write_kv(unwrap(cache.k).detach().clone(),
                        k_new._data.detach(), starts)
        vbuf = write_kv(unwrap(cache.v).detach().clone(),
                        v_new._data.detach(), starts)
        T = q.shape[1]
        mask = attention_mask(starts, T, kbuf.shape[1], dtype=q.dtype)
        user = _convert_attention_mask(attn_mask, q.dtype)
        if user is not None:
            mask = mask + user._data
        out = nn_ops.scaled_dot_product_attention(
            q, Tensor(kbuf), Tensor(vbuf), attn_mask=Tensor(mask),
            dropout_p=self.dropout, training=self.training)
        b = out.shape[0]
        out = self.out_proj(manipulation.reshape(out, [b, T, self.embed_dim]))
        new_cache = self.FixedCache(Tensor(kbuf), Tensor(vbuf),
                                    Tensor(starts + T))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        outs.append(new_cache)
        return tuple(outs)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(_act, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clone_layer(layer):
    """A copy of ``layer`` with copies of its parameter values, as the
    reference (and paddle) deep-copies the stacked layer."""
    return copy.deepcopy(layer)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(_act, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt, static_cache = tgt
            else:
                static_cache = cache[1]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        from ...ops._common import device
        allow = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                      device=device()))
        neg = torch.finfo(torch.float32).min
        return Tensor(torch.where(allow, 0.0, neg).to(torch.float32))
