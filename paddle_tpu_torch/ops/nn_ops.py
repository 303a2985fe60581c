"""The Tensor entry points of ``paddle_tpu/ops/nn_misc.py`` and
``paddle_tpu/ops/loss.py`` that the layers call: ``linear`` (:121),
dense ``embedding`` (:28), the dropout family (:72-120), ``bilinear``,
``cosine_similarity``, ``pairwise_distance``,
``scaled_dot_product_attention`` (:183), ``cross_entropy`` (loss :38)
and ``softmax_with_cross_entropy`` (loss :78).

Each dispatches a kernel on torch tensors.  Attention, dropout and cross
entropy dispatch the port's torch-level functions
(``ops/nn_misc.py``, ``ops/loss.py``) under the reference's op names, so
CUDA tensors reach the hand-written flash-attention kernels without a
mask or attention dropout, and their plain math otherwise, exactly as the
port's own layers do; dropout masks come from the port's device streams.
``linear`` keeps paddle's ``[in, out]`` weight layout (``x @ W + b``).

Waiting (``ROADMAP.md`` §A item 5a's rest): the sparse embedding
(``sparse=True`` raises, naming A2) and the rest of the two modules.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import autograd
from ._common import dispatch, t

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "bilinear", "cosine_similarity",
           "pairwise_distance", "scaled_dot_product_attention",
           "cross_entropy", "softmax_with_cross_entropy"]



def _keep(shape, p, device):
    # nn_misc imports amp, which imports this package: bind at call time
    from .nn_misc import _keep as keep
    return keep(shape, p, device)


def linear(x, weight, bias=None, name=None):
    """``x @ W (+ b)`` with ``W`` of shape ``[in, out]``."""
    tensors = [t(x), t(weight)] + ([t(bias)] if bias is not None else [])

    def kernel(a, w, *b):
        return F.linear(a, w.t(), b[0] if b else None)
    return dispatch("linear", kernel, tensors, {})


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    x, weight = t(x), t(weight)
    if sparse and autograd.is_grad_enabled() and not weight.stop_gradient:
        raise NotImplementedError(
            "embedding(sparse=True): the row-sparse (SelectedRows) gradient "
            "is not ported yet (ROADMAP.md A2)")

    def kernel(idx, w):
        out = F.embedding(idx, w)
        if padding_idx is not None and padding_idx >= 0:
            out = out * (idx != padding_idx).unsqueeze(-1).to(out.dtype)
        return out
    return dispatch("embedding", kernel, (x, weight), {})


def _dropout_kernel(a, *, p, axis, mode):
    shape = tuple(a.shape)
    if axis is not None:
        keep_axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in keep_axes else 1 for i, s in enumerate(shape))
    keep = _keep(shape, p, a.device)
    if mode == "upscale_in_train":
        return torch.where(keep, a / (1.0 - p), 0.0).to(a.dtype)
    return torch.where(keep, a, 0.0).to(a.dtype)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    x = t(x)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return dispatch("dropout_infer", lambda a: a * (1.0 - p), (x,),
                            {})
        return x
    return dispatch("dropout", _dropout_kernel, (x,),
                    dict(p=float(p), axis=axis, mode=mode))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    x = t(x)
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805

    def kernel(a):
        keep = _keep(tuple(a.shape), p, a.device)
        q = 1.0 - p
        a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
        b_coef = -a_coef * alpha_p * p
        return a_coef * torch.where(keep, a, alpha_p) + b_coef
    return dispatch("alpha_dropout", kernel, (x,), {})


def bilinear(x1, x2, weight, bias=None, name=None):
    tensors = [t(x1), t(x2), t(weight)] + \
        ([t(bias)] if bias is not None else [])

    def kernel(a, b, w, *bs):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + bs[0] if bs else out
    return dispatch("bilinear", kernel, tensors, {})


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    def kernel(a, b):
        num = torch.sum(a * b, dim=axis)
        den = torch.sqrt(torch.sum(a * a, dim=axis)) * \
            torch.sqrt(torch.sum(b * b, dim=axis))
        return num / torch.clamp_min(den, eps)
    return dispatch("cosine_similarity", kernel, (t(x1), t(x2)), {})


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    def kernel(a, b):
        d = a - b + epsilon
        return torch.pow(torch.sum(torch.pow(torch.abs(d), p), dim=-1,
                                   keepdim=keepdim), 1.0 / p)
    return dispatch("pairwise_distance", kernel, (t(x), t(y)), {})


def _sdpa_kernel(q, k, v, *mask, causal, scale, dropout_p):
    from .nn_misc import scaled_dot_product_attention as sdpa
    return sdpa.__wrapped__(q, k, v, mask[0] if mask else None,
                            dropout_p=dropout_p, is_causal=causal,
                            training=True, scale=scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    """Inputs ``(B, S, H, D)``; ``attn_mask`` additive; without a mask or
    attention dropout, CUDA tensors run the flash-attention kernels."""
    tensors = [t(query), t(key), t(value)]
    if attn_mask is not None:
        tensors.append(t(attn_mask))
    return dispatch("scaled_dot_product_attention", _sdpa_kernel, tensors,
                    dict(causal=bool(is_causal), scale=scale,
                         dropout_p=float(dropout_p) if training else 0.0))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    tensors = [t(input), t(label)] + ([t(weight)] if weight is not None
                                      else [])

    def kernel(x, lbl, *w):
        from .loss import cross_entropy as xent
        return xent.__wrapped__(x, lbl, w[0] if w else None,
                                ignore_index=ignore_index,
                                reduction=reduction, soft_label=soft_label,
                                axis=axis, use_softmax=use_softmax,
                                label_smoothing=label_smoothing)
    return dispatch("cross_entropy", kernel, tensors, {})


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    def kernel(lg, lb):
        sm = torch.softmax(lg, dim=axis)
        logp = torch.log_softmax(lg, dim=axis)
        if soft_label:
            return -torch.sum(lb * logp, dim=axis, keepdim=True), sm
        idx = lb
        if idx.dim() == lg.dim() and idx.shape[axis] == 1:
            idx = idx.squeeze(axis)
        idx = idx.long().unsqueeze(axis)
        picked = torch.gather(logp, axis, idx.clamp_min(0))
        loss = torch.where(idx != ignore_index, -picked,
                           torch.zeros_like(picked))
        return loss, sm
    loss, sm = dispatch("softmax_with_cross_entropy", kernel,
                        (t(logits), t(label)), {})
    return (loss, sm) if return_softmax else loss
