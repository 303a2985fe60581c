"""Normalization ops — the counterpart of ``paddle_tpu/ops/norm_ops.py``.

``layer_norm`` is ``F.layer_norm`` (one kernel on the card); the others
keep the reference's formulas.  ``batch_norm`` in training writes the
new running statistics into its ``running_mean`` / ``running_var``
tensors in place (under no_grad), as the reference rebinds them, so a
``Layer``'s buffers stay the same tensors (and a captured step updates
them at every replay).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import dispatch, t

__all__ = ["layer_norm", "batch_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize", "rms_norm"]


def _affine(out, wb, has_w, has_b, bshape=None):
    i = 0
    if has_w:
        w = wb[i]
        out = out * (w.reshape(bshape) if bshape else w)
        i += 1
    if has_b:
        b = wb[i]
        out = out + (b.reshape(bshape) if bshape else b)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    x = t(x)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = tuple(int(s) for s in normalized_shape)
    has_w, has_b = weight is not None, bias is not None
    tensors = [x] + ([t(weight)] if has_w else []) + \
        ([t(bias)] if has_b else [])

    def kernel(a, *wb):
        w = wb[0] if has_w else None
        b = wb[-1] if has_b else None
        return F.layer_norm(a, shape, w, b, epsilon)
    return dispatch("layer_norm", kernel, tensors, {})


def rms_norm(x, weight=None, epsilon=1e-06, name=None):
    x = t(x)
    tensors = [x] + ([t(weight)] if weight is not None else [])

    def kernel(a, *w):
        ms = torch.mean(torch.square(a), dim=-1, keepdim=True)
        out = a * torch.rsqrt(ms + epsilon)
        return out * w[0] if w else out
    return dispatch("rms_norm", kernel, tensors, {})


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    x, rm, rv = t(x), t(running_mean), t(running_var)
    channel_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    red = tuple(i for i in range(x.ndim) if i != channel_axis)
    if use_global_stats is None:
        use_global_stats = not training
    has_w, has_b = weight is not None, bias is not None
    tensors = [x, rm, rv] + ([t(weight)] if has_w else []) + \
        ([t(bias)] if has_b else [])
    bshape = [1] * x.ndim
    bshape[channel_axis] = x.shape[channel_axis]

    def kernel(a, mean_r, var_r, *wb):
        if use_global_stats:
            mu, var = mean_r, var_r
        else:
            mu = torch.mean(a, dim=red)
            var = torch.var(a, dim=red, correction=0)
        out = (a - mu.reshape(bshape)) * torch.rsqrt(
            var.reshape(bshape) + epsilon)
        return _affine(out, wb, has_w, has_b, bshape)

    out = dispatch("batch_norm", kernel, tensors, {})
    if training and not use_global_stats:
        with torch.no_grad():
            a = x._data.detach()
            rm._data.mul_(momentum).add_(
                (1.0 - momentum) * torch.mean(a, dim=red).to(rm.dtype))
            rv._data.mul_(momentum).add_(
                (1.0 - momentum) * torch.var(a, dim=red, correction=0
                                             ).to(rv.dtype))
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9,
                  eps=1e-05, data_format="NCHW", name=None):
    x = t(x)
    channel_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    red = tuple(range(2, x.ndim)) if channel_axis == 1 else \
        tuple(range(1, x.ndim - 1))
    has_w, has_b = weight is not None, bias is not None
    tensors = [x] + ([t(weight)] if has_w else []) + \
        ([t(bias)] if has_b else [])
    bshape = [1] * x.ndim
    bshape[channel_axis] = x.shape[channel_axis]

    def kernel(a, *wb):
        mu = torch.mean(a, dim=red, keepdim=True)
        var = torch.var(a, dim=red, keepdim=True, correction=0)
        out = (a - mu) * torch.rsqrt(var + eps)
        return _affine(out, wb, has_w, has_b, bshape)
    return dispatch("instance_norm", kernel, tensors, {})


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    x = t(x)
    has_w, has_b = weight is not None, bias is not None
    tensors = [x] + ([t(weight)] if has_w else []) + \
        ([t(bias)] if has_b else [])
    channel_last = not data_format.startswith("NC")

    def kernel(a, *wb):
        a_t = torch.movedim(a, -1, 1) if channel_last else a
        n, c = a_t.shape[:2]
        grouped = a_t.reshape(n, num_groups, c // num_groups,
                              *a_t.shape[2:])
        red = tuple(range(2, grouped.dim()))
        mu = torch.mean(grouped, dim=red, keepdim=True)
        var = torch.var(grouped, dim=red, keepdim=True, correction=0)
        out = ((grouped - mu) * torch.rsqrt(var + epsilon)).reshape(
            a_t.shape)
        out = _affine(out, wb, has_w, has_b, [1, c] + [1] * (a_t.dim() - 2))
        return torch.movedim(out, 1, -1) if channel_last else out
    return dispatch("group_norm", kernel, tensors, {})


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    def kernel(a):
        sq = torch.square(a)
        ch = 1 if data_format.startswith("NC") else a.dim() - 1
        half = size // 2
        c = a.shape[ch]
        pads = [0, 0] * a.dim()
        pos = 2 * (a.dim() - 1 - ch)
        pads[pos], pads[pos + 1] = half, size - half - 1
        padded = F.pad(sq, pads)
        acc = torch.zeros_like(a)
        for i in range(size):
            acc = acc + torch.narrow(padded, ch, i, c)
        return a / torch.pow(k + alpha * acc / size, beta)
    return dispatch("local_response_norm", kernel, (t(x),), {})


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def kernel(a):
        nrm = torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=axis,
                                  keepdim=True), 1.0 / p)
        return a / torch.clamp_min(nrm, epsilon)
    return dispatch("normalize", kernel, (t(x),), {})
