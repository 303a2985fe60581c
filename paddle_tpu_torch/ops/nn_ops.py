"""The Tensor entry points of ``paddle_tpu/ops/nn_misc.py`` and
``paddle_tpu/ops/loss.py``: ``linear`` (:121), ``embedding`` (:28), the
dropout family (:72-120), ``bilinear``, ``cosine_similarity``,
``pairwise_distance``, ``scaled_dot_product_attention`` (:183),
``sparse_attention`` (:203), ``sequence_mask`` ... ``nce`` (:236-428;
``class_center_sample`` raises, as the reference's), and every loss of
``loss.py`` (``cross_entropy`` :38, ``softmax_with_cross_entropy`` :78,
``one_hot`` ... ``margin_cross_entropy``).

Each dispatches a kernel on torch tensors.  Attention, dropout and the
losses dispatch the port's torch-level functions
(``ops/nn_misc.py``, ``ops/loss.py``) under the reference's op names, so
CUDA tensors reach the hand-written flash-attention kernels without a
mask or attention dropout, and their plain math otherwise, exactly as the
port's own layers do, and AMP casts each by its reference op; dropout
masks come from the port's device streams.  ``sparse_attention`` is the
reference's plain math (a dense product with the CSR pattern as a mask),
on the card too.  ``nce`` draws its negatives on the host from
``np.random.RandomState(seed)``, as the reference does, so with a
``seed`` it equals the reference; without one the seed comes from the
port's generator.
``linear`` keeps paddle's ``[in, out]`` weight layout (``x @ W + b``).

``embedding(sparse=True)`` gives the weight a row-sparse gradient
(torch's sparse embedding backward, read as a
:class:`~paddle_tpu_torch.core.selected_rows.SelectedRows`; the
reference's :28-69), with one row per id: padding ids keep their rows,
with zero values, as the reference keeps them.  Inside
:func:`dense_embedding` (``Model(jit=True)``'s steps, which the reference
traces) it takes the dense gradient, as the reference does for a traced
weight (:39-40).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ._common import dispatch, t

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "bilinear", "cosine_similarity",
           "pairwise_distance", "scaled_dot_product_attention",
           "cross_entropy", "softmax_with_cross_entropy",
           # the rest of the reference's loss.py
           "one_hot", "mse_loss", "square_error_cost", "l1_loss",
           "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div", "smooth_l1_loss",
           "huber_loss", "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "label_smooth",
           "sigmoid_focal_loss", "log_loss", "ctc_loss", "dice_loss",
           "hsigmoid_loss", "margin_cross_entropy",
           # the rest of the reference's nn_misc.py
           "sequence_mask", "diag_embed", "affine_channel", "npair_loss",
           "temporal_shift", "class_center_sample", "sparse_attention",
           "nce"]

_dense = threading.local()


@contextlib.contextmanager
def dense_embedding():
    """Within the block ``embedding(sparse=True)`` takes the dense
    gradient (this thread)."""
    was = getattr(_dense, "on", False)
    _dense.on = True
    try:
        yield
    finally:
        _dense.on = was


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
    """Rows of ``weight`` at the ids ``x``, zero at ``padding_idx``; with
    ``sparse`` the weight's gradient is row-sparse (the module
    docstring)."""
    x, weight = t(x), t(weight)
    sparse = bool(sparse) and not getattr(_dense, "on", False)

    def kernel(idx, w):
        # padding_idx is not given to torch, whose sparse gradient would
        # drop those ids: the mask below zeroes their rows and values
        out = F.embedding(idx.long() if sparse else idx, w, sparse=sparse)
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
        return _losses().softmax_with_cross_entropy.__wrapped__(
            lg, lb, soft_label=soft_label, ignore_index=ignore_index,
            axis=axis)
    loss, sm = dispatch("softmax_with_cross_entropy", kernel,
                        (t(logits), t(label)), {})
    return (loss, sm) if return_softmax else loss


# -- the rest of the losses (``paddle_tpu/ops/loss.py:33-441``) -------------
def _call(op_name, fn, args, **kw):
    """Dispatch the torch-level ``fn`` (an ``ops/loss.py`` function runs
    unwrapped: the dispatch casts under AMP) on ``args``, its tensor
    arguments in order, None where one is not given."""
    given = [i for i, a in enumerate(args) if a is not None]
    fn = getattr(fn, "__wrapped__", fn)

    def kernel(*arrays):
        full = [None] * len(args)
        for i, a in zip(given, arrays):
            full[i] = a
        return fn(*full, **kw)
    return dispatch(op_name, kernel, [t(args[i]) for i in given], {})


def _losses():
    from . import loss
    return loss


def one_hot(x, num_classes, name=None):
    return dispatch("one_hot", lambda a: _losses().one_hot(a, num_classes),
                    (t(x),), {})


def mse_loss(input, label, reduction="mean", name=None):
    return _call("mse_loss", _losses().mse_loss, (input, label),
                 reduction=reduction)


def square_error_cost(input, label):
    return _call("square_error_cost", _losses().square_error_cost,
                 (input, label))


def l1_loss(input, label, reduction="mean", name=None):
    return _call("l1_loss", _losses().l1_loss, (input, label),
                 reduction=reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    return _call("nll_loss", _losses().nll_loss, (input, label, weight),
                 ignore_index=ignore_index, reduction=reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    return _call("bce", _losses().binary_cross_entropy,
                 (input, label, weight), reduction=reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    fn = _losses().binary_cross_entropy_with_logits.__wrapped__

    def kernel(z, y, w, pw):
        return fn(z, y, w, reduction=reduction, pos_weight=pw)
    return _call("bce_with_logits", kernel, (logit, label, weight,
                                              pos_weight))


def kl_div(input, label, reduction="mean", name=None):
    return _call("kl_div", _losses().kl_div, (input, label),
                 reduction=reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return _call("smooth_l1", _losses().smooth_l1_loss, (input, label),
                 reduction=reduction, delta=delta)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    return _call("huber_loss", _losses().huber_loss, (input, label),
                 delta=delta, reduction=reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _call("margin_ranking", _losses().margin_ranking_loss,
                 (input, other, label), margin=margin, reduction=reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _call("hinge_embedding", _losses().hinge_embedding_loss,
                 (input, label), margin=margin, reduction=reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    return _call("cosine_embedding", _losses().cosine_embedding_loss,
                 (input1, input2, label), margin=margin, reduction=reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-06, swap=False, reduction="mean",
                        name=None):
    return _call("triplet_margin", _losses().triplet_margin_loss,
                 (input, positive, negative), margin=margin, p=p,
                 epsilon=epsilon, swap=swap, reduction=reduction)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _call("label_smooth", _losses().label_smooth,
                 (label, prior_dist), epsilon=epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    return _call("sigmoid_focal", _losses().sigmoid_focal_loss,
                 (logit, label, normalizer), alpha=alpha, gamma=gamma,
                 reduction=reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _call("log_loss", _losses().log_loss, (input, label),
                 epsilon=epsilon)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC as the reference computes it (``ops/loss.py``'s
    ``ctc_loss``: a log-softmax first, log(0) as -1e5, a plain mean)."""
    return _call("ctc_loss", _losses().ctc_loss,
                 (log_probs, labels, input_lengths, label_lengths),
                 blank=blank, reduction=reduction,
                 norm_by_times=norm_by_times)


def dice_loss(input, label, epsilon=1e-5, name=None):
    return _call("dice_loss", _losses().dice_loss, (input, label),
                 epsilon=epsilon)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss; ``path_table`` / ``path_code`` (custom
    tree) are read as they are, without a gradient."""
    loss = _losses()
    table = None if path_table is None else t(path_table)._data
    code = None if path_code is None else t(path_code)._data

    def fn(x, y, w, b):
        return loss.hsigmoid_loss.__wrapped__(
            x, y, num_classes, w, b, path_table=table, path_code=code)
    return _call("hsigmoid_loss", fn, (input, label, weight, bias))


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    return _call("margin_cross_entropy", _losses().margin_cross_entropy,
                 (logits, label), margin1=margin1, margin2=margin2,
                 margin3=margin3, scale=scale,
                 return_softmax=return_softmax, reduction=reduction)


# -- the rest of ``paddle_tpu/ops/nn_misc.py`` (:203-428) --------------------
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]``; ``maxlen`` defaults to ``max(x)``
    (read on the host, as the reference reads it)."""
    from .creation import _dt
    x = t(x)
    if maxlen is None:
        maxlen = int(x._data.max().item())
    rng = torch.arange(int(maxlen), device=x._data.device)
    return dispatch("sequence_mask", lambda a: (rng < a.unsqueeze(-1)).to(
        _dt(dtype)), (x,), {})


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    return dispatch("diag_embed", lambda a: torch.diag_embed(
        a, offset, dim1, dim2), (t(input),), {})


def affine_channel(x, scale, bias, data_layout="NCHW", name=None):
    """Per-channel ``x · scale + bias`` (reference ``affine_channel_op``)."""
    def kernel(a, s, b):
        if data_layout in ("NCHW", "NCDHW"):
            shape = (1, -1) + (1,) * (a.dim() - 2)
        else:
            shape = (1,) * (a.dim() - 1) + (-1,)
        return a * s.reshape(shape) + b.reshape(shape)
    return dispatch("affine_channel", kernel, (t(x), t(scale), t(bias)), {})


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def kernel(a, p, y):
        y = y.reshape(-1, 1)
        same = (y == y.t()).to(a.dtype)
        same = same / torch.sum(same, dim=1, keepdim=True)
        logp = torch.log_softmax(a @ p.t(), dim=1)
        ce = -torch.mean(torch.sum(same * logp, dim=1))
        reg = l2_reg * (torch.mean(torch.sum(torch.square(a), dim=1))
                        + torch.mean(torch.sum(torch.square(p), dim=1))) \
            * 0.25
        return ce + reg
    return dispatch("npair_loss", kernel, (t(anchor), t(positive),
                                           t(labels)), {})


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """Shift a ``shift_ratio`` share of the channels one segment back and
    as many one segment forward (reference ``temporal_shift_op``)."""
    def kernel(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        nt, c, h, w = a.shape
        a = a.reshape(nt // seg_num, seg_num, c, h, w)
        fold = int(c * shift_ratio)
        left = torch.cat([a[:, 1:, :fold],
                          torch.zeros_like(a[:, :1, :fold])], dim=1)
        right = torch.cat([torch.zeros_like(a[:, :1, fold:2 * fold]),
                           a[:, :-1, fold:2 * fold]], dim=1)
        out = torch.cat([left, right, a[:, :, 2 * fold:]], dim=2).reshape(
            nt, c, h, w)
        return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
    return dispatch("temporal_shift", kernel, (t(x),), {})


def class_center_sample(label, num_classes, num_samples, group=None):
    raise NotImplementedError(
        "class_center_sample: PS-style sampled softmax is not implemented "
        "(the reference raises too)")


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Block-sparse attention (reference ``sparse_attention_op``) as the
    reference computes it: dense attention over (B, H, S, D) with the CSR
    pattern as a mask (built on the host), in plain math on the card too."""
    offs = t(sparse_csr_offset)._data.reshape(-1).cpu().numpy()
    cols = t(sparse_csr_columns)._data.reshape(-1).cpu().numpy()

    def kernel(q, k, v):
        s, d = q.shape[2], q.shape[3]
        allow = np.zeros((s, s), dtype=bool)
        for i in range(s):
            allow[i, cols[offs[i]:offs[i + 1]]] = True
        allow = torch.as_tensor(allow, device=q.device)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / float(np.sqrt(d))
        logits = logits.masked_fill(~allow, torch.finfo(logits.dtype).min)
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v)
    return dispatch("sparse_attention", kernel, (t(query), t(key), t(value)),
                    {})


def _nce_samples(lab, N, V, num_neg, sampler, custom_dist, seed):
    """The reference's host-side sampling (``nce_op.h``): the true labels
    and ``num_neg`` negatives a row from ``np.random.RandomState(seed)``,
    and each sample's ``q = P_sampler(c) · num_neg``."""
    rng = np.random.RandomState(seed)
    if sampler == "uniform":
        negs = rng.randint(0, V, size=(N, num_neg))

        def q(c):
            return np.full(c.shape, 1.0 / V)
    elif sampler == "log_uniform":
        u = rng.rand(N, num_neg)
        negs = np.clip((np.exp(u * np.log(V + 1.0)) - 1.0).astype(np.int64),
                       0, V - 1)

        def q(c):
            c = c.astype(np.float64)
            return np.log((c + 2.0) / (c + 1.0)) / np.log(V + 1.0)
    elif sampler == "custom_dist":
        probs = np.asarray(custom_dist, np.float64)
        probs = probs / probs.sum()
        negs = np.stack([rng.choice(V, size=num_neg, p=probs)
                         for _ in range(N)])

        def q(c):
            return probs[c]
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    samples = np.concatenate([lab, negs], axis=1)
    return samples, (q(samples) * num_neg).astype(np.float32)


def nce(input, label, weight, bias=None, num_total_classes=None,
        num_neg_samples=10, sampler="uniform", sample_weight=None,
        custom_dist=None, seed=None, name=None):
    """Noise-contrastive estimation (reference ``nce_op.h``): per row the
    true class(es) and ``num_neg_samples`` negatives drawn on the host,
    ``o = sigmoid(x · w_c + b_c)``, cost ``-log(o / (o + q))`` for a true
    class and ``-log(q / (o + q))`` for a negative; (N, 1).  With ``seed``
    the draws are ``np.random.RandomState(seed)``'s, the reference's; without
    one the seed comes from the port's generator."""
    from ..random import default_generator
    input, weight = t(input), t(weight)
    N = int(input.shape[0])
    lab = t(label)._data.cpu().numpy().reshape(N, -1)
    V = int(num_total_classes if num_total_classes is not None
            else weight.shape[0])
    if seed is None:
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=
                                 default_generator.device("cpu")))
    samples, qv = _nce_samples(lab, N, V, num_neg_samples, sampler,
                               custom_dist, seed)
    num_true = lab.shape[1]
    dev = input._data.device
    idx = torch.as_tensor(samples, device=dev).long()
    q = torch.as_tensor(qv, device=dev)

    def kernel(x, w, b, sw):
        logits = torch.einsum("nd,nsd->ns", x, w[idx])
        if b is not None:
            logits = logits + b[idx]
        o = torch.sigmoid(logits)
        qq = q.to(o.dtype)
        cost = torch.sum(-torch.log(o[:, :num_true] / (
            o[:, :num_true] + qq[:, :num_true])), dim=1) + torch.sum(
            -torch.log(qq[:, num_true:] / (o[:, num_true:]
                                           + qq[:, num_true:])), dim=1)
        if sw is not None:
            cost = cost * sw.reshape(-1)
        return cost.reshape(-1, 1)
    return _call("nce", kernel, (input, weight, bias, sample_weight))
