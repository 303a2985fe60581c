"""The losses on torch tensors — the counterpart of
``paddle_tpu/ops/loss.py`` in plain PyTorch (the reference has no Pallas
kernel here): ``cross_entropy`` (:38), ``softmax_with_cross_entropy``
(:78) and the rest, :33-441 (``one_hot``, ``mse_loss`` ...
``margin_cross_entropy``).  The Tensor entry points the layers and users
call are ``ops/nn_ops.py``'s.

Cross entropy's semantics are the reference's: hard labels of shape
``(…, 1)`` or ``(…)`` (or soft labels with ``soft_label=True``),
``ignore_index`` rows counted as zero loss and left out of the
``"mean"`` (which divides by the summed weights of the valid rows,
:69-73), per-class ``weight``, and ``label_smoothing`` mixing the one-hot
target with the uniform one.  Its log-softmax runs in fp32.  A hard label
picks its log-probability by gather instead of a one-hot product, which
is the same sum with the zero terms left out and needs no ``(…, V)``
target tensor.  The other losses run in their input's type, as the
reference computes them; ``ctc_loss`` is the reference's
``optax.ctc_loss`` recursion (a log-softmax first, log(0) as
:data:`CTC_LOG_EPSILON`, a plain mean), not ``F.ctc_loss``.  Under
:func:`~paddle_tpu_torch.amp.auto_cast` each is its reference op
(:func:`~paddle_tpu_torch.amp.amp_op`): cross entropy, the BCEs, NLL,
KL and MSE are black-list ops, cast to fp32.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..amp import amp_op

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "one_hot", "mse_loss", "square_error_cost",
           "l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div", "smooth_l1_loss",
           "huber_loss", "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "label_smooth",
           "sigmoid_focal_loss", "log_loss", "ctc_loss", "dice_loss",
           "hsigmoid_loss", "margin_cross_entropy", "CTC_LOG_EPSILON"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none'; got "
                     f"{reduction!r}")


@amp_op("cross_entropy")
def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross entropy of ``input`` (logits, or probabilities when
    ``use_softmax=False``) against ``label``, reduced by ``reduction``."""
    x = input.float()
    logp = torch.log_softmax(x, dim=axis) if use_softmax else \
        torch.log(x.clamp_min(1e-30))
    nclass = logp.shape[axis]
    if soft_label:
        soft = label.to(logp.dtype)
        if label_smoothing > 0.0:
            soft = soft * (1.0 - label_smoothing) + label_smoothing / nclass
        return _reduce(-(soft * logp).sum(dim=axis), reduction)

    idx = label
    if idx.dim() == logp.dim() and idx.shape[axis] == 1:
        idx = idx.squeeze(axis)
    idx = idx.long()
    valid = idx != ignore_index
    safe = idx.clamp(0, nclass - 1)
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    # a label outside [0, nclass) has an all-zero one-hot in the reference
    in_range = (idx >= 0) & (idx < nclass)
    loss = -torch.where(in_range, picked, torch.zeros_like(picked))
    if label_smoothing > 0.0:
        loss = loss * (1.0 - label_smoothing) \
            - logp.sum(dim=axis) * (label_smoothing / nclass)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    w = None if weight is None else weight.to(loss.device, loss.dtype)[safe]
    if w is not None:
        loss = loss * w
    if reduction == "mean":
        denom = (w if w is not None else torch.ones_like(loss)) * valid
        return loss.sum() / denom.sum().clamp_min(1e-12)
    return _reduce(loss, reduction)


@amp_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1):
    """``(loss, softmax)``: the loss keeps ``axis`` (size 1), and a hard
    label equal to ``ignore_index`` has loss 0 (the reference's :78)."""
    sm = torch.softmax(logits, dim=axis)
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        return -torch.sum(label * logp, dim=axis, keepdim=True), sm
    idx = label
    if idx.dim() == logits.dim() and idx.shape[axis] == 1:
        idx = idx.squeeze(axis)
    idx = idx.long().unsqueeze(axis)
    picked = torch.gather(logp, axis, idx.clamp_min(0))
    return torch.where(idx != ignore_index, -picked,
                       torch.zeros_like(picked)), sm


# -- the rest of the reference's losses (``paddle_tpu/ops/loss.py:33-441``),
# each in its input's type, as the reference computes it -------------------
def one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """fp32 one-hot rows of the ids ``x``; an id outside [0,
    num_classes) gives a row of zeros (the reference's ``jax.nn.one_hot``)."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long().unsqueeze(-1) == classes).to(torch.float32)


@amp_op("mse_loss")
def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


@amp_op("square_error_cost")
def square_error_cost(input, label):
    return torch.square(input - label)


@amp_op("l1_loss")
def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


def _picked(x, idx, dim):
    """``x``'s entries at ``idx`` along ``dim`` (0 where ``idx`` is out of
    range: the reference's one-hot product), and the clamped ids."""
    n = x.shape[dim]
    idx = idx.long()
    safe = idx.clamp(0, n - 1)
    got = x.gather(dim, safe.unsqueeze(dim)).squeeze(dim)
    return torch.where((idx >= 0) & (idx < n), got, torch.zeros_like(got)), \
        safe


@amp_op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """``-input[label]`` along axis 1, weighted, ``ignore_index`` left out
    of the loss and of the ``"mean"``'s weight sum."""
    picked, safe = _picked(input, label, 1)
    loss = -picked
    valid = label != ignore_index
    wgt = weight[safe] if weight is not None else torch.ones_like(loss)
    loss = torch.where(valid, loss * wgt, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / (wgt * valid).sum().clamp_min(1e-12)
    return _reduce(loss, reduction)


@amp_op("bce")
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    p = input.clamp(1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _softplus(x):
    """``log(1 + e^x)`` as JAX's ``softplus`` (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@amp_op("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    log_sig_pos = -_softplus(-logit)
    log_sig_neg = -logit - _softplus(-logit)
    pos = label * log_sig_pos if pos_weight is None else \
        pos_weight * label * log_sig_pos
    loss = -(pos + (1 - label) * log_sig_neg)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("kl_div")
def kl_div(input, label, reduction="mean"):
    loss = label * (torch.log(label.clamp_min(1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@amp_op("smooth_l1")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = torch.abs(input - label)
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


@amp_op("huber_loss")
def huber_loss(input, label, delta=1.0, reduction="mean"):
    d = torch.abs(input - label)
    return _reduce(torch.where(d <= delta, 0.5 * d * d,
                               delta * (d - 0.5 * delta)), reduction)


@amp_op("margin_ranking")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


@amp_op("hinge_embedding")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0.0)),
                   reduction)


@amp_op("cosine_embedding")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = torch.sum(input1 * input2, dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0.0)),
                   reduction)


@amp_op("triplet_margin")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def dist(u, v):
        return torch.pow(torch.sum(torch.pow(torch.abs(u - v) + epsilon, p),
                                   dim=-1), 1.0 / p)
    d_ap, d_an = dist(input, positive), dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0.0), reduction)


@amp_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1):
    uniform = prior_dist if prior_dist is not None else \
        1.0 / label.shape[-1]
    return (1.0 - epsilon) * label + epsilon * uniform


@amp_op("sigmoid_focal")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = _softplus(-logit) * label + _softplus(logit) * (1 - label)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@amp_op("log_loss")
def log_loss(input, label, epsilon=1e-4):
    return -label * torch.log(input + epsilon) - \
        (1 - label) * torch.log(1 - input + epsilon)


CTC_LOG_EPSILON = -1e5


@amp_op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``log_probs`` (T, N, C) as the reference computes it
    (``optax.ctc_loss``, :310-329): its input goes through a log-softmax,
    log(0) is ``CTC_LOG_EPSILON`` (an impossible alignment gives a large
    finite loss, not ``inf``), and ``"mean"`` is the plain mean of the
    per-sequence losses (``F.ctc_loss``'s divides by the label lengths
    first).  The forward recursion over time, in plain torch."""
    eps = CTC_LOG_EPSILON
    logprobs = torch.log_softmax(log_probs.transpose(0, 1), dim=-1)
    B, T, _ = logprobs.shape
    labels = labels.long()
    N = labels.shape[1]
    dt = logprobs.dtype
    pad = (torch.arange(T, device=logprobs.device)[None, :]
           >= input_lengths.reshape(-1, 1)).to(dt)
    repeat = torch.nn.functional.pad(
        (labels[:, :-1] == labels[:, 1:]).to(dt), (0, 1))
    phi_lp = logprobs[:, :, blank].transpose(0, 1).unsqueeze(-1)  # T,B,1
    emit_lp = logprobs.gather(2, labels.unsqueeze(1).expand(B, T, N)) \
        .transpose(0, 1)                                           # T,B,N

    def add_phi(phi, score):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)],
                         dim=-1)
    phi = torch.full((B, N + 1), eps, dtype=dt, device=logprobs.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=-1)
    emit = torch.full((B, N), eps, dtype=dt, device=logprobs.device)
    for t in range(T):
        phi_orig = phi
        phi = add_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(phi[:, :-1] + emit_lp[t],
                                    emit + emit_lp[t])
        next_phi = add_phi(phi + phi_lp[t],
                           emit + phi_lp[t] + eps * (1.0 - repeat))
        p = pad[:, t:t + 1]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * phi_orig + (1.0 - p) * next_phi
    last = add_phi(phi, emit)
    lens = (torch.arange(N, device=logprobs.device)[None, :]
            < label_lengths.reshape(-1, 1)).sum(1)
    per_seq = -last.gather(1, lens.reshape(-1, 1)).squeeze(1)
    return _reduce(per_seq, reduction)


@amp_op("dice_loss")
def dice_loss(input, label, epsilon=1e-5):
    """The dice loss of probabilities ``input`` (N, ..., C) against class
    ids ``label`` (N, ..., 1)."""
    oh = one_hot(label.squeeze(-1), input.shape[-1]).to(input.dtype)
    p2, y2 = input.reshape(input.shape[0], -1), oh.reshape(oh.shape[0], -1)
    inter = torch.sum(p2 * y2, dim=1)
    union = torch.sum(p2, dim=1) + torch.sum(y2, dim=1)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


@functools.lru_cache(maxsize=64)
def _complete_tree_paths(num_classes: int):
    """(table, code, valid) of the complete binary tree over
    ``num_classes`` leaves, numpy (the reference's ``_complete_tree_paths``,
    :393): internal nodes 1..C-1 are weight rows 0..C-2; shallow leaves
    have shorter, masked paths."""
    C = max(int(num_classes), 2)
    depth = max(1, int(np.ceil(np.log2(C))))
    node = np.arange(C, dtype=np.int64) + C
    tbl = np.zeros((C, depth), np.int32)
    code = np.zeros((C, depth), np.float32)
    valid = np.zeros((C, depth), np.float32)
    for d in range(depth):
        active = node > 1
        parent = node // 2
        tbl[:, d] = np.where(active, parent - 1, 0)
        code[:, d] = np.where(active, node % 2, 0).astype(np.float32)
        valid[:, d] = active.astype(np.float32)
        node = np.where(active, parent, node)
    return tbl, code, valid


@amp_op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None):
    """Hierarchical sigmoid over the complete binary tree of
    ``num_classes`` leaves, or the custom tree of ``path_table`` /
    ``path_code``: the sigmoid cross entropy at every live level of each
    label's path, summed, averaged over the batch."""
    dev = input.device
    if path_table is None:
        tbl, code, valid = (torch.as_tensor(a, device=dev)
                            for a in _complete_tree_paths(int(num_classes)))
    else:
        tbl = path_table.to(dev)
        code = path_code.to(dev, torch.float32)
        valid = torch.ones_like(code)
    y = label.reshape(-1).long()
    nodes, codes, live = tbl[y].long(), code[y], valid[y]
    logits = torch.einsum("nd,nkd->nk", input, weight[nodes])
    if bias is not None:
        logits = logits + bias.reshape(-1)[nodes]
    ce = torch.clamp_min(logits, 0) - logits * codes + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return torch.mean(torch.sum(ce * live, dim=1))


@amp_op("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False,
                         reduction="mean"):
    """ArcFace / CosFace margins on the target cosine, ``cos(m1·θ + m2) -
    m3``, then cross entropy of the scaled logits; the loss is (N, 1)
    with ``reduction="none"``."""
    y = label.reshape(-1).long().unsqueeze(1)
    theta = torch.arccos(logits.clamp(-1.0, 1.0))
    adjusted = torch.cos(margin1 * theta.gather(1, y) + margin2) - margin3
    scaled = logits.scatter(1, y, adjusted) * scale
    nll = -torch.log_softmax(scaled, dim=-1).gather(1, y)
    loss = nll.mean() if reduction == "mean" else \
        nll.sum() if reduction == "sum" else nll
    return (loss, torch.softmax(scaled, dim=-1)) if return_softmax else loss
