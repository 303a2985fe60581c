"""Reductions and scans — the counterpart of
``paddle_tpu/ops/reduction.py``.

Result types follow the reference with x64 off: sums, products and scans
of integers stay int32 (torch widens them to int64), a mean of integers
is float32, and index results are int32.  ``median`` averages the two
middle values, as ``jnp.median`` does (torch's returns the lower one).
The ops the reference computes outside its tape (``all``, ``any``,
``argmax``, ``argmin``, ``count_nonzero``, ``kthvalue``, ``mode``) record
no gradient here either.
"""
from __future__ import annotations

import builtins

import torch

from ._common import INT, axes, dispatch, int_result, no_grad_dispatch, t

__all__ = [
    "sum", "mean", "max", "min", "prod", "all", "any", "argmax", "argmin",
    "cumsum", "cumprod", "logsumexp", "logcumsumexp", "amax", "amin",
    "nansum", "nanmean", "count_nonzero", "median", "quantile", "std",
    "var", "kthvalue", "mode",
]


def _dims(a, ax):
    """``ax`` as torch's reduction dims (every dim when None)."""
    if ax is None:
        return tuple(range(a.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def _cast_out(out, a, dtype):
    from ..core.dtype import dtype_to_torch
    if dtype is not None:
        return out.to(dtype_to_torch(dtype))
    return int_result(out, a)


def _sum(a, ax, keepdim):
    return torch.sum(a, dim=_dims(a, ax), keepdim=keepdim)


def _prod(a, ax, keepdim):
    out = a
    for d in sorted((d % builtins.max(a.dim(), 1) for d in _dims(a, ax)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _mean(a, ax, keepdim):
    if not (a.is_floating_point() or a.is_complex()):
        a = a.to(torch.float32)
    return torch.mean(a, dim=_dims(a, ax), keepdim=keepdim)


def _amax(a, ax, keepdim):
    return torch.amax(a, dim=_dims(a, ax), keepdim=keepdim)


def _amin(a, ax, keepdim):
    return torch.amin(a, dim=_dims(a, ax), keepdim=keepdim)


def _nansum(a, ax, keepdim):
    return torch.nansum(a, dim=_dims(a, ax), keepdim=keepdim)


def _nanmean(a, ax, keepdim):
    if not a.is_floating_point():
        a = a.to(torch.float32)
    return torch.nanmean(a, dim=_dims(a, ax), keepdim=keepdim)


def _reduce(op_name, fn):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        x = t(x)
        ax = axes(axis)

        def kernel(a):
            return _cast_out(fn(a, ax, keepdim), a, dtype)
        return dispatch(op_name, kernel, (x,), {})
    op.__name__ = op.__qualname__ = op_name
    return op


sum = _reduce("reduce_sum", _sum)
mean = _reduce("reduce_mean", _mean)
prod = _reduce("reduce_prod", _prod)
amax = _reduce("reduce_amax", _amax)
amin = _reduce("reduce_amin", _amin)
nansum = _reduce("nansum", _nansum)
nanmean = _reduce("nanmean", _nanmean)
max = _reduce("reduce_max", _amax)
min = _reduce("reduce_min", _amin)


def all(x, axis=None, keepdim=False, name=None):
    ax = axes(axis)
    return no_grad_dispatch(
        "all", lambda a: torch.all(a.bool(), dim=_dims(a, ax),
                                   keepdim=keepdim), (t(x),))


def any(x, axis=None, keepdim=False, name=None):
    ax = axes(axis)
    return no_grad_dispatch(
        "any", lambda a: torch.any(a.bool(), dim=_dims(a, ax),
                                   keepdim=keepdim), (t(x),))


def _arg(fn, op_name, x, axis, keepdim, dtype):
    from ..core.dtype import dtype_to_torch
    ax = axes(axis)
    dt = dtype_to_torch(dtype)

    def kernel(a):
        return fn(a, dim=ax, keepdim=bool(keepdim and ax is not None)
                  ).to(dt)
    return no_grad_dispatch(op_name, kernel, (t(x),))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, "argmax", x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, "argmin", x, axis, keepdim, dtype)


def cumsum(x, axis=None, dtype=None, name=None):
    def kernel(a):
        b, d = (a.reshape(-1), 0) if axis is None else (a, int(axis))
        return _cast_out(torch.cumsum(b, dim=d), a, dtype)
    return dispatch("cumsum", kernel, (t(x),), {})


def cumprod(x, dim=None, dtype=None, name=None):
    def kernel(a):
        b, d = (a.reshape(-1), 0) if dim is None else (a, int(dim))
        return _cast_out(torch.cumprod(b, dim=d), a, dtype)
    return dispatch("cumprod", kernel, (t(x),), {})


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = axes(axis)

    def kernel(a):
        if not a.is_floating_point():
            a = a.to(torch.float32)
        return torch.logsumexp(a, dim=_dims(a, ax), keepdim=keepdim)
    return dispatch("logsumexp", kernel, (t(x),), {})


def logcumsumexp(x, axis=None, name=None):
    def kernel(a):
        b, d = (a.reshape(-1), 0) if axis is None else (a, int(axis))
        return torch.logcumsumexp(b, dim=d)
    return dispatch("logcumsumexp", kernel, (t(x),), {})


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = axes(axis)

    def kernel(a):
        dims = _dims(a, ax)
        out = torch.count_nonzero(a, dim=dims)
        if keepdim:
            for d in sorted(d % a.dim() for d in dims):
                out = out.unsqueeze(d)
        return out.to(INT)
    return no_grad_dispatch("count_nonzero", kernel, (t(x),))


def _to_last(a, ax):
    """``a`` with the dims ``ax`` (all when None) flattened into one last
    dim, and the shape a keepdim result takes."""
    dims = [d % a.dim() for d in _dims(a, ax)] if a.dim() else []
    rest = [d for d in range(a.dim()) if d not in dims]
    moved = a.permute(rest + dims) if a.dim() else a.reshape(1)
    flat = moved.reshape([a.shape[d] for d in rest] + [-1])
    keep = [1 if d in dims else a.shape[d] for d in range(a.dim())]
    return flat, keep


def _quantile(a, q, ax, keepdim):
    if not a.is_floating_point():
        a = a.to(torch.float32)
    flat, keep = _to_last(a, ax)
    qs = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    out = torch.quantile(flat, qs, dim=-1)
    if keepdim:
        out = out.reshape(tuple(qs.shape) + tuple(keep))
    return out


def median(x, axis=None, keepdim=False, name=None):
    ax = axes(axis)
    return dispatch("median", lambda a: _quantile(a, 0.5, ax, keepdim),
                    (t(x),), {})


def quantile(x, q, axis=None, keepdim=False, name=None):
    ax = axes(axis)
    qv = q.tolist() if hasattr(q, "tolist") else q
    return dispatch("quantile", lambda a: _quantile(a, qv, ax, keepdim),
                    (t(x),), {})


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = axes(axis)

    def kernel(a):
        if not a.is_floating_point():
            a = a.to(torch.float32)
        return torch.std(a, dim=_dims(a, ax), correction=int(unbiased),
                         keepdim=keepdim)
    return dispatch("std", kernel, (t(x),), {})


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = axes(axis)

    def kernel(a):
        if not a.is_floating_point():
            a = a.to(torch.float32)
        return torch.var(a, dim=_dims(a, ax), correction=int(unbiased),
                         keepdim=keepdim)
    return dispatch("var", kernel, (t(x),), {})


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def kernel(a):
        vals, idx = torch.sort(a, dim=axis, stable=True)
        v = vals.select(axis, k - 1)
        i = idx.select(axis, k - 1)
        if keepdim:
            v, i = v.unsqueeze(axis), i.unsqueeze(axis)
        return v, i.to(INT)
    return no_grad_dispatch("kthvalue", kernel, (t(x),))


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and the index of its last occurrence, as the
    reference's ``mode`` (:166-195)."""
    def kernel(a):
        moved = a.movedim(axis, -1)
        n = moved.shape[-1]
        rows = moved.reshape(-1, n)
        srt, order = torch.sort(rows, dim=-1, stable=True)
        change = torch.ones_like(srt, dtype=torch.long)
        change[:, 1:] = (srt[:, 1:] != srt[:, :-1]).long()
        runs = torch.cumsum(change, dim=-1)
        counts = torch.zeros(rows.shape[0], n + 1, dtype=torch.long,
                             device=a.device).scatter_add_(
            1, runs, torch.ones_like(runs))
        best = torch.argmax(counts, dim=-1, keepdim=True)
        is_best = (runs == best).long()
        pos = n - 1 - torch.argmax(is_best.flip(-1), dim=-1, keepdim=True)
        vals = srt.gather(-1, pos).reshape(moved.shape[:-1])
        idxs = order.gather(-1, pos).reshape(moved.shape[:-1]).to(INT)
        if keepdim:
            vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
        return vals, idxs
    return no_grad_dispatch("mode", kernel, (t(x),))
