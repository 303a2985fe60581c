"""Shape and layout ops — the counterpart of
``paddle_tpu/ops/manipulation.py``.

Each op is a torch call under dispatch.  Where numpy's semantics (the
reference's) differ from torch's, the kernel keeps numpy's: ``expand``
keeps a dim at ``-1``, ``unsqueeze`` of several axes counts them in the
output, ``pad`` takes the reference's layouts and reflects, clamps or
wraps any dim, ``argsort`` is stable and ``descending`` flips it, and
index results are int32.  The ops with data-dependent shapes
(``masked_select``, ``unique``, ``unique_consecutive``, ``nonzero``,
``bincount``) and the index ops (``argsort``, ``searchsorted``, ``topk``'s
indices) record no gradient, as in the reference.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtype import dtype_to_torch
from ..core.tensor import Tensor, _getitem
from ._common import INT, dispatch, no_grad_dispatch, promote, t

slice_builtin = builtins.slice

__all__ = [
    "reshape", "reshape_", "transpose", "concat", "stack", "split", "chunk",
    "squeeze", "unsqueeze", "flatten", "expand", "expand_as", "tile",
    "broadcast_to", "gather", "gather_nd", "scatter", "scatter_nd_add",
    "put_along_axis", "take_along_axis", "index_select", "index_sample",
    "masked_select", "slice", "strided_slice", "flip", "roll", "rot90",
    "unbind", "topk", "sort", "argsort", "unique", "unique_consecutive",
    "nonzero", "where", "pad", "shard_index", "unstack", "repeat_interleave",
    "moveaxis", "swapaxes", "as_complex", "as_real", "crop", "tensordot",
    "searchsorted", "bincount", "tolist", "cast",
]


def _ints(v):
    if isinstance(v, Tensor):
        v = v.tolist()
    return [int(s.item()) if isinstance(s, Tensor) else int(s) for s in v]


def _scalar_int(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def cast(x, dtype=None, name=None):
    dt = dtype_to_torch(dtype)
    return dispatch("cast", lambda a: a.to(dt), (t(x),), {})


def reshape(x, shape, name=None):
    shape = tuple(_ints(shape))
    return dispatch("reshape", lambda a: torch.reshape(a, shape), (t(x),),
                    {})


def reshape_(x, shape, name=None):
    x._data = reshape(x, shape)._data
    return x


def transpose(x, perm=None, name=None):
    x = t(x)
    p = tuple(perm) if perm is not None else tuple(range(x.ndim))[::-1]
    return dispatch("transpose", lambda a: a.permute(p), (x,), {})


def moveaxis(x, source, destination, name=None):
    return dispatch("moveaxis",
                    lambda a: torch.movedim(a, source, destination),
                    (t(x),), {})


def swapaxes(x, axis1, axis2, name=None):
    return dispatch("swapaxes", lambda a: torch.swapaxes(a, axis1, axis2),
                    (t(x),), {})


def concat(x, axis=0, name=None):
    axis = _scalar_int(axis)
    return dispatch("concat", lambda *a: torch.cat(promote(*a), dim=axis),
                    [t(v) for v in x], {})


def stack(x, axis=0, name=None):
    return dispatch("stack", lambda *a: torch.stack(promote(*a), dim=axis),
                    [t(v) for v in x], {})


def split(x, num_or_sections, axis=0, name=None):
    x = t(x)
    axis = _scalar_int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_scalar_int(s) for s in num_or_sections]
        residual = dim - builtins.sum(s for s in sizes if s > 0)
        sizes = [residual if s == -1 else s for s in sizes]
    return list(dispatch("split",
                         lambda a: tuple(torch.split(a, sizes, dim=axis)),
                         (x,), {}))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(dispatch("unbind", lambda a: tuple(torch.unbind(a, axis)),
                         (t(x),), {}))


unstack = unbind


def squeeze(x, axis=None, name=None):
    x = t(x)
    if isinstance(axis, (list, tuple)):
        ax = tuple(a for a in axis if x.shape[a] == 1)
    elif axis is not None:
        ax = (axis,) if x.shape[axis] == 1 else ()
    else:
        ax = None

    def kernel(a):
        if ax == ():
            return a.view(a.shape)
        return a.squeeze() if ax is None else a.squeeze(ax)
    return dispatch("squeeze", kernel, (x,), {})


def unsqueeze(x, axis, name=None):
    x = t(x)
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    n = x.ndim + len(ax)
    ax = sorted(int(a) % n for a in ax)

    def kernel(a):
        for d in ax:
            a = a.unsqueeze(d)
        return a
    return dispatch("unsqueeze", kernel, (x,), {})


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = t(x)
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return reshape(x, x.shape[:s] + [-1] + x.shape[e + 1:])


def expand(x, shape, name=None):
    x = t(x)
    shape = _ints(shape)
    xshape = ([1] * (len(shape) - x.ndim)) + x.shape
    target = tuple(xs if s == -1 else s for s, xs in zip(shape, xshape))
    return dispatch("expand", lambda a: torch.broadcast_to(a, target),
                    (x,), {})


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return expand(x, t(y).shape)


def tile(x, repeat_times, name=None):
    reps = tuple(_ints(repeat_times))
    return dispatch("tile", lambda a: torch.tile(a, reps), (t(x),), {})


def repeat_interleave(x, repeats, axis=None, name=None):
    r = repeats.tolist() if isinstance(repeats, Tensor) else repeats

    def kernel(a):
        rep = r if isinstance(r, int) else torch.as_tensor(r,
                                                           device=a.device)
        return torch.repeat_interleave(a, rep, dim=axis)
    return dispatch("repeat_interleave", kernel, (t(x),), {})


def gather(x, index, axis=0, name=None):
    axis = _scalar_int(axis)

    def kernel(a, idx):
        if idx.dim() == 0:
            return torch.index_select(a, axis, idx.reshape(1)).squeeze(axis)
        return torch.index_select(a, axis, idx.reshape(-1))
    return dispatch("gather", kernel, (t(x), t(index)), {})


def gather_nd(x, index, name=None):
    def kernel(a, idx):
        return a[tuple(torch.movedim(idx.long(), -1, 0))]
    return dispatch("gather_nd", kernel, (t(x), t(index)), {})


def scatter(x, index, updates, overwrite=True, name=None):
    def kernel(a, idx, upd):
        return a.index_put((idx.reshape(-1).long(),), upd.to(a.dtype),
                           accumulate=not overwrite)
    return dispatch("scatter", kernel, (t(x), t(index), t(updates)), {})


def scatter_nd_add(x, index, updates, name=None):
    def kernel(a, idx, upd):
        return a.index_put(tuple(torch.movedim(idx.long(), -1, 0)),
                           upd.to(a.dtype), accumulate=True)
    return dispatch("scatter_nd_add", kernel,
                    (t(x), t(index), t(updates)), {})


def take_along_axis(arr, indices, axis, name=None):
    return dispatch("take_along_axis",
                    lambda a, i: torch.take_along_dim(a, i.long(), dim=axis),
                    (t(arr), t(indices)), {})


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    def kernel(a, i, v):
        i = i.long()
        v = torch.broadcast_to(v.to(a.dtype), i.shape)
        if reduce == "add":
            return torch.scatter_add(a, axis, i, v)
        if reduce == "multiply":
            return torch.scatter_reduce(a, axis, i, v, "prod")
        return torch.scatter(a, axis, i, v)
    return dispatch("put_along_axis", kernel,
                    (t(arr), t(indices), t(values)), {})


def index_select(x, index, axis=0, name=None):
    return dispatch("index_select",
                    lambda a, i: torch.index_select(a, axis, i),
                    (t(x), t(index)), {})


def index_sample(x, index):
    return dispatch("index_sample",
                    lambda a, i: torch.take_along_dim(a, i.long(), dim=1),
                    (t(x), t(index)), {})


def masked_select(x, mask, name=None):
    return no_grad_dispatch("masked_select", lambda a, m: a[m.bool()],
                            (t(x), t(mask)))


def slice(input, axes, starts, ends):
    input = t(input)
    sl = [slice_builtin(None)] * input.ndim
    for ax, s, e in zip(axes, starts, ends):
        sl[ax] = slice_builtin(_scalar_int(s), _scalar_int(e))
    idx = tuple(sl)
    return dispatch("slice", lambda a: a[idx], (input,), {})


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = t(x)
    sl = [slice_builtin(None)] * x.ndim
    for ax, s, e, st in zip(axes, starts, ends, strides):
        sl[ax] = slice_builtin(int(s), int(e), int(st))
    idx = tuple(sl)
    return dispatch("strided_slice", lambda a: _getitem(a, idx=idx), (x,),
                    {})


def flip(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return dispatch("flip", lambda a: torch.flip(a, ax), (t(x),), {})


def roll(x, shifts, axis=None, name=None):
    return dispatch("roll", lambda a: torch.roll(a, shifts, dims=axis),
                    (t(x),), {})


def rot90(x, k=1, axes=(0, 1), name=None):
    return dispatch("rot90", lambda a: torch.rot90(a, k, list(axes)),
                    (t(x),), {})


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    k = _scalar_int(k)

    def kernel(a):
        vals, idx = torch.topk(a, k, dim=axis, largest=largest,
                               sorted=True)
        return vals, idx
    vals, idx = dispatch("topk", kernel, (t(x),), {})
    return vals, Tensor(idx._data.to(INT))


def sort(x, axis=-1, descending=False, name=None):
    def kernel(a):
        out = torch.sort(a, dim=axis, stable=True).values
        return torch.flip(out, (axis,)) if descending else out
    return dispatch("sort", kernel, (t(x),), {})


def argsort(x, axis=-1, descending=False, name=None):
    def kernel(a):
        out = torch.argsort(a, dim=axis, stable=True)
        if descending:
            out = torch.flip(out, (axis,))
        return out.to(INT)
    return no_grad_dispatch("argsort", kernel, (t(x),))


def _host_out(x, arrays):
    """numpy results of a data-dependent op as Tensors on ``x``'s device,
    64-bit integers as int32."""
    dev = x._data.device
    outs = []
    for r in arrays:
        r = np.asarray(r)
        if r.dtype == np.int64:
            r = r.astype(np.int32)
        outs.append(Tensor(torch.as_tensor(r).to(dev)))
    return outs


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    x = t(x)
    res = np.unique(x.numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _host_out(x, [res])[0]
    return tuple(_host_out(x, res))


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = t(x)
    a = x.numpy()
    if axis is None:
        a = a.reshape(-1)
    keep = np.concatenate([[True], a[1:] != a[:-1]]) if a.size \
        else np.array([], bool)
    out = [a[keep]]
    if return_inverse:
        out.append(np.cumsum(keep) - 1)
    if return_counts:
        idx = np.flatnonzero(keep)
        out.append(np.diff(np.append(idx, a.size)))
    outs = _host_out(x, out)
    return outs[0] if len(outs) == 1 else tuple(outs)


def nonzero(x, as_tuple=False):
    def kernel(a):
        idx = torch.nonzero(a).to(INT)
        return tuple(idx.unbind(1)) if as_tuple else idx
    return no_grad_dispatch("nonzero", kernel, (t(x),))


def where(condition, x=None, y=None, name=None):
    condition = t(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    x, y = t(x, condition), t(y, condition)
    return dispatch("where",
                    lambda c, a, b: torch.where(c.bool(), *promote(a, b)),
                    (condition, x, y), {})


def _pad_index(n, before, after, mode, device):
    """The source index of each padded position along one dim."""
    idx = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return idx.clamp(0, n - 1)
    if mode == "wrap":
        return idx % n
    period = 2 * (n - 1)
    m = idx.abs() % period if period else idx * 0
    return torch.where(m >= n, period - m, m)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    x = t(x)
    pad = _ints(pad)
    nd = x.ndim
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        widths = [(0, 0)] * nd
        spatial = list(range(nd))[::-1]
        for i in range(len(pad) // 2):
            dim = spatial[i]
            if data_format in ("NCHW", "NCL", "NCDHW") and nd >= 3:
                dim = nd - 1 - i
            widths[dim] = (pad[2 * i], pad[2 * i + 1])
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]

    def kernel(a):
        if jmode == "constant":
            flat = []
            for b, e in reversed(widths):
                flat += [b, e]
            return F.pad(a, flat, mode="constant", value=value)
        for d, (b, e) in enumerate(widths):
            if b or e:
                a = torch.index_select(
                    a, d, _pad_index(a.shape[d], b, e, jmode, a.device))
        return a
    return dispatch("pad", kernel, (x,), {})


def crop(x, shape=None, offsets=None, name=None):
    x = t(x)
    shape = [int(s) for s in (shape or x.shape)]
    offsets = [int(o) for o in (offsets or [0] * x.ndim)]
    idx = tuple(slice_builtin(o, o + (s if s != -1 else x.shape[i] - o))
                for i, (o, s) in enumerate(zip(offsets, shape)))
    return dispatch("crop", lambda a: a[idx], (x,), {})


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards

    def kernel(a):
        shard = torch.div(a, size, rounding_mode="floor")
        return torch.where(shard == shard_id, a % size,
                           torch.full_like(a, ignore_value))
    return dispatch("shard_index", kernel, (t(input),), {})


def as_complex(x, name=None):
    return dispatch("as_complex",
                    lambda a: torch.complex(a[..., 0], a[..., 1]),
                    (t(x),), {})


def as_real(x, name=None):
    return dispatch("as_real",
                    lambda a: torch.stack([torch.real(a), torch.imag(a)],
                                          dim=-1), (t(x),), {})


def tensordot(x, y, axes=2, name=None):
    return dispatch("tensordot",
                    lambda a, b: torch.tensordot(*promote(a, b), dims=axes),
                    (t(x), t(y)), {})


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return no_grad_dispatch(
        "searchsorted",
        lambda s, v: torch.searchsorted(s, v.to(s.dtype), right=right
                                        ).to(INT),
        (t(sorted_sequence), t(values)))


def bincount(x, weights=None, minlength=0, name=None):
    x = t(x)
    n = int(x._data.max().item()) + 1 if x.size else 0
    length = builtins.max(n, minlength)
    tensors = [x] + ([t(weights)] if weights is not None else [])

    def kernel(a, *w):
        out = torch.bincount(a.long(), weights=w[0] if w else None,
                             minlength=length)
        return out.to(w[0].dtype) if w else out.to(INT)
    return no_grad_dispatch("bincount", kernel, tensors)


def tolist(x):
    return t(x).tolist()
