"""The ragged sequence ops — the counterpart of
``paddle_tpu/ops/sequence.py``: 17 ops on a ragged batch held as the pair
``(x, seq_lens)``, ``x`` of shape ``(total, ...)`` with every sequence
concatenated and ``seq_lens`` of shape ``(num_seqs,)`` with
``sum(seq_lens) <= total``.

A token's sequence is found by a binary search of its position among the
sequences' ends (the reference's ``_segment_ids``, :48-57), so no length
is read back to the host; tokens past ``sum(seq_lens)`` fall in a scrap
segment, ``num_seqs``, and are masked out of every result.  The ops whose
output shape depends on the lengths (``sequence_pad`` without ``maxlen``,
``sequence_unpad``, ``sequence_expand``, ``sequence_expand_as``,
``sequence_concat``, ``sequence_slice``, ``sequence_reshape``,
``sequence_erase``) read them on the host, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ._common import INT, dispatch
from ._common import t as _t

__all__ = [
    "sequence_pool", "sequence_softmax", "sequence_first_step",
    "sequence_last_step", "sequence_pad", "sequence_unpad",
    "sequence_reverse", "sequence_conv", "sequence_expand",
    "sequence_expand_as", "sequence_concat", "sequence_slice",
    "sequence_enumerate", "sequence_reshape", "sequence_erase",
    "sequence_scatter", "edit_distance",
]


def _segment_ids(lens: torch.Tensor, total: int):
    """Each of ``total`` positions' sequence (``num_seqs`` past the
    lengths' sum), and whether it lies within them."""
    ends = torch.cumsum(lens, 0)
    pos = torch.arange(total, device=lens.device, dtype=ends.dtype)
    ids = torch.searchsorted(ends, pos, right=True)
    return ids, ids < lens.shape[0]


def _bounds(lens: torch.Tensor, fill: int):
    """Each sequence's start and end, with one more entry, ``fill``, for
    the scrap segment."""
    ends = torch.cumsum(lens, 0)
    extra = torch.full((1,), fill, dtype=ends.dtype, device=ends.device)
    return torch.cat([ends - lens, extra]), torch.cat([ends, extra])


def _rows(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A mask over the first axis, broadcast over ``a``'s other axes."""
    return mask.reshape((-1,) + (1,) * (a.dim() - 1))


def _host(lens) -> np.ndarray:
    return np.asarray(_t(lens).numpy(), np.int64).reshape(-1)


def sequence_pool(x, seq_lens, pool_type="average", pad_value=0.0, name=None):
    """Per-sequence ``sum``, ``average``, ``sqrt``, ``max``, ``min``,
    ``first`` or ``last``; an empty sequence gives ``pad_value``."""
    ptype = pool_type.lower()

    def kernel(a, lens):
        total, n = a.shape[0], lens.shape[0]
        ids, valid = _segment_ids(lens, total)
        vmask = _rows(valid, a)
        idx = ids.reshape((-1,) + (1,) * (a.dim() - 1)).expand(a.shape)
        seg = (n + 1,) + tuple(a.shape[1:])
        if ptype in ("sum", "average", "sqrt"):
            out = torch.zeros(seg, dtype=a.dtype, device=a.device).index_add(
                0, ids, torch.where(vmask, a, torch.zeros_like(a)))[:n]
            if ptype != "sum":
                div = _rows(torch.clamp(lens, min=1).to(a.dtype), a)
                out = out / (div if ptype == "average" else torch.sqrt(div))
        elif ptype in ("max", "min"):
            if a.is_floating_point():
                fill = float("-inf") if ptype == "max" else float("inf")
            else:
                info = torch.iinfo(a.dtype)
                fill = info.min if ptype == "max" else info.max
            masked = torch.where(vmask, a, torch.full_like(a, fill))
            out = torch.full(seg, fill, dtype=a.dtype, device=a.device)
            out = out.scatter_reduce(0, idx, masked, "a" + ptype)[:n]
        elif ptype in ("first", "last"):
            ends = torch.cumsum(lens, 0)
            pick = ends - lens if ptype == "first" else \
                torch.clamp(ends - 1, min=0)
            out = a[torch.clamp(pick, 0, total - 1)]
        else:
            raise ValueError(f"unknown pool_type '{pool_type}'")
        empty = _rows(lens == 0, out)
        return torch.where(empty, torch.full_like(out, pad_value), out)
    return dispatch("sequence_pool", kernel, (_t(x), _t(seq_lens)), {})


def sequence_first_step(x, seq_lens, name=None):
    return sequence_pool(x, seq_lens, "first")


def sequence_last_step(x, seq_lens, name=None):
    return sequence_pool(x, seq_lens, "last")


def sequence_softmax(x, seq_lens, name=None):
    """Softmax within each sequence (``x`` of shape ``(total,)`` or
    ``(total, 1)``); the scrap tail gets probability 0."""
    def kernel(a, lens):
        squeeze = a.dim() == 2 and a.shape[1] == 1
        v = a.reshape(a.shape[0]) if squeeze else a
        total, n = v.shape[0], lens.shape[0]
        ids, valid = _segment_ids(lens, total)
        neg = torch.where(valid, v, torch.full_like(v, float("-inf")))
        mx = torch.full((n + 1,), float("-inf"), dtype=v.dtype,
                        device=v.device).scatter_reduce(0, ids, neg, "amax")
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        e = torch.where(valid, torch.exp(v - mx[ids]), torch.zeros_like(v))
        denom = torch.zeros(n + 1, dtype=v.dtype,
                            device=v.device).index_add(0, ids, e)
        out = e / torch.clamp(denom[ids], min=1e-30)
        return out.reshape(a.shape) if squeeze else out
    return dispatch("sequence_softmax", kernel, (_t(x), _t(seq_lens)), {})


def sequence_pad(x, seq_lens, pad_value=0.0, maxlen=None, name=None):
    """``(total, ...)`` to ``(num_seqs, maxlen, ...)``; returns
    ``(padded, seq_lens)``.  ``maxlen`` defaults to the longest length,
    read on the host."""
    x, seq_lens = _t(x), _t(seq_lens)
    if maxlen is None:
        lens_np = _host(seq_lens)
        maxlen = int(lens_np.max()) if lens_np.size else 1

    def kernel(a, lens):
        total = a.shape[0]
        pos = torch.arange(maxlen, device=a.device)[None, :]
        tok = (torch.cumsum(lens, 0) - lens)[:, None] + pos
        ok = pos < lens[:, None]
        got = a[torch.clamp(tok, 0, total - 1)]
        okb = ok.reshape(ok.shape + (1,) * (a.dim() - 1))
        return torch.where(okb, got, torch.full_like(got, pad_value)), lens
    return dispatch("sequence_pad", kernel, (x, seq_lens), {})


def sequence_unpad(x, seq_lens, name=None):
    """``(num_seqs, maxlen, ...)`` to ``(sum(seq_lens), ...)``."""
    x, seq_lens = _t(x), _t(seq_lens)
    total = int(_host(seq_lens).sum())

    def kernel(a, lens):
        ids, _ = _segment_ids(lens, total)
        starts, _ = _bounds(lens, 0)
        within = torch.arange(total, device=a.device) - starts[ids]
        return a[ids, within]
    return dispatch("sequence_unpad", kernel, (x, seq_lens), {})


def sequence_reverse(x, seq_lens, name=None):
    """Tokens reversed within each sequence; the scrap tail in place."""
    def kernel(a, lens):
        total = a.shape[0]
        ids, valid = _segment_ids(lens, total)
        starts, ends = _bounds(lens, 0)
        pos = torch.arange(total, device=a.device)
        src = torch.where(valid, starts[ids] + (ends[ids] - 1 - pos), pos)
        return a[torch.clamp(src, 0, total - 1)]
    return dispatch("sequence_reverse", kernel, (_t(x), _t(seq_lens)), {})


def sequence_conv(x, seq_lens, filter, context_length=3, context_start=None,
                  bias=None, name=None):
    """A context window of ``context_length`` taps from ``context_start``
    within each sequence (out-of-sequence taps are 0), times ``filter``
    of shape ``(context_length * D, M)``, plus ``bias``."""
    if context_start is None:
        context_start = -((context_length - 1) // 2)
    tensors = (_t(x), _t(seq_lens), _t(filter)) + \
        ((_t(bias),) if bias is not None else ())

    def kernel(a, lens, w, *maybe_b):
        total, d = a.shape
        ids, valid = _segment_ids(lens, total)
        starts, ends = _bounds(lens, total)
        pos = torch.arange(total, device=a.device)
        taps = pos[:, None] + context_start + \
            torch.arange(context_length, device=a.device)[None]
        ok = (taps >= starts[ids][:, None]) & (taps < ends[ids][:, None]) \
            & valid[:, None]
        ctx = a[torch.clamp(taps, 0, total - 1)]
        ctx = torch.where(ok[..., None], ctx, torch.zeros_like(ctx))
        out = ctx.reshape(total, context_length * d) @ w
        if maybe_b:
            out = out + maybe_b[0]
        return torch.where(valid[:, None], out, torch.zeros_like(out))
    return dispatch("sequence_conv", kernel, tensors, {})


def _gather_rows(op_name, x, idx: np.ndarray, others=()):
    """``x``'s rows at the host-computed ``idx``."""
    def kernel(a, *_):
        return a[torch.as_tensor(idx, dtype=torch.int64, device=a.device)]
    return dispatch(op_name, kernel, (x,) + tuple(others), {})


def _starts(lens_np: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lens_np)])[:-1]


def sequence_expand(x, x_lens, y_lens, name=None):
    """Each sequence of ``x`` repeated ``y_lens[i]`` times."""
    x, x_lens, y_lens = _t(x), _t(x_lens), _t(y_lens)
    xl, yl = _host(x_lens), _host(y_lens)
    idx = [t for s, n, r in zip(_starts(xl), xl, yl) for _ in range(int(r))
           for t in range(int(s), int(s + n))]
    return _gather_rows("sequence_expand", x, np.asarray(idx, np.int64),
                        (x_lens, y_lens))


def sequence_expand_as(x, y_lens, name=None):
    """Row ``i`` of ``x`` (``(num_seqs, D)``) repeated ``y_lens[i]``
    times."""
    x, y_lens = _t(x), _t(y_lens)
    total = int(_host(y_lens).sum())

    def kernel(a, lens):
        return a[_segment_ids(lens, total)[0]]
    return dispatch("sequence_expand_as", kernel, (x, y_lens), {})


def sequence_concat(xs, lens_list, name=None):
    """Sequence ``i`` of the output is the concatenation of sequence ``i``
    of each input; returns ``(out, out_lens)``."""
    xs = [_t(x) for x in xs]
    lens_np = [_host(n) for n in lens_list]
    starts = [_starts(n) for n in lens_np]
    offsets = np.concatenate([[0], np.cumsum([x.shape[0] for x in xs])])
    idx = [offsets[j] + t for i in range(len(lens_np[0]))
           for j in range(len(xs))
           for t in range(int(starts[j][i]),
                          int(starts[j][i] + lens_np[j][i]))]
    idx = np.asarray(idx, np.int64)
    out_lens = np.sum(np.stack(lens_np), axis=0).astype(np.int32)

    def kernel(*arrs):
        cat = torch.cat(arrs, 0)
        return cat[torch.as_tensor(idx, device=cat.device)]
    out = dispatch("sequence_concat", kernel, tuple(xs), {})
    return out, _t(out_lens, out)


def sequence_slice(x, seq_lens, offset, length, name=None):
    """``length[i]`` tokens of sequence ``i`` from ``offset[i]``; returns
    ``(out, new_lens)``."""
    x, seq_lens = _t(x), _t(seq_lens)
    offset, length = _host(offset), _host(length)
    idx = [t for s, o, n in zip(_starts(_host(seq_lens)), offset, length)
           for t in range(int(s + o), int(s + o + n))]
    out = _gather_rows("sequence_slice", x, np.asarray(idx, np.int64),
                       (seq_lens,))
    return out, _t(length.astype(np.int32), x)


def sequence_enumerate(x, seq_lens, win_size, pad_value=0, name=None):
    """Every ``win_size``-gram of ids (``(total,)`` to ``(total,
    win_size)``), ``pad_value`` past each sequence's end."""
    def kernel(a, lens):
        total = a.shape[0]
        ids, valid = _segment_ids(lens, total)
        _, ends = _bounds(lens, total)
        taps = torch.arange(total, device=a.device)[:, None] + \
            torch.arange(win_size, device=a.device)[None]
        ok = (taps < ends[ids][:, None]) & valid[:, None]
        vals = a[torch.clamp(taps, 0, total - 1)]
        return torch.where(ok, vals, torch.full_like(vals, pad_value))
    return dispatch("sequence_enumerate", kernel, (_t(x), _t(seq_lens)), {})


def sequence_reshape(x, seq_lens, new_dim, name=None):
    """Each sequence's payload re-cut to width ``new_dim``; returns
    ``(out, new_lens)``."""
    x, seq_lens = _t(x), _t(seq_lens)
    new_lens = _host(seq_lens) * x.shape[1] // new_dim
    out = dispatch("sequence_reshape", lambda a, _: a.reshape(-1, new_dim),
                   (x, seq_lens), {})
    return out, _t(new_lens.astype(np.int32), x)


def sequence_erase(x, seq_lens, tokens, name=None):
    """The ids in ``tokens`` removed from each sequence; returns ``(out,
    new_lens)``."""
    x, seq_lens = _t(x), _t(seq_lens)
    keep = ~np.isin(np.asarray(x.numpy()), np.asarray(list(tokens)))
    lens_np = _host(seq_lens)
    new_lens = np.asarray([int(keep[int(s):int(s + n)].sum())
                           for s, n in zip(_starts(lens_np), lens_np)],
                          np.int32)
    out = _gather_rows("sequence_erase", x,
                       np.nonzero(keep)[0].astype(np.int64), (seq_lens,))
    return out, _t(new_lens, x)


def sequence_scatter(x, index, updates, seq_lens, name=None):
    """Sequence ``i`` of ``updates`` added into row ``i`` of ``x`` at the
    columns ``index`` gives."""
    def kernel(a, idx, upd, lens):
        ids, valid = _segment_ids(lens, idx.shape[0])
        rows = torch.where(valid, ids, torch.zeros_like(ids))
        cols = torch.clamp(idx, 0, a.shape[1] - 1).to(torch.int64)
        vals = torch.where(valid, upd, torch.zeros_like(upd))
        return a.index_put((rows, cols), vals.to(a.dtype), accumulate=True)
    return dispatch("sequence_scatter", kernel,
                    (_t(x), _t(index), _t(updates), _t(seq_lens)), {})


def edit_distance(hyps, refs, hyp_lens, ref_lens, normalized=True, name=None):
    """Levenshtein distance of each hypothesis (``(B, Th)`` ids) to its
    reference (``(B, Tr)``) over their lengths, divided by the reference's
    length when ``normalized``; returns ``(dist, seq_num)``.

    Row ``i + 1`` of the table from row ``i``: ``new[0] = i + 1`` and
    ``new[j] = min(base[j - 1], new[j - 1] + 1)``, ``base`` the deletion
    and substitution costs; so ``new[j] - j`` is a running minimum
    (``torch.cummin``) and one row is a handful of batched ops."""
    def kernel(h, r, hl, rl):
        B, Th = h.shape
        Tr = r.shape[1]
        cols = torch.arange(Tr + 1, dtype=torch.float32, device=h.device)
        row = cols.expand(B, Tr + 1)
        rows = [row]
        for i in range(Th):
            sub = row[:, :-1] + (h[:, i:i + 1] != r).float()
            base = torch.minimum(row[:, 1:] + 1.0, sub)
            head = torch.full((B, 1), float(i + 1), device=h.device)
            row = torch.cummin(torch.cat([head, base - cols[1:]], 1),
                               1).values + cols
            rows.append(row)
        table = torch.stack(rows, 1)                    # (B, Th+1, Tr+1)
        b = torch.arange(B, device=h.device)
        dist = table[b, hl.long(), rl.long()]
        if normalized:
            dist = dist / torch.clamp(rl, min=1).float()
        return dist, torch.tensor(B, dtype=INT, device=h.device)
    return dispatch("edit_distance", kernel,
                    (_t(hyps), _t(refs), _t(hyp_lens), _t(ref_lens)), {})
