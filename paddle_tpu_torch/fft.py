"""``paddle.fft`` of the port — the counterpart of ``paddle_tpu/fft.py``:
the 1-D, 2-D and n-D transforms, ``hfftn`` / ``ihfftn`` and their 2-D
forms, ``fftfreq`` / ``rfftfreq`` and the shifts, on ``torch.fft`` on the
input's device.  ``norm`` is ``"backward"`` (the default), ``"ortho"`` or
``"forward"``; another value raises ``ValueError`` (:28-34).  A real
float32 input gives complex64 results (``core/dtype.py``: complex128 is
complex64, as the reference with x64 off).
"""
from __future__ import annotations

import torch

from .core.dtype import dtype_to_torch
from .core.tensor import Tensor
from .ops._common import device, dispatch
from .ops._common import t as _t

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2",
    "fftn", "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_VALID_NORM = ("backward", "ortho", "forward")


def _norm(norm):
    if norm is None:
        return "backward"
    if norm not in _VALID_NORM:
        raise ValueError(
            f"norm should be one of {_VALID_NORM}, got {norm!r}")
    return norm


def _make_1d(op_name, tfn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        nm = _norm(norm)
        return dispatch(op_name, lambda a: tfn(a, n=n, dim=axis, norm=nm),
                        (_t(x),), {})
    op.__name__ = op.__qualname__ = op_name
    return op


def _nd_axes(s, axes):
    """The reference's axes: ``axes`` as given, else the last ``len(s)``
    axes when ``s`` is given, else every axis (None)."""
    ss = tuple(s) if s is not None else None
    if axes is not None:
        return ss, tuple(axes)
    return ss, (tuple(range(-len(ss), 0)) if ss is not None else None)


def _make_nd(op_name, tfn):
    def op(x, s=None, axes=None, norm="backward", name=None):
        nm = _norm(norm)
        ss, ax = _nd_axes(s, axes)
        return dispatch(op_name, lambda a: tfn(a, s=ss, dim=ax, norm=nm),
                        (_t(x),), {})
    op.__name__ = op.__qualname__ = op_name
    return op


fft = _make_1d("fft", torch.fft.fft)
ifft = _make_1d("ifft", torch.fft.ifft)
rfft = _make_1d("rfft", torch.fft.rfft)
irfft = _make_1d("irfft", torch.fft.irfft)
hfft = _make_1d("hfft", torch.fft.hfft)
ihfft = _make_1d("ihfft", torch.fft.ihfft)

fftn = _make_nd("fftn", torch.fft.fftn)
ifftn = _make_nd("ifftn", torch.fft.ifftn)
rfftn = _make_nd("rfftn", torch.fft.rfftn)
irfftn = _make_nd("irfftn", torch.fft.irfftn)


def _make_2d(op_name, ndfn):
    def op(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return ndfn(x, s=s, axes=axes, norm=norm)
    op.__name__ = op.__qualname__ = op_name
    return op


fft2 = _make_2d("fft2", fftn)
ifft2 = _make_2d("ifft2", ifftn)
rfft2 = _make_2d("rfft2", rfftn)
irfft2 = _make_2d("irfft2", irfftn)


def _hfftn(a, s, axes, nm, inverse):
    """The reference's composition (:90-114): ``fftn`` over the leading
    axes, then ``hfft`` on the last; the inverse ``ihfft`` on the last
    first (it needs the real input), then ``ifftn`` over the rest."""
    if axes is None:
        ndim = len(s) if s is not None else a.dim()
        axes = tuple(range(-ndim, 0))
    axes = tuple(axes)
    s = tuple(s) if s is not None else None
    head, last = axes[:-1], axes[-1]
    n_last = None if s is None else s[-1]
    sub = None if s is None else s[:-1]
    if inverse:
        a = torch.fft.ihfft(a, n=n_last, dim=last, norm=nm)
        return torch.fft.ifftn(a, s=sub, dim=head, norm=nm) if head else a
    if head:
        a = torch.fft.fftn(a, s=sub, dim=head, norm=nm)
    return torch.fft.hfft(a, n=n_last, dim=last, norm=nm)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    nm = _norm(norm)
    return dispatch("hfftn", lambda a: _hfftn(a, s, axes, nm, False),
                    (_t(x),), {})


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    nm = _norm(norm)
    return dispatch("ihfftn", lambda a: _hfftn(a, s, axes, nm, True),
                    (_t(x),), {})


hfft2 = _make_2d("hfft2", hfftn)
ihfft2 = _make_2d("ihfft2", ihfftn)


def _freq(tfn, n, d, dtype):
    out = tfn(int(n), d=d, device=device())
    return Tensor(out if dtype is None else out.to(dtype_to_torch(dtype)))


def fftfreq(n, d=1.0, dtype=None, name=None):
    """The sample frequencies of an ``n``-point transform, on the current
    place."""
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def _shift(op_name, tfn):
    def op(x, axes=None, name=None):
        ax = tuple(axes) if isinstance(axes, (list, tuple)) else axes
        return dispatch(op_name, lambda a: tfn(a, dim=ax), (_t(x),), {})
    op.__name__ = op.__qualname__ = op_name
    return op


fftshift = _shift("fftshift", torch.fft.fftshift)
ifftshift = _shift("ifftshift", torch.fft.ifftshift)
