"""``paddle.signal`` of the port — the counterpart of
``paddle_tpu/signal.py``: :func:`frame`, :func:`overlap_add`, :func:`stft`
and :func:`istft` on the input's device.  A frame is a strided view
(``Tensor.unfold``), overlap-add an ``index_add`` and the transforms
``torch.fft``; the window is padded to ``n_fft`` about its centre
(:80-94), and the errors are the reference's ``ValueError``\\ s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .core.tensor import Tensor
from .ops._common import dispatch
from .ops._common import t as _t

__all__ = ["frame", "overlap_add", "stft", "istft"]

# jnp.pad's modes as torch's F.pad names them
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def _check(hop_length, axis=-1):
    if hop_length is None or hop_length <= 0:
        raise ValueError("hop_length must be positive")
    if axis not in (0, -1):
        raise ValueError(f"axis should be 0 or -1, got {axis}")


def _num_frames(n, frame_length, hop_length):
    if n < frame_length:
        raise ValueError(
            f"input size ({n}) < frame_length ({frame_length})")
    return 1 + (n - frame_length) // hop_length


def _frame_index(out_len, frame_length, hop_length, device):
    """``(frame_length, num_frames)`` positions: frame ``f``'s ``k``-th
    sample sits at ``k + hop_length * f``."""
    n = _num_frames(out_len, frame_length, hop_length)
    return (torch.arange(frame_length, device=device)[:, None]
            + hop_length * torch.arange(n, device=device)[None, :])


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames of ``x``: ``axis=-1`` gives ``(...,
    frame_length, num_frames)``, ``axis=0`` ``(num_frames, frame_length,
    ...)``."""
    x = _t(x)
    _check(hop_length, axis)
    _num_frames(x.shape[0] if axis == 0 else x.shape[-1], frame_length,
                hop_length)

    def kernel(a):
        if axis == 0:
            return a.unfold(0, frame_length, hop_length).movedim(-1, 1)
        return a.unfold(-1, frame_length, hop_length).transpose(-1, -2)
    return dispatch("frame", kernel, (x,), {})


def _overlap_add(a, hop_length, axis):
    """``a``'s frames summed at their positions (:func:`frame`'s
    inverse)."""
    if axis == 0:
        nf, fl = a.shape[0], a.shape[1]
    else:
        fl, nf = a.shape[-2], a.shape[-1]
    out_len = (nf - 1) * hop_length + fl
    idx = _frame_index(out_len, fl, hop_length, a.device)
    if axis == 0:
        out = torch.zeros((out_len,) + tuple(a.shape[2:]), dtype=a.dtype,
                          device=a.device)
        return out.index_add(0, idx.T.reshape(-1),
                             a.reshape((nf * fl,) + tuple(a.shape[2:])))
    out = torch.zeros(tuple(a.shape[:-2]) + (out_len,), dtype=a.dtype,
                      device=a.device)
    return out.index_add(-1, idx.reshape(-1),
                         a.reshape(tuple(a.shape[:-2]) + (fl * nf,)))


def overlap_add(x, hop_length, axis=-1, name=None):
    """Frames (``(..., frame_length, num_frames)`` for ``axis=-1``,
    ``(num_frames, frame_length, ...)`` for ``axis=0``) added at their
    positions."""
    x = _t(x)
    _check(hop_length, axis)
    return dispatch("overlap_add", lambda a: _overlap_add(a, hop_length,
                                                          axis), (x,), {})


def _prep_window(window, win_length, n_fft, dtype, device):
    """The window (ones by default) of ``win_length``, padded to ``n_fft``
    about its centre."""
    if win_length > n_fft:
        raise ValueError(
            f"win_length ({win_length}) must be <= n_fft ({n_fft})")
    if window is None:
        w = torch.ones(win_length, dtype=dtype, device=device)
    else:
        w = window._data if isinstance(window, Tensor) else \
            torch.as_tensor(window)
        if w.shape[0] != win_length:
            raise ValueError(
                f"window length ({w.shape[0]}) != win_length ({win_length})")
        w = w.detach().to(device=device, dtype=dtype)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = F.pad(w, (pad, n_fft - win_length - pad))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False,
         onesided=True, name=None):
    """The short-time Fourier transform: complex ``(..., n_fft // 2 + 1
    if onesided else n_fft, num_frames)``."""
    x = _t(x)
    hop_length = n_fft // 4 if hop_length is None else hop_length
    if hop_length <= 0:
        raise ValueError("hop_length must be positive")
    win_length = n_fft if win_length is None else win_length
    is_complex = x._data.is_complex()
    w = _prep_window(window, win_length, n_fft, x._data.real.dtype
                     if is_complex else x._data.dtype, x._data.device)
    if is_complex and onesided:
        raise ValueError("onesided is not supported for complex input")
    if center and pad_mode not in _PAD_MODES:
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")

    def kernel(a):
        if center:
            lead = a.shape[:-1]
            flat = a.reshape((-1, 1, a.shape[-1]))
            flat = F.pad(flat, (n_fft // 2, n_fft // 2),
                         mode=_PAD_MODES[pad_mode])
            a = flat.reshape(tuple(lead) + (flat.shape[-1],))
        _num_frames(a.shape[-1], n_fft, hop_length)
        frames = a.unfold(-1, n_fft, hop_length) * w
        fftfn = torch.fft.rfft if onesided and not is_complex \
            else torch.fft.fft
        spec = fftfn(frames, n=n_fft, dim=-1).transpose(-1, -2)
        if normalized:
            spec = spec * (1.0 / torch.sqrt(torch.tensor(
                float(n_fft), dtype=spec.real.dtype)))
        return spec
    return dispatch("stft", kernel, (x,), {})


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The inverse STFT, divided by the squared window's overlap-add
    envelope; raises ``ValueError`` where the envelope has a zero in the
    kept samples (NOLA), which reads the envelope's minimum back."""
    x = _t(x)
    hop_length = n_fft // 4 if hop_length is None else hop_length
    if hop_length <= 0:
        raise ValueError("hop_length must be positive")
    win_length = n_fft if win_length is None else win_length
    if onesided and return_complex:
        raise ValueError(
            "onesided=True is incompatible with return_complex=True")
    dev = x._data.device
    w = _prep_window(window, win_length, n_fft, torch.float32, dev)
    out_len = (x.shape[-1] - 1) * hop_length + n_fft
    env_full = _overlap_add((w * w)[:, None].expand(n_fft, x.shape[-1]),
                            hop_length, -1)
    env = env_full
    if center:
        env = env[n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        env = env[:length]
    if env.numel() and float(env.abs().min()) < 1e-11:
        raise ValueError(
            "window/hop_length pair violates NOLA: overlap-add envelope "
            "has (near-)zero entries; istft is not invertible")

    def kernel(spec):
        if normalized:
            spec = spec * torch.sqrt(torch.tensor(float(n_fft),
                                                  dtype=spec.real.dtype))
        if onesided and not return_complex:
            frames = torch.fft.irfft(spec, n=n_fft, dim=-2)
        else:
            frames = torch.fft.ifft(spec, n=n_fft, dim=-2)
            if not return_complex:
                frames = frames.real
        out = _overlap_add(frames * w[:, None].to(frames.dtype), hop_length,
                           -1)
        e = env_full.to(out.real.dtype if out.is_complex() else out.dtype)
        out = out / torch.where(e > 1e-11, e, torch.ones_like(e))
        if center:
            out = out[..., n_fft // 2: out_len - n_fft // 2]
        if length is not None:
            out = out[..., :length]
        return out
    return dispatch("istft", kernel, (x,), {})
