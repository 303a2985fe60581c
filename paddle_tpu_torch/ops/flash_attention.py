"""Flash attention forward — the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py`` (forward only).

:func:`flash_attention` takes the reference's ``(B, S, H, D)`` layout and
folds it to ``(B*H, T, d)``, as the reference does, for
:func:`flash_attn_fwd`, the wrapper of the hand-written CUDA kernel
``csrc/flash_attn_fwd.cu``.  On a CUDA tensor that wrapper launches the
kernel or raises; on a CPU tensor it computes :func:`flash_attention_ref`,
the plain PyTorch version of the same function.  :data:`LAUNCHES` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attn_fwd", "flash_attention_ref",
           "LAUNCHES", "NEG_INF", "HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (a plain integer; tests and the smoke run
# reset it to 0 and read it back)
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attn_fwd")
        fn = lib.flash_attn_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attn_error_string)
    return _fn


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch attention over ``(BH, T, d)`` — the reference's
    ``_xla_attention``: fp32 scores, bottom-right causal mask filled with
    ``NEG_INF``, probabilities cast to ``v``'s type before the product."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q.shape[-1], scale)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        allow = torch.ones((tq, tk), dtype=torch.bool,
                           device=s.device).tril(tk - tq)
        s = s.masked_fill(~allow, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v).to(q.dtype)


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ·scale) v over ``(BH, Tq, d)`` / ``(BH, Tk, d)``.

    CUDA tensors go through the kernel (contiguous, fp32 or bf16,
    d in :data:`HEAD_DIMS`), anything else it refuses raises.  CPU
    tensors take :func:`flash_attention_ref`.  Causal attention with
    ``Tq > Tk`` is refused on both."""
    global LAUNCHES
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attn_fwd takes (BH, T, d) tensors; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if k.shape != (bh, tk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if tk == 0:
        raise ValueError("attention over zero keys")
    if causal and tq > tk:
        raise ValueError(f"causal attention with Tq={tq} > Tk={tk} leaves "
                         "fully masked rows; the kernel does not take it")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd runs on CUDA or CPU, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes fp32 or bf16 q/k/v of one type; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel has "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if tq == 0 or bh == 0:
        return out
    fn, errstr = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, tq, tk, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
                 _scale(d, scale), stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd launch failed: "
                           f"{errstr(err).decode()} (cudaError {err})")
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``(B, S, H, D)`` in, ``(B, S, H, D)`` out, through the folded
    ``(B*H, T, D)`` layout the kernel takes."""
    B, T, H, D = q.shape
    Tk = k.shape[1]

    def fold(x, t):
        return x.permute(0, 2, 1, 3).reshape(B * H, t, D).contiguous()

    out = flash_attn_fwd(fold(q, T), fold(k, Tk), fold(v, Tk),
                         causal=causal, scale=scale)
    return out.reshape(B, H, T, D).permute(0, 2, 1, 3)
