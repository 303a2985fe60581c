"""Fused bias + dropout + residual add + LayerNorm — the counterpart of
``paddle_tpu/ops/pallas/fused_ln.py``.

    out = LayerNorm(residual + dropout(x + bias)) · gamma + beta

over the rows of ``(N, D)`` inputs, with fp32 statistics and the result in
x's type.  The dropout mask is a pure function of (seed, element index):
:func:`hash_uniform` is the reference's Murmur3-finaliser hash bit for
bit, so a backward recomputes the mask instead of storing it.

:func:`fused_ln` launches the hand-written kernel ``csrc/fused_ln.cu`` on
CUDA tensors (or raises) and computes :func:`fused_ln_ref`, its plain
version, on CPU tensors.  :data:`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["hash_uniform", "fused_ln_ref", "fused_ln", "LAUNCHES"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF

# kernel launches since import (a plain integer; tests and the smoke run
# reset it to 0 and read it back)
LAUNCHES = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_ln")
        lib.fused_ln.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        lib.fused_ln.restype = ctypes.c_int
        lib.fused_ln_error_string.argtypes = [ctypes.c_int]
        lib.fused_ln_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h · c mod 2**32`` for int64 ``h`` in [0, 2**32): in 16-bit halves
    of ``c``, so that no product leaves int64 (torch has no uint32
    arithmetic)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_uniform(seed, shape: Tuple[int, ...], offset: int = 0, *,
                 device=None) -> torch.Tensor:
    """Uniform [0, 1) fp32 of ``shape`` (1-D or 2-D) from the hash of each
    element's linear index plus ``offset``, mod 2**32 — the reference's
    :33, computed in int64 and masked to 32 bits after every step."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"hash_uniform takes a 1-D or 2-D shape; got "
                         f"{shape}")
    idx = torch.arange(shape[0], dtype=torch.int64, device=device)
    if len(shape) == 2:
        idx = (idx * shape[1])[:, None] + torch.arange(
            shape[1], dtype=torch.int64, device=device)[None, :]
    h = (idx + (int(offset) & _M32)) & _M32
    h = _mul32(h ^ (int(seed) & _M32), 0x9E3779B1)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _f32(v: float) -> torch.Tensor:
    """``v`` rounded to fp32, as a 0-d CPU tensor that joins fp32
    arithmetic on either device (the reference's weakly typed scalar)."""
    return torch.tensor(v, dtype=torch.float32)


def fused_ln_ref(x: torch.Tensor, residual: torch.Tensor, bias: torch.Tensor,
                 gamma: torch.Tensor, beta: torch.Tensor, seed, *, p: float,
                 eps: float) -> torch.Tensor:
    """Plain version of the kernel (the reference's ``_fused_math``): keep
    where ``u >= fp32(p)``, scale by a true fp32 division by
    ``fp32(1 - p)``, mean and centred variance in fp32."""
    N, D = x.shape
    h = x.float() + bias.float()
    if p > 0.0:
        u = hash_uniform(seed, (N, D), device=x.device)
        h = torch.where(u >= _f32(p), h / _f32(1.0 - p), 0.0)
    z = residual.float() + h
    mean = z.mean(-1, keepdim=True)
    zc = z - mean
    var = (zc * zc).mean(-1, keepdim=True)
    y = zc * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return y.to(x.dtype)


def fused_ln(x: torch.Tensor, residual: torch.Tensor, bias: torch.Tensor,
             gamma: torch.Tensor, beta: torch.Tensor, seed, *, p: float,
             eps: float) -> torch.Tensor:
    """``x``, ``residual`` ``(N, D)`` of one type (fp32 or bf16); ``bias``,
    ``gamma``, ``beta`` ``(D,)`` in x's type or fp32; ``seed`` an integer
    (its low 32 bits are the hash seed).  Returns a new ``(N, D)`` tensor
    in x's type.  CUDA tensors go through the kernel (contiguous inputs);
    CPU tensors take :func:`fused_ln_ref`."""
    global LAUNCHES
    if x.dim() != 2 or residual.shape != x.shape:
        raise ValueError(f"fused_ln takes x and residual (N, D); got "
                         f"{tuple(x.shape)}, {tuple(residual.shape)}")
    N, D = x.shape
    vectors = (bias, gamma, beta)
    if any(t.shape != (D,) for t in vectors):
        raise ValueError(f"fused_ln: bias, gamma, beta must be ({D},); got "
                         f"{[tuple(t.shape) for t in vectors]}")
    devices = {t.device for t in (x, residual, *vectors)}
    if len(devices) != 1:
        raise ValueError(f"fused_ln: tensors on different devices: "
                         f"{devices}")
    if x.device.type == "cpu":
        return fused_ln_ref(x, residual, bias, gamma, beta, seed, p=p,
                            eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln runs on CUDA or CPU, not {x.device}")
    if x.dtype not in _DTYPE_CODES or residual.dtype != x.dtype:
        raise TypeError(f"the kernel takes fp32 or bf16 x and residual of "
                        f"one type; got {x.dtype}, {residual.dtype}")
    if any(t.dtype not in (torch.float32, x.dtype) for t in vectors):
        raise TypeError(f"fused_ln: bias, gamma, beta must be fp32 or "
                        f"{x.dtype}; got {[t.dtype for t in vectors]}")
    if not all(t.is_contiguous() for t in (x, residual, *vectors)):
        raise ValueError("fused_ln: inputs must be contiguous")
    out = torch.empty_like(x)
    if N == 0 or D == 0:
        return out
    param_bf16 = sum(1 << i for i, t in enumerate(vectors)
                     if t.dtype == torch.bfloat16)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_ln(x.data_ptr(), residual.data_ptr(),
                           bias.data_ptr(), gamma.data_ptr(),
                           beta.data_ptr(), out.data_ptr(), N, D,
                           _DTYPE_CODES[x.dtype], param_bf16,
                           int(seed) & _M32, int(p > 0.0), p, 1.0 - p, eps,
                           stream)
    if err:
        raise RuntimeError(f"fused_ln launch failed: "
                           f"{lib.fused_ln_error_string(err).decode()} "
                           f"(cudaError {err})")
    LAUNCHES += 1
    return out
