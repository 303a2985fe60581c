"""Fused bias + dropout + residual add + LayerNorm — the counterpart of
``paddle_tpu/ops/pallas/fused_ln.py``.

    out = LayerNorm(residual + dropout(x + bias)) · gamma + beta

over the rows of ``(N, D)`` inputs, with fp32 statistics and the result in
x's type.  The dropout mask is a pure function of (seed, element index):
:func:`hash_uniform` is the reference's Murmur3-finaliser hash bit for
bit, so a backward recomputes the mask instead of storing it.

:func:`fused_ln` launches the hand-written kernel ``csrc/fused_ln.cu`` on
CUDA tensors (or raises) and computes :func:`fused_ln_ref`, its plain
version, on CPU tensors; :func:`fused_ln_bwd` does the same for the
backward with ``csrc/fused_ln_bwd.cu`` and :func:`fused_ln_bwd_ref` (the
reference's ``_fused_bwd``, ``ops/fused_ops.py:62``, has no Pallas
kernel).  x and the residual may differ in type (a 16-bit type, bf16 or
fp16, beside fp32), as in the reference.  :data:`LAUNCHES` and
:data:`BWD_LAUNCHES` count kernel launches, :data:`ROUTE_LAUNCHES` the
forward's by the kernel that ran: ``"tile"`` (``ln_fwd_tile``, 16-bit x
at D <= 1024, D % 8 == 0, 16-byte aligned rows), ``"warp"``
(``fused_ln_warp``, the other rows up to D 1024) or ``"row"``
(``fused_ln_row``, longer rows).

The kernels read the hash seed from device memory, so that a step captured
in a CUDA graph draws new masks at every replay: the wrappers take the seed
as an integer (put on the card by one fill) or as a 1-element int64 tensor
on x's device (a slot of a captured step's seed vector,
:class:`~paddle_tpu_torch.random.SeedSlots`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["hash_uniform", "fused_ln_ref", "fused_ln", "fused_ln_bwd_ref",
           "fused_ln_bwd", "LAUNCHES", "BWD_LAUNCHES", "ROUTE_LAUNCHES"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LOW = (torch.bfloat16, torch.float16)
_M32 = 0xFFFFFFFF

# kernel launches since import, forward and backward (plain integers;
# tests and the smoke run reset them to 0 and read them back)
LAUNCHES = 0
BWD_LAUNCHES = 0
# the forward's launches by the kernel the library reports it ran (reset
# each value to 0)
ROUTE_LAUNCHES = {"tile": 0, "warp": 0, "row": 0}
_ROUTES = ("tile", "warp", "row")

_lib = None
_lib_bwd = None
# blocks that fit on the card at once, by (direction, device index, D,
# type codes): the backward's first launch, the forward's tile
_RESIDENT = {}


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_ln")
        lib.fused_ln.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        lib.fused_ln.restype = ctypes.c_int
        lib.fused_ln_resident.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.fused_ln_resident.restype = ctypes.c_int
        lib.fused_ln_error_string.argtypes = [ctypes.c_int]
        lib.fused_ln_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _kernel_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load("fused_ln_bwd")
        lib.fused_ln_bwd.argtypes = [ctypes.c_void_p] * 12 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_void_p]
        lib.fused_ln_bwd.restype = ctypes.c_int
        lib.fused_ln_bwd_resident.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.fused_ln_bwd_resident.restype = ctypes.c_int
        lib.fused_ln_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fused_ln_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


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


def _seed_on(seed, device: torch.device, p: float):
    """The seed as the kernels read it: an int64 tensor of one element on
    ``device`` (an integer is filled in there, with no host-to-device
    copy), or None without dropout, where the kernels do not read it."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype != torch.int64 or \
                seed.device != device:
            raise ValueError(f"a seed tensor must be one int64 on {device}; "
                             f"got {tuple(seed.shape)} {seed.dtype} on "
                             f"{seed.device}")
        return seed
    if p <= 0.0:
        return None
    return torch.full((1,), int(seed) & _M32, dtype=torch.int64,
                      device=device)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


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


def _check(name: str, tensors, x: torch.Tensor, residual: torch.Tensor,
           vectors) -> None:
    """The checks the forward and the backward share: (N, D) rows, (D,)
    vectors, one device."""
    if x.dim() != 2 or residual.shape != x.shape:
        raise ValueError(f"{name} takes x and residual (N, D); got "
                         f"{tuple(x.shape)}, {tuple(residual.shape)}")
    D = x.shape[1]
    if any(t.shape != (D,) for t in vectors):
        raise ValueError(f"{name}: bias, gamma, beta must be ({D},); got "
                         f"{[tuple(t.shape) for t in vectors]}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices: "
                         f"{devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU, not {x.device}")


def _check_cuda(name: str, tensors, x: torch.Tensor, residual: torch.Tensor,
                vectors) -> int:
    """What the kernels take: x and residual each fp32, bf16 or fp16, in
    the pairs AMP makes (one 16-bit type beside itself or fp32: bf16 beside
    fp16 is refused), bias, gamma, beta each fp32, bf16 or fp16,
    contiguous.  Returns the parameters' type codes, two bits each (bits
    0-1 bias, 2-3 gamma, 4-5 beta)."""
    if x.dtype not in _DTYPE_CODES or residual.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes x and residual each "
                        f"fp32, bf16 or fp16; got {x.dtype}, "
                        f"{residual.dtype}")
    if x.dtype in _LOW and residual.dtype in _LOW and \
            x.dtype != residual.dtype:
        raise TypeError(f"{name}: x {x.dtype} beside a {residual.dtype} "
                        f"residual is no pair AMP makes; the kernel takes "
                        f"a 16-bit type beside itself or fp32")
    if any(t.dtype not in _DTYPE_CODES for t in vectors):
        raise TypeError(f"{name}: bias, gamma, beta must each be fp32, bf16 "
                        f"or fp16; got {[t.dtype for t in vectors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return sum(_DTYPE_CODES[t.dtype] << (2 * i)
               for i, t in enumerate(vectors))


def fused_ln(x: torch.Tensor, residual: torch.Tensor, bias: torch.Tensor,
             gamma: torch.Tensor, beta: torch.Tensor, seed, *, p: float,
             eps: float) -> torch.Tensor:
    """``x``, ``residual`` ``(N, D)``, each fp32, bf16 or fp16 (in their
    own types, as the reference's kernel reads them; a 16-bit type beside
    itself or fp32); ``bias``, ``gamma``, ``beta`` ``(D,)``, each fp32,
    bf16 or fp16; ``seed`` an integer or a
    1-element int64 tensor on x's device (its low 32 bits are the hash
    seed).  Returns a new ``(N, D)`` tensor in x's type.
    CUDA tensors go through ``csrc/fused_ln.cu`` (contiguous inputs; one
    launch, counted in :data:`LAUNCHES` and by kernel in
    :data:`ROUTE_LAUNCHES`); CPU tensors take :func:`fused_ln_ref`."""
    global LAUNCHES
    vectors = (bias, gamma, beta)
    tensors = (x, residual, *vectors)
    _check("fused_ln", tensors, x, residual, vectors)
    if x.device.type == "cpu":
        return fused_ln_ref(x, residual, bias, gamma, beta, seed, p=p,
                            eps=eps)
    param_types = _check_cuda("fused_ln", tensors, x, residual, vectors)
    N, D = x.shape
    out = torch.empty_like(x)
    if N == 0 or D == 0:
        return out
    codes = (_DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype])
    lib = _kernel()
    route = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        seed_t = _seed_on(seed, x.device, p)
        blocks = _resident("fwd", x.device, D, codes)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_ln(x.data_ptr(), residual.data_ptr(),
                           bias.data_ptr(), gamma.data_ptr(),
                           beta.data_ptr(), out.data_ptr(), N, D, *codes,
                           param_types, _ptr(seed_t), int(p > 0.0), p,
                           1.0 - p, eps, blocks, ctypes.byref(route), stream)
    if err:
        raise RuntimeError(f"fused_ln launch failed: "
                           f"{lib.fused_ln_error_string(err).decode()} "
                           f"(cudaError {err})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[_ROUTES[route.value]] += 1
    return out


def fused_ln_bwd_ref(g: torch.Tensor, x: torch.Tensor,
                     residual: torch.Tensor, bias: torch.Tensor,
                     gamma: torch.Tensor, beta: torch.Tensor, seed, *,
                     p: float, eps: float):
    """Plain version of the backward kernel: the vjp of
    :func:`fused_ln_ref` (the reference's ``_fused_bwd``,
    ``fused_ops.py:62``) written out.  Returns ``(dx, dres, dbias,
    dgamma, dbeta)``, each in its input's type.  Computes in fp32, or in
    float64 when x is float64 (a truth to hold fp32 runs against); the
    mask and ``q = fp32(1 - p)`` are the forward's either way."""
    N, D = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    h = x.to(acc) + bias.to(acc)
    keep = None
    if p > 0.0:
        keep = hash_uniform(seed, (N, D), device=x.device) >= _f32(p)
        q = _f32(1.0 - p).to(acc)
        h = torch.where(keep, h / q, 0.0)
    z = residual.to(acc) + h
    mean = z.mean(-1, keepdim=True)
    zc = z - mean
    rstd = torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)
    y = zc * rstd
    gf = g.to(acc)
    gg = gf * gamma.to(acc)
    dz = rstd * (gg - gg.mean(-1, keepdim=True)
                 - y * (gg * y).mean(-1, keepdim=True))
    dh = dz if keep is None else torch.where(keep, dz / q, 0.0)
    # dres and dx are separate tensors even where their values agree:
    # autograd may accumulate into either in place
    return (dh.to(x.dtype, copy=True), dz.to(residual.dtype, copy=True),
            dh.sum(0).to(bias.dtype), (gf * y).sum(0).to(gamma.dtype),
            gf.sum(0).to(beta.dtype))


def _resident(direction: str, device: torch.device, D: int, codes) -> int:
    """Blocks that fit on the card at once, asked of the kernel's library
    once per direction, device, D and types: the backward's first launch
    (``fused_ln_bwd_resident``) or the forward's 16-bit tile
    (``fused_ln_resident``, 0 where the tile does not take the rows)."""
    key = (direction, device.index, D, codes)
    fit = _RESIDENT.get(key)
    if fit is None:
        lib = _kernel() if direction == "fwd" else _kernel_bwd()
        name = "fused_ln" if direction == "fwd" else "fused_ln_bwd"
        out = ctypes.c_int(0)
        err = getattr(lib, f"{name}_resident")(D, *codes, ctypes.byref(out))
        if err:
            raise RuntimeError(
                f"{name} occupancy query failed: "
                f"{getattr(lib, f'{name}_error_string')(err).decode()} "
                f"(cudaError {err})")
        fit = _RESIDENT[key] = out.value
    return fit


def _bwd_blocks(device: torch.device, N: int, D: int, codes) -> int:
    """Blocks of the backward's first launch: as many as fit on the card
    at once, and no more than the rows need (a block per eight rows at
    most on the warp paths, whose blocks take 8 or 16 rows at once, one
    per row on the row path)."""
    rows_at_once = 8 if D <= 1024 else 1
    return max(1, min(_resident("bwd", device, D, codes),
                      -(-N // rows_at_once)))


def fused_ln_bwd(g: torch.Tensor, x: torch.Tensor, residual: torch.Tensor,
                 bias: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 seed, *, p: float, eps: float):
    """The epilogue's backward: ``g`` ``(N, D)`` in x's type and the
    forward's inputs as :func:`fused_ln` takes them.  Returns ``(dx, dres,
    dbias, dgamma, dbeta)``, new tensors each in its input's type.  CUDA
    tensors go through ``csrc/fused_ln_bwd.cu`` (two launches: the rows,
    on ``ln_bwd_tile`` for 16-bit x at D <= 1024, then the fold of the
    column sums, counted once in
    :data:`BWD_LAUNCHES`); CPU tensors take :func:`fused_ln_bwd_ref`."""
    global BWD_LAUNCHES
    vectors = (bias, gamma, beta)
    tensors = (g, x, residual, *vectors)
    _check("fused_ln_bwd", tensors, x, residual, vectors)
    if g.shape != x.shape:
        raise ValueError(f"fused_ln_bwd: g must be {tuple(x.shape)}; got "
                         f"{tuple(g.shape)}")
    if x.device.type == "cpu":
        return fused_ln_bwd_ref(g, x, residual, bias, gamma, beta, seed, p=p,
                                eps=eps)
    param_types = _check_cuda("fused_ln_bwd", tensors, x, residual, vectors)
    if g.dtype != x.dtype:
        raise TypeError(f"fused_ln_bwd: g must be in x's type {x.dtype}; "
                        f"got {g.dtype}")
    N, D = x.shape
    dx, dres = torch.empty_like(x), torch.empty_like(residual)
    grads = [torch.empty_like(t) for t in vectors]
    if N == 0 or D == 0:
        return (dx, dres, *(t.zero_() for t in grads))
    codes = (_DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype])
    lib = _kernel_bwd()
    with torch.cuda.device(x.device):
        seed_t = _seed_on(seed, x.device, p)
        blocks = _bwd_blocks(x.device, N, D, codes)
        partial = torch.empty((blocks, 3, D), dtype=torch.float32,
                              device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_ln_bwd(
            g.data_ptr(), x.data_ptr(), residual.data_ptr(),
            bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            dx.data_ptr(), dres.data_ptr(), *(t.data_ptr() for t in grads),
            partial.data_ptr(), blocks, N, D, *codes, param_types,
            _ptr(seed_t), int(p > 0.0), p, 1.0 - p, eps, stream)
    if err:
        raise RuntimeError(f"fused_ln_bwd launch failed: "
                           f"{lib.fused_ln_bwd_error_string(err).decode()} "
                           f"(cudaError {err})")
    BWD_LAUNCHES += 1
    return (dx, dres, *grads)
