"""Fused softmax cross-entropy LM head — the counterpart of
``paddle_tpu/ops/pallas/softmax_xent.py``.

:func:`softmax_xent_fwd` returns the per-row log-sum-exp and label logit
of ``x @ w`` without an ``(N, V)`` logits tensor: on a CUDA tensor it
launches a hand-written kernel (or raises), on a CPU tensor it computes
:func:`softmax_xent_fwd_ref`, its plain version.
:func:`softmax_xent_dlogits` forms one chunk's
``(softmax(x @ w) - onehot(labels)) · g`` from the saved lse in x's type:
a kernel on a CUDA tensor, :func:`softmax_xent_dlogits_ref` on a CPU
tensor.  Which CUDA source runs is :func:`_route`'s choice, made before
any launch: ``csrc/softmax_xent_sm90.cu`` (TMA and wgmma) for bf16 and
fp16 operands TMA can describe, else ``csrc/softmax_xent_fwd.cu`` /
``csrc/softmax_xent_dlogits.cu`` (``mma.sync`` tiles).  A launch on either
route that fails raises; it is never retried on the other.
:func:`softmax_xent_loss` is the mean cross-entropy as an autograd
function whose backward is the reference's ``_sxl_bwd`` (:200): per chunk
of rows one dlogits launch, then ``dx`` and ``dW`` as plain products, as
the reference left them to XLA.  :data:`LAUNCHES` and
:data:`DLOGITS_LAUNCHES` count kernel launches, :data:`ROUTE_LAUNCHES`
the same launches by route.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["softmax_xent_fwd", "softmax_xent_fwd_ref", "softmax_xent_dlogits",
           "softmax_xent_dlogits_ref", "softmax_xent_loss", "SoftmaxXentLoss",
           "matmul_f32", "LAUNCHES", "DLOGITS_LAUNCHES", "ROUTE_LAUNCHES",
           "BWD_CHUNK", "SM90_BN"]

# the kernels' type codes (the sm90 source takes 1 and 2, the tile
# kernels all three)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SM90_DTYPES = (torch.bfloat16, torch.float16)
BWD_CHUNK = 4096      # rows per backward chunk (the reference's C)

# the sm90 kernels' vocabulary columns per tile (csrc/softmax_xent_sm90.cu
# BN): the forward's partials hold one max and one sum per row and tile
SM90_BN = 256

# kernel launches since import (plain integers; tests and the smoke run
# reset them to 0 and read them back)
LAUNCHES = 0             # softmax_xent_fwd
DLOGITS_LAUNCHES = 0     # softmax_xent_dlogits
# the same launches by route (:func:`_route`); reset each value to 0
ROUTE_LAUNCHES = {"sm90_fwd": 0, "tile_fwd": 0, "sm90_dlogits": 0,
                  "tile_dlogits": 0}

_P, _I = [ctypes.c_void_p], [ctypes.c_int]
# CUDA source -> (its error-string function, {entry point: argtypes})
_ENTRY_POINTS = {
    "softmax_xent_fwd": ("softmax_xent_error_string", {
        "softmax_xent_fwd": _P * 5 + _I * 4 + _P}),
    "softmax_xent_dlogits": ("softmax_xent_dlogits_error_string", {
        "softmax_xent_dlogits": _P * 6 + _I * 4 + _P}),
    "softmax_xent_sm90": ("softmax_xent_sm90_error_string", {
        "softmax_xent_sm90_fwd": _P * 6 + _I * 4 + _P,
        "softmax_xent_sm90_dlogits": _P * 6 + _I * 4 + _P}),
}

_libs = {}


def _kernel(name: str = "softmax_xent_fwd"):
    """The loaded library of ``csrc/<name>.cu``, its entry points typed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        err_name, entries = _ENTRY_POINTS[name]
        for fn_name, argtypes in entries.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, err_name)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib.error_string = err
        _libs[name] = lib
    return lib


def _route(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which CUDA source takes a head launch on ``x (rows, D)`` and ``w
    (D, V)``: ``"sm90"`` (``csrc/softmax_xent_sm90.cu``, TMA and wgmma)
    when both are bf16, or both fp16, and contiguous with rows TMA can
    describe (``D`` and ``V`` multiples of 8, so 16-byte row strides, and
    16-byte aligned bases), else ``"tile"`` (``csrc/softmax_xent_fwd.cu``
    / ``softmax_xent_dlogits.cu``: fp32, and 16-bit rows such as V 700).
    A pure function of the types, shapes and layouts."""
    D, V = w.shape
    if x.dtype not in _SM90_DTYPES or w.dtype != x.dtype \
            or not (x.is_contiguous() and w.is_contiguous()) \
            or D % 8 or V % 8 or x.data_ptr() % 16 or w.data_ptr() % 16:
        return "tile"
    return "sm90"


def _launch_sm90_fwd(x, w, lab, lse, at) -> None:
    """Row 10 on ``csrc/softmax_xent_sm90.cu``: the tiles' max and sum
    partials, then their fold into ``lse``.  An operand TMA cannot
    describe fails the encode of its map, and the launch raises."""
    N, D = x.shape
    V = w.shape[1]
    part = torch.empty((2, -(-V // SM90_BN), N), dtype=torch.float32,
                       device=x.device)
    lib = _kernel("softmax_xent_sm90")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.softmax_xent_sm90_fwd(x.data_ptr(), w.data_ptr(),
                                        lab.data_ptr(), lse.data_ptr(),
                                        at.data_ptr(), part.data_ptr(), N, D,
                                        V, _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, lib, "softmax_xent_fwd (sm90)")
    ROUTE_LAUNCHES["sm90_fwd"] += 1


def _launch_sm90_dlogits(x, w, labels, lse, g, out) -> None:
    """Row 11 on ``csrc/softmax_xent_sm90.cu``; raises as
    :func:`_launch_sm90_fwd`."""
    C, D = x.shape
    lib = _kernel("softmax_xent_sm90")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.softmax_xent_sm90_dlogits(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), out.data_ptr(), C, D, w.shape[1],
            _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, lib, "softmax_xent_dlogits (sm90)")
    ROUTE_LAUNCHES["sm90_dlogits"] += 1


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32 from operands of one type
    (the reference's ``preferred_element_type=float32``): bf16 and fp16
    operands on the card go to cuBLAS with an fp32 output, anything else
    is multiplied in fp32 (a 16-bit value is exact in fp32)."""
    if a.is_cuda and a.dtype in _SM90_DTYPES:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _chunk(n: int) -> int:
    c = min(BWD_CHUNK, n)
    while n % c:
        c //= 2
    return c


def softmax_xent_fwd_ref(x: torch.Tensor, w: torch.Tensor,
                         labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: fp32 logits chunk by chunk, their
    log-sum-exp and the logit at each label (0 for a label outside
    ``[0, V)``, as the kernel leaves it)."""
    N, V = x.shape[0], w.shape[1]
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    at = torch.zeros(N, dtype=torch.float32, device=x.device)
    c = _chunk(N) if N else 1
    for c0 in range(0, N, c):
        logits = matmul_f32(x[c0:c0 + c], w)
        lse[c0:c0 + c] = torch.logsumexp(logits, -1)
        lab = labels[c0:c0 + c].long()
        ok = (lab >= 0) & (lab < V)
        picked = logits.gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
        at[c0:c0 + c] = torch.where(ok, picked, torch.zeros_like(picked))
    return lse, at


def softmax_xent_fwd(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (N, D)``, ``w (D, V)`` of one type (fp32, bf16 or fp16), ``labels
    (N,)`` integers -> ``(lse (N,), at (N,))`` in fp32;
    ``loss = mean(lse - at)``.  CUDA tensors go through the kernel; CPU
    tensors take :func:`softmax_xent_fwd_ref`."""
    global LAUNCHES
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or labels.shape != (x.shape[0],):
        raise ValueError(f"softmax_xent_fwd takes x (N, D), w (D, V), "
                         f"labels (N,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(labels.shape)}")
    devices = {x.device, w.device, labels.device}
    if len(devices) != 1:
        raise ValueError(f"softmax_xent_fwd: tensors on different devices: "
                         f"{devices}")
    if x.device.type == "cpu":
        return softmax_xent_fwd_ref(x, w, labels)
    if x.device.type != "cuda":
        raise ValueError(f"softmax_xent_fwd runs on CUDA or CPU, not "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"the kernel takes fp32, bf16 or fp16 x and w of "
                        f"one type; got {x.dtype}, {w.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be integers; got {labels.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("softmax_xent_fwd: x and w must be contiguous")
    N, D = x.shape
    V = w.shape[1]
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    at = torch.zeros(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return lse, at
    if D == 0 or V == 0:
        raise ValueError(f"softmax_xent_fwd over D={D}, V={V}")
    lab = labels.to(torch.int32).contiguous()
    if _route(x, w) == "sm90":
        _launch_sm90_fwd(x, w, lab, lse, at)
    else:
        lib = _kernel()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.softmax_xent_fwd(x.data_ptr(), w.data_ptr(),
                                       lab.data_ptr(), lse.data_ptr(),
                                       at.data_ptr(), N, D, V,
                                       _DTYPE_CODES[x.dtype], stream)
        _raise_on(err, lib, "softmax_xent_fwd")
        ROUTE_LAUNCHES["tile_fwd"] += 1
    LAUNCHES += 1
    return lse, at


def _raise_on(err: int, lib, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.error_string(err).decode()} "
                           f"(cudaError {err})")


def softmax_xent_dlogits_ref(x: torch.Tensor, w: torch.Tensor,
                             labels: torch.Tensor, lse: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """Plain version of the dlogits kernel: ``p = exp(x @ w - lse)`` in
    fp32, 1 subtracted at each label inside ``[0, V)``, times ``g``, cast
    to x's type; ``(C, V)``."""
    V = w.shape[1]
    p = torch.exp(matmul_f32(x, w) - lse[:, None])
    lab = labels.long()
    ok = (lab >= 0) & (lab < V)
    # p - 1 at the label (p + -1 is the same fp32 value), p + -0 elsewhere
    p.scatter_add_(1, lab.clamp(0, V - 1)[:, None], -ok[:, None].to(p.dtype))
    return (p * g).to(x.dtype)


def softmax_xent_dlogits(x: torch.Tensor, w: torch.Tensor,
                         labels: torch.Tensor, lse: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """``(softmax(x @ w) - onehot(labels)) · g`` in x's type from the saved
    ``lse``: ``x (C, D)``, ``w (D, V)`` of one type (fp32, bf16 or fp16),
    ``labels (C,)`` integers (int32 on the card), ``lse (C,)`` fp32, ``g``
    a one-element fp32 tensor, read where it lies (no host sync).  Returns
    ``(C, V)``.  CUDA tensors go through the kernel; CPU tensors take
    :func:`softmax_xent_dlogits_ref`."""
    global DLOGITS_LAUNCHES
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or labels.shape != (x.shape[0],) or lse.shape != labels.shape \
            or g.numel() != 1:
        raise ValueError(f"softmax_xent_dlogits takes x (C, D), w (D, V), "
                         f"labels (C,), lse (C,), one g; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}, {tuple(lse.shape)}, "
                         f"{tuple(g.shape)}")
    devices = {t.device for t in (x, w, labels, lse, g)}
    if len(devices) != 1:
        raise ValueError(f"softmax_xent_dlogits: tensors on different "
                         f"devices: {devices}")
    if x.device.type == "cpu":
        return softmax_xent_dlogits_ref(x, w, labels, lse, g)
    if x.device.type != "cuda":
        raise ValueError(f"softmax_xent_dlogits runs on CUDA or CPU, not "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"the kernel takes fp32, bf16 or fp16 x and w of "
                        f"one type; got {x.dtype}, {w.dtype}")
    if labels.dtype != torch.int32 or lse.dtype != torch.float32 \
            or g.dtype != torch.float32:
        raise TypeError(f"softmax_xent_dlogits takes int32 labels and fp32 "
                        f"lse and g; got {labels.dtype}, {lse.dtype}, "
                        f"{g.dtype}")
    if not all(t.is_contiguous() for t in (x, w, labels, lse)):
        raise ValueError("softmax_xent_dlogits: inputs must be contiguous")
    C, D = x.shape
    V = w.shape[1]
    out = torch.empty((C, V), dtype=x.dtype, device=x.device)
    if C == 0:
        return out
    if D == 0 or V == 0:
        raise ValueError(f"softmax_xent_dlogits over D={D}, V={V}")
    if _route(x, w) == "sm90":
        _launch_sm90_dlogits(x, w, labels, lse, g, out)
    else:
        lib = _kernel("softmax_xent_dlogits")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.softmax_xent_dlogits(x.data_ptr(), w.data_ptr(),
                                           labels.data_ptr(), lse.data_ptr(),
                                           g.data_ptr(), out.data_ptr(), C, D,
                                           V, _DTYPE_CODES[x.dtype], stream)
        _raise_on(err, lib, "softmax_xent_dlogits")
        ROUTE_LAUNCHES["tile_dlogits"] += 1
    DLOGITS_LAUNCHES += 1
    return out


class SoftmaxXentLoss(torch.autograd.Function):
    """mean over rows of ``lse - at``; the backward recomputes the logits
    chunk by chunk from the saved lse."""

    @staticmethod
    def forward(ctx, x, w, labels):
        lse, at = softmax_xent_fwd(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        return (lse - at).sum() / x.shape[0]

    @staticmethod
    def backward(ctx, g):
        """The reference's ``_sxl_bwd``: per chunk of C rows,
        ``pb = ((exp(logits - lse) - onehot) · g/N)`` in x's type (one
        :func:`softmax_xent_dlogits` launch), ``dx = pb wᵀ`` and
        ``dW += xᵀ pb`` in fp32, cast to w's type.  ``g/N`` stays on the
        device; the labels are cast to int32 once."""
        x, w, labels, lse = ctx.saved_tensors
        N, D = x.shape
        gs = g.float() / N
        lab = labels.to(torch.int32)
        dx = torch.empty_like(x)
        dw = torch.zeros((D, w.shape[1]), dtype=torch.float32,
                         device=x.device)
        c = _chunk(N)
        for c0 in range(0, N, c):
            xc = x[c0:c0 + c]
            pb = softmax_xent_dlogits(xc, w, lab[c0:c0 + c],
                                      lse[c0:c0 + c], gs)
            dx[c0:c0 + c] = torch.matmul(pb, w.t())
            dw += matmul_f32(xc.t(), pb)
        return dx, dw.to(w.dtype), None


def softmax_xent_loss(x: torch.Tensor, w: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of ``x @ w`` against ``labels``, with no
    ``(N, V)`` logits tensor in the forward."""
    return SoftmaxXentLoss.apply(x, w, labels)
