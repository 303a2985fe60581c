"""Fused softmax cross-entropy LM head — the counterpart of
``paddle_tpu/ops/pallas/softmax_xent.py``.

:func:`softmax_xent_fwd` returns the per-row log-sum-exp and label logit
of ``x @ w`` without an ``(N, V)`` logits tensor: on a CUDA tensor it
launches the hand-written kernel ``csrc/softmax_xent_fwd.cu`` (or raises),
on a CPU tensor it computes :func:`softmax_xent_fwd_ref`, its plain
version.  :func:`softmax_xent_dlogits` forms one chunk's
``(softmax(x @ w) - onehot(labels)) · g`` from the saved lse in x's type:
the kernel ``csrc/softmax_xent_dlogits.cu`` on a CUDA tensor,
:func:`softmax_xent_dlogits_ref` on a CPU tensor.
:func:`softmax_xent_loss` is the mean cross-entropy as an autograd
function whose backward is the reference's ``_sxl_bwd`` (:200): per chunk
of rows one dlogits launch, then ``dx`` and ``dW`` as plain products, as
the reference left them to XLA.  :data:`LAUNCHES` and
:data:`DLOGITS_LAUNCHES` count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["softmax_xent_fwd", "softmax_xent_fwd_ref", "softmax_xent_dlogits",
           "softmax_xent_dlogits_ref", "softmax_xent_loss", "SoftmaxXentLoss",
           "matmul_f32", "LAUNCHES", "DLOGITS_LAUNCHES", "BWD_CHUNK"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BWD_CHUNK = 4096      # rows per backward chunk (the reference's C)

# kernel launches since import (plain integers; tests and the smoke run
# reset them to 0 and read them back)
LAUNCHES = 0             # softmax_xent_fwd
DLOGITS_LAUNCHES = 0     # softmax_xent_dlogits

_libs = {}


def _kernel(name: str = "softmax_xent_fwd"):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        fn = getattr(lib, name)
        if name == "softmax_xent_fwd":
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            err = lib.softmax_xent_error_string
        else:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            err = lib.softmax_xent_dlogits_error_string
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib.error_string = err
        _libs[name] = lib
    return lib


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32 from operands of one type
    (the reference's ``preferred_element_type=float32``): bf16 operands on
    the card go to cuBLAS with an fp32 output, anything else is multiplied
    in fp32 (a bf16 value is exact in fp32)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
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
    """``x (N, D)``, ``w (D, V)`` of one type (fp32 or bf16), ``labels
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
        raise TypeError(f"the kernel takes fp32 or bf16 x and w of one "
                        f"type; got {x.dtype}, {w.dtype}")
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
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.softmax_xent_fwd(x.data_ptr(), w.data_ptr(),
                                   lab.data_ptr(), lse.data_ptr(),
                                   at.data_ptr(), N, D, V,
                                   _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, lib, "softmax_xent_fwd")
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
    ``lse``: ``x (C, D)``, ``w (D, V)`` of one type (fp32 or bf16),
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
        raise TypeError(f"the kernel takes fp32 or bf16 x and w of one "
                        f"type; got {x.dtype}, {w.dtype}")
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
    lib = _kernel("softmax_xent_dlogits")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.softmax_xent_dlogits(x.data_ptr(), w.data_ptr(),
                                       labels.data_ptr(), lse.data_ptr(),
                                       g.data_ptr(), out.data_ptr(), C, D, V,
                                       _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, lib, "softmax_xent_dlogits")
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
