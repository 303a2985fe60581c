"""Packed-QKV flash attention, forward and backward — the counterpart of
``flash_attention_qkv`` in ``paddle_tpu/ops/pallas/flash_attention.py``
(its custom VJPs ``_flash_qkv`` for T <= 512 and ``_flash_qkv_mid`` for
512 < T <= 2048; longer sequences and head dims outside 32/64/128, which
the reference sends to its split path, take the same kernels here, which
stream K/V at any T and are built at every head dim of ``HEAD_DIMS``).

``qkv`` is the fused projection output ``(B, T, 3·H·d)`` laid out
``[q heads | k heads | v heads]`` (the reference's ``reshape(B, T, 3H, d)``
and split); the result is ``ctx (B, T, H·d)``.  :class:`FlashQKV` is the
autograd function: its forward is :func:`flash_qkv_fwd` and its backward
:func:`flash_qkv_bwd`.  These wrappers launch the attention kernels of
:mod:`.flash_attention` (bf16 and fp16 at d 64 / 128:
``csrc/flash_attn_sm90.cu``; fp32 at every built head dim, and bf16 and
fp16 at the others: ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu``; see ``kernel_route``) on head views of the
packed projection, which those kernels read, and of the packed gradient,
which they write, by stride: no head-split copy is made in either
direction.  On a CUDA tensor each wrapper launches its kernel or raises;
on a CPU tensor it computes its plain PyTorch version
(:func:`flash_qkv_fwd_ref`, :func:`flash_qkv_bwd_ref`).
:func:`flash_attention_qkv_ref` is the plain differentiable function the
tests hold both against.  :data:`FWD_LAUNCHES` and :data:`BWD_LAUNCHES`
count kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as _fa
from .flash_attention import HEAD_DIMS, NEG_INF, _scale, flash_attention_ref

__all__ = ["flash_attention_qkv", "flash_attention_qkv_ref", "FlashQKV",
           "flash_qkv_fwd", "flash_qkv_bwd", "flash_qkv_fwd_ref",
           "flash_qkv_bwd_ref", "FWD_LAUNCHES", "BWD_LAUNCHES", "HEAD_DIMS"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# kernel launches since import (plain integers; tests and the smoke run
# reset them to 0 and read them back)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

def _dims(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, T, 3·H·d); got {tuple(qkv.shape)}")
    B, T, F3 = qkv.shape
    if num_heads <= 0 or F3 % (3 * num_heads):
        raise ValueError(f"qkv width {F3} is not 3·H·d for H={num_heads}")
    return B, T, num_heads, F3 // (3 * num_heads)


def _split(qkv: torch.Tensor, num_heads: int):
    """q, k, v as (B, H, T, d) views of the packed projection."""
    B, T, H, d = _dims(qkv, num_heads)
    return qkv.reshape(B, T, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)


def _views(qkv: torch.Tensor, num_heads: int):
    """q, k, v as (B, T, H, d) views of the packed projection (or of its
    gradient): row stride 3F, q at column h·d, k at F + h·d, v at
    2F + h·d."""
    B, T, H, d = _dims(qkv, num_heads)
    return qkv.view(B, T, 3, H, d).unbind(2)


def _causal_mask(T: int, device) -> torch.Tensor:
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


def flash_attention_qkv_ref(qkv: torch.Tensor, num_heads: int, *,
                            causal: bool = False,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Plain, differentiable attention from the packed projection: the
    reference's split path (``flash_attention_qkv`` :631 into its XLA
    math), fp32 scores and probabilities cast to v's type."""
    B, T, H, d = _dims(qkv, num_heads)
    q, k, v = (x.reshape(B * H, T, d) for x in _split(qkv, num_heads))
    out = flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return out.reshape(B, H, T, d).permute(0, 2, 1, 3).reshape(B, T, H * d)


def flash_qkv_fwd_ref(qkv: torch.Tensor, num_heads: int, *,
                      causal: bool = False, scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(ctx (B, T, F), lse (B, H, T)
    fp32)``.  The math of ``_qkv_fwd_kernel`` (:276): fp32 scores,
    ``p = exp(s - max)`` cast to v's type for the product, fp32
    accumulation, divided by the fp32 row sum."""
    B, T, H, d = _dims(qkv, num_heads)
    q, k, v = _split(qkv, num_heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(d, scale)
    if causal:
        s = s.masked_fill(~_causal_mask(T, s.device), NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    pv = torch.matmul(e.to(qkv.dtype).float(), v.float())
    out = (pv / l).to(qkv.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.permute(0, 2, 1, 3).reshape(B, T, H * d), lse


def flash_qkv_bwd_ref(qkv: torch.Tensor, out: torch.Tensor,
                      lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
                      *, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the backward kernel: ``dqkv (B, T, 3F)`` in the
    packed layout.  The math of ``_qkv_bwd_kernel`` (:303): P rebuilt from
    q and k, ``delta = rowsum(P * dP)``, P cast to dO's type for dV and
    ``dS = P (dP - delta)`` cast to q's type for dQ and dK, all products
    accumulated in fp32.  ``out`` and ``lse`` are the kernel's residuals;
    this version rebuilds P without them, as the reference does."""
    del out, lse
    B, T, H, d = _dims(qkv, num_heads)
    sc = _scale(d, scale)
    dt = qkv.dtype
    q, k, v = (x.float() for x in _split(qkv, num_heads))
    do = dout.reshape(B, T, H, d).permute(0, 2, 1, 3).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * sc
    if causal:
        s = s.masked_fill(~_causal_mask(T, s.device), NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (p * dp).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    ds = (p * (dp - delta)).to(dt).float()
    dq = sc * torch.matmul(ds, k)
    dk = sc * torch.matmul(ds.transpose(-1, -2), q)
    grads = torch.stack([dq, dk, dv]).to(dt)          # (3, B, H, T, d)
    return grads.permute(1, 3, 0, 2, 4).reshape(B, T, 3 * H * d)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name} takes fp32, bf16 or fp16; got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed types {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _route(name: str, qkv: torch.Tensor, num_heads: int, *others) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU);
    raises on anything the kernel does not take."""
    B, T, H, d = _dims(qkv, num_heads)
    devices = {qkv.device} | {t.device for t in others}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices: {devices}")
    if qkv.device.type == "cpu":
        return False
    # the split kernels' head dims: d 16 runs them too, on head views of
    # the projection, where the reference's packed entry reroutes to its
    # split path
    _fa._check_head_dim(name, d)
    if qkv.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, not {qkv.device}")
    return True


def flash_qkv_fwd(qkv: torch.Tensor, num_heads: int, *,
                  causal: bool = False, scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ctx (B, T, F), lse (B, H, T) fp32)`` for a packed ``qkv``.  CUDA
    tensors go through the kernel; CPU tensors take
    :func:`flash_qkv_fwd_ref`."""
    global FWD_LAUNCHES
    if not _route("flash_qkv_fwd", qkv, num_heads):
        return flash_qkv_fwd_ref(qkv, num_heads, causal=causal, scale=scale)
    B, T, H, d = _dims(qkv, num_heads)
    _check_cuda("flash_qkv_fwd", qkv)
    out = torch.empty((B, T, H * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qkv.device)
    if B * T == 0:
        return out, lse
    q, k, v = _views(qkv, H)
    _fa._launch_fwd(q, k, v, out.view(B, T, H, d), lse, causal,
                    _scale(d, scale))
    FWD_LAUNCHES += 1
    return out, lse


def flash_qkv_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                  dout: torch.Tensor, num_heads: int, *,
                  causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """``dqkv (B, T, 3F)`` from the forward's ``qkv``, ``out`` and ``lse``
    and the gradient ``dout`` of ``out``.  CUDA tensors go through the
    kernel (three launches: delta, dK/dV, dQ; counted as one); CPU tensors
    take :func:`flash_qkv_bwd_ref`."""
    global BWD_LAUNCHES
    if not _route("flash_qkv_bwd", qkv, num_heads, out, lse, dout):
        return flash_qkv_bwd_ref(qkv, out, lse, dout, num_heads,
                                 causal=causal, scale=scale)
    B, T, H, d = _dims(qkv, num_heads)
    if out.shape != (B, T, H * d) or dout.shape != out.shape \
            or lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(f"flash_qkv_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype} do not fit qkv {tuple(qkv.shape)}")
    _check_cuda("flash_qkv_bwd", qkv, out, dout)
    if not lse.is_contiguous():
        raise ValueError("flash_qkv_bwd: lse must be contiguous")
    dqkv = torch.empty_like(qkv)
    if B * T == 0:
        return dqkv
    delta = torch.empty((B, H, T), dtype=torch.float32, device=qkv.device)
    q, k, v = _views(qkv, H)
    _fa._launch_bwd(q, k, v, out.view(B, T, H, d), lse,
                    dout.view(B, T, H, d), *_views(dqkv, H), delta, causal,
                    _scale(d, scale))
    BWD_LAUNCHES += 1
    return dqkv


class FlashQKV(torch.autograd.Function):
    """ctx = attention(qkv) with the kernels in both directions.

    ``saved`` is ``None``, or the ``(ctx, lse)`` an earlier forward over
    the same ``qkv`` produced: then no forward kernel runs and ``ctx`` is
    returned as it is.  A block recomputed for its backward under the
    ``"ctx"`` remat policy passes it, so the attention forward runs once
    per step.  The residuals are ``qkv``, ``ctx`` and ``lse``."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, scale, saved):
        if saved is None:
            out, lse = flash_qkv_fwd(qkv, num_heads, causal=causal,
                                     scale=scale)
        else:
            out, lse = saved
            out = out.detach()
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.causal, ctx.scale = num_heads, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = flash_qkv_bwd(qkv, out, lse, dout.contiguous(), ctx.num_heads,
                             causal=ctx.causal, scale=ctx.scale)
        return dqkv, None, None, None, None


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int, *,
                        causal: bool = False, scale: Optional[float] = None,
                        saved: Optional[Tuple[torch.Tensor, torch.Tensor]]
                        = None) -> torch.Tensor:
    """Attention straight from the fused projection output:
    ``(B, T, 3·H·d)`` in, ``(B, T, H·d)`` out (see :class:`FlashQKV`)."""
    return FlashQKV.apply(qkv, num_heads, causal, scale, saved)
