"""Flash attention, forward and backward — the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``: ``flash_attention`` (:1034)
and its custom VJP ``_flash`` (:975), routed by ``_pallas_mode`` (:55).

Two hand-written CUDA kernels carry every attention of the port.  Both read
``(B, S, H, D)`` operands by stride, so the head-split views of a fused
projection are read where they lie and no folded ``(B*H, T, D)`` copy is
made in either direction:

- ``csrc/flash_attn_fwd.cu``, wrapped by :func:`flash_attn_fwd`: the
  forward, with an optional fp32 lse ``(B, H, Tq)`` (reference rows 1 and
  2 here, row 3 through :mod:`.flash_attention_qkv`);
- ``csrc/flash_attn_bwd.cu``, wrapped by :func:`flash_attn_bwd`: the
  backward from the saved lse (rows 6, 7, 8 and 9 here, rows 4 and 5
  through :mod:`.flash_attention_qkv`).

Those two are built at the head dims of :data:`HEAD_DIMS` (16, 32, 64,
80, 96, 128) and carry fp32 (on the tensor cores in split precision,
3xTF32 ``mma.sync``) and bf16 at head dims 16, 32, 80 and 96
(``mma.sync``).  bf16 at head dims 64 and 128 goes to
``csrc/flash_attn_sm90.cu``, the same
forward and backward built for Hopper on ``wgmma`` and TMA tile loads
(:func:`kernel_route`); its operands are described to TMA by
:func:`tma_geometry`, and an operand TMA cannot describe raises.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes its plain PyTorch version (:func:`flash_attn_fwd_ref`,
:func:`flash_attn_bwd_ref`).  :class:`FlashAttention` is the autograd
function (the role of ``_flash``) and :func:`flash_attention` the
``(B, S, H, D)`` entry, which routes each call by :func:`_pallas_mode`.
:data:`FWD_LAUNCHES` and :data:`BWD_LAUNCHES` count launches,
:data:`MODE_LAUNCHES` counts them by direction and mode,
:data:`SM90_FWD_LAUNCHES` and :data:`SM90_BWD_LAUNCHES` count the launches
of ``flash_attn_sm90`` (these wrappers' and :mod:`.flash_attention_qkv`'s),
and :func:`reference_rows` names the TPU kernel a launch stands in for.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "FlashAttention", "flash_attn_fwd",
           "flash_attn_bwd", "flash_attn_fwd_ref", "flash_attn_bwd_ref",
           "flash_attention_ref", "reference_rows", "FWD_LAUNCHES",
           "BWD_LAUNCHES", "MODE_LAUNCHES", "NEG_INF", "HEAD_DIMS",
           "SM90_HEAD_DIMS", "SM90_FWD_LAUNCHES", "SM90_BWD_LAUNCHES",
           "kernel_route", "tma_geometry", "prepare_stream"]

NEG_INF = -1e30
# head dims the kernels are built at: every other d raises on the card
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
SM90_HEAD_DIMS = (64, 128)   # bf16 head dims of csrc/flash_attn_sm90.cu
SMALL_T_MAX = 1024      # flash_attention.py:43
MID_T_MAX = 4096        # flash_attention.py:52
SMALL_BWD_T_MAX = 512   # flash_attention.py:1011: longer keys take row 7
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's launches (csrc/flash_attn_bwd.cu `passes`)
PASS_DELTA, PASS_DKV, PASS_DQ = 1, 2, 4
ALL_PASSES = PASS_DELTA | PASS_DKV | PASS_DQ

# kernel launches since import (plain integers, and a dict keyed
# "fwd small", "bwd stream", ...; tests and the smoke run reset them to 0
# and read them back)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
MODE_LAUNCHES: Dict[str, int] = {}
# launches of csrc/flash_attn_sm90.cu (a backward's three passes count one)
SM90_FWD_LAUNCHES = 0
SM90_BWD_LAUNCHES = 0

_libs: Dict[str, ctypes.CDLL] = {}
_SCHED: Dict[Tuple[Optional[int], int], torch.Tensor] = {}
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "flash_attn_sm90":
            lib.flash_sm90_fwd.argtypes = [ctypes.c_void_p] * 5 + [
                _STRIDES] + [ctypes.c_int] * 6 + [ctypes.c_float] + [
                ctypes.c_void_p] * 2
            lib.flash_sm90_fwd.restype = ctypes.c_int
            lib.flash_sm90_bwd.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), _STRIDES, ctypes.c_void_p,
                ctypes.c_void_p] + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2
            lib.flash_sm90_bwd.restype = ctypes.c_int
            err = lib.flash_sm90_error_string
        elif name == "flash_attn_fwd":
            lib.flash_attn_fwd.argtypes = [ctypes.c_void_p] * 5 + [
                _STRIDES] + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                 ctypes.c_void_p]
            lib.flash_attn_fwd.restype = ctypes.c_int
            err = lib.flash_attn_error_string
        else:
            lib.flash_attn_bwd.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), _STRIDES, ctypes.c_void_p,
                ctypes.c_void_p] + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            lib.flash_attn_bwd.restype = ctypes.c_int
            err = lib.flash_attn_bwd_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib.error_string = err
        _libs[name] = lib
    return lib


def _pallas_mode(seq_q: int, seq_k: int, causal: bool) -> str:
    """The reference's routing (:55) without its environment and TPU
    checks: ``"math"`` for causal attention with ``seq_q > seq_k`` (fully
    masked rows, which the reference keeps on its XLA math), else
    ``"small"`` (both lengths <= 1024), ``"mid"`` (<= 4096) or
    ``"stream"``.  Lengths that are not multiples of 128 go to the kernel,
    which masks the ragged edge, where the reference takes its XLA math."""
    if causal and seq_q > seq_k:
        return "math"
    if seq_q <= SMALL_T_MAX and seq_k <= SMALL_T_MAX:
        return "small"
    if seq_q <= MID_T_MAX and seq_k <= MID_T_MAX:
        return "mid"
    return "stream"


def reference_rows(direction: str, mode: str, seq_k: int) -> Tuple[int, ...]:
    """Rows of the kernel table (``PERF.md``) that a ``direction``
    (``"fwd"`` or ``"bwd"``) launch in ``mode`` stands in for: the forward
    is row 1 (``_small_fwd_kernel``) but row 2 (``_fwd_kernel_pipelined``)
    when streaming; the backward is row 6 (``_small_bwd_kernel``) for
    ``seq_k <= 512`` in mode ``"small"``, row 7 (``_tiled_bwd_kernel``)
    for longer small and mid keys, rows 8 and 9 (``_bwd_dq_kernel``,
    ``_bwd_dkv_kernel``) when streaming (:1007-1025)."""
    if direction == "fwd":
        return (2,) if mode == "stream" else (1,)
    if mode == "stream":
        return (8, 9)
    if mode == "small" and seq_k <= SMALL_BWD_T_MAX:
        return (6,)
    return (7,)


def _count(direction: str, tq: int, tk: int, causal: bool) -> None:
    key = f"{direction} {_pallas_mode(tq, tk, causal)}"
    MODE_LAUNCHES[key] = MODE_LAUNCHES.get(key, 0) + 1


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _visible(tq: int, tk: int, device) -> torch.Tensor:
    """(tq, tk) bool: query i sees key j iff j <= i + tk - tq."""
    return torch.ones((tq, tk), dtype=torch.bool, device=device).tril(tk - tq)


def _as_bshd(x: torch.Tensor) -> torch.Tensor:
    """A ``(B, S, H, D)`` view: ``(BH, T, d)`` is ``(BH, T, 1, d)``."""
    return x.unsqueeze(2) if x.dim() == 3 else x


def _fold(x: torch.Tensor) -> torch.Tensor:
    """``(B, S, H, D)`` -> contiguous ``(B*H, S, D)``."""
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()


def _unfold(x: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """``(B*H, S, D)`` -> ``(B, S, H, D)``."""
    return x.reshape(B, H, x.shape[1], x.shape[2]).permute(0, 2, 1, 3)


def _like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``(B, S, H, D)`` result in the rank of ``like``."""
    return x.squeeze(2) if like.dim() == 3 else x


def _lse_shape(q: torch.Tensor, q4: torch.Tensor) -> Tuple[int, ...]:
    """lse's shape for ``q``: ``(BH, Tq)`` or ``(B, H, Sq)``."""
    B, tq, H, _ = q4.shape
    return (q.shape[0], tq) if q.dim() == 3 else (B, H, tq)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    """fp32 ``q kᵀ·scale`` of folded operands, masked with NEG_INF."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_visible(s.shape[-2], s.shape[-1], s.device),
                          NEG_INF)
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch attention over ``(BH, T, d)`` — the reference's
    ``_xla_attention``: fp32 scores, bottom-right causal mask filled with
    ``NEG_INF``, probabilities cast to ``v``'s type before the product."""
    s = _scores(q, k, causal, _scale(q.shape[-1], scale))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v).to(q.dtype)


def flash_attn_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = False,
                       scale: Optional[float] = None,
                       return_lse: bool = False):
    """Plain version of the forward kernel, with its arguments and results
    (see :func:`flash_attn_fwd`): the output of
    :func:`flash_attention_ref` and lse = logsumexp of the masked fp32
    scores, as ``_fwd_kernel_pipelined`` writes it."""
    q4, k4, v4 = (_as_bshd(x) for x in (q, k, v))
    B, _tq, H, d = q4.shape
    qf, kf = _fold(q4), _fold(k4)
    out = _like(_unfold(flash_attention_ref(qf, kf, _fold(v4), causal=causal,
                                            scale=scale), B, H), q)
    if not return_lse:
        return out
    lse = torch.logsumexp(_scores(qf, kf, causal, _scale(d, scale)), -1)
    return out, lse.reshape(_lse_shape(q, q4))


def flash_attn_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor, *, causal: bool = False,
                       scale: Optional[float] = None):
    """Plain version of the backward kernel: ``(dq, dk, dv)`` from the
    forward's ``out`` and ``lse``, as ``_flash_bwd`` (:909) computes them:
    ``P = exp(s - lse)``, ``delta = rowsum(dO∘O)``, P cast to dO's type for
    dV and ``dS = P (dP - delta)`` cast to q's type for dQ and dK, every
    product in fp32."""
    q4, k4, v4 = (_as_bshd(x) for x in (q, k, v))
    B, tq, H, d = q4.shape
    sc = _scale(d, scale)
    dt = q.dtype
    qf, kf, vf = (_fold(x).float() for x in (q4, k4, v4))
    of, dof = (_fold(_as_bshd(x)).float() for x in (out, dout))
    s = _scores(qf, kf, causal, sc)
    p = torch.exp(s - lse.reshape(B * H, tq, 1))
    if causal:
        p = p.masked_fill(~_visible(tq, s.shape[-1], s.device), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    ds = (p * (dp - delta)).to(dt).float()
    dq = sc * torch.matmul(ds, kf)
    dk = sc * torch.matmul(ds.transpose(-1, -2), qf)
    return tuple(_like(_unfold(g.to(dt), B, H), like)
                 for g, like in ((dq, q), (dk, k), (dv, v)))


def _operands(name: str, q, k, v, *more):
    """``(B, S, H, D)`` views of q, k, v (and of ``more``, laid out as q),
    after the checks both the kernel and its plain version need."""
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"{name} takes (BH, T, d) or (B, S, H, D) tensors; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    q4, k4, v4 = (_as_bshd(x) for x in (q, k, v))
    B, _tq, H, d = q4.shape
    tk = k4.shape[1]
    if k4.shape != (B, tk, H, d) or v4.shape != k4.shape:
        raise ValueError(f"{name}: shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if tk == 0:
        raise ValueError(f"{name}: attention over zero keys")
    for x in more:
        if x.shape != q.shape:
            raise ValueError(f"{name}: {tuple(x.shape)} does not match q "
                             f"{tuple(q.shape)}")
    devices = {t.device for t in (q, k, v, *more)}
    if len(devices) != 1:
        raise ValueError(f"{name}: q, k, v on different devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU, not {q.device}")
    return q4, k4, v4


def _layout_ok(x: torch.Tensor) -> bool:
    """What the kernels read: a contiguous last axis, 16-byte aligned rows."""
    el = x.element_size()
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        (st * el) % 16 == 0 for n, st in zip(x.shape[:-1], x.stride()[:-1])
        if n > 1)


def _check_head_dim(name: str, d: int) -> None:
    """Raises ``ValueError`` for a head dim the kernels are not built at
    (:data:`HEAD_DIMS`); there is no fallback to the plain version."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not built; the kernels "
                         f"have {HEAD_DIMS}")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes fp32 or bf16; got {dtype}")
    _check_head_dim(name, tensors[0].shape[-1])
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed types {dtype} and {t.dtype}")
        if not _layout_ok(t):
            raise ValueError(f"{name}: operands need a contiguous last axis "
                             f"and 16-byte aligned rows; got strides "
                             f"{t.stride()}")


def tma_geometry(x: torch.Tensor, rows: int = 64) -> Dict[str, tuple]:
    """How TMA reads a ``(B, S, H, D)`` bf16 operand of
    ``csrc/flash_attn_sm90.cu``: ``dims`` ``(D, H, S, B)``, innermost
    first; ``strides``, the byte strides of H, S and B; ``box``
    ``(64, 1, rows, 1)``, one 128-byte-swizzled half of a ``rows``-row tile
    (a tile of head dim 128 is two boxes).  A dimension of extent 1 is
    never stepped over, so it takes the stride ``D·2`` whatever torch
    reports.  Raises ``ValueError`` where TMA cannot describe the operand:
    not 4-D, last axis not contiguous, base not 16-byte aligned, or a
    stride that is not a multiple of 16 bytes or is 2**40 bytes or more."""
    g = _tma_dims(x)
    return dict(dims=g[:4], strides=g[4:], box=(64, 1, rows, 1))


def _tma_dims(x: torch.Tensor) -> Tuple[int, ...]:
    """:func:`tma_geometry`'s dims and strides as one 7-tuple."""
    if x.dim() != 4:
        raise ValueError(f"TMA operands are (B, S, H, D); got "
                         f"{tuple(x.shape)}")
    B, S, H, D = x.shape
    sb, ss, sh, sd = x.stride()
    el = x.element_size()
    if sd != 1 and D > 1:
        raise ValueError(f"TMA cannot describe an operand whose last axis "
                         f"is not contiguous: strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"TMA cannot describe an operand whose base "
                         f"{x.data_ptr():#x} is not 16-byte aligned")
    strides = (sh * el if H > 1 else D * el, ss * el if S > 1 else D * el,
               sb * el if B > 1 else D * el)
    for st in strides:
        if st % 16 or not 0 < st < 2 ** 40:
            raise ValueError(f"TMA cannot describe an operand with byte "
                             f"strides {strides} (multiples of 16 below "
                             f"2**40 only)")
    return (D, H, S, B) + strides


def kernel_route(dtype: torch.dtype, head_dim: int,
                 *operands: torch.Tensor) -> str:
    """Which CUDA library takes an attention launch: ``"sm90"``
    (``csrc/flash_attn_sm90.cu``, wgmma and TMA) for bf16 at a head dim of
    :data:`SM90_HEAD_DIMS`, else ``"tile"`` (``csrc/flash_attn_fwd.cu`` /
    ``flash_attn_bwd.cu``: fp32 in 3xTF32, bf16 at d 16, 32, 80 and 96,
    all on ``mma.sync``).
    A pure function of the type, the head dim and the operands' layouts:
    an ``"sm90"`` operand that TMA cannot describe (:func:`tma_geometry`)
    raises ``ValueError``; it is never sent to the other library."""
    if _sm90_geometry(dtype, head_dim, *operands) is None:
        return "tile"
    return "sm90"


def _sm90_geometry(dtype: torch.dtype, head_dim: int, *tensors):
    """None where :func:`kernel_route` says ``"tile"``; else the
    :func:`tma_geometry` dims and byte strides of each operand, 7 values
    each, as the C array ``flash_attn_sm90`` takes."""
    if dtype != torch.bfloat16 or head_dim not in SM90_HEAD_DIMS:
        return None
    vals = sum((_tma_dims(t) for t in tensors), ())
    return (ctypes.c_longlong * len(vals))(*vals)


def _sched(device: torch.device, stream: int) -> int:
    """The item counters of ``flash_attn_sm90`` on this device and stream:
    four int32, zero between launches (each launch leaves them zero)."""
    key = (device.index, stream)
    buf = _SCHED.get(key)
    if buf is None:
        buf = _SCHED[key] = torch.zeros(4, dtype=torch.int32, device=device)
    return buf.data_ptr()


def prepare_stream(stream: torch.cuda.Stream) -> None:
    """Make ``flash_attn_sm90``'s item counters for ``stream`` now.  A
    CUDA graph captured on ``stream`` binds them by address; made at first
    use inside the capture, they would come from the graph's memory pool
    with their zero fill recorded into the graph."""
    _sched(stream.device, stream.cuda_stream)


def _strides(*tensors: torch.Tensor):
    """Element strides (batch, row, head) of each ``(B, S, H, D)`` operand,
    as the C array the kernels take."""
    vals = [st if n > 1 else 0 for t in tensors
            for n, st in zip(t.shape[:3], t.stride()[:3])]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(err: int, lib: ctypes.CDLL, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.error_string(err).decode()} "
                           f"(cudaError {err})")


def _launch_fwd(q4, k4, v4, out4, lse, causal: bool,
                scale: Optional[float]) -> None:
    """One launch of the forward (``flash_attn_sm90`` or
    ``flash_attn_fwd``, by :func:`kernel_route`) on checked operands."""
    global SM90_FWD_LAUNCHES
    B, tq, H, d = q4.shape
    geo = _sm90_geometry(q4.dtype, d, q4, k4, v4, out4)
    if geo is not None:
        lib = _lib("flash_attn_sm90")
        with torch.cuda.device(q4.device):
            stream = torch.cuda.current_stream(q4.device).cuda_stream
            sched = _sched(q4.device, stream)
            err = lib.flash_sm90_fwd(
                q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(),
                None if lse is None else lse.data_ptr(),
                geo, B, H, tq, k4.shape[1], d,
                int(bool(causal)), _scale(d, scale), sched, stream)
        _raise_on(err, lib, "flash_attn_sm90 forward")
        SM90_FWD_LAUNCHES += 1
        return
    lib = _lib("flash_attn_fwd")
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        err = lib.flash_attn_fwd(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _strides(q4, k4, v4, out4), B, H, tq, k4.shape[1], d,
            _DTYPE_CODES[q4.dtype], int(bool(causal)), _scale(d, scale),
            stream)
    _raise_on(err, lib, "flash_attn_fwd")


def _launch_bwd(q4, k4, v4, out4, lse, dout4, dq4, dk4, dv4, delta,
                causal: bool, scale: Optional[float],
                passes: int = ALL_PASSES) -> None:
    """Launches of the backward (``flash_attn_sm90`` or
    ``flash_attn_bwd``, by :func:`kernel_route`; the ``passes`` bit mask)
    on checked operands; ``lse`` and ``delta`` are contiguous
    ``(B, H, Tq)`` fp32."""
    global SM90_BWD_LAUNCHES
    B, tq, H, d = q4.shape
    ops = (q4, k4, v4, out4, dout4, dq4, dk4, dv4)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in ops))
    geo = _sm90_geometry(q4.dtype, d, *ops)
    if geo is not None:
        lib = _lib("flash_attn_sm90")
        with torch.cuda.device(q4.device):
            stream = torch.cuda.current_stream(q4.device).cuda_stream
            sched = _sched(q4.device, stream)
            err = lib.flash_sm90_bwd(
                ptrs, geo, lse.data_ptr(), delta.data_ptr(), B,
                H, tq, k4.shape[1], d, int(bool(causal)), _scale(d, scale),
                passes, sched, stream)
        _raise_on(err, lib, "flash_attn_sm90 backward")
        SM90_BWD_LAUNCHES += 1
        return
    lib = _lib("flash_attn_bwd")
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        err = lib.flash_attn_bwd(
            ptrs, _strides(*ops), lse.data_ptr(), delta.data_ptr(), B, H, tq,
            k4.shape[1], d, _DTYPE_CODES[q4.dtype], int(bool(causal)),
            _scale(d, scale), passes, stream)
    _raise_on(err, lib, "flash_attn_bwd")


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, scale: Optional[float] = None,
                   return_lse: bool = False):
    """softmax(q kᵀ·scale) v over ``(BH, Tq, d)`` / ``(BH, Tk, d)`` or
    ``(B, Sq, H, D)`` / ``(B, Sk, H, D)`` operands; the output is a new
    contiguous tensor of q's shape and type.  With ``return_lse`` it
    returns ``(out, lse)``, lse fp32 ``(BH, Tq)`` or ``(B, H, Sq)``.

    CUDA tensors go through the kernel (fp32 or bf16, d in
    :data:`HEAD_DIMS`, any strides with a contiguous last axis and 16-byte
    aligned rows); anything else it refuses raises.  CPU tensors take
    :func:`flash_attn_fwd_ref`.  Causal attention with ``Tq > Tk`` is
    refused on both."""
    global FWD_LAUNCHES
    q4, k4, v4 = _operands("flash_attn_fwd", q, k, v)
    B, tq, H, d = q4.shape
    tk = k4.shape[1]
    if causal and tq > tk:
        raise ValueError(f"causal attention with Tq={tq} > Tk={tk} leaves "
                         "fully masked rows; the kernel does not take it")
    if q.device.type == "cpu":
        return flash_attn_fwd_ref(q, k, v, causal=causal, scale=scale,
                                  return_lse=return_lse)
    _check_cuda("flash_attn_fwd", q4, k4, v4)
    out4 = torch.empty((B, tq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, tq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    if B * H * tq:
        _launch_fwd(q4, k4, v4, out4, lse, causal, scale)
        FWD_LAUNCHES += 1
        _count("fwd", tq, tk, causal)
    out = _like(out4, q)
    if not return_lse:
        return out
    return out, lse.reshape(_lse_shape(q, q4))


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   *, causal: bool = False, scale: Optional[float] = None):
    """``(dq, dk, dv)`` of :func:`flash_attn_fwd` from its ``out`` and
    ``lse`` and the gradient ``dout`` of ``out``, each in the layout of
    its input (new contiguous tensors).  CUDA tensors go through the kernel
    (three launches: delta, dK/dV, dQ; counted as one); CPU tensors take
    :func:`flash_attn_bwd_ref`."""
    global BWD_LAUNCHES
    q4, k4, v4 = _operands("flash_attn_bwd", q, k, v, out, dout)
    B, tq, H, d = q4.shape
    tk = k4.shape[1]
    if causal and tq > tk:
        raise ValueError(f"causal attention with Tq={tq} > Tk={tk} leaves "
                         "fully masked rows; the kernel does not take it")
    if tuple(lse.shape) != _lse_shape(q, q4) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attn_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} does not fit q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                  scale=scale)
    out4, dout4 = _as_bshd(out), _as_bshd(dout)
    _check_cuda("flash_attn_bwd", q4, k4, v4, out4, dout4)
    grads = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
             for x in (q4, k4, v4)]
    if B * H * tq:
        delta = torch.empty((B, H, tq), dtype=torch.float32, device=q.device)
        _launch_bwd(q4, k4, v4, out4, lse.contiguous(), dout4, *grads,
                    delta, causal, scale)
        BWD_LAUNCHES += 1
        _count("bwd", tq, tk, causal)
    return tuple(_like(g, like) for g, like in zip(grads, (q, k, v)))


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) with the kernels in both directions — the
    role of the reference's ``_flash``.  The forward saves q, k, v, out
    and the fp32 lse; the backward launches :func:`flash_attn_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attn_fwd(q, k, v, causal=causal, scale=scale,
                                  return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.is_cuda and not _layout_ok(dout):
            dout = dout.contiguous()
        dq, dk, dv = flash_attn_bwd(q, k, v, out, lse, dout,
                                    causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def _math_attention(q, k, v, causal: bool, scale: Optional[float]):
    """The reference's ``_xla_attention`` on ``(B, S, H, D)``, plain and
    differentiable by autograd."""
    B, _, H, _ = q.shape
    return _unfold(flash_attention_ref(_fold(q), _fold(k), _fold(v),
                                       causal=causal, scale=scale), B, H)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``(B, S, H, D)`` in, ``(B, S, H, D)`` out, routed as ``_flash``
    routes it: mode ``"math"`` (causal with Sq > Sk) takes the plain math;
    every other call takes the kernels, through :class:`FlashAttention`
    when a gradient is wanted and as one forward launch without lse
    otherwise (serving)."""
    if _pallas_mode(q.shape[1], k.shape[1], causal) == "math":
        return _math_attention(q, k, v, causal, scale)
    if q.is_cuda:
        q, k, v = (x if _layout_ok(x) else x.contiguous() for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, scale)
    return flash_attn_fwd(q, k, v, causal=causal, scale=scale)
