"""``paddle_tpu/ops/linalg.py`` whole: the products ``Tensor``'s methods
name (``matmul`` :34, ``mm``, ``bmm``, ``mv``, ``dot``, ``t``, ``norm``
:75, ``dist`` :95), then the decompositions, solves and statistics
(:110-273) on ``torch.linalg`` on the input's device.

The reference runs ``cross``, ``cholesky``, the solves, ``inverse``,
``pinv``, ``det``, ``matrix_power``, ``multi_dot`` and ``einsum`` through
its dispatch, so they carry gradients; it builds ``svd``, ``qr``, ``lu``,
``eig``, ``eigh``, ``eigvals``, ``eigvalsh``, ``slogdet``,
``matrix_rank``, ``histogram``, ``lstsq``, ``cov`` and ``corrcoef``
outside it, so their results record none (:168-266), and here neither.

``FLAGS_matmul_precision`` is read at each product, as the reference
reads it (:29): ``"default"``, ``"highest"`` and ``"float32"`` keep fp32
products in full fp32 (``device.resolve_device`` pins
``allow_tf32 = False`` on the card); ``"high"``, ``"tensorfloat32"`` and
``"bfloat16"`` let the card take fp32 products in TF32.
"""
from __future__ import annotations

import contextlib

import torch

from ..utils import flags
from ._common import INT, dispatch, no_grad_dispatch, promote
from ._common import t as _t

__all__ = [
    "matmul", "mm", "bmm", "dot", "t", "transpose_matmul", "norm", "dist",
    "cross", "cholesky", "solve", "triangular_solve", "cholesky_solve",
    "inverse", "pinv", "svd", "qr", "lu", "eig", "eigh", "eigvals",
    "eigvalsh", "det", "slogdet", "matrix_rank", "matrix_power",
    "multi_dot", "histogram", "mv", "lstsq", "cov", "corrcoef", "einsum",
]

_TF32 = ("high", "tensorfloat32", "bfloat16")


@contextlib.contextmanager
def _precision(a: torch.Tensor):
    """Products inside run at ``FLAGS_matmul_precision`` on the card."""
    if not a.is_cuda or flags.get_flag("FLAGS_matmul_precision") not in _TF32:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def kernel(a, b):
        a, b = promote(a, b)
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        if a.is_cuda and not (a.is_floating_point() or a.is_complex()):
            # the card has no integer product: float64 holds these sums
            # exactly below 2**53, and the cast wraps as int32 arithmetic
            out = torch.matmul(a.double(), b.double()).to(torch.int64)
            return out.to(a.dtype)
        with _precision(a):
            return torch.matmul(a, b)
    return dispatch("matmul", kernel, (_t(x), _t(y)), {})


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


def dot(x, y, name=None):
    def kernel(a, b):
        a, b = promote(a, b)
        out = torch.sum(a * b, dim=-1)
        return out.to(torch.int32) if out.dtype == torch.int64 else out
    return dispatch("dot", kernel, (_t(x), _t(y)), {})


def t(input, name=None):
    input = _t(input)
    if input.ndim < 2:
        return input
    from .manipulation import transpose
    return transpose(input, perm=[1, 0])


transpose_matmul = t


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = _t(x)
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def kernel(a):
        dims = tuple(range(a.dim())) if ax is None else ax
        if p == "fro":
            return torch.sqrt(torch.sum(torch.square(a), dim=dims,
                                        keepdim=keepdim))
        if p == float("inf"):
            return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
        return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=dims,
                                   keepdim=keepdim), 1.0 / p)
    return dispatch("norm", kernel, (x,), {})


def dist(x, y, p=2, name=None):
    def kernel(a, b):
        d = torch.abs(a - b)
        if p == float("inf"):
            return torch.amax(d)
        if p == float("-inf"):
            return torch.amin(d)
        if p == 0:
            return torch.sum((d != 0).to(d.dtype))
        return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)
    return dispatch("dist", kernel, (_t(x), _t(y)), {})


def cross(x, y, axis=9, name=None):
    """The default ``axis=9`` takes the first axis of size 3 (:110-114)."""
    x, y = _t(x), _t(y)
    ax = axis if axis != 9 else next(
        (i for i, s in enumerate(x.shape) if s == 3), -1)
    return dispatch("cross", lambda a, b: torch.linalg.cross(
        *promote(a, b), dim=ax), (x, y), {})


def _sym(a):
    """``(a + a^H) / 2``: the reference's ``cholesky`` and ``eigh`` read
    this, not one triangle (``jnp.linalg``'s ``symmetrize_input``), so
    ``UPLO`` changes nothing there and here."""
    return (a + a.mH) / 2


def cholesky(x, upper=False, name=None):
    return dispatch("cholesky", lambda a: torch.linalg.cholesky(
        _sym(a), upper=upper), (_t(x),), {})


def solve(x, y, name=None):
    return dispatch("solve", torch.linalg.solve, (_t(x), _t(y)), {})


def _as_matrix(b, a):
    """A right-hand side of one dimension fewer than ``a`` as a column."""
    return (b.unsqueeze(-1), True) if b.dim() == a.dim() - 1 else (b, False)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def kernel(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        b, vec = _as_matrix(b, a)
        out = torch.linalg.solve_triangular(a, b, upper=up,
                                            unitriangular=unitriangular)
        return out.squeeze(-1) if vec else out
    return dispatch("triangular_solve", kernel, (_t(x), _t(y)), {})


def cholesky_solve(x, y, upper=False, name=None):
    """``x`` the right-hand side, ``y`` the Cholesky factor (:135-140):
    two triangular solves on the factor's triangle, as the reference's
    ``cho_solve``, so the factor's gradient lies in that triangle too."""
    def kernel(b, factor):
        b, vec = _as_matrix(b, factor)
        low = factor.mH if upper else factor
        z = torch.linalg.solve_triangular(low, b, upper=False)
        out = torch.linalg.solve_triangular(low.mH, z, upper=True)
        return out.squeeze(-1) if vec else out
    return dispatch("cholesky_solve", kernel, (_t(x), _t(y)), {})


def inverse(x, name=None):
    return dispatch("inverse", torch.linalg.inv, (_t(x),), {})


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """``rcond`` is the relative cut-off (``rtol``, :164)."""
    return dispatch("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), (_t(x),), {})


def svd(x, full_matrices=False, name=None):
    """``(U, S, VH)``, VH the conjugate transpose of V (:169-173)."""
    return no_grad_dispatch("svd", lambda a: torch.linalg.svd(
        a, full_matrices=full_matrices), (_t(x),))


def qr(x, mode="reduced", name=None):
    """``(Q, R)``; ``mode="r"`` gives R alone."""
    out = no_grad_dispatch("qr", lambda a: torch.linalg.qr(a, mode=mode),
                           (_t(x),))
    return out[1] if mode == "r" else out


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)``: 1-based int32 pivots, and with ``get_infos`` a
    zero info (:184-190)."""
    def kernel(a):
        lu_, piv = torch.linalg.lu_factor(a)
        outs = (lu_, piv.to(INT))
        if get_infos:
            outs += (torch.zeros((), dtype=INT, device=a.device),)
        return outs
    return no_grad_dispatch("lu", kernel, (_t(x),))


def eig(x, name=None):
    """Eigenvalues and vectors of a general matrix, complex, on the
    input's device (the reference computes them on the host, :193-200)."""
    return no_grad_dispatch("eig", torch.linalg.eig, (_t(x),))


def eigh(x, UPLO="L", name=None):
    return no_grad_dispatch("eigh", lambda a: torch.linalg.eigh(
        _sym(a), UPLO=UPLO), (_t(x),))


def eigvals(x, name=None):
    return no_grad_dispatch("eigvals", torch.linalg.eigvals, (_t(x),))


def eigvalsh(x, UPLO="L", name=None):
    return no_grad_dispatch("eigvalsh", lambda a: torch.linalg.eigvalsh(
        _sym(a), UPLO=UPLO), (_t(x),))


def det(x, name=None):
    return dispatch("det", torch.linalg.det, (_t(x),), {})


def slogdet(x, name=None):
    """``[sign, log|det|]`` stacked on axis 0 (:220-223)."""
    return no_grad_dispatch("slogdet", lambda a: torch.stack(
        torch.linalg.slogdet(a)), (_t(x),))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The singular values above ``tol`` (an absolute cut-off, as the
    reference's ``rtol`` reads it, :226-228), else above
    ``max(S) * max(m, n) * eps``; int32."""
    def kernel(a):
        a = a if a.is_floating_point() or a.is_complex() else a.float()
        if a.dim() < 2:
            return (a != 0).any().to(INT)
        s = torch.linalg.svdvals(a)
        if tol is None:
            cut = s.amax(-1, keepdim=True) * max(a.shape[-2:]) * \
                torch.finfo(s.dtype).eps
        else:
            cut = tol
        return (s > cut).sum(-1).to(INT)
    return no_grad_dispatch("matrix_rank", kernel, (_t(x),))


def matrix_power(x, n, name=None):
    return dispatch("matrix_power", lambda a: torch.linalg.matrix_power(
        a, n), (_t(x),), {})


def multi_dot(x, name=None):
    tensors = [_t(a) for a in x]

    def kernel(*arrays):
        with _precision(arrays[0]):
            return torch.linalg.multi_dot(arrays)
    return dispatch("multi_dot", kernel, tensors, {})


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0, :242-247), the top edge in the last bin; int32."""
    def kernel(a):
        a = a.reshape(-1)
        a = a if a.is_floating_point() else a.float()
        if min != 0 or max != 0:
            lo = torch.tensor(float(min), dtype=a.dtype, device=a.device)
            hi = torch.tensor(float(max), dtype=a.dtype, device=a.device)
        else:
            lo, hi = a.min(), a.max()
        steps = torch.arange(bins + 1, dtype=a.dtype, device=a.device)
        edges = lo + (hi - lo) * (steps / bins)
        idx = torch.searchsorted(edges, a, right=True)
        idx = torch.where(a == edges[-1], bins, idx)
        keep = (idx >= 1) & (idx <= bins)
        counts = torch.zeros(bins + 2, dtype=INT, device=a.device)
        counts.index_add_(0, torch.where(keep, idx, bins + 1),
                          torch.ones_like(idx, dtype=INT))
        return counts[1:bins + 1]
    return no_grad_dispatch("histogram", kernel, (_t(input),))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)`` through the SVD on
    the input's device, as the reference's ``jnp.linalg.lstsq``: the
    residuals always computed (one per column of ``y``), rank int32."""
    def kernel(a, b):
        a, b = promote(a, b)
        vec = b.dim() == 1
        b = b.unsqueeze(-1) if vec else b
        m, n = a.shape
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        eps = torch.finfo(a.dtype).eps
        cut = eps * max(m, n) if rcond is None else \
            (rcond if rcond >= 0 else eps)
        mask = (s > 0) & (s >= cut * s[0])
        s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0)
        sol = vh.mH @ (s_inv[:, None] * (u.mH @ b))
        resid = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
        return (sol.reshape(-1) if vec else sol, resid,
                mask.sum().to(INT), s)
    return no_grad_dispatch("lstsq", kernel, (_t(x), _t(y)))


def _cov(a, rowvar, ddof, fw, aw):
    a = a if a.is_floating_point() or a.is_complex() else a.float()
    a = a if a.dim() > 1 else a.unsqueeze(0)
    if not rowvar and a.shape[0] != 1:
        a = a.T
    return torch.cov(a, correction=ddof, fweights=fw, aweights=aw)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """``ddof`` is a bool: True divides by N - 1, False by N."""
    tensors = [_t(x)] + [_t(w) for w in (fweights, aweights)
                         if w is not None]

    def kernel(a, *ws):
        ws = list(ws)
        fw = ws.pop(0).abs() if fweights is not None else None
        aw = ws.pop(0).abs() if aweights is not None else None
        return _cov(a, rowvar, 1 if ddof else 0, fw, aw)
    return no_grad_dispatch("cov", kernel, tensors)


def corrcoef(x, rowvar=True, name=None):
    def kernel(a):
        c = _cov(a, rowvar, 1, None, None)
        if c.dim() == 0:
            return c / c
        d = torch.sqrt(torch.diagonal(c).real)
        c = c / d[:, None] / d[None, :]
        return c.clamp(-1, 1)
    return no_grad_dispatch("corrcoef", kernel, (_t(x),))


def einsum(equation, *operands):
    """At ``FLAGS_matmul_precision``, as :func:`matmul`."""
    tensors = [_t(o) for o in operands]

    def kernel(*arrays):
        with _precision(arrays[0]):
            return torch.einsum(equation, *promote(*arrays))
    return dispatch("einsum", kernel, tensors, {})
