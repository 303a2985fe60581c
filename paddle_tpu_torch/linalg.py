"""``paddle.linalg`` of the port — the counterpart of
``paddle_tpu/linalg.py``: the namespace's names from ``ops/linalg.py``,
``inv`` and ``inverse`` (the same function), and :func:`cond`.
``paddle_tpu_torch.cond`` is this module's ``cond``, as the reference
rebinds it (``paddle_tpu/__init__.py:40-46``)."""
from __future__ import annotations

import torch

from .ops._common import dispatch
from .ops._common import t as _t
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, corrcoef, cov, det, eig, eigh, eigvals,
    eigvalsh, lstsq, lu, matmul, matrix_power, matrix_rank, multi_dot, norm,
    pinv, qr, slogdet, solve, svd, triangular_solve)
from .ops.linalg import inverse as inv

__all__ = [
    "cholesky", "norm", "cond", "inv", "eig", "eigvals", "multi_dot",
    "matrix_rank", "svd", "qr", "lu", "matrix_power", "det", "slogdet",
    "eigh", "eigvalsh", "pinv", "solve", "triangular_solve",
    "cholesky_solve", "lstsq", "cov", "corrcoef", "matmul",
]

inverse = inv


def cond(x, p=None, name=None):
    """The condition number of ``x`` in the norm ``p`` (None: 2; ``"fro"``,
    ``"nuc"``, 1, -1, 2, -2, inf, -inf), as the reference computes it
    (:28-60): through the singular values for 2, -2 and ``"nuc"``, and
    through the inverse's norm for the others."""
    pp = 2 if p is None else p

    def kernel(a):
        if pp in ("fro", "nuc"):
            if pp == "fro":
                na = torch.sqrt(torch.sum(torch.square(a), dim=(-2, -1)))
                nb = torch.sqrt(torch.sum(torch.square(torch.linalg.inv(a)),
                                          dim=(-2, -1)))
            else:
                s = torch.linalg.svdvals(a)
                na, nb = s.sum(-1), (1.0 / s).sum(-1)
            return na * nb
        if pp in (2, -2):
            s = torch.linalg.svdvals(a)
            smax, smin = s.amax(-1), s.amin(-1)
            return smax / smin if pp == 2 else smin / smax
        inv_a = torch.linalg.inv(a)
        axis = -2 if pp in (1, -1) else -1
        red = torch.amax if pp in (1, float("inf")) else torch.amin
        na = red(torch.sum(torch.abs(a), dim=axis), dim=-1)
        nb = red(torch.sum(torch.abs(inv_a), dim=axis), dim=-1)
        return na * nb
    return dispatch("cond", kernel, (_t(x),), {})
