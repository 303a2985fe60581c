"""``paddle.nn.utils`` — the counterpart of ``paddle_tpu/nn/utils_mod.py``:
``spectral_norm`` and ``weight_norm`` (with ``remove_weight_norm``) as
forward pre-hooks, and ``parameters_to_vector`` /
``vector_to_parameters``.

The reference's semantics, not torch's ``nn.utils`` (which reparametrise
through new parameters): the layer keeps ``weight`` as its parameter and
gets a buffer, ``weight_u`` (spectral) or ``weight_g`` (weight norm), and
a pre-forward hook rewrites the weight in place before every forward,
outside autograd: ``spectral_norm`` divides it by its largest singular
value from ``n_power_iterations`` of power iteration (:44-53), each
forward dividing the weight the last one left; ``weight_norm`` sets it to
``g · v / ‖v‖`` over every axis but ``dim`` (:66-73).  The first ``u``
is ``np.random.RandomState(0)``'s (:38-40), as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, unwrap

__all__ = ["spectral_norm", "remove_weight_norm", "weight_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _param(layer, name) -> torch.Tensor:
    """The torch tensor of ``layer``'s parameter ``name``."""
    return unwrap(getattr(layer, name))


def _power_iteration(w2d, u, n_iters, eps=1e-12):
    v = None
    for _ in range(max(1, n_iters)):
        v = w2d.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = w2d @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ (w2d @ v)
    return u, sigma


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its largest singular value before each
    forward (the module docstring); the power iteration's vector persists
    as the buffer ``<name>_u``."""
    w = _param(layer, name)
    d = dim if dim is not None else 0
    h = w.shape[d]
    u0 = np.random.RandomState(0).randn(h).astype(np.float32)
    u0 /= np.linalg.norm(u0) + eps
    layer.register_buffer(f"{name}_u", torch.as_tensor(u0).to(w.device))
    layer._spectral_cfg = (name, d, n_power_iterations, eps)

    @torch.no_grad()
    def hook(lyr, inputs):
        nm, dd, iters, e = lyr._spectral_cfg
        wt = _param(lyr, nm)
        mat = wt.movedim(dd, 0).reshape(wt.shape[dd], -1)
        ubuf = unwrap(getattr(lyr, f"{nm}_u"))
        u, sigma = _power_iteration(mat, ubuf, iters, e)
        ubuf.copy_(u)
        wt.div_(sigma)
        return None

    layer.register_forward_pre_hook(hook)
    return layer


def weight_norm(layer, name="weight", dim=0):
    """Set ``layer.<name>`` to ``g · v / ‖v‖`` before each forward, ``g``
    the buffer ``<name>_g`` of the norms the weight had (over every axis
    but ``dim``)."""
    w = _param(layer, name).detach()
    axes = tuple(i for i in range(w.dim()) if i != dim)
    g = torch.sqrt(torch.sum(w * w, dim=axes, keepdim=True))
    layer.register_buffer(f"{name}_g", g.clone())
    layer._weight_norm_cfg = (name, dim)

    @torch.no_grad()
    def hook(lyr, inputs):
        nm, dd = lyr._weight_norm_cfg
        wt = _param(lyr, nm)
        ax = tuple(i for i in range(wt.dim()) if i != dd)
        norm = torch.sqrt(torch.sum(wt * wt, dim=ax, keepdim=True)) + 1e-12
        wt.copy_(wt / norm * unwrap(getattr(lyr, f"{nm}_g")))
        return None

    layer._weight_norm_hook = layer.register_forward_pre_hook(hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Remove the weight-norm hook; the weight keeps its last value."""
    handle = getattr(layer, "_weight_norm_hook", None)
    if handle is not None:
        handle.remove()
        del layer._weight_norm_hook
    if hasattr(layer, "_weight_norm_cfg"):
        del layer._weight_norm_cfg
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened into one new tensor (no gradient)."""
    return Tensor(torch.cat([unwrap(p).detach().reshape(-1)
                             for p in parameters]))


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Each parameter set in place from the next slice of ``vec``."""
    arr = unwrap(vec) if isinstance(vec, (Tensor, torch.Tensor)) else \
        torch.as_tensor(np.asarray(vec))
    offset = 0
    for p in parameters:
        tp = unwrap(p)
        n = tp.numel()
        tp.copy_(arr[offset:offset + n].reshape(tp.shape).to(tp))
        offset += n
