"""``paddle.save`` / ``paddle.load`` of the port — the counterpart of
``paddle_tpu/framework_io.py``: nested state (dicts, lists, tuples,
numbers, strings, tensors) pickled with protocol 4, each tensor as the
reference writes one (``{"__tensor__": True, "data": <numpy array>,
"stop_gradient": ..., "name": ..., "is_parameter": ...}``).  The two
packages read each other's files: the reference's ``framework_io.load``
turns the port's tensors into its own, and :func:`load` here returns the
reference's as CPU ``torch`` tensors.  numpy has no bfloat16, so a
bfloat16 tensor is written as float32 (its values exactly).
``Model.save`` writes ``<path>.pdparams`` and ``<path>.pdopt`` with it.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .core.tensor import Tensor

__all__ = ["save", "load"]

_PROTOCOL = 4


def _to_saveable(obj):
    if isinstance(obj, Tensor):
        out = _to_saveable(obj._data)
        out["name"] = obj.name
        return out
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return {"__tensor__": True, "data": t.cpu().numpy(),
                "stop_gradient": not obj.requires_grad, "name": None,
                "is_parameter": isinstance(obj, torch.nn.Parameter)}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return torch.from_numpy(np.array(obj["data"]))
        return {k: _from_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v) for v in obj)
    return obj


def save(obj, path, protocol=_PROTOCOL, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, **configs):
    if not os.path.exists(path):
        raise ValueError(f"checkpoint path '{path}' does not exist")
    with open(path, "rb") as f:
        return _from_saveable(pickle.load(f))
