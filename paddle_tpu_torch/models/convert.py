"""Carry the reference GPT's weights into the port.

The reference names are those of ``paddle_tpu``'s
``GPT.functional_state()[0]``; the port's modules carry the same names.
The reference stores every linear weight as ``(in, out)``; ``nn.Linear``
holds ``(out, in)``, so those are transposed.  Embeddings and LayerNorm
parameters carry over as they are.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["gpt_state_from_paddle_tpu", "LINEAR_WEIGHTS"]

# name suffixes of the reference's (in, out) linear weights
LINEAR_WEIGHTS = ("attn.qkv.weight", "attn.out.weight", "up.weight",
                  "down.weight", "head.weight")


def gpt_state_from_paddle_tpu(params: Mapping[str, np.ndarray], *,
                              device=None) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~paddle_tpu_torch.models.GPT` from the
    reference's parameter arrays (any array-likes numpy can read), on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        arr = np.asarray(value)
        if name.endswith(LINEAR_WEIGHTS):
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected an (in, out) matrix, "
                                 f"got shape {arr.shape}")
            arr = arr.T
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(dev)
    return out
