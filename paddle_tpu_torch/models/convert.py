"""Carry the reference GPT's weights into the port.

:func:`gpt_state_from_paddle_tpu` takes the eager GPT's weights, named as
``paddle_tpu``'s ``GPT.functional_state()[0]``; the port's modules carry
the same names.  The reference stores every linear weight as
``(in, out)``; ``nn.Linear`` holds ``(out, in)``, so those are
transposed.  Embeddings and LayerNorm parameters carry over as they are.

:func:`gpt_spmd_state_from_paddle_tpu` takes the compiled trainer's
stacked parameter tree (``gpt_spmd.init_gpt_params``) and its AdamW state;
the port keeps that layout as it is.

:func:`fused_transformer_state_from_paddle_tpu` takes the weights of the
reference's fused transformer layers (``paddle_tpu.incubate.nn``), whose
layouts the port's layers keep, so names and arrays carry over as they
are.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["gpt_state_from_paddle_tpu", "gpt_spmd_state_from_paddle_tpu",
           "fused_transformer_state_from_paddle_tpu", "LINEAR_WEIGHTS"]

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


def _tensor_tree(tree: Mapping, dev: torch.device) -> Dict:
    return {k: _tensor_tree(v, dev) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(np.asarray(v), order="C")).to(dev)
            for k, v in tree.items()}


def gpt_spmd_state_from_paddle_tpu(params: Mapping,
                                   opt_state: Optional[Mapping] = None, *,
                                   device=None) -> Tuple[Dict, Dict]:
    """``(params, opt_state)`` for
    :func:`~paddle_tpu_torch.models.gpt_spmd.build_spmd_train_step` from
    the reference's stacked parameter tree and, if given, its optimizer
    state ``{"m": tree, "v": tree, "step": int}`` (any array-likes numpy
    can read), on ``device`` (the card unless ``device="cpu"``).  Without
    an optimizer state the moments are zero at step 0."""
    from .gpt_spmd import init_opt_state
    dev = resolve_device(device)
    out = _tensor_tree(params, dev)
    if opt_state is None:
        return out, init_opt_state(out)
    step = int(np.asarray(opt_state["step"]))
    return out, {"m": _tensor_tree(opt_state["m"], dev),
                 "v": _tensor_tree(opt_state["v"], dev),
                 "step": torch.tensor(step, dtype=torch.int32, device=dev)}


def fused_transformer_state_from_paddle_tpu(
        params: Mapping[str, np.ndarray], *,
        device=None) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's fused layers
    (:mod:`paddle_tpu_torch.incubate.nn`) from the reference layer's
    parameter arrays (any array-likes numpy can read), on ``device`` (the
    card unless ``device="cpu"``).  The port's layers keep the reference's
    layouts (the packed ``[3, H, Dh, D]`` qkv weight, ``(in, out)`` linear
    weights, ``(D,)`` LayerNorm vectors) and its parameter names, so every
    name and array carries over as it is, with no transpose."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(np.asarray(value), order="C"))
            .to(dev) for name, value in params.items()}
