"""Carry the reference GPT's weights into the port.

:func:`gpt_state_from_paddle_tpu` takes the eager GPT's weights, named as
``paddle_tpu``'s ``GPT.functional_state()[0]`` (or its ``state_dict()``);
the port's ``GPT`` is built of the same layers, with the same names and
layouts (``[in, out]`` linear weights), so every array carries over as it
is.  ``GPT.set_state_dict`` takes the reference's tree directly as well.

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
           "fused_transformer_state_from_paddle_tpu"]


def _tensors(params: Mapping, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {name: torch.from_numpy(np.array(np.asarray(value), order="C"))
            .to(dev) for name, value in params.items()}


def gpt_state_from_paddle_tpu(params: Mapping[str, np.ndarray], *,
                              device=None) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~paddle_tpu_torch.models.GPT` from the
    reference's parameter arrays (any array-likes numpy can read), on
    ``device`` (the card unless ``device="cpu"``): the same names and
    arrays, as torch tensors."""
    return _tensors(params, resolve_device(device))


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
    return _tensors(params, resolve_device(device))
