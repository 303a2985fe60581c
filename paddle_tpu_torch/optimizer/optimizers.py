"""Optimizers — the counterpart of ``paddle_tpu/optimizer/optimizers.py``:
``Optimizer`` (:52), ``SGD`` (:344), ``Adam`` (:422) and ``AdamW`` (:472).

The arithmetic is the reference's, per parameter, on the parameter's
device and in its type:

- Adam folds the bias correction into ``lr_t = lr·sqrt(1 - β2ᵗ) / (1 -
  β1ᵗ)`` and keeps eps outside the root (:443-452); the powers ``β1ᵗ``,
  ``β2ᵗ`` are fp32 device scalars, so a step reads nothing back to the
  host;
- AdamW decays the parameter by ``1 - lr·wd`` before the Adam update
  (:493-497), for the parameters ``apply_decay_param_fun(name)`` accepts
  (all when it is None); SGD and Adam add ``wd·param`` to the gradient
  (the reference's ``L2Decay``).

A step reads nothing from the host and rebinds nothing, so that
``Model.prepare(jit=True)`` can capture it in a CUDA graph: the learning
rate is a fp32 device scalar per device (:meth:`Optimizer.set_lr` fills
it in place), and every slot of the optimizer state is updated in place.

``parameters`` takes tensors or ``(name, tensor)`` pairs; an unnamed
tensor is called ``param_<i>``.  :class:`~paddle_tpu_torch.Model` names
the network's parameters as ``named_parameters()`` does, as the
reference's ``train_batch`` names them (``functional_state``).
Learning-rate schedulers, ``grad_clip``, ``multi_precision``,
``lazy_mode`` and regularizer objects raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]

_NOT_PORTED = "is not ported yet (ROADMAP.md A3)"


def _named(parameters):
    out = []
    for i, p in enumerate(parameters):
        out.append(tuple(p) if isinstance(p, tuple) else (f"param_{i}", p))
    return out


class Optimizer:
    """Base class: ``step()``, ``clear_grad()``, ``get_lr()``,
    ``set_lr()``, ``state_dict()`` and ``set_state_dict()``."""

    # L2 decay added to the gradient (SGD, Adam); AdamW decays decoupled
    _coupled_weight_decay = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float)):
            raise NotImplementedError(f"learning-rate scheduling "
                                      f"{_NOT_PORTED}; pass a number")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip {_NOT_PORTED}")
        if multi_precision:
            raise NotImplementedError(f"multi_precision {_NOT_PORTED}")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(f"regularizer objects {_NOT_PORTED}; "
                                      "pass weight_decay as a number")
        self._params = None if parameters is None else _named(parameters)
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._lr_on: Dict[torch.device, torch.Tensor] = {}
        self._global_step = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        """Set the learning rate; the device scalars the steps read are
        filled in place, so a captured step reads the new value."""
        self._learning_rate = float(value)
        for t in self._lr_on.values():
            t.fill_(self._learning_rate)

    def _lr(self, device: torch.device) -> torch.Tensor:
        """The learning rate as the 0-d fp32 scalar on ``device`` a step
        reads."""
        t = self._lr_on.get(device)
        if t is None:
            t = self._lr_on[device] = torch.full(
                (), self._learning_rate, dtype=torch.float32, device=device)
        return t

    # -- state -------------------------------------------------------------
    def _name_parameters(self, names: Mapping[int, str]) -> None:
        """Rename the parameters found in ``names`` (``id(tensor)`` ->
        name)."""
        if self._params is not None:
            self._params = [(names.get(id(p), n), p) for n, p in self._params]

    def _init_state_for(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _slot(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        key = id(p)
        if key not in self._state:
            self._state[key] = self._init_state_for(p.detach())
        return self._state[key]

    def _update(self, param, grad, state, lr: torch.Tensor, name: str):
        """``(new parameter, new state)``; ``lr`` is a 0-d device
        tensor."""
        raise NotImplementedError

    def bound_tensors(self):
        """The tensors a step reads and writes by address: the learning
        rate scalars and every slot of the state."""
        yield from self._lr_on.values()
        for slot in self._state.values():
            yield from slot.values()

    # -- eager step --------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        if self._params is None:
            raise ValueError("optimizer constructed without parameters")
        for name, p in self._params:
            if not p.requires_grad or p.grad is None:
                continue
            g = p.grad.to(p.dtype)
            if self._coupled_weight_decay and self._weight_decay:
                g = g + self._weight_decay * p
            slot = self._slot(p)
            new_p, new_state = self._update(p, g, slot, self._lr(p.device),
                                            name)
            for k, v in new_state.items():
                slot[k].copy_(v)
            p.copy_(new_p)
        self._global_step += 1

    @torch.no_grad()
    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop the gradients (``set_to_zero``: zero them in place, as a
        captured step does, so that they stay where it reads them; one
        multi-tensor launch per group of them)."""
        grads = [p.grad for _, p in self._params or [] if p.grad is not None]
        if set_to_zero:
            if grads:
                torch._foreach_zero_(grads)
            return
        for _, p in self._params or []:
            p.grad = None

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """``{"global_step": n, "<name>_<slot>": tensor, ...}``."""
        out: Dict[str, object] = {"global_step": self._global_step}
        for name, p in self._params or []:
            for k, v in self._state.get(id(p), {}).items():
                out[f"{name}_{k}"] = v
        return out

    def set_state_dict(self, state_dict: Mapping[str, object]) -> None:
        self._global_step = int(state_dict.get("global_step", 0))
        for name, p in self._params or []:
            slot = self._slot(p)
            for k, cur in slot.items():
                key = f"{name}_{k}"
                if key in state_dict:
                    cur.copy_(torch.as_tensor(state_dict[key]).to(
                        device=cur.device, dtype=cur.dtype))


class SGD(Optimizer):
    """``param - lr·grad`` (reference ``sgd_op.cc``)."""

    def _update(self, param, grad, state, lr, name):
        return param - lr * grad, state


class Adam(Optimizer):
    """Adam with the reference's bias correction folded into the step
    size (``adam_op``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            raise NotImplementedError(f"lazy_mode {_NOT_PORTED}")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state_for(self, param):
        # the powers accumulate in fp32 whatever the parameter's type
        one = torch.ones((), dtype=torch.float32, device=param.device)
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _update(self, param, grad, state, lr, name):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1 = b1 * state["moment1"] + (1 - b1) * grad
        m2 = b2 * state["moment2"] + (1 - b2) * torch.square(grad)
        lr_t = (lr * torch.sqrt(1 - b2p) / (1 - b1p)).to(param.dtype)
        new_p = param - lr_t * m1 / (torch.sqrt(m2) + eps)
        return new_p.to(param.dtype), {"moment1": m1, "moment2": m2,
                                       "beta1_pow": b1p, "beta2_pow": b2p}


class AdamW(Adam):
    """Adam with decoupled weight decay, applied before the update to the
    parameters ``apply_decay_param_fun(name)`` accepts.  ``lr_ratio`` is
    taken and not used, as in the reference."""

    _coupled_weight_decay = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_for(self, name: str) -> float:
        fun = self._apply_decay_param_fun
        return self._weight_decay if fun is None or fun(name) else 0.0

    def _update(self, param, grad, state, lr, name):
        wd = self._decay_for(name)
        decayed = param * (1.0 - lr * wd) if wd else param
        return super()._update(decayed, grad, state, lr, name)
