"""Optimizers — the counterpart of ``paddle_tpu/optimizer/optimizers.py``:
``Optimizer`` (:52), ``SGD`` (:344), ``Momentum`` (:355), ``LarsMomentum``
and its alias ``Lars`` (:378-419), ``Adam`` (:422), ``AdamW`` (:472),
``Adamax`` (:583), ``Adagrad`` (:607), ``Adadelta`` (:625), ``RMSProp``
(:647), ``Lamb`` (:678), ``Ftrl`` (:714) and ``DecayedAdagrad`` (:752),
with the reference's signatures and slot names.

The arithmetic is the reference's, per parameter, on the parameter's
device and in its type:

- Adam folds the bias correction into ``lr_t = lr·sqrt(1 - β2ᵗ) / (1 -
  β1ᵗ)`` and keeps eps outside the root (:443-452); the powers ``β1ᵗ``,
  ``β2ᵗ`` are fp32 device scalars, so a step reads nothing back to the
  host;
- AdamW decays the parameter by ``1 - lr·wd`` before the Adam update
  (:493-497), for the parameters ``apply_decay_param_fun(name)`` accepts
  (all when it is None), and takes no regularizer;
- the others add the regularizer's gradient to the gradient (:167-172):
  the parameter's own ``regularizer`` attribute, else the optimizer's
  ``weight_decay`` (a number is ``L2Decay``; ``regularizer.L1Decay`` and
  ``L2Decay`` objects as they are);
- a parameter's ``optimize_attr["learning_rate"]`` scales its rate
  (:165-166).  The port has no ``ParamAttr`` yet (``ROADMAP.md`` A2):
  ``regularizer`` and ``optimize_attr`` are plain attributes set on the
  ``torch.nn.Parameter``.

``multi_precision`` (also set by ``amp.decorate(optimizers=...)``) gives a
bf16 or fp16 parameter an fp32 master at its first step, from which its
slots are made (:90-99): the gradient is cast to fp32, the regularizer
reads the master, the update runs on the master, and the result is
copied back into the parameter in place (:171-179).  Masters are not in
``state_dict``, as in the reference.

A step reads nothing from the host and rebinds nothing, so that
``Model.prepare(jit=True)`` can capture it in a CUDA graph: the learning
rate is a fp32 device scalar per device, trust ratios (``LarsMomentum``,
``Lamb``) are ``torch.where`` on device norms, and every slot and master
is updated in place.

``learning_rate`` is a number or an
:class:`~paddle_tpu_torch.optimizer.lr.LRScheduler` (:71-84): ``get_lr()``
reads the scheduler, ``set_lr`` raises under one, and ``state_dict``
carries its state as ``"LR_Scheduler"`` (:320-321).  The device scalars
are refreshed from ``get_lr()`` only when the value changed
(:meth:`Optimizer._refresh_lr`, the reference's ``_lr_dev_cache``,
``hapi/model.py:435-442``): an eager ``step()`` refreshes first, a step
being captured does not (a fill recorded in a graph would freeze the
rate), and ``Model.train_batch`` refreshes before every replay.

``grad_clip`` (``nn/clip.py``) clips the gradients in place at the start
of ``step()``, on the device, before the update (:129-130).

``step(found_inf=None)`` takes a device bool from fp16 loss scaling
(``Model.prepare(amp_configs={"dtype": "float16"})``): where it is set the
step leaves parameters, masters and slots as they were, on the device,
as the reference's jitted step does (``hapi/model.py:311-315``); the
optimizer's ``_global_step`` advances either way (:595-596).

``step()`` hands the update to
:func:`~paddle_tpu_torch.optimizer.fused_update.fused_step` (the
reference's :119-125): every optimizer's step is one multi-tensor kernel
launch per group of parameters (``ops/multi_tensor_update.py``), whose
functor each class describes in :meth:`Optimizer._kernel_spec`.  The
per-parameter ``_update`` below stays the per-leaf path, taken with
``FLAGS_fused_optimizer=0`` or a regularizer other than ``L1Decay`` /
``L2Decay``.

Offload (``Model.prepare(offload=True)``, :meth:`Optimizer._offload_state`):
every slot (moments, accumulators, the powers) lives in pinned host memory,
in its type, and a CUDA step reads and writes it there: the fused update
moves it through the card in stages on the copy engines, or reads it in
place over PCIe (``ops/multi_tensor_update.py``'s two routes); the
per-leaf path copies each slot to the parameter's device for ``_update``
and the result back.  fp32 masters stay on the card, as
the reference's O2 masters are parameters, not optimizer state.
``state_dict`` returns the host slots and ``set_state_dict`` copies into
them in place (a captured step keeps their addresses); both wait for the
card first, since its writes to host memory land asynchronously.  A later
``prepare(offload=False)`` with the same optimizer brings the slots back
onto their parameters' devices.

``parameters`` takes tensors or ``(name, tensor)`` pairs; an unnamed
tensor is called ``param_<i>``.  :class:`~paddle_tpu_torch.Model` names
the network's parameters as ``named_parameters()`` does, as the
reference's ``train_batch`` names them (``functional_state``).

``lazy_mode`` (``Adam``, ``AdamW``) is taken with the reference's dense
semantics: the reference reads it nowhere, and updates rows only for a
``SelectedRows`` gradient, which only its eager core's sparse embedding
makes.  A sparse gradient (``torch.nn.Embedding(sparse=True)``) reaching
``step()`` raises: the row-sparse update waits for that core (A2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

from ..nn.clip import ClipGradBase
from ..ops.multi_tensor_update import Spec
from ..regularizer import L2Decay, WeightDecayRegularizer
from . import fused_update
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "LarsMomentum",
           "Ftrl", "DecayedAdagrad"]

_SPARSE = ("a sparse gradient reached the optimizer: the row-sparse "
           "(SelectedRows) update is not ported yet (ROADMAP.md A2)")
_LOW = (torch.bfloat16, torch.float16)


def _named(parameters):
    out = []
    for i, p in enumerate(parameters):
        out.append(tuple(p) if isinstance(p, tuple) else (f"param_{i}", p))
    return out


def _wd_reg(weight_decay):
    """The ``weight_decay`` argument as a regularizer, or None."""
    if weight_decay is None:
        return None
    if isinstance(weight_decay, WeightDecayRegularizer):
        return weight_decay
    return L2Decay(float(weight_decay))


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in pinned host memory, in its type."""
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    return out.copy_(t)


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(t)))


class Optimizer:
    """Base class: ``step()``, ``minimize()``, ``clear_grad()``,
    ``get_lr()``, ``set_lr()``, ``state_dict()`` and
    ``set_state_dict()``."""

    # the regularizer added to the gradient (all but AdamW, which decays
    # decoupled)
    _coupled_weight_decay = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, got {type(learning_rate)}")
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradBase):
            raise TypeError(f"grad_clip must be one of nn.ClipGradByValue, "
                            f"ClipGradByNorm, ClipGradByGlobalNorm; got "
                            f"{type(grad_clip)}")
        self._params = None if parameters is None else _named(parameters)
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)
        self._weight_decay_reg = _wd_reg(weight_decay)
        self._weight_decay = (0.0 if self._weight_decay_reg is None
                              else self._weight_decay_reg.coeff)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._lr_on: Dict[torch.device, torch.Tensor] = {}
        self._lr_value = self.get_lr()      # what the device scalars hold
        self._global_step = 0
        self._offload = False

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        """Set the learning rate; the device scalars the steps read are
        filled in place, so a captured step reads the new value."""
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)
        self._refresh_lr()

    @property
    def _lr_scheduler(self):
        return self._learning_rate if isinstance(self._learning_rate,
                                                 LRScheduler) else None

    def _refresh_lr(self) -> None:
        """Fill the device scalars with ``get_lr()`` if it changed since
        the last fill (one fill launch per device, no host sync)."""
        value = self.get_lr()
        if value != self._lr_value:
            self._lr_value = value
            for t in self._lr_on.values():
                t.fill_(value)

    def _lr(self, device: torch.device) -> torch.Tensor:
        """The learning rate as the 0-d fp32 scalar on ``device`` a step
        reads."""
        t = self._lr_on.get(device)
        if t is None:
            t = self._lr_on[device] = torch.full(
                (), self._lr_value, dtype=torch.float32, device=device)
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
        """``p``'s slots, made at its first step from its fp32 master
        (made then too) under ``multi_precision``, else from ``p``; in
        pinned host memory under offload."""
        key = id(p)
        if key not in self._state:
            if self._multi_precision and p.dtype in _LOW:
                self._master_weights[key] = p.detach().float()
            state = self._init_state_for(
                self._master_weights.get(key, p.detach()))
            self._state[key] = ({k: _pinned(v) for k, v in state.items()}
                                if self._offload else state)
        return self._state[key]

    def _offload_state(self, on: bool = True) -> None:
        """Keep every slot in pinned host memory from now on (``on``), or
        on its parameter's device again: the slots made so far move (new
        addresses: a captured step binding them captures again), later
        ones are made there."""
        if self._offload == on:
            return
        self._sync_offloaded()
        self._offload = on
        where = {id(p): p.device for _, p in self._params or ()}
        for key, state in self._state.items():
            self._state[key] = {
                k: _pinned(v) if on else v.to(where.get(key, v.device))
                for k, v in state.items()}

    def _sync_offloaded(self) -> None:
        """Wait for the card's writes into the host slots (and before
        the host writes them), under offload."""
        if self._offload and torch.cuda.is_available():
            torch.cuda.synchronize()

    def _update(self, param, grad, state, lr: torch.Tensor, name: str):
        """``(new parameter, new state)``; ``lr`` is a 0-d device
        tensor."""
        raise NotImplementedError

    def _kernel_spec(self) -> Spec:
        """The fused update's functor for this optimizer
        (``ops/multi_tensor_update.py``): its kind, hyperparameters in the
        functor's order, flags, element slots and the betas of its
        powers."""
        raise NotImplementedError

    def _kernel_record(self, name: str) -> dict:
        """What the fused update's record of parameter ``name`` carries
        beyond its tensors (AdamW's decay, LarsMomentum's exclusion)."""
        return {}

    def bound_tensors(self):
        """The tensors a step reads and writes by address: the learning
        rate scalars, every slot of the state, every master and the fused
        update's device tables and gradient buffers."""
        yield from self._lr_on.values()
        for slot in self._state.values():
            yield from slot.values()
        yield from self._master_weights.values()
        yield from fused_update.bound_tensors(self)

    # -- eager step --------------------------------------------------------
    def _regularizer_for(self, p):
        """The parameter's own regularizer, else the optimizer's; none for
        a decoupled decay."""
        if not self._coupled_weight_decay:
            return None
        reg = getattr(p, "regularizer", None)
        return reg if reg is not None else self._weight_decay_reg

    def _lr_for(self, p) -> torch.Tensor:
        lr = self._lr(p.device)
        scale = (getattr(p, "optimize_attr", None) or {}).get(
            "learning_rate", 1.0)
        return lr if scale == 1.0 else lr * scale

    def _live(self):
        """The ``(name, parameter)`` pairs a step updates: those with a
        gradient."""
        return [(name, p) for name, p in self._params
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self, found_inf: torch.Tensor = None) -> None:
        """One update of every parameter with a gradient; nothing moves
        where ``found_inf`` (a 0-d bool on the parameters' device) is
        set."""
        if self._params is None:
            raise ValueError("optimizer constructed without parameters")
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            self._refresh_lr()
        live = self._live()
        if any(p.grad.is_sparse for _, p in live):
            raise NotImplementedError(_SPARSE)
        if self._grad_clip is not None:
            self._grad_clip._clip_([(p, p.grad) for _, p in live])
        if fused_update.fused_step(self, found_inf):
            return
        for name, p in live:
            slot = self._slot(p)
            master = self._master_weights.get(id(p))
            target = p if master is None else master
            g = p.grad.to(target.dtype)
            reg = self._regularizer_for(p)
            if reg is not None and reg.coeff:
                g = g + reg.grad(target)
            # host slots (offload) go to the device for the update
            cur = {k: v.to(target.device, non_blocking=True)
                   for k, v in slot.items()}
            new_p, new_state = self._update(target, g, cur, self._lr_for(p),
                                            name)
            if found_inf is not None:
                new_state = {k: torch.where(found_inf, cur[k], v)
                             for k, v in new_state.items()}
                new_p = torch.where(found_inf, target, new_p)
            for k, v in new_state.items():
                slot[k].copy_(v, non_blocking=True)
            target.copy_(new_p)
            if master is not None:
                p.copy_(master)
        self._global_step += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The eager ``minimize``: ``loss.backward()`` unless a gradient is
        already there, then ``step()``; returns ``(None, None)``."""
        if not isinstance(loss, torch.Tensor):
            raise NotImplementedError(
                f"minimize on a static program's variable ({type(loss)}): "
                f"the static graph is not ported yet (ROADMAP.md A7)")
        if loss.grad_fn is not None and all(
                p.grad is None for _, p in self._params or []):
            loss.backward()
        self.step()
        return None, None

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

    clear_gradients = clear_grad

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """``{"global_step": n, "<name>_<slot>": tensor, ...}``, and
        ``"LR_Scheduler"``: the scheduler's state, under one."""
        out: Dict[str, object] = {"global_step": self._global_step}
        self._sync_offloaded()
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        for name, p in self._params or []:
            for k, v in self._state.get(id(p), {}).items():
                out[f"{name}_{k}"] = v
        return out

    def set_state_dict(self, state_dict: Mapping[str, object]) -> None:
        self._global_step = int(state_dict.get("global_step", 0))
        if self._lr_scheduler is not None and "LR_Scheduler" in state_dict:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        self._sync_offloaded()
        for name, p in self._params or []:
            slot = self._slot(p)
            for k, cur in slot.items():
                key = f"{name}_{k}"
                if key in state_dict:
                    cur.copy_(torch.as_tensor(state_dict[key]).to(
                        device=cur.device, dtype=cur.dtype))

    set_dict = set_state_dict

    # -- functional state (checkpoints and fit's anomaly guard) -------------
    def functional_state(self) -> Dict[str, object]:
        """The optimizer's state as the reference's ``_fn_state`` holds it
        (``paddle_tpu/optimizer/optimizers.py:254-274``): ``{"slots":
        {name: {slot: tensor}}, "master": {name: fp32 master}, "step":
        the step count}``, with Adam's powers among the slots.  The
        tensors are the live ones (on the card, or pinned host memory
        under offload), for a checkpointer's ordered snapshot; only the
        parameters whose state exists are in it."""
        slots, master = {}, {}
        for name, p in self._params or []:
            state = self._state.get(id(p))
            if state is not None:
                slots[name] = dict(state)
            m = self._master_weights.get(id(p))
            if m is not None:
                master[name] = m
        return {"slots": slots, "master": master,
                "step": self._global_step}

    @torch.no_grad()
    def load_functional_state(self, state: Mapping[str, object]) -> None:
        """Write a :meth:`functional_state` (host copies) back into the
        live tensors in place with ``copy_``, making a parameter's slots
        (and its master) first where they do not exist yet; a captured
        step therefore keeps reading the same addresses.  Offloaded slots
        are written after the card's pending writes into them land."""
        names = {n: p for n, p in self._params or []}
        unknown = sorted(set(state.get("slots", {})) - set(names))
        if unknown:
            raise KeyError(f"the optimizer has no parameters {unknown[:5]}")
        self._sync_offloaded()
        for name, saved in state.get("slots", {}).items():
            slot = self._slot(names[name])
            for k, cur in slot.items():
                if k not in saved:
                    raise KeyError(f"the saved state of {name!r} lacks its "
                                   f"{k!r} slot")
                cur.copy_(torch.as_tensor(saved[k]).to(dtype=cur.dtype),
                          non_blocking=True)
        for name, saved in state.get("master", {}).items():
            p = names[name]
            self._slot(p)
            master = self._master_weights.get(id(p))
            if master is None:
                raise KeyError(f"the saved state has an fp32 master of "
                               f"{name!r}, which this optimizer keeps none "
                               f"of (multi_precision)")
            master.copy_(torch.as_tensor(saved), non_blocking=True)
        self._global_step = int(state.get("step", self._global_step))


class SGD(Optimizer):
    """``param - lr·grad`` (reference ``sgd_op.cc``)."""

    def _kernel_spec(self):
        return Spec("sgd")

    def _update(self, param, grad, state, lr, name):
        return param - lr * grad, state


class Momentum(Optimizer):
    """``v = μ·v + g``; ``param - lr·v``, or with Nesterov ``param -
    lr·(g + μ·v)`` (reference ``momentum_op.h``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_state_for(self, param):
        return {"velocity": torch.zeros_like(param)}

    def _kernel_spec(self):
        return Spec("momentum", (self._momentum,), int(self._use_nesterov),
                    ("velocity",))

    def _update(self, param, grad, state, lr, name):
        v = self._momentum * state["velocity"] + grad
        if self._use_nesterov:
            new_p = param - lr * (grad + self._momentum * v)
        else:
            new_p = param - lr * v
        return new_p, {"velocity": v}


class LarsMomentum(Optimizer):
    """LARS: momentum with the layer-wise trust ratio ``coeff·||w|| /
    (||g|| + wd·||w|| + eps)`` (1 where a norm is 0) scaling the rate of
    ``g + wd·w``; parameters whose name contains a token of
    ``exclude_from_weight_decay`` get plain momentum, ``v = μ·v + lr·g``
    (reference ``lars_momentum_op.cu``, ``lars_optimizer.py``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-9,
                 exclude_from_weight_decay=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = list(exclude_from_weight_decay or [])

    def _init_state_for(self, param):
        return {"velocity": torch.zeros_like(param)}

    def _excluded(self, name: str) -> bool:
        return any(token in name for token in self._exclude)

    def _kernel_spec(self):
        return Spec("lars", (self._momentum, self._lars_coeff, self._lars_wd,
                             self._epsilon), 0, ("velocity",))

    def _kernel_record(self, name):
        return {"plain": self._excluded(name)}

    def _update(self, param, grad, state, lr, name):
        if self._excluded(name):
            v = self._momentum * state["velocity"] + lr * grad
            return param - v, {"velocity": v}
        w_norm, g_norm = _norm(param), _norm(grad)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm /
            (g_norm + self._lars_wd * w_norm + self._epsilon), 1.0)
        scaled = lr * local_lr * (grad + self._lars_wd * param)
        v = self._momentum * state["velocity"] + scaled
        return param - v, {"velocity": v}


Lars = LarsMomentum


class Adam(Optimizer):
    """Adam with the reference's bias correction folded into the step
    size (``adam_op``).  ``lazy_mode`` is taken with the reference's dense
    semantics (see the module's docstring)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
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

    def _kernel_spec(self):
        b1, b2 = self._beta1, self._beta2
        return Spec("adam", (b1, 1 - b1, b2, 1 - b2, self._epsilon), 0,
                    ("moment1", "moment2"), (b1, b2))

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

    def _kernel_spec(self):
        return dataclasses.replace(super()._kernel_spec(), kind="adamw")

    def _kernel_record(self, name):
        return {"decay": float(self._decay_for(name))}

    def _update(self, param, grad, state, lr, name, decay=None):
        """``decay``: this name's weight decay as the fused update's
        record holds it (its plain version), so that the decay function
        is read once a step."""
        wd = self._decay_for(name) if decay is None else decay
        decayed = param * (1.0 - lr * wd) if wd else param
        return super()._update(decayed, grad, state, lr, name)


class Adamax(Optimizer):
    """Adam on the infinity norm: ``u = max(β2·u, |g|)``, ``param -
    lr/(1 - β1ᵗ)·m/(u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state_for(self, param):
        return {"moment": torch.zeros_like(param),
                "inf_norm": torch.zeros_like(param),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=param.device)}

    def _kernel_spec(self):
        b1, b2 = self._beta1, self._beta2
        return Spec("adamax", (b1, 1 - b1, b2, self._epsilon), 0,
                    ("moment", "inf_norm"), (b1,))

    def _update(self, param, grad, state, lr, name):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        m = b1 * state["moment"] + (1 - b1) * grad
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(grad))
        step_lr = (lr / (1 - b1p)).to(param.dtype)
        new_p = param - step_lr * m / (u + eps)
        return new_p.to(param.dtype), {"moment": m, "inf_norm": u,
                                       "beta1_pow": b1p}


class Adagrad(Optimizer):
    """``acc += g²``; ``param - lr·g/(sqrt(acc) + eps)``, the accumulator
    starting at ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state_for(self, param):
        return {"moment": torch.full_like(param, self._init_acc)}

    def _kernel_spec(self):
        return Spec("adagrad", (self._epsilon,), 0, ("moment",))

    def _update(self, param, grad, state, lr, name):
        acc = state["moment"] + torch.square(grad)
        new_p = param - lr * grad / (torch.sqrt(acc) + self._epsilon)
        return new_p, {"moment": acc}


class Adadelta(Optimizer):
    """Running averages of the squared gradient and the squared update;
    ``param + lr·update`` with ``update = -sqrt(E[Δ²] + eps)/sqrt(E[g²] +
    eps)·g``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _init_state_for(self, param):
        return {"avg_squared_grad": torch.zeros_like(param),
                "avg_squared_update": torch.zeros_like(param)}

    def _kernel_spec(self):
        return Spec("adadelta", (self._rho, 1 - self._rho, self._epsilon), 0,
                    ("avg_squared_grad", "avg_squared_update"))

    def _update(self, param, grad, state, lr, name):
        rho, eps = self._rho, self._epsilon
        g2 = rho * state["avg_squared_grad"] + (1 - rho) * torch.square(grad)
        update = -torch.sqrt(state["avg_squared_update"] + eps) / \
            torch.sqrt(g2 + eps) * grad
        u2 = rho * state["avg_squared_update"] + \
            (1 - rho) * torch.square(update)
        return param + lr * update, {"avg_squared_grad": g2,
                                     "avg_squared_update": u2}


class RMSProp(Optimizer):
    """``E[g²]`` (``centered``: minus ``E[g]²``) normalises the gradient;
    ``momentum`` accumulates the normalised step."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state_for(self, param):
        s = {"mean_square": torch.zeros_like(param),
             "momentum_acc": torch.zeros_like(param)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(param)
        return s

    def _kernel_spec(self):
        rho = self._rho
        return Spec("rmsprop_centered" if self._centered else "rmsprop",
                    (rho, 1 - rho, self._epsilon, self._momentum), 0,
                    ("mean_square", "momentum_acc") + (
                        ("mean_grad",) if self._centered else ()))

    def _update(self, param, grad, state, lr, name):
        rho, eps = self._rho, self._epsilon
        ms = rho * state["mean_square"] + (1 - rho) * torch.square(grad)
        out_state = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * grad
            denom = torch.sqrt(ms - torch.square(mg) + eps)
            out_state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + eps)
        mom = self._momentum * state["momentum_acc"] + lr * grad / denom
        out_state["momentum_acc"] = mom
        return param - mom, out_state


class Lamb(Optimizer):
    """LAMB (reference ``lamb_op.h``): Adam's bias-corrected moments, cast
    to the parameter's type, give ``r = m̂/(sqrt(v̂) + eps) + wd·w``; the
    layer-wise trust ratio ``||w||/||r||`` (1 where a norm is 0) scales
    the rate.

    ``exclude_from_weight_decay_fn`` is stored and not read, as in the
    reference (:688, :704): every parameter is decayed by
    ``lamb_weight_decay``.  The port copies that gap rather than filling
    it (``ROADMAP.md`` §C)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lamb_wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state_for(self, param):
        one = torch.ones((), dtype=torch.float32, device=param.device)
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _kernel_spec(self):
        b1, b2 = self._beta1, self._beta2
        return Spec("lamb", (b1, 1 - b1, b2, 1 - b2, self._epsilon,
                             self._lamb_wd), 0, ("moment1", "moment2"),
                    (b1, b2))

    def _update(self, param, grad, state, lr, name, stored=None):
        """``stored``: the moments as their slots store them (the fused
        update's plain version, which computes 16-bit slots in fp32: the
        kernel's update pass reads the stored moments back)."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1 = b1 * state["moment1"] + (1 - b1) * grad
        m2 = b2 * state["moment2"] + (1 - b2) * torch.square(grad)
        if stored is not None:
            m1, m2 = stored(m1), stored(m2)
        # the fp32 powers promote the moments, as in the reference
        m1_hat = (m1.float() / (1 - b1p)).to(param.dtype)
        m2_hat = (m2.float() / (1 - b2p)).to(param.dtype)
        r = m1_hat / (torch.sqrt(m2_hat) + eps) + self._lamb_wd * param
        w_norm, r_norm = _norm(param), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        new_p = param - (lr * trust).to(param.dtype) * r
        return new_p.to(param.dtype), {"moment1": m1, "moment2": m2,
                                       "beta1_pow": b1p, "beta2_pow": b2p}


class Ftrl(Optimizer):
    """FTRL-proximal (reference ``ftrl_op.h:150``): ``n += g²``; ``σ =
    (n_new^-p - n_old^-p)/lr`` (``lr_power`` p, the root at -0.5); ``z +=
    g - σ·w``; ``w = (l1·sign(z) - z)/(n_new^-p/lr + 2·l2)`` where ``|z| >
    l1``, else 0.  ``l1`` and ``l2`` get ``1e-10`` added, as in the
    reference."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1 = float(l1) + 1e-10
        self._l2 = float(l2) + 1e-10
        self._lr_power = float(lr_power)

    def _init_state_for(self, param):
        return {"squared": torch.zeros_like(param),
                "linear": torch.zeros_like(param)}

    def _kernel_spec(self):
        return Spec("ftrl", (self._l1, 2 * self._l2, -self._lr_power),
                    int(self._lr_power != -0.5), ("squared", "linear"))

    def _update(self, param, grad, state, lr, name):
        l1, l2, p_ = self._l1, self._l2, self._lr_power
        sq, lin = state["squared"], state["linear"]
        new_sq = sq + torch.square(grad)
        if p_ == -0.5:
            sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
            y = torch.sqrt(new_sq) / lr + 2 * l2
        else:
            sigma = (new_sq ** (-p_) - sq ** (-p_)) / lr
            y = new_sq ** (-p_) / lr + 2 * l2
        new_lin = lin + grad - sigma * param
        x = l1 * torch.sign(new_lin) - new_lin
        new_p = torch.where(torch.abs(new_lin) > l1, x / y,
                            torch.zeros_like(param))
        return new_p.to(param.dtype), {"squared": new_sq,
                                       "linear": new_lin}


class DecayedAdagrad(Optimizer):
    """``m = decay·m + (1 - decay)·g²``; ``param - lr·g/(sqrt(m) + eps)``
    (reference ``decayed_adagrad_op.h:63``)."""

    def __init__(self, learning_rate=0.001, decay=0.95, epsilon=1e-06,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._decay, self._epsilon = float(decay), float(epsilon)

    def _init_state_for(self, param):
        return {"moment": torch.zeros_like(param)}

    def _kernel_spec(self):
        return Spec("decayed_adagrad", (self._decay, 1 - self._decay,
                                        self._epsilon), 0, ("moment",))

    def _update(self, param, grad, state, lr, name):
        m = self._decay * state["moment"] + \
            (1 - self._decay) * torch.square(grad)
        new_p = param - lr * grad / (torch.sqrt(m) + self._epsilon)
        return new_p, {"moment": m}
