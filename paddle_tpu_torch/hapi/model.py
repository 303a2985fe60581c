"""``paddle.Model`` — the counterpart of ``paddle_tpu/hapi/model.py``
(``Model`` :160): ``prepare`` (:174), ``train_batch`` (:463),
``eval_batch`` (:637) and ``predict_batch`` (:658).

The reference runs ``train_batch`` as one jitted XLA step over
functional state; the port runs the same step eagerly on the network's
device: forward, loss, backward, ``optimizer.step()`` and
``clear_grad()``, with no host synchronisation inside.  The loss comes
back as a 0-d device tensor, which ``float()`` reads, in the role of the
reference's lazy loss scalar (``_LazyScalar``).  Inputs and labels may be
numpy arrays or tensors; pass tensors already on the card to keep the
host-to-device copy out of the step.  ``prepare(jit=...)`` and the
constructor's ``inputs``/``labels`` (the reference's static input specs)
are accepted and change nothing: the port has one engine and plans no
memory.

``prepare(amp_configs=...)`` (the reference's :189-215: ``"O1"``,
``"O2"`` or a dict with ``level``, ``dtype``, ``custom_white_list``,
``custom_black_list`` and the fp16 scaler's settings) runs
``train_batch``'s forward under :func:`~paddle_tpu_torch.amp.auto_cast`,
as the reference's step does (:618; the loss, eval and predict run
outside it, as there).  O2 keeps the network's fp32 parameters as the
masters the optimizer updates: the forward sees a low-type view of them
cast inside the differentiated function (``torch.func.functional_call``),
so the gradients land on the fp32 leaves (:254-262).  fp16 engages the
dynamic loss scaling (``ops/amp_ops.py``); on the card it raises, since
the attention and epilogue kernels take fp32 and bf16 only.

Not ported yet (``ROADMAP.md`` A3), and raising ``NotImplementedError``:
metrics, ``offload=True``, the budget-driven remat of
``FLAGS_program_remat`` with ``FLAGS_remat_budget_mb``, and ``fit``,
``evaluate`` and ``predict``, which need ``io.DataLoader`` and the
callbacks.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch

from ..amp import auto_cast, to_dtype
from ..ops.amp_ops import check_finite_and_unscale, update_loss_scaling

__all__ = ["Model"]

_NOT_PORTED = "is not ported yet (ROADMAP.md A3)"


def _to_list(x) -> List:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _remat_flags_set() -> bool:
    """The reference's remat switch (``_remat_decision``): both flags set
    in the environment, which its flag registry reads."""
    on = os.environ.get("FLAGS_program_remat", "").lower() in (
        "1", "true", "yes", "on")
    return on and int(os.environ.get("FLAGS_remat_budget_mb", "0") or 0) > 0


class Model:
    """Train, evaluate and run a ``torch.nn.Module`` batch by batch."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._amp = None
        self._scaler = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True, offload=False) -> "Model":
        if metrics:
            raise NotImplementedError(f"metrics {_NOT_PORTED}")
        self._amp, self._scaler = self._amp_settings(amp_configs)
        if offload:
            raise NotImplementedError(f"optimizer-state offload "
                                      f"{_NOT_PORTED}")
        self._optimizer = optimizer
        self._loss = loss
        if optimizer is not None:
            optimizer._name_parameters(
                {id(p): n for n, p in self.network.named_parameters()})
        return self

    def _amp_settings(self, amp_configs):
        """(auto_cast keywords, fp16 scaler state) from ``amp_configs``,
        validated as the reference's ``prepare`` does; (None, None)
        without AMP."""
        if not amp_configs:
            return None, None
        cfg = {"level": amp_configs} if isinstance(amp_configs, str) \
            else dict(amp_configs)
        level = cfg.get("level", "O1")
        if level not in ("O1", "O2"):
            raise ValueError(f"amp_configs level must be 'O1' or 'O2', got "
                             f"{level!r}")
        dtype = to_dtype(cfg.get("dtype", "bfloat16"))
        if dtype not in (torch.bfloat16, torch.float16):
            raise ValueError(f"amp_configs dtype must be bfloat16 or "
                             f"float16, got {cfg['dtype']!r}")
        amp = dict(level=level, dtype=dtype,
                   custom_white_list=cfg.get("custom_white_list"),
                   custom_black_list=cfg.get("custom_black_list"))
        if dtype == torch.bfloat16:
            return amp, None
        if self._device().type == "cuda":
            raise NotImplementedError(
                "AMP in float16 on the card: the kernels of "
                "ops/flash_attention.py (_check_cuda) and ops/fused_ln.py "
                "take fp32 and bf16 only; fp16 kernels are not ported yet "
                "(ROADMAP.md A3); use dtype 'bfloat16'")
        # fp16's exponent range needs dynamic loss scaling (:198-213);
        # bf16 shares fp32's range and never engages it
        scaler = dict(
            scale=torch.tensor(float(cfg.get("init_loss_scaling",
                                             2.0 ** 15))),
            good=torch.zeros((), dtype=torch.int32),
            bad=torch.zeros((), dtype=torch.int32),
            incr_ratio=float(cfg.get("incr_ratio", 2.0)),
            decr_ratio=float(cfg.get("decr_ratio", 0.5)),
            incr_every_n_steps=int(cfg.get("incr_every_n_steps", 1000)),
            decr_every_n_nan_or_inf=int(cfg.get("decr_every_n_nan_or_inf",
                                                2)),
            use_dynamic_loss_scaling=bool(cfg.get(
                "use_dynamic_loss_scaling", True)))
        return amp, scaler

    def _forward_amp(self, inputs: List[torch.Tensor]):
        """The network's forward under the prepared AMP: O1 as it is, O2
        on a low-type view of the fp32 parameters, cast inside the
        differentiated function."""
        with auto_cast(**self._amp):
            if self._amp["level"] == "O1":
                return self.network(*inputs)
            low = self._amp["dtype"]
            view = {n: p.to(low) if p.dtype == torch.float32 else p
                    for n, p in self.network.named_parameters()}
            return torch.func.functional_call(self.network, view,
                                              tuple(inputs))

    def _scaled_backward(self, loss: torch.Tensor) -> bool:
        """fp16: backward of the loss times the scale, the gradients
        unscaled, and the scale state moved (``update_loss_scaling``).
        Returns whether every gradient was finite."""
        sc = self._scaler
        (loss.float() * sc["scale"].to(loss.device)).backward()
        params = [p for p in self.network.parameters() if p.grad is not None]
        grads, found = check_finite_and_unscale([p.grad for p in params],
                                                sc["scale"])
        for p, g in zip(params, grads):
            p.grad = g
        if sc["use_dynamic_loss_scaling"]:
            sc["scale"], sc["good"], sc["bad"] = update_loss_scaling(
                found, sc["scale"], sc["good"], sc["bad"],
                sc["incr_every_n_steps"], sc["decr_every_n_nan_or_inf"],
                sc["incr_ratio"], sc["decr_ratio"])
        return not bool(found)

    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _tensors(self, arrays) -> List[torch.Tensor]:
        dev = self._device()
        return [torch.as_tensor(a).to(dev) for a in _to_list(arrays)]

    def _pack_logs(self, loss, metrics: Dict) -> Dict:
        logs = {}
        if loss is not None:
            logs["loss"] = loss
        logs.update(metrics)
        return logs

    # ------------------------------------------------------------------
    def train_batch(self, inputs, labels=None, update: bool = True) -> Dict:
        """One step on a batch: ``{"loss": 0-d device tensor}``.  With
        ``update=False`` the gradients stay in the parameters' ``.grad``
        and nothing is stepped."""
        if _remat_flags_set():
            raise NotImplementedError(f"budget-driven remat (FLAGS_program_"
                                      f"remat, FLAGS_remat_budget_mb) "
                                      f"{_NOT_PORTED}")
        if self._loss is None or (update and self._optimizer is None):
            raise RuntimeError("call prepare(optimizer, loss) before "
                               "train_batch")
        self.network.train()
        ins = self._tensors(inputs)
        outs = _to_list(self.network(*ins) if self._amp is None
                        else self._forward_amp(ins))
        loss = self._loss(*(outs + self._tensors(labels)))
        finite = True
        if self._scaler is None:
            loss.backward()
        else:
            finite = self._scaled_backward(loss)
        if update:
            if finite:
                self._optimizer.step()
            self._optimizer.clear_grad()
        return self._pack_logs(loss.detach(), {})

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None) -> Dict:
        """``{"loss": float}`` of the batch in eval mode (``{}`` without
        labels or a loss)."""
        self.network.eval()
        outs = _to_list(self.network(*self._tensors(inputs)))
        labs = self._tensors(labels)
        loss = None
        if self._loss is not None and labs:
            loss = float(self._loss(*(outs + labs)))
        return self._pack_logs(loss, {})

    @torch.no_grad()
    def predict_batch(self, inputs) -> List:
        """The network's outputs in eval mode, as numpy arrays."""
        self.network.eval()
        outs = _to_list(self.network(*self._tensors(inputs)))
        return [o.detach().cpu().numpy() for o in outs]

    # ------------------------------------------------------------------
    def fit(self, *args, **kwargs):
        raise NotImplementedError(f"Model.fit {_NOT_PORTED}: it needs "
                                  "io.DataLoader and the callbacks")

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError(f"Model.evaluate {_NOT_PORTED}: it needs "
                                  "io.DataLoader and the callbacks")

    def predict(self, *args, **kwargs):
        raise NotImplementedError(f"Model.predict {_NOT_PORTED}: it needs "
                                  "io.DataLoader and the callbacks")
