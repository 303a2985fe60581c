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

Not ported yet (``ROADMAP.md`` A3), and raising ``NotImplementedError``:
metrics, ``amp_configs``, ``offload=True``, the budget-driven remat of
``FLAGS_program_remat`` with ``FLAGS_remat_budget_mb``, and ``fit``,
``evaluate`` and ``predict``, which need ``io.DataLoader`` and the
callbacks.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch

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

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True, offload=False) -> "Model":
        if metrics:
            raise NotImplementedError(f"metrics {_NOT_PORTED}")
        if amp_configs:
            raise NotImplementedError(f"amp_configs {_NOT_PORTED}")
        if offload:
            raise NotImplementedError(f"optimizer-state offload "
                                      f"{_NOT_PORTED}")
        self._optimizer = optimizer
        self._loss = loss
        if optimizer is not None:
            optimizer._name_parameters(
                {id(p): n for n, p in self.network.named_parameters()})
        return self

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
        outs = _to_list(self.network(*self._tensors(inputs)))
        loss = self._loss(*(outs + self._tensors(labels)))
        loss.backward()
        if update:
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
