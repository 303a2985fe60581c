"""``paddle.Model`` — the counterpart of ``paddle_tpu/hapi/model.py``
(``Model`` :160): ``prepare`` (:174), ``train_batch`` (:463),
``eval_batch`` (:637) and ``predict_batch`` (:658).

With ``prepare(jit=True)``, the default, the reference runs
``train_batch`` (with ``update=True``), ``eval_batch`` and
``predict_batch`` as jitted XLA steps cached per signature (:467-481,
:637-680).  The port captures each in a CUDA graph per signature — the
kind (``"train"``, ``"eval"``, ``"predict"``), the inputs' and labels'
shapes and dtypes, and for training the AMP level and type — through an
:class:`~paddle_tpu_torch.serving.bucketing.ExecutableCache` of
:class:`~paddle_tpu_torch.graphs.StepGraph` entries.  The first call of a
signature runs the step once, a real step, on a side stream, then
captures it; later calls copy the batch into the graph's static inputs
and replay it, one host call.  The train graph holds the forward, the
loss, the backward and the optimizer step; the gradients stay fixed
buffers, zeroed in place after each step, the optimizer updates its state
in place and reads its learning rate from a device scalar, and the fused
epilogue's seeds and the dropout masks are drawn anew at every replay
(``random.SeedSlots``, the device generators registered with the graph),
as the uncaptured step draws them.  So N calls leave the parameters as N
uncaptured steps do.  A capture that fails raises and names its key; a
parameter, gradient or optimizer slot replaced rather than updated in
place makes the next call capture again.  The loss and the outputs are
copies of the graph's outputs.  On the CPU an entry is the step function
itself.

``prepare(jit=False)``, and ``train_batch(update=False)`` either way,
run the reference's eager engine: forward, loss, backward and (with
``update``) ``optimizer.step()`` and ``clear_grad()``, with no host
synchronisation inside.  The loss comes back as a 0-d device tensor,
which ``float()`` reads, in the role of the reference's lazy loss scalar
(``_LazyScalar``).  Inputs and labels may be numpy arrays or tensors;
pass tensors already on the card to keep the host-to-device copy out of
the step.  The constructor's ``inputs``/``labels`` (the reference's
static input specs) are accepted and change nothing.

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

import itertools
import os
from typing import Callable, Dict, List

import torch

from ..amp import auto_cast, to_dtype
from ..graphs import StepGraph
from ..ops.amp_ops import check_finite_and_unscale, update_loss_scaling
from ..serving.bucketing import ExecutableCache

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
        self._jit = True
        self._steps = ExecutableCache(name="hapi")

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True, offload=False) -> "Model":
        """Set the optimizer, the loss and AMP.  ``jit`` (the default)
        captures the train (with ``update``), eval and predict steps per
        signature; ``jit=False`` runs them eagerly."""
        if metrics:
            raise NotImplementedError(f"metrics {_NOT_PORTED}")
        self._amp, self._scaler = self._amp_settings(amp_configs)
        if offload:
            raise NotImplementedError(f"optimizer-state offload "
                                      f"{_NOT_PORTED}")
        self._optimizer = optimizer
        self._loss = loss
        self._jit = bool(jit)
        self._steps = ExecutableCache(name="hapi")
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
            p.grad.copy_(g)
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

    # -- captured steps ------------------------------------------------
    def _bound(self, grads: bool):
        """What a captured step reads and writes by address: parameters
        and buffers; for training also the gradients and the optimizer's
        state and learning rate."""
        net = self.network
        out = itertools.chain(net.parameters(), net.buffers())
        if grads:
            out = itertools.chain(
                out, (p.grad for p in net.parameters() if p.grad is not None),
                self._optimizer.bound_tensors())
        return out

    def _captured(self, kind: str, make: Callable, values: List,
                  extra=()):
        """Run the step ``make()`` on ``values`` through its entry, keyed
        by ``kind``, the values' shapes and dtypes and ``extra``: the
        first call of a key runs the step (a real step) and captures it,
        later calls replay.  Returns the step's outputs, copied out of the
        graph's static outputs."""
        dev = self._device()
        sig = tuple((tuple(v.shape), v.dtype) for v in (
            v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for v in values))
        key = (kind, sig) + tuple(extra)
        made = []

        def compile_fn():
            inputs = [torch.zeros(shape, dtype=dt, device=dev)
                      for shape, dt in sig]
            exe = StepGraph(key, make(), inputs, values,
                            bound=lambda: self._bound(kind == "train"))
            made.append(exe)
            return exe
        exe = self._steps.get_or_compile(key, compile_fn,
                                         valid=StepGraph.current)
        if made:
            out, exe.first_outputs = exe.first_outputs, None
            return out
        out = exe(*values)
        if exe.graph is None:
            return out
        return tuple(o.clone() for o in out) if isinstance(out, tuple) \
            else out.clone()

    def _train_step(self, n_in: int) -> Callable:
        """forward, loss, backward, optimizer step, gradients zeroed in
        place; returns the loss."""
        def step(*tensors):
            ins, labs = list(tensors[:n_in]), list(tensors[n_in:])
            outs = _to_list(self.network(*ins) if self._amp is None
                            else self._forward_amp(ins))
            loss = self._loss(*(outs + labs))
            finite = True
            if self._scaler is None:
                loss.backward()
            else:
                finite = self._scaled_backward(loss)
            if finite:
                self._optimizer.step()
            self._optimizer.clear_grad(set_to_zero=True)
            return loss.detach()
        return step

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
        if update and self._jit:
            ins, labs = _to_list(inputs), _to_list(labels)
            opt = self._optimizer
            steps = opt._global_step
            amp = None if self._amp is None else (self._amp["level"],
                                                  self._amp["dtype"])
            loss = self._captured("train", lambda: self._train_step(
                len(ins)), ins + labs, (amp,))
            opt._global_step = steps + 1
            return self._pack_logs(loss, {})
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
        ins, labs = _to_list(inputs), _to_list(labels)
        if self._loss is not None and labs and self._jit:
            n = len(ins)

            def make():
                return lambda *t: self._loss(*(_to_list(
                    self.network(*t[:n])) + list(t[n:])))
            return self._pack_logs(float(self._captured(
                "eval", make, ins + labs)), {})
        outs = _to_list(self.network(*self._tensors(ins)))
        labs = self._tensors(labs)
        loss = None
        if self._loss is not None and labs:
            loss = float(self._loss(*(outs + labs)))
        return self._pack_logs(loss, {})

    @torch.no_grad()
    def predict_batch(self, inputs) -> List:
        """The network's outputs in eval mode, as numpy arrays."""
        self.network.eval()
        if self._jit:
            outs = self._captured("predict", lambda: lambda *t: tuple(
                _to_list(self.network(*t))), _to_list(inputs))
        else:
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
