"""``paddle.Model`` — the counterpart of ``paddle_tpu/hapi/model.py``
(``Model`` :160): ``prepare`` (:174), ``train_batch`` (:463),
``eval_batch`` (:637), ``predict_batch`` (:658), ``fit`` (:988),
``evaluate`` (:1298), ``predict`` (:1342), ``save`` and ``load``
(:1363-1384).

With ``prepare(jit=True)``, the default, the reference runs
``train_batch`` (with ``update=True``), ``eval_batch`` and
``predict_batch`` as jitted XLA steps cached per signature (:467-481,
:637-680).  The port captures each in a CUDA graph per signature — the
kind (``"train"``, ``"eval"``, ``"predict"``), the inputs' and labels'
shapes and dtypes, and for training the AMP level and type and the remat
decision — through an
:class:`~paddle_tpu_torch.serving.bucketing.ExecutableCache` of
:class:`~paddle_tpu_torch.graphs.StepGraph` entries.  The first call of a
signature runs the step once, a real step, on a side stream, then
captures it; later calls copy the batch into the graph's static inputs
(device to device when the batch is already on the card) and replay it,
one host call.  The train graph holds the forward, the loss, the
backward, the gradient clip and the optimizer step; the gradients stay
fixed buffers, zeroed in place after each step, the optimizer updates
its state in place and reads its learning rate from a device scalar,
which ``train_batch`` refreshes from the optimizer (and its scheduler)
before each replay, outside the graph; the fused epilogue's seeds and
the dropout masks are drawn anew at every replay (``random.SeedSlots``,
the device generators registered with the graph), as the uncaptured step
draws them.  So N calls leave the parameters as N uncaptured steps do.
A capture that fails raises and names its key; a parameter, gradient or
optimizer slot replaced rather than updated in place makes the next call
capture again.  On the CPU an entry is the step function itself.

A replay's outputs are the graph's static tensors, which its next replay
overwrites: each caller reads them at once, before anything can replay
the entry again — the loss is copied, ``eval_batch`` reads its loss,
``predict_batch`` copies the outputs to the host, and with metrics
(``prepare(metrics=...)``, :179-181) the train and eval graphs also hand
out the network's outputs, on the first of which ``metric.compute`` runs
right after the replay (``_update_metrics``, :675).  They are not
copied: at the flagship width they are 2 GB of logits a step.

``prepare(jit=False)``, and ``train_batch(update=False)`` either way,
run the reference's eager engine: forward, loss, backward and (with
``update``) ``optimizer.step()`` and ``clear_grad()``, with no host
synchronisation inside.  The loss comes back as a 0-d device tensor,
which ``float()`` reads, in the role of the reference's lazy loss scalar
(``_LazyScalar``); the callbacks take it as a number and read it only
where the reference's would.  Inputs and labels may be numpy arrays or
tensors.  The constructor's ``inputs`` (the reference's static input
specs) say how many leading fields of a batch are inputs
(``_split_batch``, :1290; one when not given).

``fit`` runs the reference's loop (:988-1288): a ``DataLoader`` from a
``Dataset``, the callbacks of ``config_callbacks`` (a progress bar at
``verbose``, ``ModelCheckpoint`` with ``save_dir``, and
``LRSchedulerCallback``, which steps the optimizer's scheduler after
every batch), per epoch a fresh :class:`~paddle_tpu_torch.io.DevicePrefetcher`
of depth ``prefetch_to_device`` (default ``FLAGS_prefetch_to_device``,
2; 0 turns it off) onto the model's device,
``train_batch`` per batch (with ``accumulate_grad_batches`` > 1,
``train_batch(update=False)`` and an eager step on the boundary), the
real batch size in the logs, ``evaluate`` every ``eval_freq`` epochs,
and ``num_iters`` and ``stop_training``.

``prepare(amp_configs=...)`` (the reference's :189-215: ``"O1"``,
``"O2"`` or a dict with ``level``, ``dtype``, ``custom_white_list``,
``custom_black_list`` and the fp16 scaler's settings) runs
``train_batch``'s forward under :func:`~paddle_tpu_torch.amp.auto_cast`,
as the reference's step does (:618; the loss, eval and predict run
outside it, as there).  O2 on fp32 parameters keeps them as the masters
the optimizer updates: the forward sees a low-type view of them cast
inside the differentiated function (``torch.func.functional_call``), so
the gradients land on the fp32 leaves (:254-262).  A network that
``amp.decorate`` cast to the low type runs its forward on those
parameters as they are; its optimizer's fp32 masters (``multi_precision``)
take the update.  fp16 engages the
dynamic loss scaling of the reference's jitted step (:296-331), on the
device and captured with the step: the scale (fp32), the good and bad
counts (int32) and ``found_inf`` (bool) are 0-d tensors on the model's
device, written in place and bound by address; a step scales the loss,
runs the backward, unscales the gradients and checks them in one pass per
type (``ops/multi_tensor_update.multi_tensor_unscale``, the unscale kernel
on the card), hands ``found_inf`` to ``optimizer.step``, which then writes
nothing on overflow, and moves the scale state
(``update_loss_scaling_``).  A ``train_batch(update=False)`` (``fit``'s
``accumulate_grad_batches``) leaves its gradients scaled, and the step
that updates unscales and checks their sum once.  No step reads the
flag on the host, so the captured and the eager fp16 steps are one code
path; ``_amp_found_inf`` is the last step's flag, a device tensor, as in
the reference (:581).
The optimizer's step count advances on an overflow too (:595-596).

The budget remat (:meth:`Model._remat_decision`, the reference's
:340-376): with ``FLAGS_program_remat`` set and ``FLAGS_remat_budget_mb``
above 0 (the flag registry, ``paddle_tpu_torch.set_flags``), the captured
update step keeps every product's output and recomputes the rest in the
backward (:mod:`~paddle_tpu_torch.hapi.remat`, the reference's
``dots_saveable`` checkpoint, :283-290); the decision is part of the
step's key, so setting the flags captures another graph.  The reference
engages it when its static planner's peak passes the budget or the model
cannot be planned; the port has no planner yet (``ROADMAP.md`` A7) and
takes the second branch for every model, warning as the reference does
("planner peak unknown").  A model the reference could plan under its
budget therefore remats in the port: its values are the same, its memory
lower and its step slower.  ``jit=False``, ``update=False`` and ``fit``'s
accumulating steps ignore the flags, as the reference's eager engine
does.

``prepare(offload=True)`` (the reference's :217-221, 377-409, 486-491):
from the first captured update step on, every optimizer slot lives in
pinned host memory and each update crosses PCIe for it
(``Optimizer._offload_state``, ``ops/multi_tensor_update.py``); fp32
masters stay on the card.  Where the
model is not on a card (the reference's backend without a
``pinned_host`` memory space) it warns with the reference's text and
trains un-offloaded; ``jit=False`` trains un-offloaded, as there.

``fit``'s fault-tolerance hooks (the reference's :697-934, :1017-1281):
``fit(checkpointer=AsyncCheckpointer(...))`` resumes from the newest
intact checkpoint (``distributed/checkpoint.py``: parameters, buffers,
the optimizer's slots, masters and step count, the random state, the
step and the samples seen), replays the batches already trained without
training them or firing a callback, and saves on the steps the
checkpointer wants (its snapshot ordered on the card against the next
step's in-place update).  ``FLAGS_anomaly_action`` (``raise``, ``skip``,
``rollback``) reads the loss after every step, one synchronising read a
step, and on a nan or inf raises, reverts the whole step from a copy
taken before it, or restores the newest checkpoint; the copy is made
into buffers kept on the card, on the step's stream (an offloaded
optimizer's pinned slots into host memory, after a synchronise).  As in
the reference, the tree holds neither the LR scheduler nor the fp16 loss
scaler's state, a rollback does not rewind the data, and the
``step.loss`` chaos site poisons the loss ``train_batch`` reports after a
normal update.  With no checkpointer and no flag, ``fit`` makes no
synchronising call.  The supervisor's heartbeat
(``PADDLE_SUPERVISE_STORE``) raises ``NotImplementedError`` until the
distributed launch is ported (``ROADMAP.md`` A5); ``save(training=False)``,
the inference export, until A6.  ``summary`` (:1465) prints
:func:`~paddle_tpu_torch.hapi.summary.summary`'s table.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import warnings
from typing import Callable, Dict, List

import numpy as np
import torch

from .. import framework_io
from .. import random as _random
from ..amp import auto_cast, to_dtype
from ..graphs import StepGraph
from ..metric import Metric
from ..ops.amp_ops import update_loss_scaling_
from ..ops.multi_tensor_update import multi_tensor_unscale
from ..serving.bucketing import ExecutableCache
from ..utils import chaos as _chaos
from ..utils.flags import get_flag
from . import remat as _remat
from .callbacks import config_callbacks
from .summary import summary as _summary

__all__ = ["Model"]

_SUPERVISE = ("the supervised-launch heartbeat (PADDLE_SUPERVISE_STORE) is "
              "not ported yet: it needs the distributed launch's stores, "
              "heartbeat key and fleet metrics (ROADMAP.md A5)")


def _to_list(x) -> List:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _batch_len(ins) -> int:
    """Samples in one batch (leading dim of the first input), 0 if moot."""
    try:
        return int(ins[0].shape[0])
    except (IndexError, AttributeError, TypeError):
        return 0


class Model:
    """Train, evaluate and run a ``torch.nn.Module`` batch by batch."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._save_dir = None
        self._last_prefetcher = None
        self._amp = None
        self._scaler = None
        self._amp_found_inf = None
        self._jit = True
        self._offload = False
        self._offload_on = None
        self._remat_cache = None
        self._remat_active = False
        self._remat_planned_peak = None
        self._steps = ExecutableCache(name="hapi")
        self._train_step_count = 0
        self._guard = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True, offload=False) -> "Model":
        """Set the optimizer, the loss and AMP.  ``jit`` (the default)
        captures the train (with ``update``), eval and predict steps per
        signature; ``jit=False`` runs them eagerly.  ``metrics`` are
        ``paddle_tpu_torch.metric.Metric``s.  ``offload`` keeps the
        optimizer's state in pinned host memory (module docstring); without
        it, an optimizer an earlier ``prepare`` offloaded has its state
        brought back onto the card."""
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m} is not a paddle Metric")
        self._amp, self._scaler = self._amp_settings(amp_configs)
        self._amp_found_inf = None
        self._offload = bool(offload)
        self._offload_on = None
        self._optimizer = optimizer
        self._loss = loss
        self._jit = bool(jit)
        self._steps = ExecutableCache(name="hapi")
        if optimizer is not None:
            optimizer._name_parameters(
                {id(p): n for n, p in self.network.named_parameters()})
            if not offload:             # offloaded by an earlier prepare
                optimizer._offload_state(False)
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
        # fp16's exponent range needs dynamic loss scaling (:198-213);
        # bf16 shares fp32's range and never engages it.  The state is
        # made on the model's device at the first step (_scaler_state, as
        # the reference makes it, :492-500) and written in place.
        scaler = dict(
            init_loss_scaling=float(cfg.get("init_loss_scaling", 2.0 ** 15)),
            scale=None, good=None, bad=None, found_inf=None, tables={},
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

    def _scaler_state(self) -> None:
        """Make the fp16 scaler's device state at the first step, outside
        any capture: the scale, the good and bad counts and the flag."""
        sc = self._scaler
        if sc is None or sc["scale"] is not None:
            return
        dev = self._device()
        sc["scale"] = torch.full((), sc["init_loss_scaling"],
                                 dtype=torch.float32, device=dev)
        sc["good"] = torch.zeros((), dtype=torch.int32, device=dev)
        sc["bad"] = torch.zeros((), dtype=torch.int32, device=dev)
        sc["found_inf"] = torch.zeros((), dtype=torch.bool, device=dev)

    def _backward_and_step(self, loss: torch.Tensor, update: bool) -> None:
        """The backward and, with ``update``, ``optimizer.step()``; under
        fp16 the reference's loss scaling (:296-331) around them, all on
        the device: the backward of the fp32 loss times the scale and,
        with ``update``, the gradients unscaled in place and checked
        (``found_inf``), the step skipped on the device where it is set,
        the scale state moved.  Without ``update`` the gradients stay
        scaled and add up in ``.grad`` under the one scale of the window
        (only an update moves it), so the step that updates unscales and
        checks their whole sum once."""
        sc = self._scaler
        if sc is None:
            loss.backward()
            if update:
                self._optimizer.step()
            return
        (loss.float() * sc["scale"]).backward()
        if not update:
            return
        multi_tensor_unscale(
            [p.grad for p in self.network.parameters() if p.grad is not None],
            sc["scale"], sc["found_inf"], sc["tables"])
        self._amp_found_inf = sc["found_inf"]
        self._optimizer.step(found_inf=sc["found_inf"])
        if sc["use_dynamic_loss_scaling"]:
            update_loss_scaling_(
                sc["found_inf"], sc["scale"], sc["good"], sc["bad"],
                sc["incr_every_n_steps"], sc["decr_every_n_nan_or_inf"],
                sc["incr_ratio"], sc["decr_ratio"])

    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _tensors(self, arrays) -> List[torch.Tensor]:
        dev = self._device()
        return [torch.as_tensor(a).to(dev) for a in _to_list(arrays)]

    # -- captured steps ------------------------------------------------
    def _bound(self, grads: bool):
        """What a captured step reads and writes by address: parameters
        and buffers; for training also the gradients, the optimizer's
        state and learning rate, and under fp16 the scaler's state and the
        unscale pass's device tables."""
        net = self.network
        out = itertools.chain(net.parameters(), net.buffers())
        if grads:
            out = itertools.chain(
                out, (p.grad for p in net.parameters() if p.grad is not None),
                self._optimizer.bound_tensors())
            sc = self._scaler
            if sc is not None:
                out = itertools.chain(
                    out, (sc[k] for k in ("scale", "good", "bad",
                                          "found_inf")),
                    (t for table in sc["tables"].get("tables", ())
                     for t in table.tensors()))
        return out

    def _captured(self, kind: str, make: Callable, values: List,
                  extra=()):
        """Run the step ``make()`` on ``values`` through its entry, keyed
        by ``kind``, the values' shapes and dtypes and ``extra``: the
        first call of a key runs the step (a real step) and captures it,
        later calls replay.  Returns the step's outputs: after a replay
        the graph's static outputs, which the caller reads before the
        entry can replay again."""
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
        return exe(*values)

    def _train_step(self, n_in: int, remat: bool = False) -> Callable:
        """forward, loss, backward, optimizer step (the clip inside it),
        gradients zeroed in place; returns ``(loss,)``, and with metrics
        the network's outputs after it.  With ``remat`` the network's
        blocks and the loss are recomputed regions
        (:mod:`~paddle_tpu_torch.hapi.remat`)."""
        def step(*tensors):
            ins, labs = list(tensors[:n_in]), list(tensors[n_in:])
            with (_remat.segments(self.network) if remat
                  else contextlib.nullcontext()):
                outs = _to_list(self.network(*ins) if self._amp is None
                                else self._forward_amp(ins))
            if remat:
                loss = _remat.checkpoint(self._loss, *(outs + labs))
            else:
                loss = self._loss(*(outs + labs))
            self._backward_and_step(loss, update=True)
            self._optimizer.clear_grad(set_to_zero=True)
            return self._step_outputs(loss, outs)
        return step

    def _step_outputs(self, loss, outs) -> tuple:
        """``(loss,)``, with metrics also the outputs they compute on."""
        keep = tuple(o.detach() for o in outs) if self._metrics else ()
        return (loss.detach(),) + keep

    def _update_metrics(self, outs, labels) -> Dict:
        """Each metric's ``compute`` on the first output and the labels
        (on the device), then its ``update`` (a host read); returns
        ``{name: result}``."""
        if not self._metrics:
            return {}
        results = {}
        labels = self._tensors(labels)
        for metric in self._metrics:
            computed = metric.compute(outs[0], *labels)
            if isinstance(computed, (list, tuple)):
                res = metric.update(*computed)
            else:
                res = metric.update(computed)
            names = metric.name()
            results[names[0] if isinstance(names, list) else names] = res
        return results

    def _pack_logs(self, loss, metrics: Dict) -> Dict:
        logs = {}
        if loss is not None:
            logs["loss"] = loss
        logs.update(metrics)
        return logs

    def _remat_decision(self, batch_size: int = 1) -> bool:
        """Whether the captured update step remats (the reference's
        :340-376): ``FLAGS_program_remat`` set, ``FLAGS_remat_budget_mb``
        above 0, and the planner's train peak over the budget or unknown.
        The port has no planner yet (``ROADMAP.md`` A7), so the peak is
        unknown and every budget engages it, with the reference's warning.
        The verdict is cached per (budget, batch size)."""
        if not get_flag("FLAGS_program_remat"):
            return False
        budget_mb = int(get_flag("FLAGS_remat_budget_mb") or 0)
        if budget_mb <= 0:
            return False
        cached = self._remat_cache
        if cached is not None and cached[0] == (budget_mb, batch_size):
            return cached[1]
        peak = None                       # static_memory_plan: A7
        on = peak is None or peak > budget_mb * (1 << 20)
        if on:
            warnings.warn(
                f"fit: rematerialization engaged — planner peak "
                f"{'unknown' if peak is None else f'{peak}B'} vs budget "
                f"{budget_mb}MB (FLAGS_remat_budget_mb); the train step "
                f"recomputes non-matmul activations in the backward")
        self._remat_active = on
        self._remat_planned_peak = peak
        self._remat_cache = ((budget_mb, batch_size), on)
        return on

    def _offload_state(self) -> None:
        """At the first captured update step after ``prepare(offload=
        True)``: the optimizer's slots move to pinned host memory when the
        model is on a card; elsewhere the reference's warning, once, and
        no offload (the reference's ``_offload_shardings``, :377-409)."""
        if not self._offload or self._offload_on is not None:
            return
        self._offload_on = self._device().type == "cuda"
        if self._offload_on:
            self._optimizer._offload_state()
        else:
            warnings.warn(
                "prepare(offload=True): this backend exposes no "
                "pinned_host memory space — optimizer-state offload "
                "is a no-op here (training proceeds un-offloaded)")

    # ------------------------------------------------------------------
    def train_batch(self, inputs, labels=None, update: bool = True) -> Dict:
        """One step on a batch: ``{"loss": 0-d device tensor}`` and each
        metric's result.  With ``update=False`` the gradients stay in the
        parameters' ``.grad`` and nothing is stepped."""
        if self._loss is None or (update and self._optimizer is None):
            raise RuntimeError("call prepare(optimizer, loss) before "
                               "train_batch")
        self.network.train()
        self._scaler_state()              # outside the graph
        ins, labs = _to_list(inputs), _to_list(labels)
        if not (update and self._jit):
            return self._train_batch_eager(ins, labs, update)
        opt = self._optimizer
        steps = opt._global_step
        amp = None if self._amp is None else (self._amp["level"],
                                              self._amp["dtype"])
        remat = self._remat_decision(_batch_len(ins))
        self._offload_state()             # outside the graph
        opt._refresh_lr()                 # outside the graph
        out = self._captured(
            "train", lambda: self._train_step(len(ins), remat), ins + labs,
            (remat, amp))
        opt._global_step = steps + 1
        metrics = self._update_metrics(out[1:], labs)
        self._train_step_count += 1
        loss = out[0].clone()
        if _chaos.active and _chaos.hit("step.loss") == "nan":
            # the chaos layer poisons the reported loss of a step that
            # updated normally (the reference's :601-604)
            loss = float("nan")
        if get_flag("FLAGS_check_nan_inf"):
            # the loss read at the step that made it (:605-613)
            v = float(loss)
            if not np.isfinite(v):
                raise FloatingPointError(
                    f"loss is {v} at train step {self._train_step_count} "
                    f"(FLAGS_check_nan_inf enabled)")
        return self._pack_logs(loss, metrics)

    def _train_batch_eager(self, inputs, labels, update: bool = True) -> Dict:
        """The eager engine's step: forward, loss, backward and, with
        ``update``, ``optimizer.step()`` and ``clear_grad()``."""
        self._scaler_state()
        ins = self._tensors(inputs)
        outs = _to_list(self.network(*ins) if self._amp is None
                        else self._forward_amp(ins))
        loss = self._loss(*(outs + self._tensors(labels)))
        self._backward_and_step(loss, update)
        if update:
            self._optimizer.clear_grad()
        return self._pack_logs(loss.detach(), self._update_metrics(
            [o.detach() for o in outs], labels))

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None) -> Dict:
        """``{"loss": float}`` of the batch in eval mode (no loss without
        labels or a loss function), and each metric's result."""
        self.network.eval()
        ins, labs = _to_list(inputs), _to_list(labels)
        if self._loss is not None and labs and self._jit:
            n = len(ins)

            def make():
                def step(*t):
                    outs = _to_list(self.network(*t[:n]))
                    return self._step_outputs(
                        self._loss(*(outs + list(t[n:]))), outs)
                return step
            out = self._captured("eval", make, ins + labs)
            return self._pack_logs(float(out[0]),
                                   self._update_metrics(out[1:], labs))
        outs = _to_list(self.network(*self._tensors(ins)))
        loss = None
        if self._loss is not None and labs:
            loss = float(self._loss(*(outs + self._tensors(labs))))
        return self._pack_logs(
            loss, self._update_metrics(outs, labs) if labs else {})

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
    def _epoch_input(self, loader, depth):
        """(iterator, prefetcher or None) for one epoch over ``loader``: a
        fresh :class:`~paddle_tpu_torch.io.DevicePrefetcher` of ``depth``
        onto the model's device, unless ``depth`` is 0 or the loader runs
        its own stage (which is pointed at the model's device)."""
        from ..io import DataLoader, DevicePrefetcher
        depth = int(get_flag("FLAGS_prefetch_to_device") if depth is None
                    else depth or 0)
        dev = self._device()
        if getattr(loader, "prefetch_to_device", 0) > 0:
            loader._device = dev
            return iter(loader), None
        if depth <= 0:
            return iter(loader), None
        if isinstance(loader, DataLoader):
            pf = DevicePrefetcher.for_loader(loader, depth=depth, device=dev)
        else:
            pf = DevicePrefetcher(iter(loader), depth=depth, device=dev)
        self._last_prefetcher = pf
        return iter(pf), pf

    # ------------------------------------------------------------------
    # fault tolerance: checkpoint resume and the anomaly guard (the
    # reference's :697-934)
    # ------------------------------------------------------------------
    def _ckpt_tree(self, step_count: int) -> Dict:
        """(params, buffers, opt, meta) as one checkpointable tree: the
        live tensors (the checkpointer snapshots them), the optimizer's
        functional state, and in ``meta`` the step count, the random
        state (:func:`paddle_tpu_torch.random.get_state`, the port's form
        of ``rng_seed`` / ``rng_counter``), the data-parallel world and
        the samples seen, in all and in this epoch.  As in the
        reference, no LR scheduler and no fp16 loss scale."""
        rng = _random.get_state()
        rng["seed"] = np.uint64(rng["seed"] & ((1 << 64) - 1))
        rng["draws"] = np.int64(rng["draws"])
        return {"params": dict(self.network.named_parameters()),
                "buffers": dict(self.network.named_buffers()),
                "opt": self._optimizer.functional_state(),
                "meta": {"step": np.int64(step_count), "rng": rng,
                         "world": np.int64(getattr(self, "_fit_data_world",
                                                   1)),
                         "samples": np.int64(getattr(
                             self, "_fit_samples_seen", 0)),
                         "epoch": np.int64(getattr(self, "_fit_epoch", 0)),
                         "samples_epoch": np.int64(getattr(
                             self, "_fit_samples_epoch", 0))}}

    def _fit_resume(self, checkpointer, data_world=None):
        """Restore the newest intact checkpoint into the live model, in
        place (corrupt steps are quarantined by the checkpointer); returns
        ``{"step", "world", "epoch", "samples_epoch", "label"}``, or None
        when nothing intact exists (the live state is left untouched).  The reference's :731-810 with its cross-world
        branch; the port reads only its own format-2 trees, so the
        reference's retry of a pre-v2 tree is not taken over, and any
        other restore error propagates."""
        from ..distributed.checkpoint import (CheckpointCorruptError,
                                              copy_into, derive_rank_seed)
        if data_world is None:
            data_world = getattr(self, "_fit_data_world", 1)
        try:
            restored = checkpointer.restore(template=self._ckpt_tree(0))
        except CheckpointCorruptError:
            if checkpointer.all_steps():
                warnings.warn(
                    "fit: no intact checkpoint survived verification; "
                    "starting from scratch")
            return None
        copy_into(dict(self.network.named_parameters()), restored["params"],
                  "parameters")
        copy_into(dict(self.network.named_buffers()),
                  restored.get("buffers", {}), "buffers")
        self._optimizer.load_functional_state(restored["opt"])
        meta = restored["meta"]
        old_world = int(meta["world"])
        if old_world != data_world:
            # cross-world resume: each survivor re-derives its streams
            # from its NEW rank instead of inheriting an old rank's
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            _random.set_state(meta["rng"], seed=derive_rank_seed(
                int(meta["rng"]["seed"]), rank))
        else:
            _random.set_state(meta["rng"])
        step = int(meta["step"])
        warnings.warn(f"fit: resumed from checkpoint at step {step} "
                      f"(generation "
                      f"{os.environ.get('PADDLE_RESTART_GENERATION', '0')}"
                      f", saved at data-parallel world {old_world})")
        seen = getattr(checkpointer, "last_restored_meta", None) or {}
        label = seen.get("step")
        label = step if label is None else int(label)
        return {"step": step, "world": old_world, "epoch": int(meta["epoch"]),
                "samples_epoch": int(meta["samples_epoch"]), "label": label}

    def _guard_live(self):
        """``(device tensors, host tensors, step count)`` the anomaly
        guard reverts: the parameters, buffers, and the optimizer's
        :meth:`~Optimizer.functional_state` (the reference's :878-894:
        params, buffers and ``_fn_state``); on a card, an offloaded
        optimizer's slots are the host ones."""
        fs = self._optimizer.functional_state()
        live = list(self.network.parameters())
        live += self.network.buffers()
        for slots in fs["slots"].values():
            live += slots.values()
        live += fs["master"].values()
        if self._device().type != "cuda":
            return live, [], fs["step"]
        dev, host = [], []
        for t in live:
            (dev if t.is_cuda else host).append(t)
        return dev, host, fs["step"]

    @torch.no_grad()
    def _state_refs(self):
        """Copies of the guarded state before a step, into buffers kept
        across steps (made again when the set of tensors changed; a
        tensor's storage may move, the copy reads it where it lies, and
        one whose shape changed makes the copy raise): the device tensors
        on the step's stream, one multi-tensor copy, no host wait; pinned
        host tensors (offloaded slots, which the card writes
        asynchronously) into host memory, after a synchronise of the
        step's stream."""
        dev, host, step = self._guard_live()
        key = tuple(map(id, dev + host))
        guard = self._guard
        if guard is None or guard["key"] != key:
            guard = self._guard = dict(key=key, dev=[
                torch.empty_like(t) for t in dev], host=[
                torch.empty_like(t) for t in host])
        if dev:
            torch._foreach_copy_(guard["dev"], dev, non_blocking=True)
        if host:
            torch.cuda.current_stream(self._device()).synchronize()
            for buf, t in zip(guard["host"], host):
                buf.copy_(t)
        return dev, host, step, guard

    @torch.no_grad()
    def _restore_state_refs(self, snap) -> None:
        dev, host, step, guard = snap
        if dev:
            torch._foreach_copy_(dev, guard["dev"], non_blocking=True)
        if host:
            torch.cuda.current_stream(self._device()).synchronize()
            for t, buf in zip(host, guard["host"]):
                t.copy_(buf)
        self._optimizer._global_step = step

    def _handle_anomaly(self, action, value, step_count, snap,
                        checkpointer) -> None:
        """The nan/inf loss policy (``FLAGS_anomaly_action``, the
        reference's :896-934): ``raise``; ``skip`` reverts this step;
        ``rollback`` restores the newest intact checkpoint (or reverts
        the step without one).  The data is not rewound either way."""
        from ..profiler import flight as _flight
        from ..profiler import metrics as _metrics
        _metrics.counter("train.anomaly",
                         "nan/inf losses caught by the fit anomaly "
                         "guard").inc()
        if _flight.active:
            _flight.note("train", "anomaly", value=str(value),
                         step=step_count, action=action)
        if action == "raise":
            raise FloatingPointError(
                f"loss is {value} at train step {step_count} "
                f"(FLAGS_anomaly_action=raise)")
        if action == "rollback" and checkpointer is not None:
            restored = self._fit_resume(checkpointer)
            if restored is not None:
                warnings.warn(f"anomalous loss {value} at step "
                              f"{step_count}: rolled back to checkpoint "
                              f"step {restored['step']}")
                return
            warnings.warn("FLAGS_anomaly_action=rollback: no intact "
                          "checkpoint yet, reverting this step instead")
        elif action == "rollback":
            warnings.warn("FLAGS_anomaly_action=rollback without a "
                          "checkpointer: reverting this step instead")
        self._restore_state_refs(snap)
        # the accumulation path has already backward()ed the poisoned
        # loss into .grad: flush it (zeroed in place, so that a captured
        # step keeps its gradient buffers)
        self._optimizer.clear_grad(set_to_zero=True)
        warnings.warn(f"anomalous loss {value} at step {step_count}: "
                      f"step reverted, continuing")

    @staticmethod
    def _check_fault_tolerance() -> None:
        """The supervisor's heartbeat waits for the distributed launch
        (A5) and raises rather than being ignored."""
        if os.environ.get("PADDLE_SUPERVISE_STORE"):
            raise NotImplementedError(_SUPERVISE)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, checkpointer=None,
            prefetch_to_device=None):
        """Train on ``train_data`` (a ``Dataset`` or a loader) for
        ``epochs``; see the module docstring."""
        from ..io import DataLoader, Dataset, DistributedBatchSampler
        self._check_fault_tolerance()
        self._save_dir = save_dir
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                batch_size=batch_size, steps=steps,
                                log_freq=log_freq, verbose=verbose,
                                save_freq=save_freq, save_dir=save_dir,
                                metrics=["loss"] + [m.name() for m in
                                                    self._metrics])
        # the hooks cost one predicate read a step when unconfigured (no
        # checkpointer, no anomaly flag, no chaos spec)
        anomaly = get_flag("FLAGS_anomaly_action")
        # the DATA pipeline's world: > 1 only when the loader shards the
        # index space across ranks
        data_world = 1
        bs = getattr(train_loader, "batch_sampler", None)
        if isinstance(bs, DistributedBatchSampler):
            data_world = int(bs.nranks)
        self._fit_data_world = data_world
        self._fit_samples_seen = 0
        start_step = 0
        resume_samples = None
        resume_epoch = 0
        # directory labels stay monotonic across elastic resumes (the
        # reference's :1037-1043)
        self._fit_save_offset = 0
        if checkpointer is not None and self._optimizer is not None:
            info = self._fit_resume(checkpointer, data_world)
            if info is not None:
                if info["world"] != data_world:
                    self._fit_save_offset = info["label"]
                    # replay completed epochs wholesale and skip WITHIN
                    # the saved epoch by global sample count
                    resume_samples = info["samples_epoch"]
                    resume_epoch = info["epoch"]
                    warnings.warn(
                        f"fit: resharded resume — checkpoint was taken "
                        f"at data-parallel world {info['world']}, this "
                        f"run is world {data_world}; replaying "
                        f"{resume_epoch} completed epoch(s) plus "
                        f"{resume_samples} already-trained global "
                        f"samples instead of old-world step indices")
                else:
                    start_step = info["step"]
                    self._fit_save_offset = max(
                        0, info["label"] - info["step"])
        cbks.on_train_begin()
        step_count = 0
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            self._fit_epoch = epoch
            self._fit_samples_epoch = 0
            for m in self._metrics:
                m.reset()
            logs = {}
            it, pf = self._epoch_input(train_loader, prefetch_to_device)
            try:
                for step, batch in enumerate(it):
                    if resume_samples is not None:
                        # cross-world resume: replay the data order by
                        # GLOBAL samples up to the checkpoint's mark
                        if epoch > resume_epoch:
                            resume_samples = None
                        else:
                            bl = _batch_len(self._split_batch(batch)[0]) \
                                * data_world
                            if epoch < resume_epoch or \
                                    self._fit_samples_epoch + bl <= \
                                    resume_samples:
                                self._fit_samples_seen += bl
                                self._fit_samples_epoch += bl
                                step_count += 1
                                continue
                            short = resume_samples - self._fit_samples_epoch
                            if short > 0:
                                warnings.warn(
                                    f"fit: resharded-resume boundary "
                                    f"falls inside a batch — re-training "
                                    f"{short} of {resume_samples} replayed "
                                    f"samples (the old step boundary is "
                                    f"not representable on the new "
                                    f"world's batch grid)")
                            resume_samples = None
                    if resume_samples is None and step_count < start_step:
                        # resumed run: this batch's update is inside the
                        # restored state; replay the data order without
                        # training it (shuffle must be off or seeded)
                        step_count += 1
                        bl = _batch_len(self._split_batch(batch)[0]) \
                            * data_world
                        self._fit_samples_seen += bl
                        self._fit_samples_epoch += bl
                        continue
                    cbks.on_train_batch_begin(step)
                    ins, lbls = self._split_batch(batch)
                    if anomaly:
                        # the guard's per-step copy (the reference's
                        # :1171-1174)
                        snap = self._state_refs()
                    if accumulate_grad_batches > 1:
                        # the gradients add up in .grad; the optimizer
                        # steps on the boundary
                        if (step + 1) % accumulate_grad_batches:
                            logs = self.train_batch(ins, lbls, update=False)
                        else:
                            self.network.train()
                            logs = self._train_batch_eager(ins, lbls)
                    else:
                        logs = self.train_batch(ins, lbls)
                    step_count += 1
                    self._fit_samples_seen += _batch_len(ins) * data_world
                    self._fit_samples_epoch += _batch_len(ins) * data_world
                    if anomaly and "loss" in logs:
                        # one synchronising read a step (:1206-1218)
                        v = float(logs["loss"])
                        if not np.isfinite(v):
                            self._handle_anomaly(anomaly, v, step_count,
                                                 snap, checkpointer)
                            logs["loss"] = v
                    if _chaos.active:
                        # host.slow stretches this step's wall time
                        _chaos.hit("host.slow")
                    save_label = step_count + self._fit_save_offset
                    if checkpointer is not None and (
                            not hasattr(checkpointer, "want_save")
                            or checkpointer.want_save(save_label)):
                        # the tree and its snapshot only on the steps the
                        # checkpointer writes
                        checkpointer.save(save_label,
                                          self._ckpt_tree(step_count))
                    # the real batch size, also of a partial last batch
                    logs["batch_size"] = _batch_len(ins)
                    cbks.on_train_batch_end(step, logs)
                    if num_iters is not None and step_count >= num_iters:
                        break
            finally:
                if pf is not None:
                    pf.close()
                else:
                    lpf = getattr(train_loader, "_last_prefetcher", None)
                    if lpf is not None:
                        lpf.close()
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and epoch % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size,
                              verbose=verbose, callbacks=cbks, _inner=True)
            if cbks.stop_training or self.stop_training:
                break
            if num_iters is not None and step_count >= num_iters:
                break
        cbks.on_train_end()
        if checkpointer is not None:
            # the last step's write lands before fit returns (:1274-1281)
            checkpointer.wait_until_finished()

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)):
            n_in = len(self._inputs) if self._inputs else 1
            if len(batch) <= n_in:
                return list(batch), []
            return list(batch[:n_in]), list(batch[n_in:])
        return [batch], []

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _inner=False):
        """``{"loss": the mean of the batches' losses, <metric>: its
        accumulated value}`` over ``eval_data``."""
        from ..io import DataLoader, Dataset
        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = eval_data
        cbks = callbacks if _inner else config_callbacks(
            callbacks, model=self, verbose=verbose, log_freq=log_freq,
            mode="eval")
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, lbls = self._split_batch(batch)
            logs = self.eval_batch(ins, lbls)
            if "loss" in logs:
                losses.append(logs["loss"])
            logs["batch_size"] = _batch_len(ins)
            cbks.on_eval_batch_end(step, logs)
        final = {}
        if losses:
            final["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name()
            final[names[0] if isinstance(names, list) else names] = \
                m.accumulate()
        cbks.on_eval_end(final)
        return final

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """``predict_batch`` over ``test_data``: per batch a list of the
        outputs as numpy arrays, or with ``stack_outputs`` one array per
        output, the batches concatenated."""
        from ..io import DataLoader, Dataset
        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = test_data
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # ------------------------------------------------------------------
    def save(self, path, training=True):
        """``<path>.pdparams`` (the network's ``state_dict``) and, with an
        optimizer, ``<path>.pdopt`` (its ``state_dict``), through
        :mod:`~paddle_tpu_torch.framework_io`."""
        if not training:
            raise NotImplementedError(
                "Model.save(training=False), the inference export through "
                "jit.save, is not ported yet (ROADMAP.md A6)")
        framework_io.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            framework_io.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Copy ``<path>.pdparams`` into the network (in place, so the
        captured steps stay valid) and, unless ``reset_optimizer``,
        ``<path>.pdopt`` into the optimizer."""
        self.network.load_state_dict(
            framework_io.load(path + ".pdparams"), strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(framework_io.load(opt_path))

    def summary(self, input_size=None, dtype=None):
        """:func:`~paddle_tpu_torch.hapi.summary.summary` of the network:
        prints its table, returns the totals."""
        return _summary(self.network, input_size, dtypes=dtype)
