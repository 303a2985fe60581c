"""hapi callbacks of the port — the counterpart of
``paddle_tpu/hapi/callbacks.py``: ``CallbackList``, ``Callback``,
``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping``,
``LRSchedulerCallback``, ``VisualDL`` and ``config_callbacks``.

``Model.train_batch`` returns its loss as a 0-d device tensor, whose
read waits for the step.  The reference's loss is a lazy scalar
(``numbers.Real``), and its logging callbacks keep only
``numbers.Number`` values; here a 0-d tensor counts as a number too
(:func:`_is_scalar`), and is read only where the reference coerces:
``ProgBarLogger`` on its ``log_freq`` lines and at the end of an epoch,
``VisualDL`` at its flushes, ``EarlyStopping`` on the evaluation's
result.  No callback reads ``logs["loss"]`` on any other step, so
``fit`` at ``verbose=0`` never waits for the card.

``ProfilerCallback`` raises ``NotImplementedError``: the profiler's
tracer is not ported yet (ROADMAP.md A8, the profiler bullet).
"""
from __future__ import annotations

import numbers
import os
import time

import numpy as np
import torch

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRSchedulerCallback", "VisualDL", "ProfilerCallback",
           "config_callbacks"]


def _is_scalar(v) -> bool:
    """A number, or a 0-d tensor (read only when it is formatted)."""
    return isinstance(v, numbers.Number) or (
        isinstance(v, torch.Tensor) and v.dim() == 0)


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)

    @property
    def stop_training(self):
        return any(getattr(c, "stop_training", False)
                   for c in self.callbacks)


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.step = 0
        self._epoch_t0 = time.time()
        self._ips_t0 = self._epoch_t0
        self._ips_samples = 0

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if k == "batch_size":        # loop metadata, not a metric
                continue
            if _is_scalar(v):
                parts.append(f"{k}: {float(v):.4f}")
            elif isinstance(v, (list, tuple, np.ndarray)):
                parts.append(f"{k}: " + ",".join(f"{x:.4f}" for x in
                                                 np.ravel(v)[:4]))
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        # logs['loss'] is a LAZY device scalar in the async fit loop —
        # it must only be coerced (via _fmt) on log_freq boundaries, so
        # the steady-state loop blocks on the device at most once per
        # window (tools/pipeline_gate.py + test_async_pipeline pin this)
        self.step = step
        self._ips_samples += ((logs or {}).get("batch_size")
                              or self.params.get("batch_size") or 0)
        if self.verbose >= 2 and step % self.log_freq == 0:
            total = self.params.get("steps")
            msg = (f"Epoch {self.epoch + 1}/{self.epochs} "
                   f"step {step}/{total} - {self._fmt(logs)}")
            # ips over the window since the last log line (reference
            # hapi ProgBarLogger reports "ips: N samples/sec")
            now = time.time()
            dt = now - self._ips_t0
            if self._ips_samples and dt > 0:
                msg += f" - ips: {self._ips_samples / dt:.2f} samples/s"
            self._ips_t0 = now
            self._ips_samples = 0
            print(msg, flush=True)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose >= 1:
            dt = time.time() - self._epoch_t0
            print(f"Epoch {epoch + 1}/{self.epochs} done in {dt:.1f}s "
                  f"- {self._fmt(logs)}", flush=True)

    def on_eval_end(self, logs=None):
        if self.verbose >= 1:
            print(f"Eval - {self._fmt(logs)}", flush=True)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stop_training = False
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.best = None
        self.wait = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.ravel(cur)[0]) if isinstance(
            cur, (list, tuple, np.ndarray)) else float(cur)
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir,
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: stop (best {self.monitor}="
                          f"{self.best:.5f})")


class LRSchedulerCallback(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        assert by_step != by_epoch
        self.by_step = by_step

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if not self.by_step and s is not None:
            s.step()


class VisualDL(Callback):
    """Scalar logging callback.  VisualDL itself isn't in this image;
    writes a plain jsonl the dashboard (or any reader) can tail.

    Per-step values are buffered as-is and only coerced to float at
    flush points (every ``flush_every`` steps, epoch end, train end) —
    ``logs['loss']`` is a lazy device scalar in the async fit loop, and
    coercing it every step would reintroduce the per-step host sync
    this pipeline removes.  A crash mid-window loses at most
    ``flush_every`` steps of scalars; shrink it (or 1 for the old
    write-per-step behavior) when post-mortem completeness matters more
    than pipeline depth."""

    def __init__(self, log_dir="vdl_log", flush_every=64):
        super().__init__()
        self.log_dir = log_dir
        self.flush_every = max(1, int(flush_every))
        self._f = None
        self._buf = []

    def on_train_begin(self, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def _flush(self):
        import json
        if not self._f:
            self._buf.clear()
            return
        for step, rec in self._buf:
            out = {"step": step}
            for k, v in rec:
                out[k] = float(v)   # lazy scalars materialize here
            self._f.write(json.dumps(out) + "\n")
        self._buf.clear()

    def on_train_batch_end(self, step, logs=None):
        if self._f and logs:
            self._buf.append((step, [(k, v) for k, v in logs.items()
                                     if k != "batch_size" and
                                     _is_scalar(v)]))
            if len(self._buf) >= self.flush_every:
                self._flush()

    def on_epoch_end(self, epoch, logs=None):
        self._flush()

    def on_train_end(self, logs=None):
        if self._f:
            self._flush()
            self._f.close()


class ProfilerCallback(Callback):
    """Drives the reference's ``paddle.profiler.Profiler`` across
    ``Model.fit``; the profiler is not ported yet."""

    def __init__(self, profiler=None, summary=True, **profiler_kwargs):
        raise NotImplementedError(
            "ProfilerCallback is not ported yet: it drives "
            "paddle.profiler's Profiler and host tracer, which wait for "
            "the profiler port (ROADMAP.md A8, the profiler bullet; the "
            "metrics registry and the flight recorder are ported)")


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    if not any(isinstance(c, LRSchedulerCallback) for c in cbks) and \
            mode == "train":
        cbks = cbks + [LRSchedulerCallback()]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"batch_size": batch_size, "epochs": epochs,
                    "steps": steps, "verbose": verbose,
                    "metrics": metrics or []})
    return lst
