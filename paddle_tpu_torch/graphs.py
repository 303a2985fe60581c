"""Captured steps — the port's counterpart of the reference's compiled
executables (``jax.jit(step).lower(...).compile()``, cached per shape
bucket by ``paddle_tpu/serving/bucketing.py`` ``ExecutableCache``).

A :class:`StepGraph` holds one step function over static input tensors.
On the card it is a ``torch.cuda.CUDAGraph``: made by running the step once
on a capture stream (a real step, whose outputs the first call returns),
then capturing it into a graph with its own memory pool; every later call
copies the caller's values into the static inputs and replays the graph
with one host call.  A replay reads every tensor by the address it had
at capture: the inputs, the outputs, and what the step reads besides
(parameters, caches, optimizer state), whose addresses the entry records
(:meth:`StepGraph.current` says whether they still hold).  On the CPU,
where CUDA graphs do not exist, the entry calls the step function itself.

A capture that fails raises :class:`CaptureError`, which names the key;
nothing falls back to running the step uncaptured.

What a replay cannot do, and what stands in for it:

- *Host draws.* The fused epilogue's hash seeds are drawn on the host
  (:mod:`~paddle_tpu_torch.random`): the capture takes them from a
  :class:`~paddle_tpu_torch.random.SeedSlots` vector, which each replay
  refills with fresh draws in the same order.  The port's device
  generators (plain dropout) are registered with the graph
  (``register_generator_state``), so each replay advances them as the
  uncaptured step does.
- *Launch counters.*  The kernel wrappers count launches in plain
  integers (:data:`COUNTERS`) when they run; a capture runs them but
  launches nothing, and a replay launches without running them.  The
  capture's rise of every counter is taken back out and added again at
  each replay.
- *Item counters of ``flash_attn_sm90``*, kept per stream: made for the
  capture stream before the capture
  (:func:`~paddle_tpu_torch.ops.flash_attention.prepare_stream`).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import flash_attention as _fa
from .random import SeedSlots, default_generator

__all__ = ["CaptureError", "StepGraph", "COUNTERS", "launch_counts"]

# the kernel wrappers' launch counters, (module of paddle_tpu_torch.ops,
# attribute): an int, or a dict of ints by key
COUNTERS = (("flash_attention", "FWD_LAUNCHES"),
            ("flash_attention", "BWD_LAUNCHES"),
            ("flash_attention", "MODE_LAUNCHES"),
            ("flash_attention", "SM90_FWD_LAUNCHES"),
            ("flash_attention", "SM90_BWD_LAUNCHES"),
            ("flash_attention_qkv", "FWD_LAUNCHES"),
            ("flash_attention_qkv", "BWD_LAUNCHES"),
            ("fused_ln", "LAUNCHES"),
            ("fused_ln", "BWD_LAUNCHES"),
            ("fused_ln", "ROUTE_LAUNCHES"),
            ("softmax_xent", "LAUNCHES"),
            ("softmax_xent", "DLOGITS_LAUNCHES"),
            ("softmax_xent", "ROUTE_LAUNCHES"),
            ("multi_tensor_update", "LAUNCHES"),
            ("multi_tensor_update", "NORM_LAUNCHES"),
            ("multi_tensor_update", "POW_LAUNCHES"),
            ("multi_tensor_update", "UNSCALE_LAUNCHES"),
            ("multi_tensor_update", "OFFLOAD_ROUTES"))

# one capture stream per device
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def _module(name: str):
    import importlib
    return importlib.import_module(f"{__package__}.ops.{name}")


def launch_counts() -> Dict[Tuple[str, str, Optional[str]], int]:
    """Every launch counter's value, keyed (module, attribute, dict key or
    None)."""
    out = {}
    for mod, attr in COUNTERS:
        val = getattr(_module(mod), attr)
        if isinstance(val, dict):
            out.update({(mod, attr, k): v for k, v in val.items()})
        else:
            out[(mod, attr, None)] = val
    return out


def _set_counts(values: Dict, add: bool) -> None:
    """Write ``values`` into the counters (``add``: add them instead).  A
    dict key written to 0 that it did not hold is removed, so that reset
    counters compare equal to what they were."""
    for (mod, attr, key), v in values.items():
        m = _module(mod)
        if key is None:
            setattr(m, attr, (getattr(m, attr) if add else 0) + v)
            continue
        d = getattr(m, attr)
        new = (d.get(key, 0) if add else 0) + v
        if new or key in d:
            d[key] = new


def _restore_counts(before: Dict) -> Dict:
    """Put the counters back to ``before``; returns each one's rise."""
    after = launch_counts()
    rise = {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
    for k in after:
        if k not in before:                 # a dict key the capture added
            mod, attr, key = k
            getattr(_module(mod), attr).pop(key, None)
    _set_counts(before, add=False)
    return rise


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


def _reset_generators(device: torch.device) -> None:
    """After a capture that failed: the generators the graph held are left
    marked as capturing, and would refuse every later draw.  Each gets a
    fresh copy of its state (same seed and offset, not capturing)."""
    for gen in (torch.cuda.default_generators[device.index or 0],
                default_generator.device(device)):
        gen.graphsafe_set_state(gen.clone_state())


def _host_value(v, like: torch.Tensor):
    """``v`` (numpy, a Python sequence or a tensor) in ``like``'s type, on
    the host unless it is already on ``like``'s device."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
    if v.device == like.device:
        return v
    return v.to(like.dtype)


class StepGraph:
    """``fn(*inputs)`` on the static tensors ``inputs``, as one executable
    under ``key`` (see the module docstring).

    Made with the first call's values ``first``: they are copied into the
    inputs and the step runs once uncaptured (:attr:`first_outputs`), then
    on the card it is captured.  ``bound()`` returns the other tensors the
    step reads or writes by address, as they stand after the first run.
    Calling the entry copies its arguments into the inputs (host arrays
    through pinned memory, without waiting) and runs the step: the static
    outputs of a replay, which the next call overwrites."""

    def __init__(self, key, fn: Callable, inputs: Sequence[torch.Tensor],
                 first: Sequence, bound: Callable[[], Iterable[
                     torch.Tensor]] = tuple):
        self.key = key
        self.fn = fn
        self.inputs = tuple(inputs)
        self.device = self.inputs[0].device
        self._bound = bound
        self.graph = None
        self.outputs = None
        self.seeds: Optional[SeedSlots] = None
        self.rise: Dict = {}
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self._load(first)
        if self.device.type == "cuda":
            self.first_outputs = self._capture()
        else:
            self.first_outputs = fn(*self.inputs)
        # after the first run, which may make what the step binds
        # (gradients, optimizer state)
        self.ptrs = self._ptrs()

    def _ptrs(self) -> Tuple[int, ...]:
        return tuple(t.data_ptr() for t in self._bound())

    def current(self) -> bool:
        """Whether every tensor the step binds still has the address it was
        captured with (a parameter replaced, rather than copied into,
        makes the entry stale)."""
        return self._ptrs() == self.ptrs

    def _load(self, values: Sequence) -> None:
        if len(values) != len(self.inputs):
            raise ValueError(f"step {self.key!r} takes {len(self.inputs)} "
                             f"inputs; got {len(values)}")
        for buf, v in zip(self.inputs, values):
            src = _host_value(v, buf)
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(f"step {self.key!r}: an input of shape "
                                 f"{tuple(src.shape)} where the step takes "
                                 f"{tuple(buf.shape)}")
            if buf.is_cuda and src.device.type == "cpu":
                src = src.pin_memory()
            buf.copy_(src, non_blocking=True)

    def _capture(self):
        """Run the step once on the capture stream (a real step), then
        capture it; returns the uncaptured run's outputs."""
        dev = self.device
        stream = _capture_stream(dev)
        _fa.prepare_stream(stream)
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        drawn = default_generator.draws
        with torch.cuda.stream(stream):
            first = self.fn(*self.inputs)
        cur.wait_stream(stream)
        for t in first if isinstance(first, (tuple, list)) else (first,):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)      # the caller reads it on cur
        drawn = default_generator.draws - drawn
        # garbage with graphs in it goes now: a graph destroyed during the
        # capture (by a collection the capture's allocations start) would
        # free memory mid-capture, which the card refuses
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()          # so that the pool's growth shows
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(default_generator.device(dev))
        seeds = SeedSlots(drawn, dev)
        before = launch_counts()
        reserved = torch.cuda.memory_reserved(dev)
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with seeds.recording(), torch.cuda.graph(graph, stream=stream):
                out = self.fn(*self.inputs)
            torch.cuda.synchronize(dev)
        except Exception as e:
            _reset_generators(dev)
            raise CaptureError(f"capturing step {self.key!r} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            if collecting:
                gc.enable()
            self.rise = _restore_counts(before)
        if seeds.count != drawn:
            raise CaptureError(
                f"capturing step {self.key!r}: the capture took "
                f"{seeds.count} seeds, the uncaptured step drew {drawn}")
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.outputs, self.seeds = graph, out, seeds
        return first

    def __call__(self, *values):
        self._load(values)
        if self.graph is None:
            return self.fn(*self.inputs)
        if self.seeds.count:
            self.seeds.refill()
        self.graph.replay()
        _set_counts(self.rise, add=True)
        return self.outputs
