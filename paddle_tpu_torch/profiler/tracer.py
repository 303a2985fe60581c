"""Host-span tracer with chrome://tracing export — the port's copy of
``paddle_tpu/profiler/tracer.py``.

Pure Python and always available, so every layer can be instrumented
unconditionally.  Device-side traces are ``torch.profiler``'s job; the
file this module exports loads into the same Perfetto UI beside them.

Hot-path contract: ``active`` is a module-level bool.  Instrumented code
does ONE predicate read when tracing is off::

    if tracer.active:
        t0 = tracer.now_ns()
    ...
    if tracer.active:
        tracer.on_serving_phase(name, t0)

Spans live in a bounded ring buffer (``FLAGS_host_tracer_capacity``);
beyond capacity the oldest spans drop, so an unbounded run cannot run
the host out of memory through its own profiler.  The port's sites so
far: the generation session's ``serve::<name>.prefill`` /
``serve::<name>.decode`` phases, the request spans of
:mod:`~paddle_tpu_torch.profiler.rtrace` (``cat="rtrace"``), the
compile ledger's ``compile::<site>`` spans
(:mod:`~paddle_tpu_torch.profiler.memscope`), ``Model.fit``'s and
``evaluate``'s step phases and steps (``cat="hapi"``), the loaders'
``io::batch_wait`` (``cat="dataloader"``) and the eager core's dispatch
(``op::<name>``, ``cat="dispatch"``, with the ``dispatch.count`` /
``dispatch.op.<name>`` / ``dispatch.time_ns`` metrics;
``core/dispatch.py``), which :func:`eager_phase_profile` tables.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils import concurrency as _conc
from ..utils import flags as _flags
from . import metrics as _metrics

__all__ = ["active", "enable", "disable", "is_enabled", "clear", "events",
           "drain", "record", "now_ns", "chrome_trace_dict",
           "export_chrome_tracing", "summarize", "op_table",
           "op_phase", "phase_shares", "OP_PHASES"]

# module-level fast predicate — the single check hot paths gate on
active = False

_lock = _conc.Lock(name="profiler.tracer", lazy=True)
_events: collections.deque = collections.deque(maxlen=1 << 20)

# event tuple layout: (name, start_ns, end_ns, tid, cat, args)
_Event = Tuple[str, int, int, int, str, Optional[dict]]

now_ns = time.perf_counter_ns


def enable(capacity: Optional[int] = None):
    """Start collecting host spans (ring capacity from the flag unless
    given).  Re-enabling with a new capacity preserves buffered spans."""
    global active, _events
    cap = int(capacity or _flags.get_flag("FLAGS_host_tracer_capacity"))
    with _lock:
        if _events.maxlen != cap:
            _events = collections.deque(_events, maxlen=cap)
        active = True


def disable():
    global active
    active = False


def is_enabled() -> bool:
    return active


def clear():
    _events.clear()


def events() -> List[_Event]:
    return list(_events)


def drain() -> List[_Event]:
    """Snapshot and empty the buffer (one profiler record window)."""
    with _lock:
        evs = list(_events)
        _events.clear()
    return evs


def record(name: str, start_ns: int, end_ns: int, tid: Optional[int] = None,
           cat: str = "host", args: Optional[dict] = None):
    """Append one completed span.  Timestamps are ``now_ns()`` values."""
    _events.append((name, start_ns, end_ns,
                    tid if tid is not None
                    else threading.get_ident() % (1 << 31), cat, args))


# ---------------------------------------------------------------------------
# instrumentation hooks — called by framework hot paths AFTER checking
# ``active``, so each one may allocate freely
# ---------------------------------------------------------------------------

def on_dispatch(op_name: str, start_ns: int):
    """One eager op went through core.dispatch."""
    end_ns = time.perf_counter_ns()
    record("op::" + op_name, start_ns, end_ns, cat="dispatch")
    _metrics.counter("dispatch.count").inc()
    _metrics.counter("dispatch.op." + op_name).inc()
    _metrics.counter("dispatch.time_ns").inc(end_ns - start_ns)


def on_cache_event(kind: str):
    """Eager jit/vjp cache outcome: 'hit' | 'miss' | 'uncacheable'."""
    _metrics.counter("dispatch.jit_cache." + kind).inc()


def on_trace_time(ns: int):
    """Time spent re-tracing — what the cache saves."""
    _metrics.counter("dispatch.trace_time_ns").inc(ns)


def on_collective(name: str, start_ns: int, nbytes: int, world: int = 0):
    end_ns = time.perf_counter_ns()
    args: Dict[str, Any] = {"bytes": nbytes}
    if world:
        args["world"] = world
    record("cc::" + name, start_ns, end_ns, cat="collective", args=args)
    _metrics.counter(f"collective.{name}.count").inc()
    _metrics.counter(f"collective.{name}.bytes").inc(nbytes)


def on_data_wait(start_ns: int, depth: Optional[int] = None):
    """Consumer-side wait for the next DataLoader batch."""
    end_ns = time.perf_counter_ns()
    record("io::batch_wait", start_ns, end_ns, cat="dataloader")
    _metrics.counter("dataloader.batches").inc()
    _metrics.histogram("dataloader.batch_wait_ms").observe(
        (end_ns - start_ns) / 1e6)
    if depth is not None:
        _metrics.gauge("dataloader.queue_depth").set(depth)


def on_queue_depth(name: str, depth: int):
    _metrics.gauge(name + ".queue_depth").set(depth)


def on_step_phase(phase: str, start_ns: int, end_ns: Optional[int] = None,
                  mode: str = "train") -> int:
    """One phase of a hapi train-loop step: ``data_wait`` (blocked on
    the input pipeline for the next batch), ``device`` (inside the
    jitted-step dispatch call — in a steady sync-free loop the device
    backpressure surfaces here), ``host`` (everything else: state
    plumbing, callbacks, bookkeeping).  Histograms + total-ns counters
    let the bench compute data_wait_frac / host_frac / device_frac and
    attribute a utilization win instead of asserting it.  Returns the
    span duration in ns."""
    if end_ns is None:
        end_ns = time.perf_counter_ns()
    record(f"step::{phase}", start_ns, end_ns, cat="hapi")
    dt = end_ns - start_ns
    _metrics.histogram(f"{mode}.step.{phase}_ms").observe(dt / 1e6)
    _metrics.counter(f"{mode}.step.{phase}_ns").inc(dt)
    # memscope peak watermark rides the phase boundary (one predicate
    # read when memory accounting is off)
    from . import memscope as _memscope
    if _memscope.active:
        _memscope.on_phase(phase)
    return dt


def on_step_host(dt_ns: int, mode: str = "train"):
    """Host-side remainder of one loop step (body minus the dispatch
    'device' phase).  Not a contiguous span — metrics only; the full
    body span is already recorded by :func:`on_hapi_step`."""
    _metrics.histogram(f"{mode}.step.host_ms").observe(dt_ns / 1e6)
    _metrics.counter(f"{mode}.step.host_ns").inc(dt_ns)


def on_serving_phase(name: str, start_ns: int,
                     end_ns: Optional[int] = None) -> int:
    """One serving-side generation phase span — ``<prefix>.prefill``
    (prompt ingestion filling the KV-cache) or ``<prefix>.decode`` (one
    token across the in-flight batch).  The chrome-trace view then
    shows the prefill stalls a continuous batcher injects between
    decode steps, which is the thing to stare at when time-to-first-
    token and inter-token latency fight each other.  Latency histograms
    for the same phases live in the metrics registry (the session owns
    those; this is the tracer span only).  Returns the span ns."""
    if end_ns is None:
        end_ns = time.perf_counter_ns()
    record(f"serve::{name}", start_ns, end_ns, cat="serving")
    from . import memscope as _memscope
    if _memscope.active:
        _memscope.on_phase(name)
    return end_ns - start_ns


def on_hapi_step(start_ns: int, num_samples: int = 0, mode: str = "train"):
    """One hapi Model loop step (latency is host wall time; with the
    lazy-loss pipeline this is enqueue latency, not device step time)."""
    end_ns = time.perf_counter_ns()
    record(f"hapi::{mode}_step", start_ns, end_ns, cat="hapi")
    dt_ns = end_ns - start_ns
    _metrics.histogram(f"hapi.{mode}_step_latency_ms").observe(dt_ns / 1e6)
    if num_samples:
        _metrics.counter(f"hapi.{mode}_samples").inc(num_samples)
        if dt_ns > 0:
            _metrics.gauge(f"hapi.{mode}_ips").set(
                num_samples / (dt_ns / 1e9))


# ---------------------------------------------------------------------------
# export / aggregation
# ---------------------------------------------------------------------------

def chrome_trace_dict(evs: Optional[List[_Event]] = None) -> dict:
    """chrome://tracing document ('X' complete events; ts/dur in us).
    Overlapping spans on one tid render nested in Perfetto/chrome."""
    if evs is None:
        evs = events()
    pid = os.getpid()
    tevs = []
    for name, t0, t1, tid, cat, args in evs:
        e = {"name": name, "cat": cat or "host", "ph": "X",
             "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
             "pid": pid, "tid": tid}
        if args:
            e["args"] = dict(args)
        tevs.append(e)
    return {"traceEvents": tevs, "displayTimeUnit": "ms"}


def export_chrome_tracing(path: str,
                          evs: Optional[List[_Event]] = None) -> str:
    """Write the buffered (or given) spans as a chrome-trace JSON
    file."""
    doc = chrome_trace_dict(evs)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def summarize(evs: Optional[List[_Event]] = None) -> Dict[str, dict]:
    """Aggregate spans by name: calls, total/avg/max/min ns."""
    if evs is None:
        evs = events()
    out: Dict[str, dict] = {}
    for name, t0, t1, _tid, _cat, _args in evs:
        dur = t1 - t0
        s = out.get(name)
        if s is None:
            out[name] = {"calls": 1, "total_ns": dur,
                         "max_ns": dur, "min_ns": dur}
        else:
            s["calls"] += 1
            s["total_ns"] += dur
            if dur > s["max_ns"]:
                s["max_ns"] = dur
            if dur < s["min_ns"]:
                s["min_ns"] = dur
    for s in out.values():
        s["avg_ns"] = s["total_ns"] / s["calls"]
    return out


# ---------------------------------------------------------------------------
# op-level aggregation over ``op::`` spans (the eager dispatch core's)
# ---------------------------------------------------------------------------

# op-name prefix -> phase class, first match wins.  "conv" covers the
# fused conv-block ops too (fused_conv_bn_relu spans conv+bn+act in one
# op — it IS the conv phase after fusion).
OP_PHASES = (
    ("conv", ("conv", "fused_conv", "fused_bn_")),
    ("optimizer", ("optimizer", "sgd", "momentum", "adam", "lamb",
                   "fused_update")),
    ("norm", ("batch_norm", "layer_norm", "instance_norm", "group_norm",
              "rms_norm", "sync_batch_norm")),
    ("matmul", ("linear", "matmul", "mm", "bmm", "addmm", "einsum")),
    ("pool", ("max_pool", "avg_pool", "adaptive_", "max_unpool")),
    ("loss", ("cross_entropy", "softmax_with_cross_entropy", "mse",
              "nll", "bce", "kl_div")),
)


def eager_phase_profile(model, opt, x, y, p0, steps: int = 2):
    """The reference's per-op phase breakdown of eager train steps
    (``paddle_tpu/profiler/tracer.py:290``): ``steps`` instrumented eager
    ``Model`` steps (``_train_batch_eager(update=False)``, then
    ``opt.step()`` and ``opt.clear_grad()``), read from the eager core's
    ``op::`` spans, with the optimizer's wall time folded in as its own
    synthetic bucket.  One step runs first outside the window, so it
    attributes no first-call costs.  ``p0`` is a parameter the step
    updates: the card is synchronised on it after each step.  Returns
    ``(op_table, phase_shares, wall_s)``; the tracer's state is restored
    on exit."""
    import torch

    def _sync():
        t = getattr(p0, "_data", p0)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)

    model._train_batch_eager([x], [y], update=False)
    opt.step()
    opt.clear_grad()
    _sync()
    was = active
    enable()
    clear()
    opt_ns = 0
    t_all = time.perf_counter()
    try:
        for _ in range(steps):
            model._train_batch_eager([x], [y], update=False)
            t0 = time.perf_counter_ns()
            opt.step()
            opt.clear_grad()
            _sync()
            opt_ns += time.perf_counter_ns() - t0
        wall = time.perf_counter() - t_all
        table = op_table()
        return table, phase_shares(table, extra_ns={"optimizer": opt_ns}), \
            wall
    finally:
        clear()
        if not was:
            disable()


def op_phase(op_name: str) -> str:
    """Phase class of one dispatched op name ('conv', 'norm',
    'matmul', 'pool', 'optimizer', 'loss', or 'elementwise')."""
    for phase, prefixes in OP_PHASES:
        for p in prefixes:
            if op_name.startswith(p):
                return phase
    return "elementwise"


def op_table(evs: Optional[List[_Event]] = None) -> Dict[str, dict]:
    """``summarize()`` restricted to dispatched ops (``op::`` spans),
    keyed by bare op name, each row carrying its phase class."""
    out = {}
    for name, s in summarize(evs).items():
        if not name.startswith("op::"):
            continue
        op = name[len("op::"):]
        row = dict(s)
        row["phase"] = op_phase(op)
        out[op] = row
    return out


def phase_shares(table: Optional[Dict[str, dict]] = None,
                 extra_ns: Optional[Dict[str, int]] = None
                 ) -> Dict[str, dict]:
    """Fraction of total dispatched-op host time per phase class.

    ``extra_ns`` adds phases measured outside the dispatch layer (e.g.
    an ``optimizer`` wall-time bucket when the optimizer runs through
    one fused jit call rather than per-op dispatch).  Returns
    ``{phase: {"time_frac", "total_ns", "calls"}}`` sorted by share;
    purely-synthetic buckets (extra_ns with no dispatched ops) carry
    ``calls=None`` — a dispatch count would be a lie for them.
    """
    table = op_table() if table is None else table
    agg: Dict[str, dict] = {}
    for op, row in table.items():
        a = agg.setdefault(row["phase"], {"total_ns": 0, "calls": 0})
        a["total_ns"] += row["total_ns"]
        a["calls"] += row["calls"]
    for phase, ns in (extra_ns or {}).items():
        a = agg.setdefault(phase, {"total_ns": 0, "calls": None})
        a["total_ns"] += int(ns)
    total = sum(a["total_ns"] for a in agg.values()) or 1
    for a in agg.values():
        a["time_frac"] = a["total_ns"] / total
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]["total_ns"]))
