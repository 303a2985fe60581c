"""Device-memory accounting, OOM forensics, the compile ledger and
goodput — the port's copy of ``paddle_tpu/profiler/memscope.py``, on the
card's caching allocator.

The reference reads a census of live jax arrays; the port reads the CUDA
caching allocator, which sees every device allocation (tensors held only
by C++, a CUDA graph's private pool) where a walk of Python objects would
miss some and cost a pass over the whole heap:

- :func:`live_bytes` is ``torch.cuda.memory_allocated()``;
- :func:`device_stats` maps ``torch.cuda.memory_stats()`` onto the
  reference's keys (``bytes_in_use``, ``peak_bytes_in_use``,
  ``bytes_limit``, ``largest_alloc_size``, ``bytes_reserved``);
- :func:`peak_bytes` is ``torch.cuda.max_memory_allocated()``, whose
  watermark :func:`reset` resets, as the reference resets its own;
- :func:`census` counts the allocator's live blocks from
  ``torch.cuda.memory_snapshot()``.

On the CPU (or before CUDA is initialised) the device reads give
nothing, as the reference's do on its CPU backend; tags and
:func:`tree_nbytes` still count.

Four surfaces, all armed by ``FLAGS_mem_accounting`` (or :func:`enable`),
all one module-predicate read when off:

- **tagged attribution** — subsystems report what they hold
  (:func:`set_tag_bytes` for exactly-known footprints: the serving
  engines' ``params`` and ``kv_arena``; the :func:`tag` scope for delta
  attribution); the unattributed remainder is ``activations``.  Gauges
  ``mem.live_bytes.<tag>`` ride the metrics registry.
- **phase peak watermarks** — :func:`on_phase` samples the allocator at
  the serving-phase hooks and keeps per-phase maxima
  (``mem.peak_bytes.<phase>`` gauges).
- **compile ledger** — every executable made (on the card: a CUDA graph
  capture) is recorded with its cause (``new-site`` / ``new-bucket`` vs
  the nearest known signature / ``retrace`` / ``flag-change``) and wall
  time; mirrored as ``cat="compile"`` tracer spans and ``mem.compile``
  flight events.
- **OOM forensics and goodput** — :func:`oom_dump` turns an exhaustion
  (``torch.cuda.OutOfMemoryError``, a block-pool exhaustion) into an
  artifact: census, block-pool and prefix-cache occupancy and the flight
  ring, written to ``PADDLE_FLIGHT_DIR``; :class:`GoodputMeter` splits a
  run's wall time into productive step time and badput buckets.
"""
from __future__ import annotations

import contextlib
import difflib
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils import flags as _flags
from . import flight as _flight
from . import metrics as _metrics

__all__ = ["active", "enable", "disable", "configure",
           "live_bytes", "device_stats", "tree_nbytes",
           "set_tag_bytes", "add_tag_bytes", "tag", "tag_bytes",
           "on_phase", "peak_bytes", "phase_peaks", "census",
           "is_oom", "oom_dump", "pool_state", "prefix_cache_state",
           "compile_record", "compile_entries", "compile_count",
           "compile_seconds", "GoodputMeter", "reset"]

# module-level fast predicate — the single read every hook gates on
active = False

_lock = threading.RLock()
_tag_bytes: Dict[str, int] = {}
_phase_peaks: Dict[str, int] = {}
_peak = 0

# one forensics artifact per distinct seam per process — an OOM storm
# must not turn the flight dir into its own memory problem
_oom_dumped: set = set()

_compiles: List[Dict[str, Any]] = []
_site_sigs: Dict[str, List[str]] = {}
_site_flags_fp: Dict[str, str] = {}


def enable():
    global active
    active = True


def disable():
    global active
    active = False


def configure():
    """Arm from ``FLAGS_mem_accounting`` (flags-change observer —
    ``set_flags({"FLAGS_mem_accounting": 1})`` takes effect live)."""
    global active
    active = bool(_flags.get_flag("FLAGS_mem_accounting"))


def reset():
    """Drop tags, peaks, ledger and the OOM once-latch, and reset the
    allocator's peak watermark."""
    global _peak
    with _lock:
        _tag_bytes.clear()
        _phase_peaks.clear()
        _peak = 0
        _oom_dumped.clear()
        _compiles.clear()
        _site_sigs.clear()
        _site_flags_fp.clear()
    torch = _cuda()
    if torch is not None:
        torch.cuda.reset_peak_memory_stats()


# ---------------------------------------------------------------------------
# the allocator's reads
# ---------------------------------------------------------------------------

def _cuda():
    """``torch`` when the card's allocator has anything to say (CUDA
    initialised in this process), else None."""
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch
    except Exception:           # noqa: BLE001 — accounting never throws
        pass
    return None


def live_bytes() -> int:
    """Device bytes held by live allocations on the current card
    (``torch.cuda.memory_allocated``); 0 on the CPU.  Never raises."""
    torch = _cuda()
    if torch is None:
        return 0
    try:
        return int(torch.cuda.memory_allocated())
    except Exception:           # noqa: BLE001
        return 0


def _snapshot_blocks():
    """The current card's live allocator blocks' sizes (from
    ``torch.cuda.memory_snapshot``)."""
    torch = _cuda()
    if torch is None:
        return []
    dev = torch.cuda.current_device()
    return [int(b["size"]) for seg in torch.cuda.memory_snapshot()
            if seg.get("device", dev) == dev
            for b in seg.get("blocks", ())
            if b.get("state") == "active_allocated"]


def device_stats() -> Dict[str, int]:
    """The allocator's own statistics under the reference's keys; empty
    on the CPU."""
    torch = _cuda()
    if torch is None:
        return {}
    try:
        s = torch.cuda.memory_stats()
        blocks = _snapshot_blocks()
        return {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory),
            "largest_alloc_size": max(blocks) if blocks else 0,
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
        }
    except Exception:           # noqa: BLE001
        return {}


def tree_nbytes(tree) -> int:
    """Bytes across a tree of tensors (and numpy arrays): a tensor, or
    dicts, lists and tuples (named tuples too) of them."""
    try:
        if tree is None:
            return 0
        if hasattr(tree, "element_size") and hasattr(tree, "numel"):
            return int(tree.numel()) * int(tree.element_size())
        if isinstance(tree, dict):
            return sum(tree_nbytes(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(tree_nbytes(v) for v in tree)
        nb = getattr(tree, "nbytes", None)
        return int(nb) if isinstance(nb, (int,)) else 0
    except Exception:           # noqa: BLE001
        return 0


# ---------------------------------------------------------------------------
# tagged attribution
# ---------------------------------------------------------------------------

def _tag_gauge(name: str):
    return _metrics.gauge(
        f"mem.live_bytes.{name}",
        f"device bytes attributed to the '{name}' subsystem "
        "(memscope census attribution)")


def set_tag_bytes(name: str, nbytes) -> int:
    """Attribute an exactly-known footprint to ``name`` (replaces the
    previous value).  Callers gate on the module predicate."""
    nbytes = max(int(nbytes), 0)
    with _lock:
        _tag_bytes[name] = nbytes
    _tag_gauge(name).set(nbytes)
    return nbytes


def add_tag_bytes(name: str, delta) -> int:
    with _lock:
        cur = max(_tag_bytes.get(name, 0) + int(delta), 0)
        _tag_bytes[name] = cur
    _tag_gauge(name).set(cur)
    return cur


@contextlib.contextmanager
def tag(name: str):
    """Delta-attribution scope: device bytes that appear inside the
    scope and survive it are charged to ``name``::

        with memscope.tag("prefetch"):
            batches = [b.to("cuda") for b in window]
    """
    if not active:
        yield
        return
    before = live_bytes()
    try:
        yield
    finally:
        delta = live_bytes() - before
        if delta:
            add_tag_bytes(name, delta)


def tag_bytes() -> Dict[str, int]:
    """Current attribution including the ``activations`` residual
    (allocated bytes minus everything explicitly attributed)."""
    with _lock:
        out = dict(_tag_bytes)
    live = live_bytes()
    attributed = sum(v for k, v in out.items() if k != "activations")
    out["activations"] = max(live - attributed, out.get("activations", 0))
    return out


# ---------------------------------------------------------------------------
# phase peak watermarks
# ---------------------------------------------------------------------------

def on_phase(phase: str) -> int:
    """Sample the allocator at a step or serving phase boundary and keep
    the per-phase high-water mark (``mem.peak_bytes.<phase>``; a phase
    sampled only at 0 bytes, as on the CPU, keeps 0); callers gate on the
    module predicate.  Returns the sample."""
    cur = live_bytes()
    global _peak
    with _lock:
        if phase not in _phase_peaks or cur > _phase_peaks[phase]:
            _phase_peaks[phase] = cur
            _metrics.gauge(
                f"mem.peak_bytes.{phase}",
                f"peak device bytes observed at the '{phase}' phase "
                "boundary (memscope watermark)").set(cur)
        if cur > _peak:
            _peak = cur
    return cur


def peak_bytes() -> int:
    """Process high-water mark: the max over every phase sample, the
    allocator's own peak (``max_memory_allocated``) and its current
    bytes."""
    torch = _cuda()
    cur = live_bytes()
    if torch is not None:
        try:
            cur = max(cur, int(torch.cuda.max_memory_allocated()))
        except Exception:       # noqa: BLE001
            pass
    global _peak
    with _lock:
        if cur > _peak:
            _peak = cur
        return _peak


def phase_peaks() -> Dict[str, int]:
    with _lock:
        return dict(_phase_peaks)


def census() -> Dict[str, Any]:
    """The full accounting snapshot — what the forensics dump and
    ``/healthz`` compose from.  ``live_arrays`` counts the allocator's
    live blocks."""
    try:
        blocks = _snapshot_blocks()
        total, count = int(sum(blocks)), len(blocks)
    except Exception:           # noqa: BLE001
        total, count = 0, 0
    with _lock:
        tags = dict(_tag_bytes)
        peaks = dict(_phase_peaks)
        peak = _peak
    attributed = sum(v for k, v in tags.items() if k != "activations")
    tags["activations"] = max(total - attributed,
                              tags.get("activations", 0))
    return {"live_bytes_total": total, "live_arrays": count,
            "tags": tags, "device": device_stats(),
            "peak_bytes": max(peak, total), "phase_peaks": peaks}


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

def is_oom(exc) -> bool:
    """Is this a device-memory (or KV block-pool) exhaustion?  Matches
    ``torch.cuda.OutOfMemoryError``, ``BlockPoolExhausted`` and the
    reference's message patterns."""
    if exc is None:
        return False
    try:
        import torch
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:           # noqa: BLE001
        pass
    if type(exc).__name__ == "BlockPoolExhausted":
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg
            or "out of memory" in msg)


def pool_state(pool) -> Optional[Dict[str, int]]:
    """Block-pool occupancy for the forensics doc / ``/healthz``."""
    if pool is None:
        return None
    try:
        bb = int(getattr(pool, "block_bytes", 0))
        return {"num_blocks": int(pool.num_blocks),
                "block_size": int(pool.block_size),
                "block_bytes": bb,
                "used": int(pool.used),
                "available": int(pool.available),
                "arena_bytes": int(pool.num_blocks) * bb}
    except Exception:           # noqa: BLE001
        return None


def prefix_cache_state(pc) -> Optional[Dict[str, int]]:
    if pc is None:
        return None
    try:
        n = len(pc)
        bb = int(getattr(pc.pool, "block_bytes", 0))
        return {"entries": n,
                "capacity_blocks": int(pc.capacity_blocks),
                "bytes": n * bb}
    except Exception:           # noqa: BLE001
        return None


def oom_dump_path() -> Optional[str]:
    """``$PADDLE_FLIGHT_DIR/oom.r<rank>.g<gen>.json`` — next to the
    flight recorder's dumps, so one directory collects the whole
    post-mortem."""
    d = os.environ.get("PADDLE_FLIGHT_DIR")
    if not d:
        return None
    rank = os.environ.get("PADDLE_TRAINER_ID", "0")
    gen = os.environ.get("PADDLE_RESTART_GENERATION", "0")
    return os.path.join(d, f"oom.r{rank}.g{gen}.json")


def oom_dump(exc, context: str = "", pool=None, prefix_cache=None
             ) -> Optional[Dict[str, Any]]:
    """Turn an exhaustion into a diagnosable artifact: record a
    ``mem.oom`` flight event, then write census + pool/prefix-cache
    occupancy + the flight ring to :func:`oom_dump_path`.  One dump
    per distinct ``context`` per process (the flight event fires every
    time); never raises — forensics must not eat the original error.
    Callers re-raise / shed exactly as before."""
    try:
        err = f"{type(exc).__name__}: {exc}"
        if _flight.active:
            _flight.note("mem", "oom", context=context, error=err)
        with _lock:
            if context in _oom_dumped and \
                    not os.environ.get("PADDLE_OOM_DUMP_EVERY"):
                return None
            _oom_dumped.add(context)
        doc = {"reason": "oom", "context": context, "error": err,
               "dumped_at": time.time(),
               "census": census(),
               "pool": pool_state(pool),
               "prefix_cache": prefix_cache_state(prefix_cache),
               "flight": _flight.snapshot_doc(reason=f"oom:{context}")}
        target = oom_dump_path()
        if target:
            d = os.path.dirname(os.path.abspath(target))
            os.makedirs(d, exist_ok=True)
            tmp = target + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, target)
            doc["path"] = target
        return doc
    except Exception:           # noqa: BLE001 — never mask the OOM
        return None


# ---------------------------------------------------------------------------
# compile/retrace ledger
# ---------------------------------------------------------------------------

def _flags_fingerprint() -> str:
    try:
        vals = _flags.all_flags()
        blob = "|".join(f"{k}={vals[k]}" for k in sorted(vals))
        return hashlib.md5(blob.encode()).hexdigest()[:12]
    except Exception:           # noqa: BLE001
        return ""


def compile_record(site: str, signature, wall_s: float,
                   provenance: str = "jit",
                   cause: Optional[str] = None) -> Dict[str, Any]:
    """Record one compile (on the card: one CUDA graph capture) with its
    cause:

    - ``new-site``      first compile this site ever ran
    - ``new-bucket``    unseen shape signature; ``nearest`` names the
      closest known one so the diff is readable
    - ``retrace``       a signature this site already compiled —
      always a bug or a cache eviction, worth staring at
    - ``flag-change``   the flag set changed since the site's last
      compile (numerics/codegen flags force recompiles)

    ``provenance`` says how the executable was made (``jit``: the
    executable cache ran its maker).  Callers gate on the module
    predicate.  Mirrored as a ``cat="compile"`` tracer span and
    a ``mem.compile`` flight event for offline query."""
    sig = str(signature)
    fp = _flags_fingerprint()
    with _lock:
        sigs = _site_sigs.setdefault(site, [])
        prev_fp = _site_flags_fp.get(site)
        nearest = None
        if cause is None:
            if prev_fp is not None and prev_fp != fp:
                cause = "flag-change"
            elif sig in sigs:
                cause = "retrace"
            elif not sigs:
                cause = "new-site"
            else:
                cause = "new-bucket"
                nearest = max(sigs, key=lambda s: difflib.SequenceMatcher(
                    None, s, sig).ratio())
        if sig not in sigs:
            sigs.append(sig)
        _site_flags_fp[site] = fp
        entry = {"t": time.time(), "site": site,
                 "signature": sig[:240], "cause": cause,
                 "wall_ms": round(float(wall_s) * 1e3, 3),
                 "provenance": provenance}
        if nearest is not None:
            entry["nearest"] = nearest[:240]
        _compiles.append(entry)
    _metrics.counter(
        "mem.compiles", "compiles (graph captures) recorded by the "
        "memscope ledger (cause + provenance per entry)").inc()
    from . import tracer as _tracer
    if _tracer.active:
        end = _tracer.now_ns()
        _tracer.record(f"compile::{site}",
                       end - max(int(float(wall_s) * 1e9), 1), end,
                       cat="compile",
                       args={"cause": cause, "provenance": provenance,
                             "signature": sig[:120]})
    if _flight.active:
        _flight.note("mem", "compile", site=site, cause=cause,
                     provenance=provenance,
                     wall_ms=round(float(wall_s) * 1e3, 1))
    return entry


def compile_entries() -> List[Dict[str, Any]]:
    with _lock:
        return list(_compiles)


def compile_count() -> int:
    with _lock:
        return len(_compiles)


def compile_seconds(since_index: int = 0) -> float:
    """Ledger wall-seconds past ``since_index`` — the goodput meter's
    compile badput bucket."""
    with _lock:
        return sum(e["wall_ms"] for e in _compiles[since_index:]) / 1e3


# ---------------------------------------------------------------------------
# goodput accounting
# ---------------------------------------------------------------------------

def _goodput_doc_path() -> Optional[str]:
    d = os.environ.get("PADDLE_FLIGHT_DIR")
    if not d:
        return None
    rank = os.environ.get("PADDLE_TRAINER_ID", "0")
    gen = os.environ.get("PADDLE_RESTART_GENERATION", "0")
    return os.path.join(d, f"goodput.r{rank}.g{gen}.json")


class GoodputMeter:
    """Wall-clock decomposition of one run: productive step time vs
    badput buckets.

    The caller feeds measured intervals — :meth:`step_ns` for the step
    body, :meth:`add_ns` for badput (``data_wait`` / ``checkpoint`` /
    ``anomaly`` / ...); compiles come from the ledger automatically
    (they execute *inside* the first step dispatch, so
    :meth:`finish` carves them out of productive time).  Fractions are
    of total wall and sum to 1 by construction (``other`` is the
    residual: callbacks, metrics, logging, host bookkeeping)."""

    BUCKETS = ("data_wait", "checkpoint", "compile", "anomaly")

    def __init__(self, mode: str = "train"):
        self.mode = mode
        self._acc: Dict[str, int] = {}
        self._step_ns = 0
        self._t0: Optional[int] = None
        self._ledger0 = 0

    def start(self) -> "GoodputMeter":
        self._t0 = time.perf_counter_ns()
        self._ledger0 = compile_count()
        return self

    def add_ns(self, bucket: str, ns):
        self._acc[bucket] = self._acc.get(bucket, 0) + max(int(ns), 0)

    def add_s(self, bucket: str, s: float):
        self.add_ns(bucket, int(float(s) * 1e9))

    def step_ns(self, ns):
        self._step_ns += max(int(ns), 0)

    def finish(self, export: bool = True,
               extra: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
        total = max(time.perf_counter_ns() - (self._t0 or 0), 1)
        compile_ns = int(compile_seconds(self._ledger0) * 1e9)
        # compiles run inside the measured step dispatch — carve them
        # out so 'productive' means steps that actually trained
        productive = max(self._step_ns - compile_ns, 0)
        buckets = dict(self._acc)
        buckets["compile"] = buckets.get("compile", 0) + compile_ns
        used = productive + sum(buckets.values())
        if used > total:
            # nesting/rounding over-attribution: scale to the wall
            scale = total / used
            productive = int(productive * scale)
            buckets = {k: int(v * scale) for k, v in buckets.items()}
            used = productive + sum(buckets.values())
        other = total - used
        fr = {k: v / total for k, v in buckets.items()}
        fr["productive"] = productive / total
        fr["other"] = other / total
        doc = {"mode": self.mode,
               "total_s": round(total / 1e9, 6),
               "productive_s": round(productive / 1e9, 6),
               "buckets_s": {k: round(v / 1e9, 6)
                             for k, v in buckets.items()},
               "fractions": {k: round(v, 6) for k, v in fr.items()},
               "compiles": compile_count() - self._ledger0}
        if extra:
            doc.update(extra)
        if export:
            for k, v in doc["fractions"].items():
                _metrics.gauge(
                    f"{self.mode}.goodput.{k}",
                    f"fraction of fit wall-clock spent on '{k}' "
                    "(memscope goodput decomposition; fractions sum "
                    "to 1)").set(v)
            path = _goodput_doc_path()
            if path:
                try:
                    os.makedirs(os.path.dirname(os.path.abspath(path)),
                                exist_ok=True)
                    tmp = path + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(doc, f)
                    os.replace(tmp, path)
                    doc["path"] = path
                except Exception:   # noqa: BLE001 — telemetry never throws
                    pass
        return doc


_flags.on_change(configure)
configure()
