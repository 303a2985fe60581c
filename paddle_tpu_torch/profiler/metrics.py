"""Metrics registry — the port's copy of ``paddle_tpu/profiler/metrics.py``:
counters, gauges and histograms with JSON and Prometheus-text export
(:func:`snapshot`, :func:`prometheus_text`, :func:`dump_json`).

Reference parity: ``platform/monitor.h:77`` (the STAT_* int registry the
reference exposes through ``stat_add``/``stat_get``) grown into a typed
registry.  Pure Python and allocation-light: a Counter.inc is one int
add under the GIL (no lock), a Histogram.observe is an int add plus a
ring-slot store.  The port's counters so far: ``ckpt.verify_fail``,
``ckpt.write_fail``, ``ckpt.quarantined``
(:mod:`paddle_tpu_torch.distributed.checkpoint`), ``chaos.injected`` and
``chaos.injected.<site>`` (:mod:`paddle_tpu_torch.utils.chaos`),
``resilience.retry`` and ``train.anomaly`` (``Model.fit``'s guard).
"""
from __future__ import annotations

import bisect
import json
import re
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "counter", "gauge",
           "histogram", "get", "snapshot", "prometheus_text", "reset",
           "dump_json"]


class Counter:
    """Monotonically increasing integer (resettable for test windows)."""

    __slots__ = ("name", "doc", "_v")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._v = 0

    def inc(self, n: int = 1):
        self._v += n

    @property
    def value(self) -> int:
        return self._v

    def reset(self):
        self._v = 0

    def snapshot(self):
        return self._v


class Gauge:
    """Last-set value (queue depth, ips, ...)."""

    __slots__ = ("name", "doc", "_v")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._v = 0.0

    def set(self, v: float):
        self._v = v

    def inc(self, n: float = 1.0):
        self._v += n

    def dec(self, n: float = 1.0):
        self._v -= n

    @property
    def value(self) -> float:
        return self._v

    def reset(self):
        self._v = 0.0

    def snapshot(self):
        return self._v


# default Prometheus bucket bounds: a 1-2.5-5 ladder wide enough for
# the registry's mixed units (most histograms are milliseconds; the
# occupancy/fill ratios land in the low buckets).  Cumulative counts
# over these feed the `_bucket{le=...}` exposition series.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    """count/sum/min/max plus percentile estimates over a bounded
    reservoir of the most recent observations (so a long-running
    trainer's p50/p95 track current behavior, not the whole epoch
    history), and exact per-bucket counts over the full history for
    Prometheus ``_bucket{le=...}`` exposition."""

    __slots__ = ("name", "doc", "_count", "_sum", "_min", "_max",
                 "_ring", "_cap", "_i", "_bounds", "_bcounts")

    def __init__(self, name: str, doc: str = "", reservoir: int = 4096,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.doc = doc
        self._cap = reservoir
        self._bounds = tuple(sorted(buckets)) if buckets \
            else DEFAULT_BUCKETS
        self.reset()

    def reset(self):
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._ring = []
        self._i = 0
        self._bcounts = [0] * len(self._bounds)

    def observe(self, v: float):
        self._count += 1
        self._sum += v
        if self._min is None or v < self._min:
            self._min = v
        if self._max is None or v > self._max:
            self._max = v
        # le semantics: the observation counts in the first bucket
        # whose bound is >= v (observations past the top bound land
        # only in +Inf, i.e. _count)
        i = bisect.bisect_left(self._bounds, v)
        if i < len(self._bcounts):
            self._bcounts[i] += 1
        if len(self._ring) < self._cap:
            self._ring.append(v)
        else:
            self._ring[self._i] = v
            self._i = (self._i + 1) % self._cap

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> List[Tuple[str, int]]:
        """Cumulative ``[(le_label, count)]`` ending with ``+Inf`` ==
        total count — the Prometheus histogram contract."""
        out: List[Tuple[str, int]] = []
        cum = 0
        for bound, n in zip(self._bounds, self._bcounts):
            cum += n
            out.append((format(bound, "g"), cum))
        out.append(("+Inf", self._count))
        return out

    def percentile(self, p: float) -> Optional[float]:
        if not self._ring:
            return None
        vals = sorted(self._ring)
        idx = min(len(vals) - 1, max(0, int(round(p / 100.0
                                                  * (len(vals) - 1)))))
        return vals[idx]

    def snapshot(self):
        if not self._count:
            return {"count": 0}
        return {
            "count": self._count,
            "sum": self._sum,
            "avg": self._sum / self._count,
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


class Registry:
    """Name -> metric, get-or-create; one process-wide default below."""

    def __init__(self):
        # RLock, as the reference's: its lock sanitizer records its own
        # observations through this registry, re-entering get-or-create
        self._lock = threading.RLock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name, doc, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, doc, **kw)
                self._metrics[name] = m
            return m

    def counter(self, name: str, doc: str = "") -> Counter:
        return self._get_or_create(Counter, name, doc)

    def gauge(self, name: str, doc: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, doc)

    def histogram(self, name: str, doc: str = "",
                  reservoir: int = 4096,
                  buckets: Optional[Tuple[float, ...]] = None
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, doc,
                                   reservoir=reservoir, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, object]:
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4):
        counters/gauges as-is; histograms as histogram-typed
        ``_bucket{le=...}`` cumulative series + ``_sum``/``_count``.
        Bare ``{quantile=...}`` samples are NOT legal inside a
        histogram-typed family (conformant parsers drop the whole
        family), so the reservoir estimates stay out of the exposition
        — dashboards get quantiles via ``histogram_quantile()`` over
        the buckets, or exactly via :meth:`snapshot`."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            pname = _PROM_BAD.sub("_", name)
            if m.doc:
                lines.append(f"# HELP {pname} {m.doc}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pname} histogram")
                for le, cum in m.bucket_counts():
                    lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{pname}_sum {m.sum}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        """Zero every metric (metrics stay registered)."""
        for m in list(self._metrics.values()):
            m.reset()

    def clear(self):
        with self._lock:
            self._metrics.clear()


_DEFAULT = Registry()


def counter(name: str, doc: str = "") -> Counter:
    return _DEFAULT.counter(name, doc)


def gauge(name: str, doc: str = "") -> Gauge:
    return _DEFAULT.gauge(name, doc)


def histogram(name: str, doc: str = "", reservoir: int = 4096,
              buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
    return _DEFAULT.histogram(name, doc, reservoir=reservoir,
                              buckets=buckets)


def get(name: str):
    return _DEFAULT.get(name)


def snapshot() -> Dict[str, object]:
    """Flat {metric name: value-or-stats} view of the default registry."""
    return _DEFAULT.snapshot()


def prometheus_text() -> str:
    return _DEFAULT.to_prometheus()


def reset():
    _DEFAULT.reset()


def dump_json(path: Optional[str] = None) -> str:
    """Serialize the snapshot as JSON; write to ``path`` when given."""
    text = json.dumps(snapshot(), indent=2, sort_keys=True, default=float)
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
