"""``paddle.profiler`` of the port: the metrics registry (:mod:`.metrics`),
the flight recorder (:mod:`.flight`), the host-span tracer
(:mod:`.tracer`), per-request tracing (:mod:`.rtrace`) and device-memory
accounting (:mod:`.memscope`), the reference's
``paddle_tpu/profiler/{metrics,flight,tracer,rtrace,memscope}.py``.  The
reference's ``Profiler``, ``RecordEvent``, ``make_scheduler`` and the
legacy ``start_profiler`` / ``stop_profiler`` are not ported yet
(``ROADMAP.md`` §A item 9)."""
from . import flight, memscope, metrics, rtrace, tracer

__all__ = ["flight", "memscope", "metrics", "rtrace", "tracer"]
