"""``paddle.profiler`` of the port: the metrics registry (:mod:`.metrics`)
and the flight recorder (:mod:`.flight`), the reference's
``paddle_tpu/profiler/{metrics,flight}.py``.  The reference's tracer,
memscope and request tracing are not ported yet (``ROADMAP.md`` §A item
9)."""
from . import flight, metrics

__all__ = ["flight", "metrics"]
