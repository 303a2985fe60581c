"""Resilience primitives — the port's copy of
``paddle_tpu/utils/resilience.py``: bounded retry with backoff
(:func:`retry`), deadlines (:class:`Deadline`) and one-shot fail points
(:func:`arm_fail_point`, :func:`fail_point`, :func:`clear_fail_points`).

The module is framework-neutral Python; the port keeps its own copy so
that it imports nothing of the reference.  Retries count in the port's
metrics registry (``resilience.retry``,
:mod:`paddle_tpu_torch.profiler.metrics`).

Cost contract: a successful call through :func:`retry` is one extra
``try`` frame — no metric lookups, no clock reads.  Everything else
happens only on the failure path.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["Deadline", "FailPointError", "retry", "fail_point",
           "arm_fail_point", "clear_fail_points"]


class Deadline:
    """A monotonic wall-clock budget.  ``Deadline(None)`` never expires."""

    __slots__ = ("_at",)

    def __init__(self, seconds: Optional[float]):
        self._at = None if seconds is None else time.monotonic() + seconds

    def remaining(self) -> Optional[float]:
        """Seconds left (clamped at 0), or None for an infinite budget."""
        if self._at is None:
            return None
        return max(0.0, self._at - time.monotonic())

    def expired(self) -> bool:
        return self._at is not None and time.monotonic() >= self._at

    def clamp(self, delay: float) -> float:
        """Shrink ``delay`` so a sleep never overshoots the budget."""
        rem = self.remaining()
        return delay if rem is None else min(delay, rem)

    def __repr__(self):
        rem = self.remaining()
        return f"Deadline(remaining={'inf' if rem is None else f'{rem:.3f}s'})"


def retry(*, retry_on: Tuple[Type[BaseException], ...] = (OSError,),
          max_tries: int = 5, base_delay: float = 0.05,
          max_delay: float = 2.0, multiplier: float = 2.0,
          jitter: float = 0.5, deadline: Optional[float] = None,
          classify: Optional[Callable[[BaseException], bool]] = None,
          on_retry: Optional[Callable[[BaseException, int], None]] = None,
          metric: str = "resilience.retry",
          sleep: Callable[[float], None] = time.sleep):
    """Decorator: retry ``fn`` on transient failure with exponential
    backoff + jitter, bounded by ``max_tries`` AND an optional per-call
    wall-clock ``deadline`` (seconds).

    ``classify(exc) -> bool`` refines ``retry_on``: return False to
    re-raise immediately (e.g. an ``ExecuteError`` whose exit code is
    not transient).  ``on_retry(exc, attempt)`` observes each retry.
    The final failing exception is always re-raised unmodified so
    callers keep their existing except clauses.
    """
    if max_tries < 1:
        raise ValueError("max_tries must be >= 1")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            dl = Deadline(deadline)
            attempt = 0
            while True:
                try:
                    return fn(*args, **kwargs)
                except retry_on as e:
                    if classify is not None and not classify(e):
                        raise
                    attempt += 1
                    if attempt >= max_tries or dl.expired():
                        raise
                    from ..profiler import metrics as _metrics
                    _metrics.counter(
                        metric, "transient-failure retries across the "
                        "framework (resilience.retry decorator)").inc()
                    if on_retry is not None:
                        on_retry(e, attempt)
                    delay = min(max_delay,
                                base_delay * (multiplier ** (attempt - 1)))
                    delay *= 1.0 + jitter * random.random()
                    sleep(dl.clamp(delay))
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# fail points: one-shot, test-armed failure injection for code paths the
# spec-driven chaos registry doesn't reach (e.g. "die between the rename
# and the COMMITTED marker").  Disarmed cost: one dict-truthiness read.
# ---------------------------------------------------------------------------
class FailPointError(RuntimeError):
    """Default exception raised by an armed fail point."""


_fail_points: dict = {}


def arm_fail_point(name: str, exc=FailPointError):
    """Arm ``name`` to raise once at its next :func:`fail_point` visit.
    ``exc`` is an exception class or instance."""
    _fail_points[name] = exc


def clear_fail_points():
    _fail_points.clear()


def fail_point(name: str):
    """Raise the armed exception for ``name`` (one-shot), else no-op."""
    if not _fail_points:
        return
    exc = _fail_points.pop(name, None)
    if exc is None:
        return
    raise exc(f"fail_point({name!r}) armed") if isinstance(exc, type) \
        else exc
