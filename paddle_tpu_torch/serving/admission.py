"""Admission control for the generation engines — the subset of
``paddle_tpu/serving/admission.py`` that the contiguous and paged engines
need.

Every request passes :meth:`AdmissionController.acquire` before it may
enter the engine queue:

- queue depth at ``max_queue`` -> :class:`RequestRejected` (``queue_full``);
- reserved tokens over the ``max_tokens`` budget ->
  :class:`RequestRejected` (``token_budget``);
- a request larger than the whole budget or the cache ->
  :class:`RequestRejected` (``too_large``);
- engine closed -> :class:`EngineClosed` (``reason == "closed"``).

A request whose deadline passes while it waits is shed with
:class:`DeadlineExceeded` (``reason == "deadline"``), one whose deadline
passes while it sits preempted to host memory with ``reason ==
"deadline_preempted"``; a paged engine sheds a request its block pool
cannot hold with ``RequestRejected(reason="kv_blocks")``.  Counts per
outcome are kept in :attr:`AdmissionController.counts`, and the
reference's counters ``<name>.request.shed_deadline_preempted`` and
``<name>.request.shed_kv_blocks`` in the metrics registry.

Requests carry a priority class (:data:`PRIORITIES`, best first); the
engines dequeue by class with bounded aging.  The reference's per-tenant
token buckets, its Retry-After estimate and its quota watcher are not
ported yet (``ROADMAP.md`` §A item 7).
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Optional

__all__ = ["RequestRejected", "DeadlineExceeded", "EngineClosed",
           "AdmissionController", "deadline_from_ms", "PRIORITIES",
           "priority_rank"]

# priority classes, best first; the rank (index) is what the engines
# order on: a lower rank dequeues first
PRIORITIES = ("interactive", "standard", "batch")
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


def priority_rank(priority: Optional[str]) -> int:
    """Rank of a priority class's name (0 = most urgent).  ``None`` means
    ``standard``; an unknown name raises ``ValueError``."""
    if priority is None:
        return _PRIORITY_RANK["standard"]
    try:
        return _PRIORITY_RANK[priority]
    except KeyError:
        raise ValueError(f"unknown priority {priority!r}; expected one of "
                         f"{list(PRIORITIES)}") from None


class RequestRejected(RuntimeError):
    """Explicit overload rejection; ``reason`` is one of ``queue_full``,
    ``token_budget``, ``too_large``, ``kv_blocks`` (the paged block pool
    could not supply the request's blocks, possibly injected through the
    ``kv.block_alloc`` chaos site), ``closed``."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before a result was produced.
    ``reason`` says where: ``deadline`` (queued, or the client's wait) or
    ``deadline_preempted`` (while preempted to host memory; the engine
    dropped the host state instead of resuming)."""

    def __init__(self, msg: str = "", reason: str = "deadline"):
        super().__init__(msg)
        self.reason = reason


class EngineClosed(RequestRejected):
    def __init__(self, msg: str = "engine is closed"):
        super().__init__(msg, reason="closed")


class AdmissionController:
    """Bounded queue plus token budget.  ``acquire``/``release`` bracket
    a request's time in the queue; ``release_tokens`` returns its token
    reservation when it leaves the engine."""

    def __init__(self, max_queue: int, max_tokens: Optional[int] = None,
                 name: str = "serving"):
        self.max_queue = int(max_queue)
        self.name = name
        self.max_tokens = int(max_tokens) if max_tokens else None
        self.counts: Counter = Counter()   # admitted, rejected.<reason>, …
        self._depth = 0
        self._tokens = 0
        self._closed = False
        self._lock = threading.Lock()

    def close(self):
        self._closed = True

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def tokens_in_flight(self) -> int:
        return self._tokens

    def reject(self, reason: str, msg: str):
        """Count the rejection and raise it (typed by ``reason``)."""
        with self._lock:
            self.counts[f"rejected.{reason}"] += 1
        if reason == "closed":
            raise EngineClosed(msg)
        raise RequestRejected(msg, reason=reason)

    def acquire(self, tokens: int = 0, tenant: Optional[str] = None):
        """Admit one request reserving ``tokens`` or raise
        :class:`RequestRejected`; ``tenant`` labels the per-tenant count
        ``<name>.tenant.<tenant>.admitted``."""
        if self._closed:
            self.reject("closed", "engine is closed")
        if self.max_tokens is not None and tokens > self.max_tokens:
            self.reject("too_large",
                        f"request reserves {tokens} tokens but the engine's "
                        f"whole token budget is {self.max_tokens}; shorten "
                        "the prompt or max_new_tokens")
        with self._lock:
            if self._depth >= self.max_queue:
                reason = "queue_full"
                msg = (f"engine queue is full ({self._depth}/"
                       f"{self.max_queue} waiting); retry with backoff")
            elif self.max_tokens is not None and \
                    self._tokens + tokens > self.max_tokens:
                reason = "token_budget"
                msg = (f"token budget exhausted ({self._tokens}+{tokens} "
                       f"over {self.max_tokens} reserved tokens in "
                       "flight); retry when running generations finish")
            else:
                self._depth += 1
                self._tokens += tokens
                self.counts["admitted"] += 1
                if tenant:
                    from ..profiler import metrics as _metrics
                    _metrics.counter(
                        f"{self.name}.tenant.{tenant}.admitted").inc()
                return
        self.reject(reason, msg)

    def release(self):
        """The request left the queue (taken into a slot or shed)."""
        with self._lock:
            self._depth = max(0, self._depth - 1)

    def release_tokens(self, tokens: int):
        """A request left the engine: return its reserved tokens."""
        with self._lock:
            self._tokens = max(0, self._tokens - int(tokens))

    def shed_deadline(self, preempted: bool = False):
        """A deadline expired before a result: while queued, or
        (``preempted``) while the request sat swapped out in host
        memory."""
        from ..profiler import flight as _flight
        with self._lock:
            self.counts["shed_deadline"] += 1
            if preempted:
                self.counts["shed_deadline_preempted"] += 1
        if preempted:
            from ..profiler import metrics as _metrics
            _metrics.counter(
                f"{self.name}.request.shed_deadline_preempted",
                "preempted-to-host requests dropped because their "
                "deadline expired while swapped out").inc()
            if _flight.active:
                _flight.note("admission", "deadline_preempted",
                             engine=self.name)
        elif _flight.active:
            _flight.note("admission", "shed_deadline", engine=self.name)

    def shed_kv_blocks(self):
        """A paged engine shed an admitted request on block-pool
        exhaustion (``RequestRejected(reason="kv_blocks")``)."""
        from ..profiler import metrics as _metrics
        with self._lock:
            self.counts["shed_kv_blocks"] += 1
        _metrics.counter(
            f"{self.name}.request.shed_kv_blocks", "admitted requests shed "
            "because the paged KV block pool could not supply blocks "
            "(incl. exhaustion injected via kv.block_alloc)").inc()
        from ..profiler import flight as _flight
        if _flight.active:
            _flight.note("admission", "shed_kv_blocks", engine=self.name)


def deadline_from_ms(deadline_ms: Optional[float]) -> Optional[float]:
    """Monotonic absolute deadline from a relative millisecond budget."""
    if deadline_ms is None:
        return None
    return time.monotonic() + float(deadline_ms) / 1e3
