"""Admission control for the generation engine — the subset of
``paddle_tpu/serving/admission.py`` that the contiguous engine needs.

Every request passes :meth:`AdmissionController.acquire` before it may
enter the engine queue:

- queue depth at ``max_queue`` -> :class:`RequestRejected` (``queue_full``);
- reserved tokens over the ``max_tokens`` budget ->
  :class:`RequestRejected` (``token_budget``);
- a request larger than the whole budget or the cache ->
  :class:`RequestRejected` (``too_large``);
- engine closed -> :class:`EngineClosed` (``reason == "closed"``).

A request whose deadline passes while it waits is shed with
:class:`DeadlineExceeded`.  Counts per outcome are kept in
:attr:`AdmissionController.counts`.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Optional

__all__ = ["RequestRejected", "DeadlineExceeded", "EngineClosed",
           "AdmissionController", "deadline_from_ms"]


class RequestRejected(RuntimeError):
    """Explicit overload rejection; ``reason`` is one of ``queue_full``,
    ``token_budget``, ``too_large``, ``closed``."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before a result was produced."""

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

    def __init__(self, max_queue: int, max_tokens: Optional[int] = None):
        self.max_queue = int(max_queue)
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

    def acquire(self, tokens: int = 0):
        """Admit one request reserving ``tokens`` or raise
        :class:`RequestRejected`."""
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

    def shed_deadline(self):
        with self._lock:
            self.counts["shed_deadline"] += 1


def deadline_from_ms(deadline_ms: Optional[float]) -> Optional[float]:
    """Monotonic absolute deadline from a relative millisecond budget."""
    if deadline_ms is None:
        return None
    return time.monotonic() + float(deadline_ms) / 1e3
