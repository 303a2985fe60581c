"""Per-request tracing for the serving stack — the port's copy of
``paddle_tpu/profiler/rtrace.py``.

The host tracer says where *process* time goes; this module says where
*one request's* time went, across the HTTP handler thread, admission,
the scheduler thread and its token boundaries shared with batchmates:

- :class:`TraceContext` — a W3C trace-context identity (128-bit
  ``trace_id``, 64-bit span ids, ``traceparent`` parsed from and echoed
  on HTTP requests) plus the request's ``X-Request-Id``; it rides the
  request object across every thread hop.
- spans — ``ingress`` (the server-side root) → ``admission`` (with the
  reject or shed reason on a terminated request) → ``queue_wait`` →
  ``prefill`` → one ``decode`` per token boundary → ``egress``, in the
  host tracer's ring (``cat="rtrace"``) with ``trace_id`` / ``span_id`` /
  ``parent_id`` in their args.
- fan-in — a batched step (one prefill, decode or verify over many
  slots) emits ONE ``batch::*`` span whose ``links`` name every member
  request's root span; each member's own span points back at it through
  ``batch_span``.

Cost contract: ``active`` is a module-level bool (armed by
``FLAGS_request_trace`` or :func:`enable`); every instrumented hop does
ONE predicate read when tracing is off.
"""
from __future__ import annotations

import os
import re
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence

from ..utils import flags as _flags
from . import tracer as _tracer

__all__ = ["active", "enable", "disable", "configure", "TraceContext",
           "new_trace_id", "new_span_id", "parse_traceparent",
           "record_span", "batch_span", "request_spans",
           "set_current", "current"]

# module-level fast predicate — the single read every hop gates on
active = False

_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# one stable trace identity for this process's engine-level (batch)
# spans: a batch step belongs to N client traces at once, so it gets
# its own id and *links* to the members instead of stealing one's
_process_trace_id: Optional[str] = None


def enable():
    global active
    active = True


def disable():
    global active
    active = False


def configure():
    """Arm from ``FLAGS_request_trace`` (flags-change observer —
    ``set_flags({"FLAGS_request_trace": 1})`` takes effect live)."""
    global active
    active = bool(_flags.get_flag("FLAGS_request_trace"))


# ambient per-thread context: while a hop is processing one request,
# its TraceContext is bound here so layers with no request in hand
# (the block pool, the flight recorder) can stamp events with the
# request identity.  Engine hops set/clear it gated on `active`.
_tls = threading.local()


def set_current(ctx: Optional["TraceContext"]):
    """Bind (or clear, with None) the thread's live request context."""
    _tls.ctx = ctx


def current() -> Optional["TraceContext"]:
    return getattr(_tls, "ctx", None)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]):
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent``
    header, or None when absent/malformed (malformed headers start a
    fresh trace rather than erroring the request — tracing must never
    cost availability)."""
    if not header:
        return None
    m = _TRACEPARENT.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, _flags_hex = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def record_span(trace_id: str, span_id: str, parent_id: Optional[str],
                name: str, start_ns: int, end_ns: Optional[int] = None,
                **fields) -> str:
    """Append one completed request-scoped span to the tracer ring.
    Returns ``span_id`` so callers can parent children to it."""
    if end_ns is None:
        end_ns = _tracer.now_ns()
    args: Dict[str, Any] = {"trace_id": trace_id, "span_id": span_id}
    if parent_id:
        args["parent_id"] = parent_id
    for k, v in fields.items():
        if v is not None:
            args[k] = v
    _tracer.record(name, start_ns, end_ns, cat="rtrace", args=args)
    return span_id


class TraceContext:
    """One request's trace identity, carried on the request object
    across the queue/batcher/engine thread hops.

    ``trace_id``/``parent_id`` come from the client's ``traceparent``
    when it sent one (so the server's spans join the caller's
    distributed trace); ``root`` is the server-side root span id — the
    ``ingress`` span — every other span of this request parents to.
    ``request_id`` is the ``X-Request-Id`` (client-sent or generated),
    attached to every span and flight-recorder event for the request.
    """

    __slots__ = ("trace_id", "parent_id", "root", "request_id",
                 "trace_flags")

    def __init__(self, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 request_id: Optional[str] = None,
                 trace_flags: str = "01"):
        self.trace_id = trace_id or new_trace_id()
        self.parent_id = parent_id
        self.root = new_span_id()
        self.request_id = request_id
        self.trace_flags = trace_flags

    @classmethod
    def from_headers(cls, traceparent: Optional[str] = None,
                     request_id: Optional[str] = None
                     ) -> "TraceContext":
        parsed = parse_traceparent(traceparent)
        if parsed is None:
            return cls(request_id=request_id)
        trace_id, parent_id = parsed
        return cls(trace_id=trace_id, parent_id=parent_id,
                   request_id=request_id)

    def traceparent(self) -> str:
        """The header to echo: same ``trace_id`` the client sent (or
        the fresh one), the server root as the span id."""
        return f"00-{self.trace_id}-{self.root}-{self.trace_flags}"

    def record(self, name: str, start_ns: int,
               end_ns: Optional[int] = None,
               parent: Optional[str] = "root",
               span_id: Optional[str] = None, **fields) -> str:
        """Record one span of this request.  ``parent="root"`` (the
        default) parents to the ingress root; ``parent=None`` uses the
        client's ``traceparent`` span (for the root span itself);
        anything else is an explicit span id."""
        pid = self.root if parent == "root" else \
            (self.parent_id if parent is None else parent)
        return record_span(
            self.trace_id, span_id or new_span_id(), pid, name,
            start_ns, end_ns, request_id=self.request_id, **fields)


def batch_span(name: str, start_ns: int, end_ns: int,
               members: Sequence[TraceContext], **fields) -> str:
    """ONE span for a batched engine step, linked to every member
    request's root span (fan-in causality: N requests, one unit of
    work).  The span lives on the process's own trace id — it belongs
    to all the member traces equally, so it links rather than adopts."""
    global _process_trace_id
    if _process_trace_id is None:
        _process_trace_id = new_trace_id()
    links = [{"trace_id": c.trace_id, "span_id": c.root}
             for c in members]
    return record_span(_process_trace_id, new_span_id(), None, name,
                       start_ns, end_ns, links=links,
                       members=len(links), **fields)


def request_spans(events: Optional[List[tuple]] = None,
                  trace_id: Optional[str] = None,
                  request_id: Optional[str] = None) -> List[dict]:
    """All buffered rtrace spans of one request (by trace or request
    id), oldest-start first."""
    if events is None:
        events = _tracer.events()
    out = []
    for nm, t0, t1, tid, cat, args in events:
        if cat != "rtrace" or not args:
            continue
        if trace_id is not None and args.get("trace_id") != trace_id:
            continue
        if request_id is not None and \
                args.get("request_id") != request_id:
            continue
        out.append({"name": nm, "start_ns": t0, "end_ns": t1,
                    **args})
    out.sort(key=lambda s: s["start_ns"])
    return out


_flags.on_change(configure)
configure()

# register with the flight recorder so flight.note can stamp events
# with the ambient request identity (late-bound attribute rather than
# an import: flight sits below rtrace in the import order)
from . import flight as _flight  # noqa: E402

_flight._rtrace = sys.modules[__name__]
