"""Always-on flight recorder — the port's copy of
``paddle_tpu/profiler/flight.py``: a lock-free bounded ring of the last
structured events this process recorded, dumped as JSON on demand
(:func:`dump`), on a crash (:func:`install_crash_dump`) or from a signal
handler (:func:`dump_on_signal`).

The port's sites so far: ``chaos`` (every fired fault injection:
site, kind, call number), ``ckpt`` (checkpoint commits and failed
asynchronous writes) and ``train`` (the anomaly guard's trips in
``Model.fit``).  The reference's request tracing (rtrace), which stamps
events with a request id, is not ported yet (``ROADMAP.md`` §A item 9):
``_rtrace`` stays None.

Cost contract: recording is one GIL-atomic ``deque.append`` of a small
tuple — no locks, safe from signal handlers; a disabled recorder
(``FLAGS_flight_recorder=0``, the port's flag registry) costs each site
one module-level predicate read::

    if flight.active:
        flight.note("ckpt", "commit", step=3, path="3")

Dump destination: ``PADDLE_FLIGHT_DIR`` receives
``flight.r<rank>.g<generation>.json``; with no directory configured
:func:`dump` returns the document without touching the filesystem.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from ..utils import flags as _flags

__all__ = ["active", "note", "events", "counts", "clear", "dump",
           "dump_on_signal", "default_dump_path", "install_crash_dump",
           "configure"]

# module-level fast predicate — the single read every site gates on
active = True

# the request-tracing module, late-bound by it at import; lets note()
# stamp events with the ambient request identity when tracing is live
_rtrace = None

# ring of (t_unix, category, event, fields-or-None); deque.append and
# the maxlen-driven eviction are single bytecode ops under the GIL, so
# concurrent writers (scheduler, workers, signal handlers, the lock
# sanitizer's callbacks) need no lock and can never deadlock the
# recorder
_ring: collections.deque = collections.deque(maxlen=2048)


def configure():
    """(Re)read the flags.  Re-arming with a new capacity preserves the
    newest events; registered as a flags-change observer so
    ``set_flags`` takes effect immediately."""
    global active, _ring
    cap = int(_flags.get_flag("FLAGS_flight_recorder_capacity"))
    if _ring.maxlen != cap:
        _ring = collections.deque(_ring, maxlen=max(1, cap))
    active = bool(_flags.get_flag("FLAGS_flight_recorder"))


def note(cat: str, event: str, **fields):
    """Record one structured event.  Callers gate on the module
    predicate (``if flight.active:``) so a disabled recorder costs one
    read; the fields dict should hold only small scalars/strings —
    this is a black box, not a log stream.

    When request tracing is live and the calling thread is inside a
    request hop (rtrace ambient context), the event is stamped with
    that request's id so ``tools/trace_summary.py --request`` can fold
    flight tails into the rtrace waterfall."""
    rt = _rtrace
    if rt is not None and rt.active and "request_id" not in fields:
        ctx = rt.current()
        if ctx is not None and ctx.request_id:
            fields["request_id"] = ctx.request_id
    _ring.append((time.time(), cat, event, fields or None))


def events(n: Optional[int] = None) -> List[tuple]:
    """Snapshot of the newest ``n`` (default: all buffered) events,
    oldest first."""
    evs = list(_ring)
    return evs if n is None else evs[-int(n):]


def counts() -> Dict[str, int]:
    """``{"cat.event": occurrences}`` over the buffered window — what
    the CI gate asserts exact numbers against."""
    out: Dict[str, int] = {}
    for _t, cat, event, _f in list(_ring):
        k = f"{cat}.{event}"
        out[k] = out.get(k, 0) + 1
    return out


def clear():
    _ring.clear()


def default_dump_path() -> Optional[str]:
    """``$PADDLE_FLIGHT_DIR/flight.r<rank>.g<gen>.json`` when the dir
    is configured, else None.  Rank/generation come from the launcher
    env contract so one directory collects the whole gang's dumps."""
    d = os.environ.get("PADDLE_FLIGHT_DIR")
    if not d:
        return None
    rank = os.environ.get("PADDLE_TRAINER_ID", "0")
    gen = os.environ.get("PADDLE_RESTART_GENERATION", "0")
    return os.path.join(d, f"flight.r{rank}.g{gen}.json")


def snapshot_doc(reason: str = "") -> Dict[str, Any]:
    """The dump document: identity + the buffered event tail."""
    return {
        "pid": os.getpid(),
        "rank": os.environ.get("PADDLE_TRAINER_ID"),
        "generation": os.environ.get("PADDLE_RESTART_GENERATION"),
        "reason": reason,
        "dumped_at": time.time(),
        "counts": counts(),
        "events": [
            {"t": t, "cat": cat, "event": event,
             **({"fields": f} if f else {})}
            for t, cat, event, f in list(_ring)],
    }


def dump(path: Optional[str] = None, reason: str = ""
         ) -> Dict[str, Any]:
    """Serialize the ring.  ``path`` (or :func:`default_dump_path`)
    receives the JSON; with neither configured the document is only
    returned.  Never raises — a post-mortem dump that throws would eat
    the original failure."""
    doc = snapshot_doc(reason)
    target = path or default_dump_path()
    if target:
        try:
            d = os.path.dirname(os.path.abspath(target))
            os.makedirs(d, exist_ok=True)
            tmp = target + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, target)
            doc["path"] = target
        except Exception:       # noqa: BLE001 — dumps must never throw
            pass
    return doc


def dump_on_signal(file=None, tail: int = 30):
    """SIGUSR1 path (``concurrency.install_signal_dump`` calls in
    after the thread dump): print the event tail to ``file`` (default
    stderr) so the worker's log ends with its history, and write the
    JSON dump when ``PADDLE_FLIGHT_DIR`` is configured.  Only reads +
    appends to an open stream — safe enough for a signal handler."""
    file = file or sys.stderr
    try:
        evs = events(tail)
        print(f"== flight recorder ({len(_ring)} buffered, "
              f"last {len(evs)}) ==", file=file)
        for t, cat, event, f in evs:
            extra = f" {f}" if f else ""
            print(f"  {t:.3f} {cat}.{event}{extra}", file=file)
        file.flush()
    except Exception:           # noqa: BLE001
        pass
    dump(reason="signal")


_hook_installed = {"done": False}


def install_crash_dump():
    """Chain ``sys.excepthook`` so an uncaught exception writes the
    flight dump (reason="crash") before the traceback prints.
    Idempotent; the original hook always runs."""
    if _hook_installed["done"]:
        return
    _hook_installed["done"] = True
    prev = sys.excepthook

    def _hook(etype, value, tb):
        try:
            if active:
                note("process", "crash", error=f"{etype.__name__}: "
                     f"{value}")
            dump(reason="crash")
        except Exception:       # noqa: BLE001
            pass
        prev(etype, value, tb)

    sys.excepthook = _hook


_flags.on_change(configure)
configure()

# supervised / flight-dir processes get the crash hook at import so a
# worker that dies before any subsystem touches the recorder still
# leaves its history behind
if os.environ.get("PADDLE_SUPERVISE_STORE") or \
        os.environ.get("PADDLE_FLIGHT_DIR"):
    install_crash_dump()
