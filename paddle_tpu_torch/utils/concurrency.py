"""Runtime concurrency sanitizer — the port's copy of
``paddle_tpu/utils/concurrency.py``: named lock factories, lock-order
and contention detection ("lock-san"), a thread registry and dumps.

:func:`Lock` / :func:`RLock` / :func:`Condition` are the factories for
the port's named locks (the serving engines, the executable cache,
admission, the block pool and prefix cache, the prefetcher, the
checkpoint writer, the metrics registry and the tracer):

- ``FLAGS_lock_san=0`` (default): the factories return **plain**
  ``threading`` primitives, not wrappers: one flag read when a lock is
  made and nothing per acquire.
- ``FLAGS_lock_san=1``: instrumented locks keep a per-thread held-lock
  stack and a process-wide **acquisition-order graph**; acquiring B
  while holding A records the edge A->B, and an edge that closes a cycle
  (this process also acquired A while holding B, possibly through other
  locks) is a potential deadlock, warned once per closing edge and
  counted (``lock.order_cycle``).  Per-site ``lock.wait_ms.<name>`` /
  ``lock.hold_ms.<name>`` histograms land in the metrics registry, and
  holds longer than ``FLAGS_lock_hold_warn_ms`` are warned and counted
  (``lock.long_hold``).
- ``FLAGS_lock_san=2``: a cycle **raises** :class:`LockOrderError` at
  the acquire that would close it.

Cycle checks run *before* the blocking acquire, so an inversion is
reported even when the schedule happens not to deadlock this run: the
graph accumulates orderings across the whole process lifetime.

The module also keeps a **thread registry** (creation site per thread:
:func:`spawn`, or every thread after :func:`install_thread_registry`)
and exposes :func:`dump_threads` / :func:`install_signal_dump`: all
thread stacks through ``faulthandler`` plus each thread's held
sanitizer locks, on demand or on ``SIGUSR1``.

Set ``PADDLE_LOCK_SAN_REPORT=<path>`` to have an instrumented process
write a JSON summary (acquires, contended acquires, cycles with their
lock chains, long holds) at exit.
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import os
import sys
import threading
import time
import warnings
import weakref
from typing import Dict, List, Optional, Tuple

from . import flags as _flags

__all__ = ["Lock", "RLock", "Condition", "LockOrderError", "level",
           "held_locks", "order_graph", "cycle_reports", "san_stats",
           "reset_graph", "write_report", "dump_threads",
           "install_signal_dump",
           "install_thread_registry", "spawn", "thread_site",
           "live_threads"]


class LockOrderError(RuntimeError):
    """Acquiring this lock would close a cycle in the process's lock
    acquisition-order graph (potential deadlock).  Raised only under
    ``FLAGS_lock_san=2``; level 1 warns instead."""


def level() -> int:
    """Current ``FLAGS_lock_san`` level (0 off / 1 warn / 2 raise)."""
    try:
        return int(_flags.get_flag("FLAGS_lock_san"))
    except KeyError:        # flags module predates the sanitizer flag
        return 0


# ---------------------------------------------------------------------------
# global sanitizer state
# ---------------------------------------------------------------------------
# raw primitives on purpose: the sanitizer must never sanitize itself
_graph_mu = threading.Lock()
_stats_mu = threading.Lock()
_edges: Dict[str, Dict[str, str]] = {}     # src -> {dst: first site}
_reported_edges: set = set()               # (src, dst) cycle-closing edges
_cycle_log: List[dict] = []
_stats = {"acquires": 0, "contended": 0, "long_holds": 0, "cycles": 0}

# thread ident -> (thread name, live held-entry stack).  Entries are the
# same list objects the owning thread mutates; readers (dump) only
# snapshot.  Idents recycle, but each new thread overwrites its slot on
# first push, so a stale entry can only describe a dead thread briefly.
_held_by_thread: Dict[int, Tuple[str, list]] = {}

_tls = threading.local()

# thread object -> "file:line" creation site (leak canary / dumps)
_thread_sites: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

_report_hook_installed = False


def _bump(key: str, n: int = 1):
    """Report-counter increment; `+=` on a dict int is a read-modify-
    write that loses updates under exactly the concurrent load the
    sanitizer exists to measure."""
    with _stats_mu:
        _stats[key] += n


def _tls_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
        _held_by_thread[threading.get_ident()] = (
            threading.current_thread().name, st)
    return st


def _busy() -> bool:
    return getattr(_tls, "busy", False)


def _metrics():
    from ..profiler import metrics
    return metrics


_THIS_FILE = os.path.abspath(__file__)


def _caller_site(depth: int = 2) -> str:
    """First stack frame OUTSIDE this module (skips __enter__ /
    Condition adapter / stdlib threading indirection)."""
    try:
        f = sys._getframe(depth)
        while f is not None:
            fn = f.f_code.co_filename
            if os.path.abspath(fn) != _THIS_FILE and \
                    not fn.endswith("threading.py"):
                return f"{os.path.basename(fn)}:{f.f_lineno}"
            f = f.f_back
        return "?"
    except Exception:       # noqa: BLE001 — diagnostics must not raise
        return "?"


def write_report(path: str):
    """Dump the sanitizer's process summary (stats, cycle reports with
    their lock chains, the order graph's edges) as JSON.  Written at
    interpreter exit to ``$PADDLE_LOCK_SAN_REPORT`` when that is set —
    a harness reads it from outside the process."""
    try:
        with _graph_mu:   # daemon threads may still be recording edges
            doc = {**_stats, "cycle_reports": list(_cycle_log),
                   "edges": {s: sorted(d) for s, d in _edges.items()}}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    except Exception:       # noqa: BLE001 — a report must never crash exit
        pass


def _install_report_hook():
    global _report_hook_installed
    if _report_hook_installed:
        return
    _report_hook_installed = True
    path = os.environ.get("PADDLE_LOCK_SAN_REPORT")
    if not path:
        return
    atexit.register(write_report, path)


# ---------------------------------------------------------------------------
# order graph
# ---------------------------------------------------------------------------
def _reachable(src: str, dst: str) -> Optional[List[str]]:
    """Path src ->* dst in the edge graph (caller holds _graph_mu), or
    None.  Graphs are tiny (one node per *named* lock role, not per
    instance), so a plain DFS is fine."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_edges(held: list, lock: "_SanLock", site: str):
    """Record held->lock edges; detect + report a closing cycle.
    Returns an error message when level 2 should raise."""
    raise_msg = None
    for entry in held:
        src = entry[0].name
        dst = lock.name
        if src == dst:
            continue
        with _graph_mu:
            known = _edges.setdefault(src, {})
            if dst in known:
                continue
            # adding src->dst: a pre-existing dst ->* src path means
            # this edge closes a cycle
            path = _reachable(dst, src)
            known[dst] = site
            if path is None or (src, dst) in _reported_edges:
                continue
            _reported_edges.add((src, dst))
            cycle = path + [dst]
            _stats["cycles"] += 1
            report = {"cycle": cycle, "site": site,
                      "thread": threading.current_thread().name}
            _cycle_log.append(report)
        msg = (f"lock-order cycle: acquiring '{dst}' while holding "
               f"'{src}' at {site}, but this process also orders "
               f"{' -> '.join(cycle)} — two threads interleaving these "
               "paths can deadlock (LK01 at runtime)")
        _observe_counter("lock.order_cycle",
                         "lock acquisition-order cycles observed by "
                         "the runtime sanitizer (potential deadlocks)")
        try:
            # flight recorder (lock-free deque append — safe from the
            # sanitizer's own callback context)
            from ..profiler import flight as _flight
            if _flight.active:
                _flight.note("locksan", "order_cycle",
                             cycle=" -> ".join(cycle), site=site)
        except Exception:       # noqa: BLE001 — sanitizer must not break code
            pass
        if level() >= 2:
            raise_msg = msg
        else:
            warnings.warn(msg, RuntimeWarning, stacklevel=4)
    return raise_msg


def _observe_counter(name: str, doc: str = ""):
    if _busy():
        return
    _tls.busy = True
    try:
        _metrics().counter(name, doc).inc()
    except Exception:       # noqa: BLE001 — sanitizer must not break code
        pass
    finally:
        _tls.busy = False


def _observe_hist(name: str, doc: str, value_ms: float):
    if _busy():
        return
    _tls.busy = True
    try:
        _metrics().histogram(name, doc).observe(value_ms)
    except Exception:       # noqa: BLE001
        pass
    finally:
        _tls.busy = False


# ---------------------------------------------------------------------------
# instrumented primitives
# ---------------------------------------------------------------------------
class _SanLockBase:
    """Shared acquire/release bookkeeping.  Subclasses own the real
    primitive in ``self._raw`` and say whether re-acquire by the owner
    is legal (RLock) or a guaranteed self-deadlock (Lock)."""

    _reentrant = False

    def __init__(self, name: Optional[str], site: str):
        self.name = name or f"lock@{site}"
        self.site = site
        self._raw = self._make_raw()
        # ident of the thread whose held stack carries this lock's
        # entry — plain threading.Lock may legally be RELEASED by a
        # different thread (hand-off/signal pattern), and that path
        # must clear the acquirer's entry or its next acquire would be
        # misread as a self-deadlock.  Reads/writes happen only while
        # the raw lock is held, so the field is lock-serialized.
        self._owner: Optional[int] = None

    def _make_raw(self):
        raise NotImplementedError

    # -- the lock protocol --------------------------------------------
    # lazy mode (module-level locks): constructed at import — before
    # set_flags can possibly run — so the level is re-read per acquire
    # instead of frozen at construction.  Only cold-path locks use it
    # (trace/checkpoint/registry/tracer); the check is one flag read.
    _lazy = False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _busy() or (self._lazy and level() <= 0):
            return self._raw.acquire(blocking, timeout)
        stack = _tls_stack()
        mine = next((e for e in stack if e[0] is self), None)
        if mine is not None:
            if not self._reentrant:
                if not blocking or (timeout is not None and
                                    timeout >= 0):
                    # legal try-lock probe on an owned lock: plain
                    # threading returns False here — preserve that
                    return self._raw.acquire(blocking, timeout)
                msg = (f"self-deadlock: thread "
                       f"'{threading.current_thread().name}' re-acquires "
                       f"non-reentrant lock '{self.name}' it already "
                       f"holds (acquired at {mine[2]}; re-acquire at "
                       f"{_caller_site()})")
                _observe_counter("lock.self_deadlock",
                                 "non-reentrant locks re-acquired by "
                                 "their owner (guaranteed hang)")
                # raises at EVERY sanitizer level: unlike an order
                # cycle (a potential deadlock), this acquire can never
                # return — raising is strictly better than hanging
                raise LockOrderError(msg)
            else:
                # reentrant re-acquire: depth only — no edges, no timers
                ok = self._raw.acquire(blocking, timeout)
                if ok:
                    mine[3] += 1
                return ok
        site = _caller_site()
        # ordering edges only for indefinitely-blocking acquires:
        # try-lock / timed probes cannot deadlock (they are the
        # standard deadlock-AVOIDANCE idiom), so they neither extend
        # the graph nor trip the cycle check
        can_hang = blocking and (timeout is None or timeout < 0)
        raise_msg = _note_edges(stack, self, site) \
            if stack and can_hang else None
        if raise_msg is not None:
            raise LockOrderError(raise_msg)
        t0 = time.perf_counter()
        ok = self._raw.acquire(blocking, timeout)
        if not ok:
            return False
        t1 = time.perf_counter()
        _bump("acquires")
        wait_ms = (t1 - t0) * 1e3
        if wait_ms > 0.05:
            _bump("contended")
        _observe_hist(f"lock.wait_ms.{self.name}",
                      "time spent blocked acquiring this lock", wait_ms)
        # entry layout: [lock, t_acquired, acquire_site, depth]
        stack.append([self, t1, site, 1])
        self._owner = threading.get_ident()
        return ok

    def release(self):
        if _busy():
            return self._raw.release()
        stack = _tls_stack()
        mine = next((e for e in reversed(stack) if e[0] is self), None)
        if mine is not None and mine[3] > 1:   # reentrant inner release
            mine[3] -= 1
            return self._raw.release()
        if mine is None and not self._reentrant and \
                self._owner is not None and \
                self._owner != threading.get_ident():
            # cross-thread release (legal for plain Lock): the entry
            # lives on the ACQUIRER's stack — clear it there, or that
            # thread's next acquire reads as a self-deadlock and every
            # interim acquire fabricates order edges
            rec = _held_by_thread.get(self._owner)
            if rec is not None:
                # scan a SNAPSHOT: the owner thread mutates its own
                # stack unsynchronized (by design), and a reversed()
                # iterator over a concurrently-shrinking list can skip
                # the entry; list() copies atomically under the GIL
                mine = next((e for e in reversed(list(rec[1]))
                             if e[0] is self), None)
                if mine is not None:
                    try:
                        rec[1].remove(mine)
                    except ValueError:   # owner removed it meanwhile
                        mine = None
        hold_ms = None
        if mine is not None:
            if mine in stack:
                stack.remove(mine)
            hold_ms = (time.perf_counter() - mine[1]) * 1e3
        self._owner = None
        # raw release FIRST: the observation below goes through the
        # metrics registry (its own lock) — doing that while still
        # holding this one would both stretch the critical section and,
        # for the registry's own lock, self-deadlock on create
        out = self._raw.release()
        if hold_ms is not None:
            _observe_hist(f"lock.hold_ms.{self.name}",
                          "time this lock was held per critical "
                          "section", hold_ms)
            try:
                warn_ms = float(
                    _flags.get_flag("FLAGS_lock_hold_warn_ms"))
            except KeyError:
                warn_ms = 0.0
            if warn_ms and hold_ms > warn_ms:
                _bump("long_holds")
                _observe_counter(
                    "lock.long_hold",
                    "critical sections held past "
                    "FLAGS_lock_hold_warn_ms")
                warnings.warn(
                    f"lock '{self.name}' held for {hold_ms:.1f}ms "
                    f"(> {warn_ms:.0f}ms threshold; acquired at "
                    f"{mine[2]}) — long holds under load serialize "
                    "every waiter", RuntimeWarning, stacklevel=2)
        return out

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return (f"<{type(self).__name__} '{self.name}' "
                f"(created at {self.site})>")


class _SanLock(_SanLockBase):
    _reentrant = False

    def _make_raw(self):
        return threading.Lock()


class _SanRLock(_SanLockBase):
    _reentrant = True

    def _make_raw(self):
        return threading.RLock()

    def locked(self) -> bool:        # RLock has no .locked() pre-3.12
        raw = self._raw
        return raw.locked() if hasattr(raw, "locked") else False


class _SanCondition:
    """Instrumented Condition: its (instrumented) lock participates in
    the order graph.  The underlying ``threading.Condition`` is built
    over an adapter that routes its internal acquire/release — which
    includes ``wait``'s release-before-park and re-acquire-on-wake —
    through the sanitizer lock, so a parked waiter correctly drops off
    the held stack (no fabricated edges while waiting) and its wake
    re-acquire is a real ordering event."""

    def __init__(self, lock: Optional[_SanLockBase], name: str,
                 site: str):
        if lock is None:
            lock = _SanRLock(name, site)
        self._san_lock = lock
        self._cond = threading.Condition(_RawLockAdapter(lock))
        self.name = name
        self.site = site

    def acquire(self, *a, **k):
        return self._san_lock.acquire(*a, **k)

    def release(self):
        return self._san_lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def __repr__(self):
        return f"<_SanCondition '{self.name}' (created at {self.site})>"


class _RawLockAdapter:
    """Presents a sanitizer lock to ``threading.Condition``'s internal
    lock protocol.  Direct acquire/release delegate with full
    bookkeeping; ``wait``'s park/wake go through
    ``_release_save``/``_acquire_restore`` so a reentrantly-held RLock
    is FULLY released while parked (one-level release would deadlock
    the notifier — stdlib Condition semantics) and the sanitizer's
    held entry — which carries the recursion depth — drops off the
    stack for the whole park and returns intact on wake."""

    def __init__(self, san: _SanLockBase):
        self._san = san

    def acquire(self, *a, **k):
        return self._san.acquire(*a, **k)

    def release(self):
        return self._san.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _release_save(self):
        san = self._san
        stack = _tls_stack()
        mine = next((e for e in reversed(stack) if e[0] is san), None)
        if mine is not None:
            stack.remove(mine)
        if stack and not _busy():
            # the wake re-acquire of the cond lock while these locks
            # stay held across the park is a real ordering event
            # (waiter-holds-M vs notifier-needs-M is a classic
            # deadlock) — record it at PARK time: the actual wake
            # acquire happens inside Condition.wait's finally, and
            # raising in its pre-release window would corrupt the
            # waiter list, so cycle closure warns even at level 2
            msg = _note_edges(stack, san, _caller_site())
            if msg is not None:
                warnings.warn(msg, RuntimeWarning, stacklevel=3)
        raw = san._raw
        if hasattr(raw, "_release_save"):    # RLock: full unwind
            state = raw._release_save()
        else:
            raw.release()
            state = None
        return (state, mine)

    def _acquire_restore(self, saved):
        state, mine = saved
        san = self._san
        raw = san._raw
        if hasattr(raw, "_acquire_restore") and state is not None:
            raw._acquire_restore(state)
        else:
            raw.acquire()
        if mine is not None:
            mine[1] = time.perf_counter()   # hold clock restarts on wake
            _tls_stack().append(mine)
        san._owner = threading.get_ident()

    def _is_owned(self):
        raw = self._san._raw
        if hasattr(raw, "_is_owned"):
            return raw._is_owned()
        if raw.acquire(False):
            raw.release()
            return False
        return True


# ---------------------------------------------------------------------------
# factories — the public construction surface
# ---------------------------------------------------------------------------
def Lock(name: Optional[str] = None, lazy: bool = False):
    """A mutex.  Plain ``threading.Lock()`` when ``FLAGS_lock_san=0``
    (no wrapper in the type), instrumented otherwise.  ``name`` keys
    the order graph and the per-site metrics; one *role* (e.g.
    ``"serving.engine.metrics"``) shares a name across instances so
    orderings generalize.

    ``lazy=True`` is for locks constructed at module import, where
    ``set_flags`` can never have run yet: the returned object is
    always the (cold-path-only) wrapper and re-reads the level on
    each acquire, so arming the sanitizer at runtime instruments them
    too instead of silently leaving the trace/checkpoint/profiler
    locks out of the order graph."""
    if lazy:
        _install_report_hook()
        lk = _SanLock(name, _caller_site())
        lk._lazy = True
        return lk
    if level() <= 0:
        return threading.Lock()
    _install_report_hook()
    return _SanLock(name, _caller_site())


def RLock(name: Optional[str] = None, lazy: bool = False):
    """Reentrant mutex (see :func:`Lock`, including ``lazy``).  Owner
    re-acquires are depth bookkeeping only — never edges, never
    self-deadlock reports."""
    if lazy:
        _install_report_hook()
        lk = _SanRLock(name, _caller_site())
        lk._lazy = True
        return lk
    if level() <= 0:
        return threading.RLock()
    _install_report_hook()
    return _SanRLock(name, _caller_site())


def Condition(lock=None, name: Optional[str] = None):
    """Condition variable (see :func:`Lock`).  ``wait`` drops the lock
    from the holder's stack while parked, so waiting never fabricates
    ordering edges."""
    if level() <= 0:
        return threading.Condition(lock)
    _install_report_hook()
    site = _caller_site()
    if lock is not None and not isinstance(lock, _SanLockBase):
        # a raw lock handed in: wrap-free passthrough (we cannot
        # instrument a primitive we don't own without changing identity)
        return threading.Condition(lock)
    return _SanCondition(lock, name or f"cond@{site}", site)


# ---------------------------------------------------------------------------
# introspection (tests, gates, dumps)
# ---------------------------------------------------------------------------
def _held_by_ident() -> Dict[int, Tuple[str, List[str]]]:
    """ident -> (thread name, held-lock strings); prunes dead idents."""
    now = time.perf_counter()
    live = set(sys._current_frames())
    out: Dict[int, Tuple[str, List[str]]] = {}
    for ident, (tname, stack) in list(_held_by_thread.items()):
        if ident not in live:
            _held_by_thread.pop(ident, None)
            continue
        if stack:
            out[ident] = (tname, [
                f"{e[0].name} (held {(now - e[1]) * 1e3:.1f}ms, "
                f"acquired at {e[2]})" for e in list(stack)])
    return out


def held_locks() -> Dict[str, List[str]]:
    """``{"thread name#ident": [lock (held Xms, acquired at site),
    ...]}`` for threads currently holding sanitizer locks.  Keyed by
    name AND ident: several framework threads legitimately share a
    name (e.g. two loaders' 'paddle-prefetch' producers), and a dump
    that collapsed them would blame the wrong holder."""
    return {f"{tname}#{ident}": locks
            for ident, (tname, locks) in _held_by_ident().items()}


def order_graph() -> Dict[str, Dict[str, str]]:
    """Snapshot of the acquisition-order graph: src -> {dst: site}."""
    with _graph_mu:
        return {s: dict(d) for s, d in _edges.items()}


def cycle_reports() -> List[dict]:
    with _graph_mu:
        return list(_cycle_log)


def san_stats() -> dict:
    """Process-level counters (acquires/contended/long_holds/cycles)."""
    return dict(_stats)


def reset_graph():
    """Test hook: forget all recorded orderings and reports."""
    with _graph_mu:
        _edges.clear()
        _reported_edges.clear()
        _cycle_log.clear()
        for k in _stats:
            _stats[k] = 0


# ---------------------------------------------------------------------------
# thread registry + dumps
# ---------------------------------------------------------------------------
_registry_installed = False


def install_thread_registry():
    """Record a creation site ("file:line" of the ``start()`` caller)
    for every thread started after this call — one dict write per
    thread start.  Idempotent.  The tests' thread-leak canary and
    :func:`dump_threads` name threads with it."""
    global _registry_installed
    if _registry_installed:
        return
    _registry_installed = True
    orig = threading.Thread.start

    def start(self, *a, **k):
        if self not in _thread_sites:
            _thread_sites[self] = _caller_site()
        return orig(self, *a, **k)

    threading.Thread.start = start


def thread_site(t: threading.Thread) -> Optional[str]:
    """Creation site recorded for ``t``, or None."""
    return _thread_sites.get(t)


def spawn(target, *, name: str, daemon: bool = True, args=(),
          kwargs=None) -> threading.Thread:
    """Create-register-start a thread in one call: the creation site is
    recorded even when :func:`install_thread_registry` was never armed,
    so framework threads are always attributable in dumps and leak
    reports."""
    t = threading.Thread(target=target, name=name, daemon=daemon,
                         args=args, kwargs=kwargs or {})
    _thread_sites[t] = _caller_site()
    t.start()
    return t


def live_threads():
    """``[(thread, creation site or None)]`` for every live thread."""
    return [(t, _thread_sites.get(t)) for t in threading.enumerate()]


def dump_threads(file=None):
    """Write every thread's held sanitizer locks + a full
    ``faulthandler`` stack dump to ``file`` (default stderr).  Async-
    signal-tolerant by construction: the held-lock walk only reads."""
    file = file or sys.stderr
    try:
        held = _held_by_ident()
        print("== lock-san thread dump ==", file=file)
        for t, site in live_threads():
            extra = f" (started at {site})" if site else ""
            _name, locks = held.get(t.ident, (None, None))
            lock_s = f" holding: {', '.join(locks)}" if locks else ""
            print(f"  thread '{t.name}' daemon={t.daemon}{extra}"
                  f"{lock_s}", file=file)
        file.flush()
    except Exception:       # noqa: BLE001 — a dump must never throw
        pass
    try:
        faulthandler.dump_traceback(file=file, all_threads=True)
    except Exception:       # noqa: BLE001
        pass


_installed_signals: set = set()


def install_signal_dump(signum=None) -> bool:
    """Install a ``SIGUSR1`` (or ``signum``) handler that runs
    :func:`dump_threads` to stderr, so a process signalled before it is
    killed for a stall leaves *why* it was wedged in its log.  Main-thread
    only
    (signal module contract); returns False when it could not install
    (non-main thread / unsupported platform)."""
    import signal as _signal
    if signum is None:
        signum = getattr(_signal, "SIGUSR1", None)
        if signum is None:          # windows
            return False
    if signum in _installed_signals:   # idempotence is per-signal
        return True

    def _handler(_sig, frame):
        dump_threads(sys.stderr)
        try:
            # flight recorder: after WHERE every thread is, WHAT the
            # process last did (tail to the log + JSON dump when
            # PADDLE_FLIGHT_DIR is configured)
            from ..profiler import flight as _flight
            _flight.dump_on_signal(sys.stderr)
        except Exception:       # noqa: BLE001 — a dump must never throw
            pass

    try:
        _signal.signal(signum, _handler)
    except (ValueError, OSError):   # not the main thread
        return False
    _installed_signals.add(signum)
    return True
