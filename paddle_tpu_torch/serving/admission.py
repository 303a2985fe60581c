"""Admission control for the generation engines — the port's copy of
``paddle_tpu/serving/admission.py``: shed, don't run out of memory.

Every request passes :meth:`AdmissionController.acquire` before it may
enter the engine queue:

- queue depth at ``max_queue`` -> :class:`RequestRejected` (``queue_full``);
- reserved tokens over the ``max_tokens`` budget ->
  :class:`RequestRejected` (``token_budget``);
- a request larger than the whole budget or the cache ->
  :class:`RequestRejected` (``too_large``);
- a tenant whose token bucket is empty -> :class:`RequestRejected`
  (``tenant_quota``);
- engine closed -> :class:`EngineClosed` (``reason == "closed"``).

A request whose deadline passes while it waits is shed with
:class:`DeadlineExceeded` (``reason == "deadline"``), one whose deadline
passes while it sits preempted to host memory with ``reason ==
"deadline_preempted"``; a paged engine sheds a request its block pool
cannot hold with ``RequestRejected(reason="kv_blocks")``.  Every outcome
is counted in the metrics registry (``<name>.request.admitted``,
``.request.rejected[.<reason>]``, ``.request.shed_deadline``,
``.request.shed_kv_blocks``, ``.queue_depth``, ``.tokens_in_flight``,
per tenant ``<name>.tenant.<tenant>.admitted`` / ``.shed``) and, per
controller, in :attr:`AdmissionController.counts`.

Multi-tenant serving adds three pieces:

- **priority classes** (:data:`PRIORITIES` = interactive / standard /
  batch): the engines dequeue by class with bounded aging;
- **per-tenant token buckets** (:class:`TenantQuotaTable`): an empty
  bucket sheds typed ``tenant_quota``; the table reloads from a JSON file
  without a restart (:class:`QuotaWatcher`);
- **drain-rate Retry-After** (:class:`DrainRateEstimator`): every
  rejection carries a ``retry_after`` derived from the observed queue
  drain rate, clamped to [1, 30] s.

The reference's ``max_rows`` bound serves its batching
``InferenceEngine``, which the port does not have yet (``ROADMAP.md`` §A
item 10); it is left out here.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import Counter
from typing import Callable, Dict, Optional

from ..utils import concurrency as _conc

__all__ = ["RequestRejected", "DeadlineExceeded", "EngineClosed",
           "AdmissionController", "PRIORITIES", "priority_rank",
           "TenantQuotaTable", "DrainRateEstimator", "QuotaWatcher",
           "deadline_from_ms"]


# priority classes, best first; the rank (index) is what the engines
# order on — lower rank dequeues first
PRIORITIES = ("interactive", "standard", "batch")
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


def priority_rank(priority: Optional[str]) -> int:
    """Rank of a priority-class name (0 = most urgent).  ``None``
    means ``standard``; unknown names raise ``ValueError`` (a typo'd
    header must 400, not silently become batch)."""
    if priority is None:
        return _PRIORITY_RANK["standard"]
    try:
        return _PRIORITY_RANK[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority {priority!r}; expected one of "
            f"{list(PRIORITIES)}") from None


class RequestRejected(RuntimeError):
    """Explicit overload rejection; ``reason`` is one of ``queue_full``,
    ``too_large``, ``token_budget``, ``kv_blocks``, ``tenant_quota``,
    ``closed`` (``overload`` when none is given).  ``kv_blocks`` means the paged KV block pool could not
    supply the request's blocks (possibly injected via the
    ``kv.block_alloc`` chaos site) — the engine shed it rather than
    corrupt a live batch; ``tenant_quota`` means the tenant's token
    bucket is empty.  ``retry_after`` (seconds, [1, 30]) is derived
    from the observed queue drain rate when the rejecting controller
    had one — the HTTP layer surfaces it as the ``Retry-After``
    header."""

    def __init__(self, msg: str, reason: str = "overload",
                 retry_after: Optional[int] = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after = retry_after


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before a result was produced.
    ``reason`` distinguishes WHERE it expired: ``deadline`` (queued or
    client-side wait) vs ``deadline_preempted`` (expired while the
    request sat preempted in host memory — the engine released the
    host-side state instead of resuming a stream nobody waits for)."""

    def __init__(self, msg: str = "", reason: str = "deadline"):
        super().__init__(msg)
        self.reason = reason


class EngineClosed(RequestRejected):
    def __init__(self, msg: str = "engine is closed"):
        super().__init__(msg, reason="closed")


class DrainRateEstimator:
    """Observed queue drain rate -> an honest ``Retry-After``.

    Every dequeue (request picked into the engine or shed) notes a
    timestamp; :meth:`retry_after_s` divides the current backlog by
    the drains-per-second observed over the rolling window and clamps
    to [1, 30] s.  A cold or stalled queue answers the ceiling — "come
    back in 30 s" is the only honest estimate when nothing has drained
    lately.  ``clock`` is injectable so tests freeze time.
    """

    FLOOR_S, CEIL_S = 1, 30

    def __init__(self, window_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self._clock = clock
        self._events: list = []        # drain timestamps, ascending
        self._lock = _conc.Lock(name="serving.drain_rate")

    def note(self, n: int = 1):
        """``n`` requests left the queue now."""
        now = self._clock()
        with self._lock:
            self._events.extend([now] * int(n))
            cut = now - self.window_s
            while self._events and self._events[0] < cut:
                self._events.pop(0)

    def rate(self) -> float:
        """Drains per second over the window (0.0 when cold)."""
        now = self._clock()
        with self._lock:
            cut = now - self.window_s
            while self._events and self._events[0] < cut:
                self._events.pop(0)
            n = len(self._events)
            if n < 2:
                return 0.0
            span = max(now - self._events[0], 1e-6)
            return n / span

    def retry_after_s(self, depth: int) -> int:
        r = self.rate()
        if r <= 0.0:
            return self.CEIL_S if depth > 0 else self.FLOOR_S
        est = math.ceil(max(int(depth), 1) / r)
        return int(min(self.CEIL_S, max(self.FLOOR_S, est)))


class TenantQuotaTable:
    """Per-tenant token buckets for admission quotas.

    Config is ``{tenant: {"rate": tokens/s, "burst": max tokens}}``;
    the ``"*"`` entry is the default for tenants not named explicitly
    (no ``"*"`` -> unknown tenants are unlimited).  Buckets refill
    continuously at ``rate`` up to ``burst`` and are charged the
    request's true token cost (prompt + max_new) at admission —
    deterministic under an injected frozen ``clock``, which is what
    makes refill testable.  :meth:`reload` swaps the whole table
    atomically (existing buckets keep their level, clamped to the new
    burst), so a :class:`QuotaWatcher` can throttle a tenant without a
    restart.
    """

    def __init__(self, quotas: Optional[Dict[str, dict]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = _conc.Lock(name="serving.tenant_quota")
        self._cfg: Dict[str, Dict[str, float]] = {}
        self._buckets: Dict[str, list] = {}   # tenant -> [level, t]
        self.generation = 0
        if quotas:
            self.reload(quotas)

    @staticmethod
    def _validate(quotas: Dict[str, dict]) -> Dict[str, Dict[str, float]]:
        out = {}
        for tenant, q in dict(quotas).items():
            rate = float(q["rate"])
            burst = float(q.get("burst", rate))
            if rate < 0 or burst <= 0:
                raise ValueError(
                    f"quota for tenant {tenant!r}: rate must be >= 0 "
                    f"and burst > 0, got rate={rate} burst={burst}")
            out[str(tenant)] = {"rate": rate, "burst": burst}
        return out

    def reload(self, quotas: Dict[str, dict]) -> int:
        """Atomically replace the quota config (validated first — a
        malformed table changes nothing).  Returns the new generation
        counter."""
        cfg = self._validate(quotas)
        with self._lock:
            self._cfg = cfg
            for tenant in list(self._buckets):
                lim = cfg.get(tenant) or cfg.get("*")
                if lim is None:
                    del self._buckets[tenant]     # now unlimited
                else:
                    self._buckets[tenant][0] = min(
                        self._buckets[tenant][0], lim["burst"])
            self.generation += 1
            return self.generation

    def limit_for(self, tenant: str) -> Optional[Dict[str, float]]:
        with self._lock:
            return self._cfg.get(tenant) or self._cfg.get("*")

    def try_acquire(self, tenant: str, tokens: int) -> bool:
        """Charge ``tokens`` against the tenant's bucket; False means
        the quota is exhausted (the caller sheds typed).  Unlimited
        tenants always pass."""
        now = self._clock()
        tokens = max(int(tokens), 1)
        with self._lock:
            lim = self._cfg.get(tenant) or self._cfg.get("*")
            if lim is None:
                return True
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = [lim["burst"], now]
            level = min(lim["burst"],
                        bucket[0] + (now - bucket[1]) * lim["rate"])
            bucket[1] = now
            if level >= tokens:
                bucket[0] = level - tokens
                return True
            bucket[0] = level
            return False

    def level(self, tenant: str) -> Optional[float]:
        """Current bucket level (refilled-to-now); None = unlimited."""
        now = self._clock()
        with self._lock:
            lim = self._cfg.get(tenant) or self._cfg.get("*")
            if lim is None:
                return None
            bucket = self._buckets.get(tenant)
            if bucket is None:
                return lim["burst"]
            return min(lim["burst"],
                       bucket[0] + (now - bucket[1]) * lim["rate"])


class QuotaWatcher:
    """Hot-reload for tenant quota tables: poll a JSON file (``{tenant: {"rate": r,
    "burst": b}}``), verify, apply atomically between requests, so an
    operator throttles a tenant by editing a file, never by
    restarting the engine.  A malformed or unparsable table is
    rejected loudly and the previous config keeps serving (counted
    ``serving.quota.reload_rejected``); applied reloads count
    ``serving.quota.reloads`` and leave an ``admission.quota_reload``
    flight event."""

    def __init__(self, path: str, controller: "AdmissionController", *,
                 interval: float = 1.0):
        self.path = os.path.abspath(path)
        self.controller = controller
        self.interval = float(interval)
        self._mtime: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> bool:
        """Apply the file if it changed; True when a reload landed."""
        try:
            mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            return False              # absent file: keep serving as-is
        if mtime == self._mtime:
            return False
        from ..profiler import flight as _flight
        from ..profiler import metrics as _metrics
        try:
            with open(self.path, "r") as f:
                quotas = json.load(f)
            if not isinstance(quotas, dict):
                raise ValueError("quota table must be a JSON object "
                                 "{tenant: {rate, burst}}")
            gen = self.controller.set_quotas(quotas)
        except Exception as e:   # noqa: BLE001 — old config keeps serving
            self._mtime = mtime   # don't re-warn every poll tick
            _metrics.counter(
                "serving.quota.reload_rejected",
                "quota-table reloads rejected (malformed file; the "
                "previous config kept serving)").inc()
            import warnings
            warnings.warn(f"quota watcher: {self.path} rejected "
                          f"({e!r}); previous quota table kept",
                          RuntimeWarning)
            return False
        self._mtime = mtime
        _metrics.counter(
            "serving.quota.reloads",
            "tenant quota tables hot-reloaded from disk").inc()
        if _flight.active:
            _flight.note("admission", "quota_reload",
                         path=self.path, tenants=len(quotas),
                         generation=gen)
        return True

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — watcher must survive
                import warnings
                warnings.warn(f"quota watcher poll failed ({e!r})",
                              RuntimeWarning)

    def start(self) -> "QuotaWatcher":
        self.poll_once()              # synchronous first read
        self._thread = _conc.spawn(self._loop, name="quota-watcher")
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None


class AdmissionController:
    """Bounded-queue gatekeeper with SLO counters.

    ``acquire``/``release`` bracket a request's time in the pending
    queue; ``release_tokens`` returns its token reservation when it
    leaves the engine.  The gauges track live depth and reserved tokens
    so ``/metrics`` shows queue pressure directly.  :attr:`counts` keeps
    this controller's own outcome counts (``admitted``,
    ``rejected.<reason>``, ``shed_deadline``, ``shed_deadline_preempted``,
    ``shed_kv_blocks``): the registry's are shared by every controller of
    one name.
    """

    def __init__(self, max_queue: int, max_tokens: Optional[int] = None,
                 name: str = "serving",
                 quotas: Optional[TenantQuotaTable] = None):
        self.max_queue = int(max_queue)
        self.name = name
        # per-tenant token buckets (None = no quotas); swappable at
        # runtime through set_quotas (the QuotaWatcher hot-reload path)
        self.quotas = quotas
        # observed dequeue rate -> drain-derived Retry-After on sheds
        self.drain = DrainRateEstimator()
        # token budget: the sum of every admitted request's reserved
        # tokens (prompt + max_new) may not exceed this
        self.max_tokens = int(max_tokens) if max_tokens else None
        self.counts: Counter = Counter()
        self._tokens = 0
        self._depth = 0
        self._lock = _conc.Lock(name=f"{name}.admission")
        from ..profiler import metrics as _metrics
        self._admitted = _metrics.counter(
            f"{name}.request.admitted", "requests accepted into the "
            "engine queue")
        self._rejected = _metrics.counter(
            f"{name}.request.rejected", "requests explicitly rejected "
            "at admission (all reasons)")
        self._shed = _metrics.counter(
            f"{name}.request.shed_deadline", "queued requests dropped "
            "because their deadline expired before execution")
        self._shed_kv = _metrics.counter(
            f"{name}.request.shed_kv_blocks", "admitted requests shed "
            "because the paged KV block pool could not supply blocks "
            "(incl. exhaustion injected via kv.block_alloc)")
        self._depth_gauge = _metrics.gauge(
            f"{name}.queue_depth", "requests currently waiting in the "
            "engine queue")
        self._tokens_gauge = _metrics.gauge(
            f"{name}.tokens_in_flight", "reserved tokens (prompt + max "
            "new) of admitted-but-unfinished generation requests")
        self._closed = False

    # -- lifecycle ----------------------------------------------------
    def close(self):
        self._closed = True

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def tokens_in_flight(self) -> int:
        return self._tokens

    # -- quotas / retry hints -----------------------------------------
    def set_quotas(self, quotas) -> int:
        """Install or replace the tenant quota table (dict config or a
        prebuilt :class:`TenantQuotaTable`, or None to drop quotas)
        without disturbing admission — THE hot-reload entry point.
        Returns the table's generation counter."""
        if quotas is None:
            self.quotas = None
            return 0
        if isinstance(quotas, TenantQuotaTable):
            self.quotas = quotas
            return quotas.generation
        table = self.quotas
        if table is None:
            table = TenantQuotaTable()
            gen = table.reload(quotas)
            self.quotas = table       # publish only after validation
            return gen
        return table.reload(quotas)

    def retry_after_s(self) -> int:
        """Drain-rate-derived retry hint for the CURRENT backlog,
        clamped to [1, 30] s."""
        return self.drain.retry_after_s(self._depth)

    def _tenant_counter(self, tenant: Optional[str], what: str):
        if not tenant:
            return None
        from ..profiler import metrics as _metrics
        return _metrics.counter(
            f"{self.name}.tenant.{tenant}.{what}",
            f"per-tenant SLO accounting: {what}")

    # -- admission ----------------------------------------------------
    def _reject(self, reason: str, msg: str,
                tenant: Optional[str] = None,
                priority: Optional[str] = None):
        from ..profiler import flight as _flight
        from ..profiler import metrics as _metrics
        retry_after = self.retry_after_s()
        with self._lock:   # exact counts even under concurrent clients
            self.counts[f"rejected.{reason}"] += 1
            self._rejected.inc()
            _metrics.counter(
                f"{self.name}.request.rejected.{reason}").inc()
            c = self._tenant_counter(tenant, "shed")
            if c is not None:
                c.inc()
        if _flight.active:
            _flight.note("admission", "reject", engine=self.name,
                         reason=reason, tenant=tenant,
                         priority=priority)
            if reason == "tenant_quota":
                _flight.note("admission", "tenant_quota",
                             engine=self.name, tenant=tenant,
                             priority=priority,
                             retry_after=retry_after)
        if reason == "closed":
            exc = EngineClosed(msg)
            exc.retry_after = retry_after
            raise exc
        raise RequestRejected(msg, reason=reason,
                              retry_after=retry_after)

    def reject(self, reason: str, msg: str,
               tenant: Optional[str] = None,
               priority: Optional[str] = None):
        """Shed a request through the standard typed-rejection path
        (counted ``request.rejected`` + ``request.rejected.<reason>``,
        flight-noted, Retry-After attached) for reasons the controller
        cannot see itself (a prompt that leaves no room in the cache, a
        replica of the wrong role).  Always raises."""
        self._reject(reason, msg, tenant=tenant, priority=priority)

    def acquire(self, tokens: int = 0, tenant: Optional[str] = None,
                priority: Optional[str] = None,
                quota_tokens: Optional[int] = None):
        """Admit one request (reserving ``tokens`` against the token
        budget, when one is configured) or raise
        :class:`RequestRejected`.  ``tenant``/``priority`` feed the
        per-tenant accounting; ``quota_tokens`` is the cost charged to
        the tenant's token bucket (defaults to ``tokens``)."""
        if self._closed:
            self._reject("closed", "engine is closed", tenant=tenant,
                         priority=priority)
        if self.max_tokens is not None and tokens > self.max_tokens:
            self._reject(
                "too_large",
                f"request reserves {tokens} tokens but the engine's "
                f"whole token budget is {self.max_tokens}; shorten the "
                "prompt or max_new_tokens", tenant=tenant,
                priority=priority)
        quotas = self.quotas
        if tenant and quotas is not None and not quotas.try_acquire(
                tenant, quota_tokens if quota_tokens is not None
                else tokens):
            self._reject(
                "tenant_quota",
                f"tenant {tenant!r} token bucket exhausted; the quota "
                "refills continuously — honor Retry-After",
                tenant=tenant, priority=priority)
        reason = None
        with self._lock:
            if self._depth >= self.max_queue:
                reason, depth = "queue_full", self._depth
            elif self.max_tokens is not None and \
                    self._tokens + tokens > self.max_tokens:
                reason, held = "token_budget", self._tokens
            else:
                self._depth += 1
                self._depth_gauge.set(self._depth)
                self._tokens += tokens
                self._tokens_gauge.set(self._tokens)
                self.counts["admitted"] += 1
                self._admitted.inc()
                c = self._tenant_counter(tenant, "admitted")
                if c is not None:
                    c.inc()
                from ..profiler import flight as _flight
                if _flight.active:
                    _flight.note("admission", "admit",
                                 engine=self.name, depth=self._depth,
                                 tenant=tenant, priority=priority)
                return
        if reason == "queue_full":
            self._reject(
                "queue_full",
                f"engine queue is full ({depth}/{self.max_queue} "
                "waiting); overload is shed explicitly — retry with "
                "backoff (GenerationEngineConfig.max_queue bounds this)",
                tenant=tenant, priority=priority)
        self._reject(
            "token_budget",
            f"token budget exhausted ({held}+{tokens} over "
            f"{self.max_tokens} reserved tokens in flight); retry when "
            "running generations finish (max_tokens_in_flight bounds "
            "this)", tenant=tenant, priority=priority)

    def release(self):
        """The request left the queue (taken into a slot or shed)."""
        with self._lock:
            self._depth = max(0, self._depth - 1)
            self._depth_gauge.set(self._depth)
        self.drain.note()

    def release_tokens(self, tokens: int):
        """A generation request retired (finished / shed / failed):
        return its reserved tokens to the budget."""
        if not tokens:
            return
        with self._lock:
            self._tokens = max(0, self._tokens - int(tokens))
            self._tokens_gauge.set(self._tokens)

    def shed_deadline(self, preempted: bool = False):
        """A deadline expired before a result: while queued (default)
        or — ``preempted=True`` — while the request sat swapped out in
        host memory (typed ``deadline_preempted``; the engine released
        the host-side state instead of resuming a dead stream)."""
        with self._lock:
            self.counts["shed_deadline"] += 1
            if preempted:
                self.counts["shed_deadline_preempted"] += 1
        self._shed.inc()
        from ..profiler import flight as _flight
        if preempted:
            from ..profiler import metrics as _metrics
            _metrics.counter(
                f"{self.name}.request.shed_deadline_preempted",
                "preempted-to-host requests dropped because their "
                "deadline expired while swapped out").inc()
            if _flight.active:
                _flight.note("admission", "deadline_preempted",
                             engine=self.name)
            return
        if _flight.active:
            _flight.note("admission", "shed_deadline",
                         engine=self.name)

    def shed_kv_blocks(self):
        """A paged engine shed an admitted request on pool exhaustion
        (typed ``RequestRejected(reason="kv_blocks")`` to the client)."""
        with self._lock:
            self.counts["shed_kv_blocks"] += 1
        self._shed_kv.inc()
        from ..profiler import flight as _flight
        if _flight.active:
            _flight.note("admission", "shed_kv_blocks",
                         engine=self.name)


def deadline_from_ms(deadline_ms: Optional[float]) -> Optional[float]:
    """Monotonic absolute deadline from a relative millisecond budget."""
    if deadline_ms is None:
        return None
    return time.monotonic() + float(deadline_ms) / 1e3
