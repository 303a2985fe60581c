"""Continuous (in-flight) batching for autoregressive generation — the
counterpart of ``GenerationEngine`` and ``PagedGenerationEngine`` of
``paddle_tpu/serving/engine.py``.

A fixed bank of ``max_slots`` decode slots runs one decode step per token
for every occupied slot.  Queued requests are admitted into free slots
between decode steps, by priority class with bounded aging: their prompts
are prefilled, grouped per prompt-length bucket, straight into the shared
KV store without touching running neighbours.  Finished rows (eos, token
budget, cache full) retire at once and their slot is refilled at the next
boundary.  Tokens stream out per request as they are sampled.

:class:`GenerationEngine` keeps one worst-case ``(max_length, H, D)``
cache per slot; :class:`PagedGenerationEngine` keeps a shared refcounted
block pool instead (``generation/paged_kv.py``), with a prefix cache, int8
KV, speculative decoding and preemption to host memory.

Because rows never interact and every step runs at the same
``(max_slots, ...)`` shapes as a solo
:meth:`~paddle_tpu_torch.generation.GenerationSession.generate` over the
same session, each stream equals the solo ``generate()`` of its prompt,
and a paged stream equals the contiguous one.

Every step is one replay of a captured CUDA graph per prompt bucket (and
one for decode), kept in the session's executable cache.  With
``GenerationEngineConfig(warmup=True)`` the engine captures them all
before it takes requests (``"async"``: on the scheduler thread, with
:attr:`GenerationEngine.ready` False until done); otherwise each is
captured at its first use.  Every launch on the card, captures, block
copies, swaps and the prefix-chain export and import included, runs on
the scheduler thread; client threads only queue requests and read
results, so no other thread touches the card while a graph is captured.
:meth:`GenerationEngine.swap_weights` stages the new weights on the
card from the caller's thread under the session's lock (no capture can
be in progress then) and the scheduler copies them into the live
parameters between two token boundaries, so every captured graph reads
them at its next replay and nothing is captured again.

Metrics (the registry, ``<name>.`` prefix): the session's ``prefill`` /
``decode`` step histograms and ``tokens_out``, ``ttft_ms``,
``inter_token_ms``, ``decode.occupancy``, ``request.completed`` /
``.failed`` / ``.cancelled``, ``slots``, ``decode_warmed_buckets``, the
executable cache's ``executable_cache.hit`` / ``compile``, the admission
counters and the per-tenant ``tenant.<t>.*`` series; :meth:`stats` reads
them.  With ``FLAGS_request_trace`` a request submitted with a trace
context leaves its span chain (:mod:`~paddle_tpu_torch.profiler.rtrace`);
with ``FLAGS_mem_accounting`` the engines attribute ``params`` and
``kv_arena`` bytes and an exhaustion leaves memscope's forensics dump.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..generation.session import GenerationSession
from ..profiler import flight as _flight
from ..profiler import memscope as _memscope
from ..profiler import metrics as _metrics
from ..profiler import rtrace as _rtrace
from ..profiler import tracer as _tracer
from ..utils import concurrency as _conc
from ..utils import flags as _flags
from .admission import (PRIORITIES, AdmissionController, DeadlineExceeded,
                        EngineClosed, RequestRejected, TenantQuotaTable,
                        deadline_from_ms, priority_rank)

__all__ = ["GenerationEngineConfig", "GenerationStream", "GenerationEngine",
           "PagedGenerationEngine", "RequestRejected", "DeadlineExceeded",
           "EngineClosed"]


class GenerationEngineConfig:
    """Knobs for :class:`GenerationEngine` and :class:`PagedGenerationEngine`.

    max_slots            rows of the running decode batch; every step has
                         exactly this batch shape
    max_length           KV-cache capacity per slot (prompt + generated
                         tokens); defaults to the model's max_seq_len
    max_new_tokens       per-request default generation budget
    max_queue            admission bound on waiting requests (default:
                         FLAGS_serving_queue_depth)
    max_tokens_in_flight token-budget bound: the sum of every admitted
                         request's (prompt_len + max_new_tokens); default
                         max_slots * max_length (what the cache can hold)
    deadline_ms          default per-request deadline (sheds while
                         queued); None = none
    aging_s              priority aging: a waiting request's class
                         improves by one per ``aging_s`` seconds queued,
                         so batch traffic cannot starve (0: strict order)
    tenant_quotas        per-tenant token buckets ``{tenant: {"rate":
                         tokens/s, "burst": max}}`` (``"*"``: the default
                         for unlisted tenants); an empty bucket sheds
                         typed ``tenant_quota``; replaced at run time by
                         ``engine.set_quotas`` / admission.QuotaWatcher
    prompt_bucket_min    smallest prompt-length bucket
    warmup               capture every prefill bucket and the decode step
                         before serving: True in the constructor,
                         "async" on the scheduler thread (``ready`` is
                         False until it lands), False at first use
    name                 the engine's name, given to its session and the
                         prefix of its metrics

    Paged knobs (read by :class:`PagedGenerationEngine` only):

    block_size           KV block width in tokens; must divide max_length
    num_blocks           the block pool's size: THE serving memory budget;
                         default max_slots * (max_length / block_size),
                         the contiguous engine's footprint
    kv_cache_dtype       'float32' | 'int8' block storage; default
                         FLAGS_kv_cache_dtype
    prefix_cache_blocks  prefix-cache capacity in blocks (0 disables);
                         default FLAGS_prefix_cache_blocks
    speculative_k        draft tokens per decode step from the n-gram
                         prompt-lookup drafter (0 disables); default
                         FLAGS_speculative_k
    spec_ngram           the trailing n-gram width the drafter matches
    """

    def __init__(self, max_slots: int = 4,
                 max_length: Optional[int] = None,
                 max_new_tokens: int = 64,
                 max_queue: Optional[int] = None,
                 max_tokens_in_flight: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 aging_s: float = 2.0,
                 tenant_quotas: Optional[Dict[str, dict]] = None,
                 prompt_bucket_min: int = 8,
                 warmup=False,
                 name: str = "serving",
                 block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = None,
                 prefix_cache_blocks: Optional[int] = None,
                 speculative_k: Optional[int] = None,
                 spec_ngram: int = 2):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = int(max_slots)
        self.max_length = max_length
        self.max_new_tokens = int(max_new_tokens)
        if max_queue is None:
            max_queue = _flags.get_flag("FLAGS_serving_queue_depth")
        self.max_queue = int(max_queue)
        self.max_tokens_in_flight = max_tokens_in_flight
        self.deadline_ms = deadline_ms
        self.aging_s = float(aging_s)
        self.tenant_quotas = tenant_quotas
        self.prompt_bucket_min = int(prompt_bucket_min)
        self.warmup = warmup if warmup == "async" else bool(warmup)
        self.name = str(name)
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        if kv_cache_dtype is None:
            kv_cache_dtype = str(_flags.get_flag("FLAGS_kv_cache_dtype"))
        self.kv_cache_dtype = kv_cache_dtype
        if prefix_cache_blocks is None:
            prefix_cache_blocks = _flags.get_flag("FLAGS_prefix_cache_blocks")
        self.prefix_cache_blocks = int(prefix_cache_blocks)
        if speculative_k is None:
            speculative_k = _flags.get_flag("FLAGS_speculative_k")
        self.speculative_k = int(speculative_k)
        self.spec_ngram = int(spec_ngram)


class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "top_k", "top_p",
                 "seed", "eos", "deadline", "budget", "future", "queue",
                 "tokens", "t_submit", "t_first", "t_last", "cancelled",
                 "finish_reason", "tenant", "priority", "blocks",
                 "cached_len", "parked", "ctx", "t_submit_ns")

    def __init__(self, prompt, max_new, temperature, top_k, top_p, seed,
                 eos, deadline, budget, ctx=None, tenant=None, priority=1):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.eos = eos
        self.deadline = deadline
        self.budget = budget
        self.future: Future = Future()
        self.queue: _queue.Queue = _queue.Queue()
        self.tokens: List[int] = []
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.cancelled = False
        # the request's trace context (profiler/rtrace.py), carried across
        # the submit -> scheduler -> stream thread hops; None when untraced
        self.ctx = ctx
        self.t_submit_ns = _tracer.now_ns() if ctx is not None else 0
        self.finish_reason: Optional[str] = None
        self.tenant: Optional[str] = tenant
        self.priority = int(priority)   # rank into admission.PRIORITIES
        self.blocks: List[int] = []     # paged: the KV blocks it holds
        self.cached_len = 0             # paged: the prefix-cache cover
        # while preempted to host memory: {"host": payload, "nblocks": n,
        # "pos": position, "last": last sampled token}; None otherwise
        self.parked: Optional[dict] = None

    @property
    def request_id(self) -> Optional[str]:
        return self.ctx.request_id if self.ctx is not None else None

    @property
    def priority_name(self) -> str:
        return PRIORITIES[self.priority]

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline


class GenerationStream:
    """Handle for one in-flight generation request.

    Iterate it to consume tokens as the engine emits them (it ends when
    the request finishes and raises the request's error if it failed), or
    call :meth:`result` to block for the whole generated sequence.
    ``cancel()`` retires the request at the next token boundary; the
    result is then the partial tokens."""

    def __init__(self, req: _GenRequest):
        self._req = req

    def __iter__(self):
        while True:
            item = self._req.queue.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Generated token ids (prompt excluded; eos, when hit, last)."""
        try:
            return self._req.future.result(timeout=timeout)
        except _FutureTimeout:
            if self._req.future.done():
                raise              # the request's own error (a deadline)
            raise DeadlineExceeded(
                f"no result within {timeout}s (generation may still be "
                "running; iterate the stream for partial tokens)") from None

    def cancel(self):
        self._req.cancelled = True

    @property
    def done(self) -> bool:
        return self._req.future.done()

    @property
    def ttft_s(self) -> Optional[float]:
        """Seconds from submit to the first sampled token (None before)."""
        r = self._req
        return None if r.t_first is None else r.t_first - r.t_submit

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason


def _check_swap_tree(live: Dict[str, object], new: Dict[str, object],
                     what: str):
    """A weight swap may never half-apply: the incoming tree must match
    the live one key for key in shape and dtype, checked before anything
    is touched (every captured graph binds the live tensors)."""
    missing = sorted(set(live) - set(new))
    extra = sorted(set(new) - set(live))
    if missing or extra:
        raise ValueError(
            f"swap_weights {what} tree mismatch: missing {missing[:3]}"
            f"{'...' if len(missing) > 3 else ''}, unexpected "
            f"{extra[:3]}{'...' if len(extra) > 3 else ''} — swap "
            "trees must match the served model exactly")
    for k, v in new.items():
        cur = live[k]
        if tuple(v.shape) != tuple(cur.shape) or \
                str(v.dtype) != str(cur.dtype):
            raise ValueError(
                f"swap_weights {what}[{k!r}]: incoming "
                f"{tuple(v.shape)}/{v.dtype} vs served "
                f"{tuple(cur.shape)}/{cur.dtype} — a shape/dtype "
                "change is a new artifact, not a hot-swap")


def _as_tensors(tree) -> Dict[str, object]:
    """``{name: tensor}`` of a tree of tensors or array-likes (numpy
    arrays are wrapped, not copied)."""
    import torch
    return {str(k): v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


class GenerationEngine:
    """Continuous batching over an autoregressive model at token
    boundaries (Orca-style); see the module docstring.

    Admission bounds the queue depth and the reserved tokens (prompt +
    max_new per request, returned at retirement) and, with
    ``tenant_quotas``, each tenant's token bucket.  :attr:`ready` is
    False while an ``"async"`` warmup runs and after :meth:`close`;
    :attr:`warmed_buckets` is the number of steps the warmup left
    captured.  :meth:`stats` reads the registry's ``<name>.*`` series
    beside this engine's own outcome counts (:attr:`counts`:
    ``completed``, ``cancelled``, ``failed``; the admission controller's;
    the session's ``prefill_steps`` / ``decode_steps``), which count this
    engine alone where the registry's are shared by every engine of one
    name."""

    def __init__(self, model,
                 config: Optional[GenerationEngineConfig] = None):
        self.config = cfg = config or GenerationEngineConfig()
        self.model = model
        self.metrics_prefix = p = cfg.name
        max_len = int(cfg.max_length or model.cfg.max_seq_len)
        self.session = self._make_session(model, cfg, max_len)
        self.max_length = self.session.max_length
        self.slots = self.session.batch_capacity
        self._admission = self._make_admission(cfg)
        self.counts: Counter = Counter()
        self._m_ttft = _metrics.histogram(
            f"{p}.ttft_ms", "time to first token (submit -> first "
            "sampled token)")
        self._m_itl = _metrics.histogram(
            f"{p}.inter_token_ms", "gap between consecutive streamed "
            "tokens of one request")
        self._m_occ = _metrics.histogram(
            f"{p}.decode.occupancy", "occupied slots per decode step")
        self._m_done = _metrics.counter(
            f"{p}.request.completed", "requests answered successfully")
        self._m_failed = _metrics.counter(
            f"{p}.request.failed", "requests completed exceptionally")
        self._m_cancelled = _metrics.counter(
            f"{p}.request.cancelled", "requests retired by client cancel "
            "(the result is the partial tokens; not counted as completed)")
        _metrics.gauge(f"{p}.slots", "decode slots").set(self.slots)
        self._init_slot_state()

        self._pending: deque = deque()
        # preempted to host memory (the paged engine only)
        self._parked: List[_GenRequest] = []
        # prefix chains to import and export on the scheduler thread at a
        # token boundary (the paged engine only)
        self._imports: List[dict] = []
        self._exports: List[dict] = []
        self._aging_s = float(cfg.aging_s)
        self._cond = _conc.Condition(name=f"{p}.genengine.cond")
        self._mlock = _conc.Lock(name=f"{p}.genengine.metrics")
        self._stop = False
        self._paused = False
        self._closed = False
        # a pending weight swap, applied by the scheduler between token
        # boundaries: (staged (live, new) pairs, done event, error holder)
        self._swap = None
        self.ready = False
        self.warmed_buckets = 0
        if cfg.warmup and cfg.warmup != "async":
            self._warmup()
        self.ready = cfg.warmup != "async"
        self._scheduler = _conc.spawn(self._loop,
                                      name="generation-scheduler")

    # -- construction hooks (PagedGenerationEngine overrides these) --------
    def _make_session(self, model, cfg: GenerationEngineConfig,
                      max_len: int):
        return GenerationSession(
            model, batch_capacity=cfg.max_slots, max_length=max_len,
            prompt_bucket_min=cfg.prompt_bucket_min, name=cfg.name)

    def _make_admission(self, cfg: GenerationEngineConfig
                        ) -> AdmissionController:
        budget = cfg.max_tokens_in_flight or self.slots * self.max_length
        return AdmissionController(cfg.max_queue, max_tokens=int(budget),
                                   name=cfg.name,
                                   quotas=self._make_quotas(cfg))

    @staticmethod
    def _make_quotas(cfg: GenerationEngineConfig):
        if not cfg.tenant_quotas:
            return None
        return TenantQuotaTable(cfg.tenant_quotas)

    def set_quotas(self, quotas) -> int:
        """Replace the per-tenant quota table (a dict of tenant ->
        ``{"rate": tokens/s, "burst": tokens}``, a built
        :class:`~paddle_tpu_torch.serving.admission.TenantQuotaTable`, or
        None to drop quotas).  Validated before it is published; bucket
        levels carry over, clamped to the new burst.  Returns the table's
        generation (the ``QuotaWatcher`` apply hook)."""
        return self._admission.set_quotas(quotas)

    def _init_slot_arrays(self):
        S = self.slots
        self._slot_req: List[Optional[_GenRequest]] = [None] * S
        self._positions = np.zeros((S,), np.int32)
        self._last_tok = np.zeros((S,), np.int32)
        self._seeds = np.zeros((S,), np.int64)
        self._temps = np.zeros((S,), np.float32)
        self._tks = np.zeros((S,), np.int32)
        self._tps = np.ones((S,), np.float32)

    def _init_slot_state(self):
        self._caches = self.session.init_caches()
        self._init_slot_arrays()
        if _memscope.active:
            self._note_memory_tags()

    # -- memory accounting ---------------------------------------------------
    def _kv_arena_bytes(self) -> int:
        """Device bytes of the KV store: the contiguous engine's per-slot
        caches (the paged engine's arenas in its override)."""
        return _memscope.tree_nbytes(getattr(self, "_caches", None))

    def _params_bytes(self) -> int:
        return _memscope.tree_nbytes(list(self.model.parameters())
                                     + list(self.model.buffers()))

    def _note_memory_tags(self):
        """Attribute this engine's exactly-known footprints to memscope's
        ``params`` and ``kv_arena`` tags (callers gate on its
        predicate)."""
        _memscope.set_tag_bytes("params", self._params_bytes())
        _memscope.set_tag_bytes("kv_arena", self._kv_arena_bytes())

    def memory_breakdown(self) -> Dict[str, int]:
        """Where the engine's device memory goes (the ``/healthz``
        fields): the parameters, the KV store, the prefix cache's share
        and, with memory accounting on, the process's peak."""
        return {
            "mem_params_bytes": self._params_bytes(),
            "mem_kv_arena_bytes": self._kv_arena_bytes(),
            "mem_prefix_cache_bytes": 0,
            "mem_peak_step_bytes":
                _memscope.peak_bytes() if _memscope.active else 0,
        }

    def _token_reservation(self, prompt, max_new: int) -> int:
        """Tokens reserved against the admission budget at submit: the
        contiguous engine's worst case, prompt + max_new (the paged engine
        reserves none: it admits by live block occupancy)."""
        return int(prompt.size) + int(max_new)

    def _set_slot_knobs(self, slot: int, req: _GenRequest):
        self._seeds[slot] = req.seed
        self._temps[slot] = req.temperature
        self._tks[slot] = req.top_k
        self._tps[slot] = req.top_p

    # -- warmup ------------------------------------------------------------
    def _warmup(self):
        """One prefill per prompt bucket with every row masked out, then
        one decode with ``live_rows=0``, over the engine's own caches:
        each step is captured (the session's executable cache).  The
        prefills leave the caches as they were, by construction; the
        decode writes at position 0 of every row while every row is free,
        and an admitted row's prefill rewrites the whole row.  A step that
        fails is reported in a warning and raises again at its first
        use."""
        from .bucketing import seq_buckets
        S = self.slots
        seeds = np.zeros((S,), np.int64)
        temps = np.zeros((S,), np.float32)
        tks = np.zeros((S,), np.int32)
        tps = np.ones((S,), np.float32)
        errors = []
        for pb in seq_buckets(self.max_length, self.config.prompt_bucket_min):
            try:
                self.session.prefill(
                    self._caches, np.zeros((S, pb), np.int32),
                    np.ones((S,), np.int32), np.zeros((S,), bool), seeds,
                    temps, tks, tps)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((f"prefill:{pb}", e))
        try:
            self.session.decode(self._caches, np.zeros((S,), np.int32),
                                np.zeros((S,), np.int32), seeds, temps, tks,
                                tps, live_rows=0)
        except Exception as e:      # noqa: BLE001
            errors.append(("decode", e))
        self._finish_warmup(errors)

    def _finish_warmup(self, errors):
        if errors:
            import warnings
            warnings.warn(
                f"{type(self).__name__} warmup failed for {len(errors)} "
                f"step(s) (first: {errors[0][0]}: {errors[0][1]!r}); they "
                "capture again at first use", RuntimeWarning, stacklevel=3)
        self.warmed_buckets = len(self.session._cache)
        _metrics.gauge(
            f"{self.metrics_prefix}.decode_warmed_buckets",
            "prefill/decode steps captured by the engine's warmup"
            ).set(self.warmed_buckets)

    # -- client surface --------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               do_sample: bool = False, temperature: float = 1.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               eos_token_id: Optional[int] = None,
               deadline_ms="default", trace_ctx=None,
               tenant: Optional[str] = None,
               priority: Optional[str] = None) -> GenerationStream:
        """Enqueue one prompt; returns a :class:`GenerationStream`.
        Raises :class:`RequestRejected` at admission (``queue_full``,
        ``token_budget``, ``too_large``, ``tenant_quota``, ``closed``);
        the ``serve.request`` chaos site can fail or delay here.
        ``priority`` is one of ``admission.PRIORITIES``
        (``"interactive"`` < ``"standard"``, the default, < ``"batch"``)
        and orders dequeue, with aging; ``tenant`` charges the request's
        prompt + max_new tokens to that tenant's bucket (when quotas are
        set) and labels its per-tenant counters; ``trace_ctx`` (an
        ``rtrace.TraceContext``) makes every hop of the request emit
        request-scoped spans."""
        prompt = np.asarray(prompt).reshape(-1).astype(np.int32)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.config.max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rank = priority_rank(priority)      # ValueError on an unknown class
        traced = trace_ctx is not None and _rtrace.active
        t_adm = _tracer.now_ns() if traced else 0
        budget = self._token_reservation(prompt, max_new)
        # a tenant's bucket drains by what the request can consume,
        # whatever the engine reserves (the paged engine reserves 0)
        quota_cost = int(prompt.size) + max_new
        try:
            if prompt.size >= self.max_length:
                self._admission.reject(
                    "too_large", f"prompt of {prompt.size} tokens leaves no "
                    f"room in the {self.max_length}-slot KV cache",
                    tenant=tenant, priority=PRIORITIES[rank])
            from ..utils import chaos as _chaos
            if _chaos.active:
                _chaos.hit("serve.request")
            self._admission.acquire(tokens=budget, tenant=tenant,
                                    priority=PRIORITIES[rank],
                                    quota_tokens=quota_cost)
        except RequestRejected as e:
            if traced:
                # a rejected request still leaves a terminated span with
                # the verdict
                trace_ctx.record("admission", t_adm, outcome=e.reason,
                                 terminated=True)
            raise
        except Exception as e:
            if traced:
                trace_ctx.record("admission", t_adm,
                                 outcome=type(e).__name__, terminated=True)
            raise
        if traced:
            trace_ctx.record("admission", t_adm, outcome="admitted")
        if deadline_ms == "default":
            deadline_ms = self.config.deadline_ms
        req = _GenRequest(prompt, max_new,
                          float(temperature) if do_sample else 0.0,
                          int(top_k), float(top_p), int(seed), eos_token_id,
                          deadline_from_ms(deadline_ms), budget,
                          ctx=trace_ctx, tenant=tenant, priority=rank)
        with self._cond:
            if self._closed:
                self._admission.release()
                self._admission.release_tokens(budget)
                if traced:
                    trace_ctx.record("queue_wait", req.t_submit_ns,
                                     outcome="closed", terminated=True)
                raise EngineClosed()
            self._pending.append(req)
            self._cond.notify()
        return GenerationStream(req)

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kw) -> np.ndarray:
        """Blocking submit: the whole generated sequence."""
        return self.submit(prompt, **kw).result(timeout=timeout)

    # -- operations ----------------------------------------------------------
    def pause(self):
        """Stop taking queued requests into slots (running slots keep
        decoding); admission keeps filling the queue up to its bounds,
        then sheds."""
        with self._cond:
            self._paused = True

    def resume(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def stats(self) -> Dict[str, object]:
        """The registry's ``<name>.*`` entries, then this engine's own
        outcome counts (see the class docstring)."""
        prefix = self.metrics_prefix + "."
        out: Dict[str, object] = {
            k: v for k, v in _metrics.snapshot().items()
            if k.startswith(prefix)}
        out.update(self.counts)
        out.update(self._admission.counts)
        out["prefill_steps"] = self.session.steps["prefill"]
        out["decode_steps"] = self.session.steps["decode"]
        return out

    @property
    def occupancy(self) -> int:
        """Occupied decode slots."""
        return sum(1 for r in self._slot_req if r is not None)

    @property
    def parked(self) -> int:
        """Requests preempted to host memory (always 0 on the contiguous
        engine)."""
        return len(self._parked)

    def swap_weights(self, params, buffers=None, *,
                     timeout: float = 60.0):
        """Replace the model's weights between two engine steps, with no
        restart and no capture.

        ``params`` (and ``buffers``) map the model's ``named_parameters``
        (``named_buffers``) names — its ``state_dict`` names — to tensors
        or arrays; a reference tree goes through
        ``models.gpt_state_from_paddle_tpu`` first.  The tree is checked
        key for key, shape and dtype, before anything is touched (a
        mismatch raises ``ValueError`` and the live weights stay), then
        staged on the model's device.  The scheduler copies the staged
        tensors into the live ones at the next token boundary (at once
        when idle): running streams finish their current step on the old
        weights and keep their slots and caches, and every later prefill
        and decode replays its captured graph over the new ones.  Blocks
        until the swap is applied; raises the application's error if it
        failed.  The flight recorder's ``serve.weights_swap`` event
        carries the staging's and the wait's milliseconds."""
        import torch
        t0 = time.perf_counter()
        live_p = dict(self.model.named_parameters())
        new_p = _as_tensors(params)
        _check_swap_tree(live_p, new_p, "params")
        pairs = [(live_p[k], v) for k, v in new_p.items()]
        if buffers is not None:
            live_b = dict(self.model.named_buffers())
            new_b = _as_tensors(buffers)
            _check_swap_tree(live_b, new_b, "buffers")
            pairs += [(live_b[k], v) for k, v in new_b.items()]
        # stage on the device under the session's lock: no graph is being
        # captured meanwhile, and the copy the boundary waits on is
        # device to device
        with self.session._lock, torch.no_grad():
            staged = [(live, torch.empty_like(live).copy_(new))
                      for live, new in pairs]
            dev = self.session.device
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        t1 = time.perf_counter()
        done = threading.Event()
        holder: Dict[str, BaseException] = {}
        with self._cond:
            if self._closed:
                raise EngineClosed()
            if self._swap is not None:
                raise RuntimeError("another weight swap is already pending")
            self._swap = (staged, done, holder)
            self._cond.notify_all()
        if not done.wait(timeout):
            with self._cond:
                if self._swap is not None and self._swap[1] is done:
                    # withdrawn before the scheduler claimed it: it will
                    # never apply
                    self._swap = None
                    raise TimeoutError(
                        f"weight swap not applied within {timeout}s "
                        "(scheduler wedged mid-step?)")
            # the scheduler claimed it while we timed out: it is applying
            # now, so wait that out rather than report the old weights live
            if not done.wait(timeout):
                raise TimeoutError(
                    f"weight swap claimed by the scheduler but not applied "
                    f"within another {timeout}s")
        err = holder.get("error")
        if err is not None:
            raise err
        with self._mlock:
            _metrics.counter(f"{self.metrics_prefix}.weight_swaps",
                             "weight swaps applied").inc()
        if _flight.active:
            _flight.note("serve", "weights_swap", engine=self.metrics_prefix,
                         stage_ms=(t1 - t0) * 1e3,
                         wait_ms=(time.perf_counter() - t1) * 1e3)

    def _apply_swap(self):
        """The scheduler's side of :meth:`swap_weights`, between token
        boundaries: copy the staged tensors into the live ones in place
        (the captured graphs read the live tensors' memory)."""
        import torch
        with self._cond:
            swap, self._swap = self._swap, None
        if swap is None:
            return
        staged, done, holder = swap
        try:
            with torch.no_grad():
                for live, new in staged:
                    live.copy_(new)
        except BaseException as e:     # noqa: BLE001 — raised to the caller
            holder["error"] = e
        finally:
            done.set()

    def _drain_swap(self, exc: BaseException):
        """Resolve a swap the scheduler will never apply (the engine is
        closing), so its caller's wait cannot hang."""
        with self._cond:
            swap, self._swap = self._swap, None
        if swap is not None:
            swap[2]["error"] = exc
            swap[1].set()

    def close(self, timeout: Optional[float] = 60.0):
        """Reject new work, let queued and running requests finish, and
        join the scheduler thread."""
        self.ready = False
        self._admission.close()
        with self._cond:
            if not self._closed:
                self._closed = True
                self._stop = True
                self._paused = False
                self._cond.notify_all()
        self._scheduler.join(timeout=timeout)
        if self._scheduler.is_alive():
            raise TimeoutError(f"generation scheduler still running after "
                               f"{timeout}s")
        self._drain_swap(EngineClosed())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler ---------------------------------------------------------
    def _occupied(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is not None]

    def _busy(self) -> bool:
        return bool(self._pending or self._parked or self._occupied())

    def _idle(self) -> bool:
        """Nothing for the scheduler to do (the caller holds ``_cond``):
        no swap or transfer queued, and no work, or paused with no
        running slot."""
        if self._swap is not None or self._imports or self._exports:
            return False
        if self._stop:
            return False
        return not self._busy() or (self._paused and not self._occupied())

    def _loop(self):
        if self.config.warmup == "async":
            try:
                self._warmup()
            finally:
                self.ready = not self._closed
        while True:
            with self._cond:
                while self._idle():
                    self._cond.wait()
                if self._stop and not self._busy():
                    break
            if self._swap is not None:
                # between boundaries by construction: the last step has
                # returned, the next has not started
                self._apply_swap()
                continue
            try:
                self._admit()
                occ = self._occupied()
                if occ:
                    self._decode_round(occ)
            except Exception as e:  # noqa: BLE001 — fail everything in flight
                self._fail_all(e)

    def _trace_boundary(self, name: str, t0: int, t1: int,
                        slots: List[int], **fields):
        """Request-trace accounting for one batched step: ONE
        ``batch::<name>`` span linked to every traced member's root, and
        a ``<name>`` span per member pointing back at it.  Callers gate
        on ``_rtrace.active``."""
        ctxs, reqs = [], []
        for s in slots:
            r = self._slot_req[s]
            if r is not None and r.ctx is not None:
                ctxs.append(r.ctx)
                reqs.append((s, r))
        if not ctxs:
            return
        bspan = _rtrace.batch_span(f"batch::{name}", t0, t1, ctxs,
                                   **fields)
        for s, r in reqs:
            r.ctx.record(name, t0, t1, batch_span=bspan, slot=s,
                         position=int(self._positions[s]))

    def _decode_round(self, occ: List[int]):
        """One token boundary: one decode step for every occupied slot."""
        t0 = _tracer.now_ns() if _rtrace.active else 0
        tok, self._caches = self.session.decode(
            self._caches, self._last_tok, self._positions, self._seeds,
            self._temps, self._tks, self._tps, live_rows=len(occ))
        if t0:
            self._trace_boundary("decode", t0, _tracer.now_ns(), occ,
                                 occupancy=len(occ))
        with self._mlock:
            self._m_occ.observe(len(occ))
        self._positions = self._positions + 1
        self._last_tok = np.array(tok, np.int32)
        for s in occ:
            self._emit(s, int(tok[s]))

    def _pop_pending(self) -> _GenRequest:
        """Priority-ordered dequeue with bounded aging (the caller holds
        ``_cond``; ``_pending`` is not empty).  The effective rank is
        ``max(0, rank - waited // aging_s)``: a batch request climbs one
        class per ``aging_s`` seconds queued; ties go by queue position."""
        aging = self._aging_s
        now = time.monotonic() if aging > 0 else 0.0
        best_i, best_key = 0, None
        for i, r in enumerate(self._pending):
            eff = r.priority
            if aging > 0:
                eff = max(0, eff - int((now - r.t_submit) / aging))
            key = (eff, i)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        req = self._pending[best_i]
        del self._pending[best_i]
        return req

    def _take_pending(self) -> List[Tuple[int, _GenRequest]]:
        """Queued requests for the free slots, in dequeue order; the
        expired ones are shed and the cancelled ones retired.  Nothing
        while paused."""
        took: List[Tuple[int, _GenRequest]] = []
        with self._cond:
            if self._paused:
                return took
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            while self._pending and free:
                req = self._pop_pending()
                self._admission.release()
                if req.expired():
                    self._shed(req)
                    continue
                if req.cancelled:
                    self._retire(req, slot=None)
                    continue
                took.append((free.pop(0), req))
        return took

    def _admit(self):
        """Move queued requests into free slots, grouped per prompt
        bucket, one masked prefill per group."""
        took = self._take_pending()
        if not took:
            return
        groups: Dict[int, List[Tuple[int, _GenRequest]]] = {}
        for slot, req in took:
            pb = self.session.prompt_bucket(len(req.prompt))
            groups.setdefault(pb, []).append((slot, req))
        S = self.slots
        for pb, members in sorted(groups.items()):
            ids = np.zeros((S, pb), np.int32)
            plens = np.ones((S,), np.int32)
            mask = np.zeros((S,), bool)
            for slot, req in members:
                n = len(req.prompt)
                ids[slot, :n] = req.prompt
                plens[slot] = n
                mask[slot] = True
                self._slot_req[slot] = req
                self._set_slot_knobs(slot, req)
                self._note_slot_admit(slot, req)
            t0 = _tracer.now_ns() if _rtrace.active else 0
            tok, self._caches = self.session.prefill(
                self._caches, ids, plens, mask, self._seeds, self._temps,
                self._tks, self._tps)
            if t0:
                self._trace_boundary("prefill", t0, _tracer.now_ns(),
                                     [s for s, _r in members], bucket=pb)
            for slot, req in members:
                self._positions[slot] = plens[slot]
                self._last_tok[slot] = tok[slot]
                self._emit(slot, int(tok[slot]))

    def _note_slot_admit(self, slot: int, req: _GenRequest):
        """The queue-wait span and the flight event of a request entering
        a decode slot."""
        if req.ctx is not None and _rtrace.active:
            req.ctx.record("queue_wait", req.t_submit_ns, slot=slot)
        if _flight.active:
            _flight.note("serve", "slot_admit", engine=self.metrics_prefix,
                         slot=slot, request=req.request_id,
                         prompt=int(req.prompt.size))

    def _emit(self, slot: int, tok: int):
        req = self._slot_req[slot]
        if req is None:
            return
        # the step's tokens are on the host already: a host clock read, no
        # device sync
        now = time.monotonic()
        with self._mlock:
            if req.t_first is None:
                req.t_first = now
                self._m_ttft.observe((now - req.t_submit) * 1e3)
            else:
                self._m_itl.observe((now - req.t_last) * 1e3)
        req.t_last = now
        req.tokens.append(tok)
        req.queue.put(tok)
        hit_eos = req.eos is not None and tok == int(req.eos)
        out_of_room = self._positions[slot] + 1 >= self.max_length
        budget_done = len(req.tokens) >= req.max_new
        if hit_eos or req.cancelled or out_of_room or budget_done:
            req.finish_reason = (
                "cancelled" if req.cancelled else
                "eos" if hit_eos else
                "cache_full" if out_of_room and not budget_done else
                "max_new_tokens")
            self._retire(req, slot)

    def _release_resources(self, req: _GenRequest):
        """Every way a request leaves the engine (finish, cancel, deadline
        or block-pool shed, engine failure) returns what it holds here:
        its token reservation, and in the paged engine its KV blocks."""
        self._admission.release_tokens(req.budget)

    def _note_tenant(self, req: _GenRequest, what: str, n: int = 1,
                     latency_ms: Optional[float] = None):
        """One count on ``<name>.tenant.<tenant>.<what>`` (and, given,
        one observation of the tenant's ``latency_ms``); nothing for a
        request without a tenant.  Callers must not hold ``_mlock``."""
        if req.tenant is None:
            return
        base = f"{self.metrics_prefix}.tenant.{req.tenant}"
        with self._mlock:
            _metrics.counter(f"{base}.{what}",
                             f"per-tenant {what} (requests or tokens)"
                             ).inc(n)
            if latency_ms is not None:
                _metrics.histogram(
                    f"{base}.latency_ms",
                    "per-tenant end-to-end request latency"
                    ).observe(latency_ms)

    def _retire(self, req: _GenRequest, slot: Optional[int]):
        if slot is not None:
            self._slot_req[slot] = None
        self._release_resources(req)
        if _flight.active:
            _flight.note("serve", "slot_retire", engine=self.metrics_prefix,
                         slot=slot, request=req.request_id,
                         reason=req.finish_reason or (
                             "cancelled" if req.cancelled else "done"),
                         tokens=len(req.tokens))
        if not req.future.done():
            req.future.set_result(np.asarray(req.tokens, np.int32))
            with self._mlock:
                if req.cancelled:
                    self.counts["cancelled"] += 1
                    self._m_cancelled.inc()
                else:
                    self.counts["completed"] += 1
                    self._m_done.inc()
            if not req.cancelled:
                self._note_tenant(
                    req, "completed",
                    latency_ms=(time.monotonic() - req.t_submit) * 1e3)
                self._note_tenant(req, "tokens_out", len(req.tokens))
        req.queue.put(None)

    def _shed(self, req: _GenRequest):
        self._admission.shed_deadline()
        self._note_tenant(req, "shed")
        self._release_resources(req)
        if req.ctx is not None and _rtrace.active:
            req.ctx.record("queue_wait", req.t_submit_ns,
                           outcome="shed_deadline", terminated=True)
        exc = DeadlineExceeded("request deadline expired while queued")
        if not req.future.done():
            req.future.set_exception(exc)
        req.queue.put(exc)

    def _fail_all(self, exc: BaseException):
        with self._cond:
            pending = list(self._pending)
            self._pending.clear()
            parked, self._parked = list(self._parked), []
        for _ in pending:
            self._admission.release()
        for r in parked:
            r.parked = None                 # drop the host-side payload
        victims = pending + parked + [r for r in self._slot_req
                                      if r is not None]
        self._slot_req = [None] * self.slots
        if _memscope.active and _memscope.is_oom(exc):
            # forensics before the victims fail with the original error
            _memscope.oom_dump(
                exc, context=f"engine:{self.metrics_prefix}",
                pool=getattr(self, "pool", None),
                prefix_cache=getattr(self, "prefix_cache", None))
        if _flight.active:
            _flight.note("serve", "engine_failure",
                         engine=self.metrics_prefix,
                         error=f"{type(exc).__name__}: {exc}",
                         victims=len(victims))
            _flight.dump(reason="engine-failure")
        for req in victims:
            self._release_resources(req)
            if req.ctx is not None and _rtrace.active:
                req.ctx.record("failed", req.t_submit_ns,
                               outcome=type(exc).__name__, terminated=True)
            if not req.future.done():
                req.future.set_exception(exc)
                with self._mlock:
                    self.counts["failed"] += 1
                    self._m_failed.inc()
            req.queue.put(exc)


# ---------------------------------------------------------------------------
# the paged KV engine: block-pool continuous batching
# ---------------------------------------------------------------------------
class PagedGenerationEngine(GenerationEngine):
    """:class:`GenerationEngine` over the paged KV cache
    (``generation/paged_kv.py``): the same scheduler and client surface,
    but KV memory is a shared refcounted block pool instead of one
    worst-case cache per slot.

    - **Admission** by live block occupancy: ``submit`` reserves nothing,
      blocks are allocated as each request grows, and a pool that cannot
      supply a block sheds the request with a typed
      ``RequestRejected(reason="kv_blocks")`` (the ``kv.block_alloc``
      chaos site injects exactly this), or first preempts a live stream
      of a strictly lower priority class to host memory: its blocks are
      swapped out, freed, and swapped back into fresh blocks when the
      pool refills, and the stream resumes bit for bit (``serve.preempt``
      chaos site; ``<name>.request.preempted`` / ``.resumed``,
      ``<name>.requests_parked``).
    - **Prefix cache** (``prefix_cache_blocks``): a prompt sharing a
      prefix with an earlier one prefills only its uncached suffix at its
      true offset; a shared partial block is copied before a request
      appends into it (one batched ``copy_blocks`` per admission round).
    - **int8 KV** (``kv_cache_dtype='int8'``): blocks in int8 with
      per-token-per-head fp32 scales, about 3.8x fewer bytes per token.
    - **Speculative decoding** (``speculative_k > 0``): the n-gram
      prompt-lookup drafter proposes up to k tokens per boundary and one
      verify step commits the longest prefix the model's own sampler
      agrees with; streams equal non-speculative ones
      (``<name>.spec.proposed`` / ``.accepted``, ``.spec.accept_rate``).

    The captured steps stay bounded: block tables and pool state are step
    data, never part of a key; one chunk per suffix bucket and route
    (``pchunk0`` for fresh fp32 prefills, ``pchunk`` for offset chunks,
    captured at warmup only when the prefix cache is on or the arenas are
    int8), the width-1 decode and the verify width.
    """

    # -- construction hooks ------------------------------------------------
    def _make_session(self, model, cfg: GenerationEngineConfig,
                      max_len: int):
        from ..generation import PagedGenerationSession
        return PagedGenerationSession(
            model, batch_capacity=cfg.max_slots, max_length=max_len,
            block_size=cfg.block_size, num_blocks=cfg.num_blocks,
            kv_dtype=cfg.kv_cache_dtype,
            prompt_bucket_min=cfg.prompt_bucket_min, name=cfg.name)

    def _make_admission(self, cfg: GenerationEngineConfig
                        ) -> AdmissionController:
        # no token budget: queue depth at submit, then live block-pool
        # occupancy at allocation
        return AdmissionController(cfg.max_queue, max_tokens=None,
                                   name=cfg.name,
                                   quotas=self._make_quotas(cfg))

    def _token_reservation(self, prompt, max_new: int) -> int:
        return 0

    def _init_slot_state(self):
        from ..generation import BlockPool, PrefixCache
        cfg, ses = self.config, self.session
        self._init_slot_arrays()
        self._arenas = ses.init_arenas()
        self._table = np.full((self.slots, ses.blocks_per_slot), -1,
                              np.int32)
        self.pool = BlockPool(ses.num_blocks, ses.block_size, name=cfg.name)
        self.pool.block_bytes = ses.arena_bytes_per_block()
        self.prefix_cache = PrefixCache(self.pool, cfg.prefix_cache_blocks,
                                        name=cfg.name)
        self.speculative_k = max(int(cfg.speculative_k), 0)
        p = cfg.name
        self._m_spec_proposed = _metrics.counter(
            f"{p}.spec.proposed", "draft tokens proposed by the "
            "prompt-lookup drafter")
        self._m_spec_accepted = _metrics.counter(
            f"{p}.spec.accepted", "draft tokens the verify step accepted")
        self._g_spec_rate = _metrics.gauge(
            f"{p}.spec.accept_rate", "accepted/proposed draft ratio "
            "(the metric's lifetime)")
        self._m_preempted = _metrics.counter(
            f"{p}.request.preempted", "decode slots preempted to host "
            "memory under block-pool pressure")
        self._m_resumed = _metrics.counter(
            f"{p}.request.resumed", "preempted requests swapped back into "
            "a decode slot")
        self._g_parked = _metrics.gauge(
            f"{p}.requests_parked", "requests swapped out to host memory "
            "awaiting blocks")
        if _memscope.active:
            self._note_memory_tags()

    def _kv_arena_bytes(self) -> int:
        """The arenas' device bytes, the sink block included."""
        return _memscope.tree_nbytes(getattr(self, "_arenas", None))

    def memory_breakdown(self) -> Dict[str, int]:
        out = super().memory_breakdown()
        out["mem_prefix_cache_bytes"] = \
            len(self.prefix_cache) * int(self.pool.block_bytes)
        return out

    def _warmup(self):
        """Every chunk width captured over the engine's own arenas with an
        all-``-1`` table and zero feeds, so every write lands in the sink:
        the fresh route per prompt bucket (fp32), the offset route per
        bucket (int8, or when the prefix cache is on), the width-1 decode,
        and the verify width when speculative decoding is on."""
        from .bucketing import seq_buckets
        ses, S = self.session, self.slots
        seeds = np.zeros((S,), np.int64)
        temps = np.zeros((S,), np.float32)
        tks = np.zeros((S,), np.int32)
        tps = np.ones((S,), np.float32)
        zeros = np.zeros((S,), np.int32)
        table = np.full((S, ses.blocks_per_slot), -1, np.int32)
        offset = ses.quantized or self.config.prefix_cache_blocks > 0
        errors = []
        for pb in seq_buckets(self.max_length, self.config.prompt_bucket_min):
            routes = [] if ses.quantized else [zeros]
            if offset:
                routes.append(np.ones((S,), np.int32))
            for starts in routes:
                try:
                    ses.prefill(self._arenas, table,
                                np.zeros((S, pb), np.int32), starts, zeros,
                                seeds, temps, tks, tps, live_rows=0)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append((f"pchunk:{pb}", e))
        try:
            ses.decode(self._arenas, table, zeros, zeros, seeds, temps, tks,
                       tps, live_rows=0)
        except Exception as e:      # noqa: BLE001
            errors.append(("pchunk:1", e))
        if self.speculative_k > 0:
            W = self.speculative_k + 1
            try:
                ses.verify(self._arenas, table, np.zeros((S, W), np.int32),
                           zeros, zeros, seeds, temps, tks, tps,
                           live_rows=0)
            except Exception as e:  # noqa: BLE001
                errors.append((f"pverify:{W}", e))
        self._finish_warmup(errors)

    # -- block accounting --------------------------------------------------
    def _release_resources(self, req: _GenRequest):
        """The token reservation (none) and every KV block the request
        holds, in one place."""
        super()._release_resources(req)
        if req.blocks:
            self.pool.decref(req.blocks)
            req.blocks = []

    # -- prefix-chain export and import (on the scheduler thread) ----------
    def _hand_to_scheduler(self, queue: List[dict], item: dict,
                           timeout: Optional[float], what: str):
        with self._cond:
            if self._closed or self._stop:
                raise EngineClosed("generation engine is closed")
            queue.append(item)
            self._cond.notify_all()
        if not item["done"].wait(timeout):
            raise TimeoutError(f"KV chain {what} timed out")
        if item["error"] is not None:
            raise item["error"]

    def export_prefix_chain(self, tokens,
                            timeout: Optional[float] = 300.0
                            ) -> Optional[bytes]:
        """This engine's longest cached prefix chain for ``tokens`` as a
        ``kv_wire`` blob (``None`` on a cache miss).  The lookup, the
        gather and the copy to host memory run on the scheduler thread at
        a token boundary, as every card launch does; this call waits for
        them."""
        item = {"tokens": np.ascontiguousarray(tokens, np.int32).reshape(-1),
                "done": threading.Event(), "error": None, "blob": None}
        self._hand_to_scheduler(self._exports, item, timeout, "export")
        return item["blob"]

    def _apply_exports(self):
        from ..generation import kv_wire
        while True:
            with self._cond:
                if not self._exports:
                    return
                item = self._exports.pop(0)
            chain = []
            try:
                toks = item["tokens"]
                chain, covered = self.prefix_cache.lookup(toks)
                if chain:
                    payload = self.session.swap_out_blocks(self._arenas,
                                                           chain)
                    item["blob"] = kv_wire.serialize_chain(
                        toks[:covered], covered, self.session.block_size,
                        payload)
            except BaseException as e:  # noqa: BLE001 — faults the caller
                item["error"] = e
            finally:
                if chain:
                    self.pool.decref(chain)
                item["done"].set()

    def import_prefix_chain(self, blob: bytes,
                            timeout: Optional[float] = 300.0) -> int:
        """Verify a ``kv_wire`` blob, allocate blocks for it, and have the
        scheduler thread write it into the arenas and offer it to the
        prefix cache at the next token boundary.  Returns the covered
        token count; later prompts sharing the prefix hit the cache as if
        this engine had prefilled it.  Raises ``KVTransferCorrupt`` on a
        bad blob (nothing adopted), ``BlockPoolExhausted`` when the pool
        cannot hold the chain, :class:`EngineClosed` on a closed engine."""
        from ..generation import blocks_for_tokens, kv_wire
        doc = kv_wire.deserialize_chain(
            blob, expect_block_size=self.session.block_size,
            expect_spec=self.session.block_spec(self._arenas))
        blocks = self.pool.alloc(blocks_for_tokens(doc["covered"],
                                                   self.session.block_size))
        item = {"tokens": doc["tokens"], "covered": doc["covered"],
                "blocks": blocks, "payload": doc["payload"],
                "done": threading.Event(), "error": None}
        try:
            self._hand_to_scheduler(self._imports, item, timeout, "import")
        except EngineClosed:
            self.pool.decref(blocks)
            raise
        return item["covered"]

    def _apply_imports(self):
        """Adopt queued chains: write each payload into its blocks, then
        offer the chain to the prefix cache (which takes its own holds).
        The import's own hold goes either way, so retained blocks end at
        the cache's refcount and duplicates free at once."""
        while True:
            with self._cond:
                if not self._imports:
                    return
                item = self._imports.pop(0)
            try:
                self.session.swap_in_blocks(self._arenas, item["blocks"],
                                            item["payload"])
                self.prefix_cache.insert(item["tokens"], item["blocks"])
                if _flight.active:
                    _flight.note("kv", "chain_import",
                                 engine=self.metrics_prefix,
                                 covered=int(item["covered"]),
                                 blocks=len(item["blocks"]))
            except BaseException as e:  # noqa: BLE001 — faults the importer
                item["error"] = e
            finally:
                self.pool.decref(item["blocks"])
                item["done"].set()

    def _drain_transfers(self, exc: BaseException):
        """Fail every queued import and export (close, loop failure):
        release the imports' holds and wake the callers."""
        with self._cond:
            imports, self._imports = list(self._imports), []
            exports, self._exports = list(self._exports), []
        for item in imports:
            self.pool.decref(item["blocks"])
        for item in imports + exports:
            item["error"] = exc
            item["done"].set()

    # -- slots ---------------------------------------------------------------
    def _prepare_slot(self, slot: int, req: _GenRequest):
        """Prefix-cache lookup, block allocation and copy-on-write for one
        admitted request; fills the slot's table row.  Returns the
        request's copy-on-write ``(src, dst)`` pair or None (the caller
        batches a round's pairs into one ``copy_blocks``).  Raises
        :class:`BlockPoolExhausted` with every transferred hold
        returned."""
        from ..generation import BlockPoolExhausted, blocks_for_tokens
        bs = self.session.block_size
        plen = int(req.prompt.size)
        chain, cached_len = self.prefix_cache.lookup(req.prompt)
        # feed at least one token: the chunk samples the token after each
        # row's window, so a fully cached prompt still feeds its last token
        cached = min(cached_len, plen - 1)
        fb = cached // bs                   # the first block the row writes
        try:
            fresh = self.pool.alloc(blocks_for_tokens(plen, bs) - fb)
        except BlockPoolExhausted:
            if chain:
                self.pool.decref(chain)
            raise
        row = chain[:fb] + fresh
        cow = None
        if fb < len(chain):
            # the write starts inside a shared cached block: copy it into
            # the row's first fresh block, and return the shared holds the
            # row no longer uses
            cow = (chain[fb], fresh[0])
            self.pool.decref(chain[fb:])
        req.blocks = row
        req.cached_len = cached
        self._table[slot, :] = -1
        self._table[slot, :len(row)] = row
        self._slot_req[slot] = req
        self._set_slot_knobs(slot, req)
        return cow

    def _ensure_blocks(self, slot: int, req: _GenRequest, upto_pos: int):
        """Grow the slot's table to cover writes through ``upto_pos``
        (lazy growth at decode).  Raises :class:`BlockPoolExhausted`."""
        from ..generation import blocks_for_tokens
        need = blocks_for_tokens(int(upto_pos) + 1, self.session.block_size)
        have = len(req.blocks)
        if need <= have:
            return
        if _rtrace.active and req.ctx is not None:
            # the pool's exhaustion events carry the request's identity
            _rtrace.set_current(req.ctx)
        try:
            fresh = self.pool.alloc(need - have)
        finally:
            if _rtrace.active:
                _rtrace.set_current(None)
        req.blocks.extend(fresh)
        self._table[slot, have:have + len(fresh)] = fresh

    def _shed_kv(self, req: _GenRequest, slot: Optional[int], cause):
        """Pool exhaustion (organic or injected): shed the request with the
        typed error; the live batch never sees a partial allocation."""
        self._admission.shed_kv_blocks()
        if slot is not None:
            self._slot_req[slot] = None
            self._table[slot, :] = -1
        if _memscope.active:
            # what filled the pool, even though the shed is graceful (one
            # artifact per process; the flight event fires every time)
            _memscope.oom_dump(
                cause if isinstance(cause, BaseException)
                else RuntimeError(str(cause)),
                context=f"kv_shed:{self.metrics_prefix}",
                pool=self.pool, prefix_cache=self.prefix_cache)
        if _flight.active:
            _flight.note("serve", "kv_shed", engine=self.metrics_prefix,
                         slot=slot, request=req.request_id,
                         cause=str(cause))
        if req.ctx is not None and _rtrace.active:
            req.ctx.record("shed", req.t_submit_ns, outcome="kv_blocks",
                           terminated=True)
        self._note_tenant(req, "shed")
        self._release_resources(req)
        exc = RequestRejected(
            f"paged KV block pool exhausted ({cause}); request shed — "
            "retry when running generations free blocks, or provision "
            "more num_blocks", reason="kv_blocks")
        if not req.future.done():
            req.future.set_exception(exc)
        req.queue.put(exc)

    # -- preemption to host memory ----------------------------------------
    def _pick_victim(self, max_rank: int,
                     exclude: Optional[int] = None) -> Optional[int]:
        """The live slot to preempt for a rank-``max_rank`` requester:
        strictly lower priority only, the lowest class first, then the slot
        holding the most blocks, then the lowest slot index."""
        best, best_key = None, None
        for s, r in enumerate(self._slot_req):
            if r is None or s == exclude or r.priority <= max_rank:
                continue
            if not r.tokens:
                # placed this round but not prefilled yet: no valid state
                continue
            key = (-r.priority, -len(r.blocks), s)
            if best_key is None or key < best_key:
                best, best_key = s, key
        return best

    def _preempt_for(self, req: _GenRequest,
                     exclude: Optional[int] = None) -> bool:
        """Free blocks for ``req`` by preempting one strictly lower-priority
        live slot to host memory; False when there is none."""
        victim = self._pick_victim(req.priority, exclude=exclude)
        if victim is None:
            return False
        self._preempt_slot(victim)
        return True

    def _preempt_slot(self, slot: int):
        """Swap one live slot out to host memory: copy its blocks out (the
        call returns once the copies landed), park the request with its
        position and last token, and free the blocks.  The noise is keyed
        on (seed, position) and both the position and the KV bytes come
        back verbatim, so the stream resumes bit for bit."""
        req = self._slot_req[slot]
        from ..utils import chaos as _chaos
        if _chaos.active:
            try:
                _chaos.hit("serve.preempt")
            except Exception as e:  # noqa: BLE001 — an injected swap failure
                # shed the victim typed rather than park state that was
                # not captured
                self._shed_kv(req, slot, e)
                return
        nblocks = len(req.blocks)
        pos = int(self._positions[slot])
        host = self.session.swap_out_blocks(self._arenas, req.blocks)
        req.parked = {"host": host, "nblocks": nblocks, "pos": pos,
                      "last": int(self._last_tok[slot])}
        self._slot_req[slot] = None
        self._table[slot, :] = -1
        self._release_resources(req)        # frees the device blocks
        with self._cond:
            self._parked.append(req)
        with self._mlock:
            self._m_preempted.inc()
            self._g_parked.set(len(self._parked))
        self._note_tenant(req, "preempted")
        if _flight.active:
            _flight.note("serve", "preempt", engine=self.metrics_prefix,
                         slot=slot, request=req.request_id,
                         tenant=req.tenant, priority=req.priority_name,
                         blocks=nblocks, position=pos)
        if req.ctx is not None and _rtrace.active:
            req.ctx.record("preempt", _tracer.now_ns(), slot=slot,
                           blocks=nblocks)

    def _sweep_parked(self):
        """A parked stream whose deadline passed (or that was cancelled)
        sheds ``deadline_preempted`` (or retires) instead of resuming."""
        with self._cond:
            dead = [r for r in self._parked if r.expired() or r.cancelled]
            for r in dead:
                self._parked.remove(r)
        for req in dead:
            req.parked = None
            if req.cancelled:
                self._retire(req, slot=None)
                continue
            self._admission.shed_deadline(preempted=True)
            self._g_parked.set(len(self._parked))
            self._note_tenant(req, "shed")
            self._release_resources(req)
            exc = DeadlineExceeded("request deadline expired while "
                                   "preempted to host memory",
                                   reason="deadline_preempted")
            if not req.future.done():
                req.future.set_exception(exc)
            req.queue.put(exc)

    def _try_resume(self):
        """Swap parked requests back into free slots as the pool refills,
        the best aged priority first.  A pool that cannot hold a parked
        stream while other slots are live waits for their retirements;
        with nothing live it drops the prefix cache's holds, then sheds
        the stream typed rather than wedge the scheduler."""
        from ..generation import BlockPoolExhausted
        cleared_cache = False
        while True:
            with self._cond:
                if not self._parked:
                    return
                free = [i for i, r in enumerate(self._slot_req)
                        if r is None]
                if not free:
                    return
                aging, now = self._aging_s, time.monotonic()

                def eff(r):
                    e = r.priority
                    if aging > 0:
                        e = max(0, e - int((now - r.t_submit) / aging))
                    return e

                req = min(self._parked, key=lambda r: (eff(r), r.t_submit))
                slot = free[0]
            try:
                blocks = self.pool.alloc(req.parked["nblocks"])
            except BlockPoolExhausted as e:
                if self._occupied():
                    return
                if not cleared_cache:
                    self.prefix_cache.clear()
                    cleared_cache = True
                    continue
                with self._cond:
                    self._parked.remove(req)
                self._g_parked.set(len(self._parked))
                req.parked = None
                self._shed_kv(req, None, e)
                continue
            self._resume_into(slot, req, blocks)

    def _resume_into(self, slot: int, req: _GenRequest, blocks: List[int]):
        """Swap a parked request back in: its host payload into the fresh
        ``blocks``, the slot's table row, position, last token and
        sampling knobs restored."""
        park = req.parked
        try:
            self.session.swap_in_blocks(self._arenas, blocks, park["host"])
        except BaseException:
            self.pool.decref(blocks)
            raise
        req.blocks = blocks
        req.parked = None
        with self._cond:
            self._parked.remove(req)
        self._table[slot, :] = -1
        self._table[slot, :len(blocks)] = blocks
        self._slot_req[slot] = req
        self._positions[slot] = park["pos"]
        self._last_tok[slot] = park["last"]
        self._set_slot_knobs(slot, req)
        with self._mlock:
            self._m_resumed.inc()
            self._g_parked.set(len(self._parked))
        self._note_tenant(req, "resumed")
        if _flight.active:
            _flight.note("serve", "resume", engine=self.metrics_prefix,
                         slot=slot, request=req.request_id,
                         tenant=req.tenant, priority=req.priority_name,
                         blocks=len(blocks), position=park["pos"])
        if req.ctx is not None and _rtrace.active:
            req.ctx.record("resume", _tracer.now_ns(), slot=slot,
                           blocks=len(blocks))

    def _retire(self, req: _GenRequest, slot: Optional[int]):
        if slot is not None:
            self._table[slot, :] = -1
        super()._retire(req, slot)

    def _fail_all(self, exc: BaseException):
        super()._fail_all(exc)
        self._drain_transfers(exc)
        self._table[:, :] = -1
        self._g_parked.set(0)

    def close(self, timeout: Optional[float] = 60.0):
        super().close(timeout=timeout)
        # transfers stranded by the loop's exit fail typed (the imports'
        # holds go), then the cache lets go: the pool drains to all free
        self._drain_transfers(EngineClosed("generation engine is closed"))
        self.prefix_cache.clear()

    # -- scheduler overrides --------------------------------------------------
    def _admit(self):
        """A token boundary: adopt imported chains, serve exports, sweep
        the parked set's deadlines, admit queued requests (preempting
        lower-priority slots under pool pressure), then resume parked
        streams into whatever slots and blocks remain."""
        self._apply_imports()
        self._apply_exports()
        self._sweep_parked()
        self._admit_pending()
        self._try_resume()

    def _admit_pending(self):
        """Prefix lookup and block allocation per request, then one chunked
        prefill per suffix bucket feeding each row's uncached suffix at its
        offset.  Pool exhaustion preempts the lowest strictly
        lower-priority live slot and retries; with no such slot the
        incoming request sheds typed."""
        from ..generation import BlockPoolExhausted, blocks_for_tokens
        took = self._take_pending()
        if not took:
            return
        placed: List[Tuple[int, _GenRequest]] = []
        cows: List[Tuple[int, int]] = []
        for slot, req in took:
            while True:
                try:
                    cow = self._prepare_slot(slot, req)
                    break
                except BlockPoolExhausted as e:
                    if self._preempt_for(req, exclude=slot):
                        continue            # blocks freed: retry
                    self._shed_kv(req, None, e)
                    cow = req = None
                    break
            if req is None:
                continue
            if cow is not None:
                cows.append(cow)
            self._note_slot_admit(slot, req)
            placed.append((slot, req))
        if not placed:
            return
        if cows:
            # one batched copy-on-write for the whole round
            self.session.copy_blocks(self._arenas, [s for s, _ in cows],
                                     [d for _, d in cows])
        groups: Dict[int, List[Tuple[int, _GenRequest]]] = {}
        for slot, req in placed:
            flen = len(req.prompt) - req.cached_len
            groups.setdefault(self.session.prompt_bucket(flen),
                              []).append((slot, req))
        S = self.slots
        for pb, members in sorted(groups.items()):
            ids = np.zeros((S, pb), np.int32)
            starts = np.zeros((S,), np.int32)
            feed = np.zeros((S,), np.int32)
            for slot, req in members:
                suffix = req.prompt[req.cached_len:]
                ids[slot, :len(suffix)] = suffix
                starts[slot] = req.cached_len
                feed[slot] = len(suffix)
            t0 = _tracer.now_ns() if _rtrace.active else 0
            tok, self._arenas = self.session.prefill(
                self._arenas, self._table, ids, starts, feed, self._seeds,
                self._temps, self._tks, self._tps, live_rows=len(members))
            if t0:
                self._trace_boundary("prefill", t0, _tracer.now_ns(),
                                     [s for s, _r in members], bucket=pb)
            for slot, req in members:
                # offer the filled prompt blocks to the prefix cache
                # before emit (which may retire the request)
                n = len(req.prompt)
                self.prefix_cache.insert(
                    req.prompt,
                    req.blocks[:blocks_for_tokens(n,
                                                  self.session.block_size)])
                self._positions[slot] = n
                self._last_tok[slot] = tok[slot]
                self._emit(slot, int(tok[slot]))

    def _grow(self, occ: List[int], extra) -> List[int]:
        """Blocks for each live row's writes this boundary (through its
        position plus ``extra(slot)``), preempting lower-priority slots
        under pressure and shedding the rows that still cannot grow;
        returns the rows that hold their blocks."""
        from ..generation import BlockPoolExhausted
        victims, live = [], []
        for s in occ:
            req = self._slot_req[s]
            if req is None:
                continue            # preempted for an earlier row this pass
            while True:
                try:
                    self._ensure_blocks(s, req,
                                        int(self._positions[s]) + extra(s))
                    live.append(s)
                    break
                except BlockPoolExhausted as e:
                    if self._preempt_for(req, exclude=s):
                        continue
                    victims.append((s, req, e))
                    break
        for s, req, e in victims:
            self._shed_kv(req, s, e)
        # a later row's preemption may have parked an earlier live row
        return [s for s in live if self._slot_req[s] is not None]

    def _decode_round(self, occ: List[int]):
        from ..generation import draft_row
        k = self.speculative_k
        if k > 0:
            drafts: Dict[int, List[int]] = {}
            for s in occ:
                req = self._slot_req[s]
                ctx = np.concatenate([req.prompt,
                                      np.asarray(req.tokens, np.int32)])
                room = self.max_length - int(self._positions[s])
                drafts[s] = draft_row(ctx, k, room,
                                      ngram=self.config.spec_ngram)
            if any(drafts.values()):
                self._verify_round(occ, drafts, k)
                return
        occ = self._grow(occ, lambda s: 0)
        if not occ:
            return
        t0 = _tracer.now_ns() if _rtrace.active else 0
        tok, self._arenas = self.session.decode(
            self._arenas, self._table, self._last_tok, self._positions,
            self._seeds, self._temps, self._tks, self._tps,
            live_rows=len(occ))
        if t0:
            self._trace_boundary("decode", t0, _tracer.now_ns(), occ,
                                 occupancy=len(occ))
        with self._mlock:
            self._m_occ.observe(len(occ))
        # rows freed this boundary sit at position 0 with a -1 table:
        # their writes land in the sink
        self._positions = self._positions + 1
        self._last_tok = np.array(tok, np.int32)
        for s in occ:
            self._emit(s, int(tok[s]))

    def _verify_round(self, occ: List[int], drafts: Dict[int, List[int]],
                      k: int):
        """A speculative boundary: one verify at width k + 1; each row
        commits the longest prefix of its drafts the model's own sampler
        agrees with, plus the sampler's token after it."""
        from ..generation import accept_span, fill_verify_row
        S, W = self.slots, k + 1
        live = self._grow(occ, lambda s: len(drafts.get(s) or []))
        if not live:
            return
        ids = np.zeros((S, W), np.int32)
        feed = np.zeros((S,), np.int32)
        for s in live:
            fill_verify_row(ids, feed, s, int(self._last_tok[s]),
                            drafts.get(s) or [])
        t0 = _tracer.now_ns() if _rtrace.active else 0
        toks, self._arenas = self.session.verify(
            self._arenas, self._table, ids, self._positions, feed,
            self._seeds, self._temps, self._tks, self._tps,
            live_rows=len(live))
        if t0:
            # the verify step is this boundary's decode work
            self._trace_boundary("decode", t0, _tracer.now_ns(), live,
                                 occupancy=len(live), verify_width=W)
        with self._mlock:
            self._m_occ.observe(len(live))
        proposed = sum(len(drafts.get(s) or []) for s in live)
        accepted = 0
        for s in live:
            span = accept_span(drafts.get(s) or [], toks[s])
            for j, t in enumerate(span):
                self._positions[s] += 1
                self._last_tok[s] = int(t)
                self._emit(s, int(t))
                # only drafts that committed count (the last token of the
                # span is the sampler's own)
                if j < len(span) - 1:
                    accepted += 1
                if self._slot_req[s] is None:
                    break           # retired mid-span (eos, budget)
        with self._mlock:
            self._m_spec_proposed.inc(proposed)
            self._m_spec_accepted.inc(accepted)
            total = self._m_spec_proposed.value
            self._g_spec_rate.set(self._m_spec_accepted.value / total
                                  if total else 0.0)
