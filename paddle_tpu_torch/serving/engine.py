"""Continuous (in-flight) batching for autoregressive generation — the
counterpart of the contiguous ``GenerationEngine`` of
``paddle_tpu/serving/engine.py``.

A fixed bank of ``max_slots`` decode slots runs one decode step per token
for every occupied slot.  Queued requests are admitted into free slots
between decode steps: their prompts are prefilled, grouped per
prompt-length bucket, straight into the shared KV cache without touching
running neighbours (the session's ``update_mask``).  Finished rows (eos,
token budget, cache full) retire at once and their slot is refilled at
the next boundary.  Tokens stream out per request as they are sampled.

Because rows never interact and every step runs at the same
``(max_slots, ...)`` shapes as a solo
:meth:`~paddle_tpu_torch.generation.GenerationSession.generate` over the
same session, each stream equals the solo ``generate()`` of its prompt.

Every step is one replay of a captured CUDA graph per prompt bucket (and
one for decode), kept in the session's executable cache.  With
``GenerationEngineConfig(warmup=True)`` the engine captures them all
before it takes requests (``"async"``: on the scheduler thread, with
:attr:`GenerationEngine.ready` False until done); otherwise each is
captured at its first use.  Captures run on the thread that runs the
steps; client threads only queue requests and read results, so no other
thread touches the card while a graph is captured.
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
from .admission import (AdmissionController, DeadlineExceeded,
                        EngineClosed, RequestRejected, deadline_from_ms)

__all__ = ["GenerationEngineConfig", "GenerationStream", "GenerationEngine",
           "RequestRejected", "DeadlineExceeded", "EngineClosed"]


class GenerationEngineConfig:
    """Knobs for :class:`GenerationEngine`.

    max_slots            rows of the running decode batch; every step has
                         exactly this batch shape
    max_length           KV-cache capacity per slot (prompt + generated
                         tokens); defaults to the model's max_seq_len
    max_new_tokens       per-request default generation budget
    max_queue            admission bound on waiting requests
    max_tokens_in_flight token-budget bound: the sum of every admitted
                         request's (prompt_len + max_new_tokens); default
                         max_slots * max_length (what the cache can hold)
    deadline_ms          default per-request deadline (sheds while
                         queued); None = none
    prompt_bucket_min    smallest prompt-length bucket
    warmup               capture every prefill bucket and the decode step
                         before serving: True in the constructor,
                         "async" on the scheduler thread (``ready`` is
                         False until it lands), False at first use
    name                 the engine's name, given to its session
    """

    def __init__(self, max_slots: int = 4,
                 max_length: Optional[int] = None,
                 max_new_tokens: int = 64,
                 max_queue: int = 128,
                 max_tokens_in_flight: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 prompt_bucket_min: int = 8,
                 warmup=False,
                 name: str = "serving"):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = int(max_slots)
        self.max_length = max_length
        self.max_new_tokens = int(max_new_tokens)
        self.max_queue = int(max_queue)
        self.max_tokens_in_flight = max_tokens_in_flight
        self.deadline_ms = deadline_ms
        self.prompt_bucket_min = int(prompt_bucket_min)
        self.warmup = warmup if warmup == "async" else bool(warmup)
        self.name = str(name)


class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "top_k", "top_p",
                 "seed", "eos", "deadline", "budget", "future", "queue",
                 "tokens", "t_submit", "t_first", "cancelled",
                 "finish_reason")

    def __init__(self, prompt, max_new, temperature, top_k, top_p, seed,
                 eos, deadline, budget):
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
        self.cancelled = False
        self.finish_reason: Optional[str] = None

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


class GenerationEngine:
    """Continuous batching over an autoregressive model at token
    boundaries (Orca-style); see the module docstring.

    Admission bounds the queue depth and the reserved tokens (prompt +
    max_new per request, returned at retirement).  :attr:`counts` holds
    the outcome counts (``completed``, ``cancelled``, ``failed``, and the
    admission ones); the session keeps the step times.  :attr:`ready` is
    False while an ``"async"`` warmup runs; :attr:`warmed_buckets` is the
    number of steps the warmup left captured."""

    def __init__(self, model,
                 config: Optional[GenerationEngineConfig] = None):
        self.config = cfg = config or GenerationEngineConfig()
        self.model = model
        max_len = int(cfg.max_length or model.cfg.max_seq_len)
        self.session = GenerationSession(
            model, batch_capacity=cfg.max_slots, max_length=max_len,
            prompt_bucket_min=cfg.prompt_bucket_min, name=cfg.name)
        self.max_length = self.session.max_length
        S = self.slots = self.session.batch_capacity
        budget = cfg.max_tokens_in_flight or S * self.max_length
        self._admission = AdmissionController(cfg.max_queue,
                                              max_tokens=int(budget))
        self.counts: Counter = Counter()

        self._caches = self.session.init_caches()
        self._slot_req: List[Optional[_GenRequest]] = [None] * S
        self._positions = np.zeros((S,), np.int32)
        self._last_tok = np.zeros((S,), np.int32)
        self._seeds = np.zeros((S,), np.int64)
        self._temps = np.zeros((S,), np.float32)
        self._tks = np.zeros((S,), np.int32)
        self._tps = np.ones((S,), np.float32)

        self._pending: deque = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._closed = False
        self.ready = False
        self.warmed_buckets = 0
        if cfg.warmup and cfg.warmup != "async":
            self._warmup()
        self.ready = cfg.warmup != "async"
        self._scheduler = threading.Thread(
            target=self._loop, name="generation-scheduler")
        self._scheduler.start()

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

    # -- client surface --------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               do_sample: bool = False, temperature: float = 1.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               eos_token_id: Optional[int] = None,
               deadline_ms="default") -> GenerationStream:
        """Enqueue one prompt; returns a :class:`GenerationStream`.
        Raises :class:`RequestRejected` at admission (``queue_full``,
        ``token_budget``, ``too_large``, ``closed``)."""
        prompt = np.asarray(prompt).reshape(-1).astype(np.int32)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.config.max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size >= self.max_length:
            self._admission.reject(
                "too_large", f"prompt of {prompt.size} tokens leaves no "
                f"room in the {self.max_length}-slot KV cache")
        budget = int(prompt.size) + max_new
        self._admission.acquire(tokens=budget)
        if deadline_ms == "default":
            deadline_ms = self.config.deadline_ms
        req = _GenRequest(prompt, max_new,
                          float(temperature) if do_sample else 0.0,
                          int(top_k), float(top_p), int(seed), eos_token_id,
                          deadline_from_ms(deadline_ms), budget)
        with self._cond:
            if self._closed:
                self._admission.release()
                self._admission.release_tokens(budget)
                raise EngineClosed()
            self._pending.append(req)
            self._cond.notify()
        return GenerationStream(req)

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kw) -> np.ndarray:
        """Blocking submit: the whole generated sequence."""
        return self.submit(prompt, **kw).result(timeout=timeout)

    def stats(self) -> Dict[str, int]:
        """Outcome counts of the engine and its admission controller."""
        out = dict(self.counts)
        out.update(self._admission.counts)
        out["prefill_steps"] = self.session.steps["prefill"]
        out["decode_steps"] = self.session.steps["decode"]
        return out

    def close(self, timeout: Optional[float] = 60.0):
        """Reject new work, let queued and running requests finish, and
        join the scheduler thread."""
        self._admission.close()
        with self._cond:
            if not self._closed:
                self._closed = True
                self._stop = True
                self._cond.notify_all()
        self._scheduler.join(timeout=timeout)
        if self._scheduler.is_alive():
            raise TimeoutError(f"generation scheduler still running after "
                               f"{timeout}s")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler ---------------------------------------------------------
    def _occupied(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is not None]

    def _loop(self):
        if self.config.warmup == "async":
            try:
                self._warmup()
            finally:
                self.ready = not self._closed
        while True:
            with self._cond:
                while not self._stop and not self._pending \
                        and not self._occupied():
                    self._cond.wait()
                if self._stop and not self._pending \
                        and not self._occupied():
                    break
            try:
                self._admit()
                occ = self._occupied()
                if occ:
                    self._decode_round(occ)
            except Exception as e:  # noqa: BLE001 — fail everything in flight
                self._fail_all(e)

    def _decode_round(self, occ: List[int]):
        """One token boundary: one decode step for every occupied slot."""
        tok, self._caches = self.session.decode(
            self._caches, self._last_tok, self._positions, self._seeds,
            self._temps, self._tks, self._tps)
        self._positions = self._positions + 1
        self._last_tok = np.array(tok, np.int32)
        for s in occ:
            self._emit(s, int(tok[s]))

    def _admit(self):
        """Move queued requests into free slots, grouped per prompt
        bucket, one masked prefill per group."""
        took: List[Tuple[int, _GenRequest]] = []
        with self._cond:
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            while self._pending and free:
                req = self._pending.popleft()
                self._admission.release()
                if req.expired():
                    self._shed(req)
                    continue
                if req.cancelled:
                    self._retire(req, slot=None)
                    continue
                took.append((free.pop(0), req))
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
                self._seeds[slot] = req.seed
                self._temps[slot] = req.temperature
                self._tks[slot] = req.top_k
                self._tps[slot] = req.top_p
            tok, self._caches = self.session.prefill(
                self._caches, ids, plens, mask, self._seeds, self._temps,
                self._tks, self._tps)
            for slot, req in members:
                self._positions[slot] = plens[slot]
                self._last_tok[slot] = tok[slot]
                self._emit(slot, int(tok[slot]))

    def _emit(self, slot: int, tok: int):
        req = self._slot_req[slot]
        if req is None:
            return
        if req.t_first is None:
            req.t_first = time.monotonic()
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

    def _retire(self, req: _GenRequest, slot: Optional[int]):
        if slot is not None:
            self._slot_req[slot] = None
        self._admission.release_tokens(req.budget)
        if not req.future.done():
            req.future.set_result(np.asarray(req.tokens, np.int32))
            self.counts["cancelled" if req.cancelled else "completed"] += 1
        req.queue.put(None)

    def _shed(self, req: _GenRequest):
        self._admission.shed_deadline()
        self._admission.release_tokens(req.budget)
        exc = DeadlineExceeded("request deadline expired while queued")
        if not req.future.done():
            req.future.set_exception(exc)
        req.queue.put(exc)

    def _fail_all(self, exc: BaseException):
        with self._cond:
            pending = list(self._pending)
            self._pending.clear()
        for _ in pending:
            self._admission.release()
        victims = pending + [r for r in self._slot_req if r is not None]
        self._slot_req = [None] * self.slots
        for req in victims:
            self._admission.release_tokens(req.budget)
            if not req.future.done():
                req.future.set_exception(exc)
                self.counts["failed"] += 1
            req.queue.put(exc)
