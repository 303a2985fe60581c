"""GenerationSession: prefill and decode over a decoder LM — the
counterpart of ``paddle_tpu/generation/session.py``.

Generation splits into

- **prefill** — one ``(B, prompt_bucket)`` forward over the right-padded
  prompts that fills the fixed-capacity KV cache and samples the first
  token per row; its attention runs through the flash-attention kernel
  (every row starts at position 0 of a zeroed cache);
- **decode** — a ``(B, 1)`` step that writes one token's keys and values
  at each row's position, attends over the capacity axis under a length
  mask, and samples the next token.

Every step runs at the session's fixed batch capacity, and ``prefill``
takes an ``update_mask`` so that a continuous-batching engine can admit
rows into a live batch without touching its neighbours' cache: the rows
outside the mask keep their cache bit for bit (a select by the mask, as
the reference merges).  Rows never interact, so a row's stream is the
same in a solo :meth:`generate` call and in any slot of an engine that
uses the same batch capacity.

As in the reference, each step is made once per shape bucket through an
:class:`~paddle_tpu_torch.serving.bucketing.ExecutableCache`: one
``"prefill:{P}"`` entry per prompt bucket and one ``"decode"``, so a
session makes at most ``len(seq_buckets(max_length)) + 1``.  An entry is
a :class:`~paddle_tpu_torch.graphs.StepGraph`: on the card a CUDA graph
captured at the bucket's first step and replayed after it, on the CPU the
step function.  A graph reads the parameters and the KV caches by the
address they had at capture, so the session owns one set of caches
(:meth:`init_caches`), and an entry whose parameters were replaced rather
than copied into (``load_state_dict`` copies) is captured again.  Steps
run under ``torch.inference_mode()`` with the model in eval mode, one at
a time; each serving step's wall time (ended by the copy of its tokens to
the host) is kept in :attr:`step_ms` and observed in the registry's
``<name>.prefill`` / ``<name>.decode`` histograms (ms), its sampled tokens
in ``<name>.tokens_out``, and with the host tracer on it is a
``serve::<name>.<phase>`` span.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..graphs import StepGraph
from ..profiler import metrics as _metrics
from ..profiler import tracer as _tracer
from ..utils import concurrency as _conc
from .sampling import sample

__all__ = ["GenerationSession"]

# step times kept per phase (a bounded window; counts are exact)
_TIMING_WINDOW = 4096
# static input types of the steps, in argument order
_PREFILL_TYPES = (torch.long, torch.long, torch.bool, torch.long,
                  torch.float32, torch.long, torch.float32)
_DECODE_TYPES = (torch.long, torch.long, torch.long, torch.float32,
                 torch.long, torch.float32)
_SERIALS = itertools.count()


def _seed_rows(seed: int, seeds, rows: int) -> np.ndarray:
    """Per-row seeds ``(rows,) int64``: ``seeds[i]`` when given (padding
    rows get 0), else the shared ``seed`` — never the batch position, so
    placement in a batch cannot change a row's stream."""
    if seeds is None:
        return np.full((rows,), int(seed), np.int64)
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    out = np.zeros((rows,), np.int64)
    n = min(len(seeds), rows)
    out[:n] = seeds[:n]
    return out


class GenerationSession:
    """Fixed-shape generation state machine over ``model``.

    ``model`` exposes ``forward(ids, caches=..., positions=...)`` (a
    decode step; without ``positions``, a prefill from zero) returning
    ``(logits, caches)``, plus ``gen_caches(batch, capacity)`` and
    ``device`` (:class:`~paddle_tpu_torch.models.GPT` has all three).

    batch_capacity    row count of every step (rounded up to a power of
                      two); an engine sets it to its slot count and
                      :meth:`generate` pads smaller batches up to it
    max_length        KV-cache capacity (prompt + generated tokens),
                      bounded by the model's ``max_seq_len``
    name              the session's name (an engine passes its own)
    executable_cache  an :class:`~paddle_tpu_torch.serving.bucketing.ExecutableCache`
                      to share; by default a private one under ``name``.
                      An entry binds its session's caches, so keys carry
                      the session's serial number.

    :attr:`steps` and :attr:`step_ms` count the steps that served a row
    (an engine's warmup steps, all rows masked out, are left out);
    :attr:`tokens_out` counts the tokens they sampled.  The registry's
    ``<name>.prefill`` / ``<name>.decode`` histograms and
    ``<name>.tokens_out`` counter take the same steps (shared by every
    session of one name).
    """

    def __init__(self, model, batch_capacity: int = 1,
                 max_length: Optional[int] = None,
                 prompt_bucket_min: int = 8, name: str = "generation",
                 executable_cache=None):
        # imported here: serving imports this module
        from ..serving.bucketing import ExecutableCache, next_bucket
        self.model = model
        cfg = model.cfg
        self.device = model.device
        self.batch_capacity = next_bucket(max(int(batch_capacity), 1))
        self.max_length = int(max_length or cfg.max_seq_len)
        if self.max_length > cfg.max_seq_len:
            raise ValueError(
                f"max_length {self.max_length} exceeds the model's "
                f"max_seq_len {cfg.max_seq_len} (no position embedding "
                "past it)")
        self.prompt_bucket_min = max(1, int(prompt_bucket_min))
        self.name = name
        self._cache = executable_cache if executable_cache is not None \
            else ExecutableCache(name=name)
        self._serial = next(_SERIALS)
        self._caches = None
        self._lock = _conc.Lock(name=f"{name}.session")
        self.steps: Dict[str, int] = {"prefill": 0, "decode": 0}
        self.step_ms: Dict[str, deque] = {
            "prefill": deque(maxlen=_TIMING_WINDOW),
            "decode": deque(maxlen=_TIMING_WINDOW)}
        self.tokens_out = 0
        self._m_step = {
            "prefill": _metrics.histogram(
                f"{name}.prefill", "prefill step latency ms (fill the "
                "KV-cache + first token)"),
            "decode": _metrics.histogram(
                f"{name}.decode", "decode step latency ms (one token for "
                "the whole batch)")}
        self._m_tokens = _metrics.counter(
            f"{name}.tokens_out", "tokens sampled by generation steps")

    # -- caches and buckets ---------------------------------------------
    def init_caches(self):
        """The session's fixed-capacity caches, zeroed: the one set its
        steps run on (made at the first call, zeroed in place after)."""
        if self._caches is None:
            self._caches = self.model.gen_caches(self.batch_capacity,
                                                 self.max_length)
        else:
            with torch.no_grad():
                for c in self._caches:
                    c.k.zero_()
                    c.v.zero_()
        return self._caches

    def _check_caches(self, caches) -> None:
        own = self._caches
        if own is None or len(caches) != len(own) or any(
                a.k is not b.k or a.v is not b.v for a, b in zip(caches, own)):
            raise ValueError(
                "these KV caches are not this session's: its steps run on "
                "the one set init_caches() returns (a captured CUDA graph "
                "reads and writes the caches it was captured over, by "
                "address); pass that set")

    def prompt_bucket(self, prompt_len: int) -> int:
        """Power-of-two prompt-length bucket (bounded by the capacity)."""
        from ..serving.bucketing import next_bucket
        b = next_bucket(max(int(prompt_len), 1),
                        min_bucket=min(self.prompt_bucket_min,
                                       self.max_length))
        return min(b, self.max_length)

    # -- the step functions (each entry of the cache wraps one) ----------
    def _make_prefill(self, P: int) -> Callable[..., torch.Tensor]:
        """The prefill step of bucket ``P`` over the session's caches:
        ``(ids, prompt_lens, update_mask, seeds, temps, top_k, top_p)``
        tensors in, the sampled tokens ``(B,)`` out."""
        net, B, caches = self.model, self.batch_capacity, self._caches

        def step(ids, plens, mask, seeds, temps, tks, tps):
            fresh = net.gen_caches(B, P)
            logits, fresh = net(ids, caches=fresh)
            idx = (plens - 1).clamp(0, P - 1)
            last = logits[torch.arange(B, device=ids.device), idx]
            # the sampled token sits at position prompt_len: the noise is
            # keyed on that position (decode keys the same way)
            tok = sample(last, seeds, plens, temps, tks, tps)
            m = mask.reshape(B, 1, 1, 1)
            for old, new in zip(caches, fresh):
                for buf, src in ((old.k, new.k), (old.v, new.v)):
                    head = buf[:, :P]
                    head.copy_(torch.where(m, src, head))
                    buf[:, P:].masked_fill_(m, 0)
            return tok
        return step

    def _make_decode(self) -> Callable[..., torch.Tensor]:
        """The decode step over the session's caches: ``(tokens,
        positions, seeds, temps, top_k, top_p)`` in, the next tokens
        out."""
        net, caches = self.model, self._caches

        def step(tokens, positions, seeds, temps, tks, tps):
            logits, _ = net(tokens[:, None], caches=caches,
                            positions=positions)
            return sample(logits[:, 0], seeds, positions + 1, temps, tks,
                          tps)
        return step

    def _bound(self):
        net = self.model
        return itertools.chain(net.parameters(), net.buffers())

    def _compiled(self, kind: str, make: Callable, types, values):
        """Run the step ``kind`` on ``values`` through its cache entry,
        keyed ``(kind, batch_capacity, max_length, serial)``: the first
        call makes the entry (on the card: runs the step, then captures
        it) and returns that run's tokens; later calls replay."""
        key = (kind, self.batch_capacity, self.max_length, self._serial)
        made = []

        def compile_fn():
            inputs = [torch.zeros(np.shape(v), dtype=t, device=self.device)
                      for v, t in zip(values, types)]
            exe = StepGraph(key, make(), inputs, values, bound=self._bound)
            made.append(exe)
            return exe
        exe = self._cache.get_or_compile(key, compile_fn,
                                         valid=StepGraph.current)
        if made:
            tok, exe.first_outputs = exe.first_outputs, None
            return tok
        return exe(*values)

    def _run(self, phase: str, step: Callable[[], torch.Tensor],
             live: int) -> np.ndarray:
        net = self.model
        with self._lock:
            was_training = net.training
            t0 = time.perf_counter_ns()
            try:
                net.eval()
                with torch.inference_mode():
                    tok = step()
                tok_h = tok.to("cpu").numpy().astype(np.int32)  # waits
            finally:
                net.train(was_training)
            if live:
                t1 = time.perf_counter_ns()
                ms = (t1 - t0) / 1e6
                self.step_ms[phase].append(ms)
                self.steps[phase] += 1
                self.tokens_out += live
                self._m_step[phase].observe(ms)
                self._m_tokens.inc(live)
                if _tracer.active:
                    _tracer.on_serving_phase(f"{self.name}.{phase}", t0, t1)
        return tok_h

    # -- steps (the engine calls these; generate() below too) -----------
    def prefill(self, caches, ids, prompt_lens, update_mask, seeds, temps,
                tks, tps):
        """Prefill ``ids`` ``(batch_capacity, P)`` and sample each row's
        first token; returns ``(tokens (B,) int32, caches)``.  Only the
        ``update_mask`` rows of the session's ``caches`` change (in
        place): they hold the prompt's keys and values at ``[0, P)`` and
        zeros after."""
        self._check_caches(caches)
        B, P = np.shape(ids)
        if B != self.batch_capacity:
            raise ValueError(f"a prefill of {B} rows; the session's steps "
                             f"run {self.batch_capacity}")
        values = (ids, prompt_lens, update_mask, seeds, temps, tks, tps)
        tok = self._run("prefill", lambda: self._compiled(
            f"prefill:{P}", lambda: self._make_prefill(P), _PREFILL_TYPES,
            values), int(np.count_nonzero(update_mask)))
        return tok, caches

    def decode(self, caches, tokens, positions, seeds, temps, tks, tps,
               live_rows: Optional[int] = None):
        """One decode step for every row: writes each row's token at its
        position (in place) and samples the next; returns
        ``(tokens (B,) int32, caches)``.  ``live_rows`` is how many rows
        serve a request (all by default; an engine's warmup passes 0)."""
        self._check_caches(caches)
        values = (tokens, positions, seeds, temps, tks, tps)
        live = self.batch_capacity if live_rows is None else int(live_rows)
        tok = self._run("decode", lambda: self._compiled(
            "decode", self._make_decode, _DECODE_TYPES, values), live)
        return tok, caches

    # -- high-level generate --------------------------------------------
    def generate(self, ids, prompt_lens=None, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 seeds=None, eos_token_id: Optional[int] = None,
                 stream_callback=None) -> List[np.ndarray]:
        """Continue a batch of prompts: ``ids`` is ``(P,)``, ``(B, P)`` or
        a list of ragged 1-D prompts.  Returns ``B`` int32 arrays of
        generated tokens (prompt excluded; eos, when hit, included last).
        Greedy unless ``do_sample``.  ``stream_callback(row, token)``
        fires per sampled token in order."""
        ids_list, lens = self._normalize_prompts(ids, prompt_lens)
        B_real, B = len(ids_list), self.batch_capacity
        if B_real > B:
            raise ValueError(
                f"{B_real} prompts exceed the session batch capacity {B}; "
                "raise batch_capacity or split the call")
        max_p = max(lens)
        if max_p >= self.max_length:
            raise ValueError(f"prompt length {max_p} leaves no room in the "
                             f"{self.max_length}-slot cache")
        Pb = self.prompt_bucket(max_p)
        batch = np.zeros((B, Pb), np.int32)
        for i, (row, n) in enumerate(zip(ids_list, lens)):
            batch[i, :n] = row
        row_seeds = _seed_rows(seed, seeds, B)
        temps = np.full((B,), float(temperature) if do_sample else 0.0,
                        np.float32)
        tks = np.full((B,), int(top_k), np.int32)
        tps = np.full((B,), float(top_p), np.float32)
        plens = np.ones((B,), np.int32)
        plens[:B_real] = lens
        mask = np.zeros((B,), bool)
        mask[:B_real] = True

        caches = self.init_caches()
        tok, caches = self.prefill(caches, batch, plens, mask, row_seeds,
                                   temps, tks, tps)
        out: List[List[int]] = [[] for _ in range(B_real)]
        done = [False] * B_real
        positions = plens.copy()            # where the sampled token sits
        max_new = max(int(max_new_tokens), 1)

        def absorb(tok_h):
            for i in range(B_real):
                if done[i]:
                    continue
                t = int(tok_h[i])
                out[i].append(t)
                if stream_callback is not None:
                    stream_callback(i, t)
                if eos_token_id is not None and t == int(eos_token_id):
                    done[i] = True
                elif len(out[i]) >= max_new:
                    done[i] = True
                elif positions[i] + 1 >= self.max_length:
                    done[i] = True          # cache full: hard stop
        absorb(tok)
        while not all(done):
            tok, caches = self.decode(caches, tok, positions, row_seeds,
                                      temps, tks, tps)
            positions = positions + 1
            absorb(tok)
        return [np.asarray(o, np.int32) for o in out]

    @staticmethod
    def _normalize_prompts(ids, prompt_lens):
        if isinstance(ids, (list, tuple)) and ids and \
                not np.isscalar(ids[0]):
            rows = [np.asarray(r).reshape(-1).astype(np.int32)
                    for r in ids]
            return rows, [len(r) for r in rows]
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        arr = np.asarray(ids)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2:
            raise ValueError(f"prompts must be (P,) or (B, P); got "
                             f"{arr.shape}")
        arr = arr.astype(np.int32)
        if prompt_lens is None:
            lens = [arr.shape[1]] * arr.shape[0]
        else:
            lens = [int(n) for n in np.asarray(prompt_lens).reshape(-1)]
            if len(lens) != arr.shape[0]:
                raise ValueError("prompt_lens rows != prompt rows")
        if min(lens) < 1:
            raise ValueError("empty prompt (length 0)")
        return [arr[i, :lens[i]] for i in range(arr.shape[0])], lens
