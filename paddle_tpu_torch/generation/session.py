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
rows into a live batch without touching its neighbours' cache.  Rows never
interact, so a row's stream is the same in a solo :meth:`generate` call
and in any slot of an engine that uses the same batch capacity.

PyTorch runs eagerly, so the reference's ahead-of-time executable cache
has no counterpart here.  Steps run under ``torch.inference_mode()`` with
the model in eval mode, and each step's wall time (ended by the copy of
its tokens to the host) is kept in :attr:`step_ms`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .sampling import sample

__all__ = ["GenerationSession"]

# step times kept per phase (a bounded window; counts are exact)
_TIMING_WINDOW = 4096


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

    batch_capacity  row count of every step (rounded up to a power of two);
                    an engine sets it to its slot count and
                    :meth:`generate` pads smaller batches up to it
    max_length      KV-cache capacity (prompt + generated tokens), bounded
                    by the model's ``max_seq_len``
    """

    def __init__(self, model, batch_capacity: int = 1,
                 max_length: Optional[int] = None,
                 prompt_bucket_min: int = 8):
        # imported here: serving imports this module
        from ..serving.bucketing import next_bucket
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
        self.steps: Dict[str, int] = {"prefill": 0, "decode": 0}
        self.step_ms: Dict[str, deque] = {
            "prefill": deque(maxlen=_TIMING_WINDOW),
            "decode": deque(maxlen=_TIMING_WINDOW)}

    # -- caches and buckets ---------------------------------------------
    def init_caches(self):
        """Zero fixed-capacity caches shaped for this session."""
        return self.model.gen_caches(self.batch_capacity, self.max_length)

    def prompt_bucket(self, prompt_len: int) -> int:
        """Power-of-two prompt-length bucket (bounded by the capacity)."""
        from ..serving.bucketing import next_bucket
        b = next_bucket(max(int(prompt_len), 1),
                        min_bucket=min(self.prompt_bucket_min,
                                       self.max_length))
        return min(b, self.max_length)

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _run(self, phase: str, step: Callable[[], torch.Tensor]
             ) -> np.ndarray:
        net = self.model
        was_training = net.training
        t0 = time.perf_counter()
        try:
            net.eval()
            with torch.inference_mode():
                tok = step()
            tok_h = tok.to("cpu").numpy().astype(np.int32)  # waits for it
        finally:
            net.train(was_training)
        self.step_ms[phase].append((time.perf_counter() - t0) * 1e3)
        self.steps[phase] += 1
        return tok_h

    # -- steps (the engine calls these; generate() below too) -----------
    def prefill(self, caches, ids, prompt_lens, update_mask, seeds, temps,
                tks, tps):
        """Prefill ``ids`` ``(B, P)`` and sample each row's first token;
        returns ``(tokens (B,) int32, caches)``.  Only ``update_mask``
        rows of ``caches`` change (in place): they hold the prompt's keys
        and values at ``[0, P)`` and zeros after."""
        B, P = np.shape(ids)

        def step():
            ids_t = self._tensor(ids, torch.long)
            plens = self._tensor(prompt_lens, torch.long)
            fresh = self.model.gen_caches(B, P)
            logits, fresh = self.model(ids_t, caches=fresh)
            idx = (plens - 1).clamp(0, P - 1)
            last = logits[torch.arange(B, device=self.device), idx]
            # the sampled token sits at position prompt_len: the noise is
            # keyed on that position (decode keys the same way)
            tok = sample(last, self._tensor(seeds, torch.long), plens,
                         self._tensor(temps, torch.float32),
                         self._tensor(tks, torch.long),
                         self._tensor(tps, torch.float32))
            rows = self._tensor(np.flatnonzero(update_mask), torch.long)
            for old, new in zip(caches, fresh):
                for buf, src in ((old.k, new.k), (old.v, new.v)):
                    buf[rows] = 0
                    buf[rows, :P] = src[rows]
            return tok
        return self._run("prefill", step), caches

    def decode(self, caches, tokens, positions, seeds, temps, tks, tps):
        """One decode step for every row: writes each row's token at its
        position (in place) and samples the next; returns
        ``(tokens (B,) int32, caches)``."""
        def step():
            pos = self._tensor(positions, torch.long)
            logits, _ = self.model(self._tensor(tokens, torch.long)[:, None],
                                   caches=caches, positions=pos)
            return sample(logits[:, 0], self._tensor(seeds, torch.long),
                          pos + 1, self._tensor(temps, torch.float32),
                          self._tensor(tks, torch.long),
                          self._tensor(tps, torch.float32))
        return self._run("decode", step), caches

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
