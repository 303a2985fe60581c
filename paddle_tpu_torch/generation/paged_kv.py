"""Paged KV cache: block-pool serving memory for autoregressive decode —
the counterpart of ``paddle_tpu/generation/paged_kv.py``.

KV memory is held the way vLLM's PagedAttention holds it, in fixed-shape
steps:

- **one arena per layer**: pre-allocated ``(num_blocks + 1, block_size,
  H, D)`` key and value tensors shared by every request.  The last block
  is the *sink* (below); the pool hands out blocks ``0 .. num_blocks-1``;
- **per-request block tables**: ``(B, max_blocks)`` integer arrays of
  arena block indices (``-1`` = unallocated).  Tables are step inputs,
  not shapes: a captured step takes them as data, so the number of
  captured steps stays bounded by the prompt buckets;
- **gather-based attention**: each step writes its tokens' keys and
  values into the arenas at table-mapped ``(block, offset)`` slots and
  gathers a dense ``(B, max_blocks * block_size, H, D)`` view per row for
  the masked attention the contiguous cache runs.  With ``block_size``
  dividing ``max_length`` the view's capacity equals the contiguous
  capacity, so a paged stream equals the contiguous one bit for bit;
- **refcounted alloc/free with copy-on-write**: :class:`BlockPool` is the
  host-side allocator; the prefix cache and any number of requests share
  filled blocks, and a sharer that must append into a partially filled
  shared block copies it first (:meth:`PagedGenerationSession.copy_blocks`);
- **int8 KV** (``kv_dtype="int8"``): arenas in int8 with per-token-per-head
  fp32 scales (:func:`~paddle_tpu_torch.quantization.quantize_int8`),
  dequantized in the view.

Unlike the reference, whose arrays are immutable, the port updates the
arenas **in place**: a captured step reads and writes them by address,
so the session owns one set (:meth:`PagedGenerationSession.init_arenas`)
and every write, copy, swap and import lands in that storage.

Write validity is expressed in bounds.  The reference maps an invalid
write (outside ``[starts, limits)`` or into an unallocated table entry)
to the out-of-range index ``num_blocks`` and lets XLA's ``mode="drop"``
discard it; on the card an out-of-range ``index_put_`` is a device-side
assert that kills the context.  So the port's arenas carry one block past
``num_blocks``, the sink, which the pool never hands out and no view
reads: every invalid write lands there.  A ``-1`` index would wrap to the
last block and corrupt it; the tests pin that it does not.  Reads clip
``-1`` entries to block 0; the causal-against-capacity mask excludes every
slot past a row's live length, and masked slots get exactly zero weight.

A paged chunk whose rows all start at position 0 (a fresh prefill of
fp32 arenas) attends through the flash-attention kernel over the window
itself, causal, as the contiguous prefill does: at start 0 the mask is
exactly causal, so it is the same function.  Every other chunk (a row at
``start > 0``: a prefix-cache hit, decode, verify) and every int8 chunk
attends with the masked math over the gathered view, as the reference's
paged steps all do.

Allocation failures are a serving event: the pool raises
:class:`BlockPoolExhausted` (injectable through the ``kv.block_alloc``
chaos site) and the engine sheds the request with a typed
``RequestRejected(reason="kv_blocks")``.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import concurrency as _conc
from .sampling import sample
from .session import GenerationSession, _seed_rows

__all__ = ["KVArena", "KVArenaQ", "PagedKV", "BlockPool",
           "BlockPoolExhausted", "PagedGenerationSession",
           "init_arenas", "write_paged", "paged_view",
           "blocks_for_tokens", "arena_blocks"]

# static input types of the paged steps, in argument order: table, ids,
# starts, feed_lens, seeds, temps, top_k, top_p
_CHUNK_TYPES = (torch.long, torch.long, torch.long, torch.long, torch.long,
                torch.float32, torch.long, torch.float32)


class KVArena(NamedTuple):
    """One layer's paged key/value storage: ``(num_blocks + 1, block_size,
    H, D)`` each, the last block the sink."""

    k: torch.Tensor
    v: torch.Tensor


class KVArenaQ(NamedTuple):
    """One layer's int8 paged key/value storage plus per-token-per-head
    dequantization scales ``(num_blocks + 1, block_size, H)`` fp32."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


class PagedKV(NamedTuple):
    """The per-layer cache the model's attention sees on the paged path:
    one layer's arena, the (shared) block table ``(B, max_blocks)``, the
    per-row absolute write limits ``(B,)`` (writes land at ``[starts,
    limits)``), and ``fresh``: every row starts at position 0 of fp32
    arenas, so attention runs causal over the window through the kernel."""

    arena: "KVArena | KVArenaQ"
    table: torch.Tensor
    limits: torch.Tensor
    fresh: bool = False


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` cache slots."""
    return -(-int(tokens) // int(block_size))


def arena_blocks(arena) -> int:
    """The blocks an arena holds for the pool (its sink left out)."""
    return int(arena.k.shape[0]) - 1


def init_arenas(num_layers: int, num_blocks: int, block_size: int,
                num_heads: int, head_dim: int, quantized: bool = False, *,
                device: torch.device,
                dtype: torch.dtype = torch.float32) -> Tuple:
    """Per-layer tuple of zeroed arenas of ``num_blocks`` blocks each (plus
    the sink)."""
    shape = (int(num_blocks) + 1, int(block_size), int(num_heads),
             int(head_dim))
    out = []
    for _ in range(int(num_layers)):
        if quantized:
            out.append(KVArenaQ(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:3], dtype=torch.float32, device=device),
                torch.zeros(shape[:3], dtype=torch.float32, device=device)))
        else:
            out.append(KVArena(torch.zeros(shape, dtype=dtype, device=device),
                               torch.zeros(shape, dtype=dtype, device=device)))
    return tuple(out)


def _write_indices(cache: PagedKV, T: int, starts: torch.Tensor):
    """Flattened ``(block, offset)`` write indices for a ``(B, T)`` token
    window written at per-row ``starts``; every invalid write (past
    ``limits`` or into an unallocated table entry) goes to the sink."""
    arena = cache.arena
    sink, bs = arena_blocks(arena), int(arena.k.shape[1])
    table = cache.table.to(torch.long)
    M = table.shape[1]
    dev = table.device
    pos = starts.to(device=dev, dtype=torch.long)[:, None] \
        + torch.arange(T, device=dev)[None, :]                    # (B, T)
    blk = table.gather(1, torch.div(pos, bs, rounding_mode="floor")
                       .clamp(0, M - 1))
    valid = (pos < cache.limits.to(device=dev, dtype=torch.long)[:, None]) \
        & (blk >= 0)
    blk = torch.where(valid, blk, torch.full_like(blk, sink))
    return blk.reshape(-1), torch.remainder(pos, bs).reshape(-1)


def write_paged(cache: PagedKV, k_new: torch.Tensor, v_new: torch.Tensor,
                starts: torch.Tensor) -> PagedKV:
    """Write ``k_new``/``v_new`` ``(B, T, H, D)`` into the arena at
    table-mapped slots, in place (int8 arenas quantize per token and head
    on the way in); returns ``cache``."""
    from ..quantization import quantize_int8
    arena = cache.arena
    B, T, H, D = k_new.shape
    blk, off = _write_indices(cache, T, starts)
    if isinstance(arena, KVArenaQ):
        kq, ks = quantize_int8(k_new, axis=-1)
        vq, vs = quantize_int8(v_new, axis=-1)
        arena.k[blk, off] = kq.reshape(B * T, H, D)
        arena.v[blk, off] = vq.reshape(B * T, H, D)
        arena.k_scale[blk, off] = ks.reshape(B * T, H)
        arena.v_scale[blk, off] = vs.reshape(B * T, H)
    else:
        arena.k[blk, off] = k_new.to(arena.k.dtype).reshape(B * T, H, D)
        arena.v[blk, off] = v_new.to(arena.v.dtype).reshape(B * T, H, D)
    return cache


def paged_view(cache: PagedKV) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-row ``(B, max_blocks * block_size, H, D)`` key and value
    views gathered through the block table (dequantized for int8 arenas).
    View position j is cache position j; unallocated entries clip to block
    0 and are always masked; the sink is never read."""
    from ..quantization import dequantize_int8
    arena = cache.arena
    n = arena_blocks(arena)
    _, bs, H, D = arena.k.shape
    B, M = cache.table.shape
    idx = cache.table.to(torch.long).clamp(0, n - 1)            # (B, M)
    k = arena.k[idx].reshape(B, M * bs, H, D)
    v = arena.v[idx].reshape(B, M * bs, H, D)
    if isinstance(arena, KVArenaQ):
        k = dequantize_int8(k, arena.k_scale[idx].reshape(B, M * bs, H))
        v = dequantize_int8(v, arena.v_scale[idx].reshape(B, M * bs, H))
    return k, v


class BlockPoolExhausted(RuntimeError):
    """The pool cannot satisfy an allocation (or the ``kv.block_alloc``
    chaos site injected exhaustion).  Engines turn it into a typed
    ``RequestRejected(reason="kv_blocks")``, never a corrupted batch."""


class BlockPool:
    """Host-side refcounted allocator over the arena's block axis.

    The pool never touches device memory: it hands out integer block ids
    and keeps the refcounts that let the prefix cache and several requests
    share filled blocks.  ``<name>.kv.blocks_in_flight`` (the admission
    signal with paging on), ``<name>.kv.block_allocs`` and
    ``<name>.kv.alloc_exhausted`` land in the metrics registry."""

    def __init__(self, num_blocks: int, block_size: int,
                 name: str = "serving"):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # bytes one block occupies across every layer's arenas (the engine
        # fills it in; metrics only)
        self.block_bytes = 0
        self._lock = _conc.Lock(name=f"{name}.kv.pool")
        self._free: deque = deque(range(self.num_blocks))
        self._ref = np.zeros(self.num_blocks, np.int32)
        from ..profiler import metrics as _metrics
        self._g_used = _metrics.gauge(
            f"{name}.kv.blocks_in_flight",
            "allocated KV blocks (live requests + prefix cache): the "
            "admission signal when paging is on")
        self._c_alloc = _metrics.counter(
            f"{name}.kv.block_allocs", "KV blocks handed out")
        self._c_exhausted = _metrics.counter(
            f"{name}.kv.alloc_exhausted", "allocations refused because "
            "the pool was empty (incl. injected via kv.block_alloc)")

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used(self) -> int:
        return self.num_blocks - self.available

    def alloc(self, n: int) -> List[int]:
        """``n`` blocks at refcount 1, or :class:`BlockPoolExhausted`
        (all or nothing: a partial grant would leak on the error path).
        The ``kv.block_alloc`` chaos site can inject the exhaustion."""
        n = int(n)
        if n == 0:
            return []
        from ..profiler import flight as _flight
        from ..utils import chaos as _chaos
        if _chaos.active:
            try:
                _chaos.hit("kv.block_alloc", exc=BlockPoolExhausted)
            except BlockPoolExhausted:
                self._c_exhausted.inc()
                if _flight.active:
                    _flight.note("kv", "exhausted", need=n, injected=True)
                raise
        with self._lock:
            if len(self._free) < n:
                self._c_exhausted.inc()
                if _flight.active:
                    _flight.note("kv", "exhausted", need=n,
                                 free=len(self._free))
                raise BlockPoolExhausted(
                    f"need {n} KV blocks but only {len(self._free)} of "
                    f"{self.num_blocks} are free (shed, don't corrupt)")
            got = [self._free.popleft() for _ in range(n)]
            for b in got:
                self._ref[b] = 1
            self._c_alloc.inc(n)
            self._g_used.set(self.num_blocks - len(self._free))
        return got

    def incref(self, blocks: Sequence[int]):
        """A new holder (a request or the prefix cache) shares ``blocks``."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(f"incref on free block {b}")
                self._ref[b] += 1

    def decref(self, blocks: Sequence[int]) -> int:
        """Drop one hold per block; a block at refcount 0 returns to the
        free list.  Returns how many were freed."""
        freed = 0
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(f"decref on free block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)
                    freed += 1
            self._g_used.set(self.num_blocks - len(self._free))
        return freed

    def refcount(self, block: int) -> int:
        with self._lock:
            return int(self._ref[block])


class PagedGenerationSession(GenerationSession):
    """:class:`GenerationSession` over paged arenas instead of per-row
    contiguous caches.

    Every step is a *chunk*: feed a ``(B, T)`` token window at per-row
    ``starts``, writing ``feed_lens`` tokens, and sample the token after
    each row's window.  Prefill is a chunk at the prompt (or suffix)
    bucket, decode the chunk at width 1, and speculative *verify* the
    chunk at width ``k + 1`` sampling at every position.  Rows with
    ``feed_lens == 0`` are inert (no writes; the host ignores their
    tokens).  Each width is one captured step per route: ``pchunk0:{P}``
    (every row at start 0, fp32: attention through the kernel),
    ``pchunk:{P}`` (the masked math over the view; decode is
    ``pchunk:1``) and ``pverify:{W}``.

    ``block_size`` must divide ``max_length``, so that the gathered view
    has the contiguous capacity (the condition for bit parity).
    :attr:`blocks_copied` counts copy-on-write block copies and
    :attr:`swaps` the ``(ms, bytes)`` of each swap out and in.
    """

    def __init__(self, model, batch_capacity: int = 1,
                 max_length: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 kv_dtype: str = "float32", prompt_bucket_min: int = 8,
                 name: str = "generation", executable_cache=None):
        super().__init__(model, batch_capacity=batch_capacity,
                         max_length=max_length,
                         prompt_bucket_min=prompt_bucket_min, name=name,
                         executable_cache=executable_cache)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.max_length % self.block_size:
            raise ValueError(
                f"block_size {self.block_size} must divide max_length "
                f"{self.max_length}: the gathered view capacity must equal "
                "the contiguous capacity for bit parity")
        self.blocks_per_slot = self.max_length // self.block_size
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else self.batch_capacity * self.blocks_per_slot)
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(f"kv_dtype must be 'float32' or 'int8', got "
                             f"{kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        # the arena geometry, in every key: two sessions sharing one
        # executable cache must not collide
        self._ptag = (f"{self.num_blocks}x{self.block_size}"
                      f"{'q' if self.quantized else ''}")
        self._arenas = None
        self._side = None
        self.blocks_copied = 0
        self.swaps: Dict[str, deque] = {"out": deque(maxlen=4096),
                                        "in": deque(maxlen=4096)}

    # -- arenas -----------------------------------------------------------
    def init_arenas(self) -> Tuple:
        """The session's arenas, zeroed: the one set its steps run on
        (made at the first call through the model's ``gen_arenas``, zeroed
        in place after)."""
        if self._arenas is None:
            hook = getattr(self.model, "gen_arenas", None)
            if hook is not None:
                self._arenas = hook(self.num_blocks, self.block_size,
                                    quantized=self.quantized)
            else:
                cfg = self.model.cfg
                self._arenas = init_arenas(
                    cfg.num_layers, self.num_blocks, self.block_size,
                    cfg.num_heads, cfg.hidden_size // cfg.num_heads,
                    quantized=self.quantized, device=self.device)
        else:
            with torch.no_grad():
                for a in self._arenas:
                    for f in a:
                        f.zero_()
        return self._arenas

    def _check_arenas(self, arenas) -> None:
        own = self._arenas
        if own is None or len(arenas) != len(own) or any(
                x is not y for a, b in zip(arenas, own)
                for x, y in zip(a, b)):
            raise ValueError(
                "these arenas are not this session's: its steps run on the "
                "one set init_arenas() returns (a captured CUDA graph reads "
                "and writes the arenas it was captured over, by address); "
                "pass that set")

    def arena_bytes_per_block(self) -> int:
        """Bytes one block costs across every layer's arenas (keys and
        values and, when quantized, the scales)."""
        cfg = self.model.cfg
        hd = cfg.hidden_size // cfg.num_heads
        per = self.block_size * cfg.num_heads * hd
        if self.quantized:
            bpb = 2 * per + 2 * self.block_size * cfg.num_heads * 4
        else:
            bpb = 2 * per * 4
        return bpb * cfg.num_layers

    def block_spec(self, arenas=None) -> List[List[Tuple[str, Tuple]]]:
        """Per-layer per-field ``(dtype, per-block shape)`` of the arenas:
        the geometry a ``kv_wire`` blob must match before its bytes may
        enter the pool (from live ``arenas`` when given)."""
        if arenas is not None:
            return [[(str(f.dtype).replace("torch.", ""),
                      tuple(int(d) for d in f.shape[1:])) for f in layer]
                    for layer in arenas]
        cfg = self.model.cfg
        hd = cfg.hidden_size // cfg.num_heads
        kv = (self.block_size, cfg.num_heads, hd)
        if self.quantized:
            sc = (self.block_size, cfg.num_heads)
            layer = [("int8", kv), ("int8", kv), ("float32", sc),
                     ("float32", sc)]
        else:
            layer = [("float32", kv), ("float32", kv)]
        return [list(layer) for _ in range(cfg.num_layers)]

    def identity_table(self, rows: Optional[int] = None) -> np.ndarray:
        """Block table mapping row i to its own contiguous run of blocks
        (the standalone :meth:`generate` layout)."""
        B = int(rows or self.batch_capacity)
        M = self.blocks_per_slot
        if B * M > self.num_blocks:
            raise ValueError(f"identity table needs {B * M} blocks but the "
                             f"pool has {self.num_blocks}")
        return (np.arange(B, dtype=np.int32)[:, None] * M
                + np.arange(M, dtype=np.int32)[None, :])

    # -- the step functions ----------------------------------------------
    def _forward(self, table, ids, starts, feed, fresh: bool):
        limits = starts + feed
        caches = tuple(PagedKV(a, table, limits, fresh)
                       for a in self._arenas)
        logits, _ = self.model(ids, caches=caches, positions=starts)
        return logits, limits

    def _make_chunk(self, T: int, fresh: bool):
        """The chunk step at width ``T`` over the session's arenas: the
        tokens ``(B,)`` sampled after each row's window."""
        B = self.batch_capacity

        def step(table, ids, starts, feed, seeds, temps, tks, tps):
            logits, limits = self._forward(table, ids, starts, feed, fresh)
            idx = (feed - 1).clamp(0, T - 1)
            last = logits[torch.arange(B, device=ids.device), idx]
            # the sampled token sits at position starts + feed: the noise
            # is keyed there, as the contiguous steps key it
            return sample(last, seeds, limits, temps, tks, tps)
        return step

    def _make_verify(self, W: int):
        """Speculative verify at width ``W``: the chunk sampling at every
        window position.  Window position i of a row fed at ``p`` is the
        token at ``p + i``; its successor's noise is keyed on ``p + 1 +
        i``, as sequential decode keys it."""
        B = self.batch_capacity

        def step(table, ids, starts, feed, seeds, temps, tks, tps):
            logits, _ = self._forward(table, ids, starts, feed, False)
            counters = starts[:, None] + 1 + torch.arange(
                W, device=ids.device)[None, :]
            toks = sample(logits.reshape(B * W, -1),
                          seeds.repeat_interleave(W), counters.reshape(-1),
                          temps.repeat_interleave(W),
                          tks.repeat_interleave(W),
                          tps.repeat_interleave(W))
            return toks.reshape(B, W)
        return step

    def _bound(self):
        return itertools.chain(super()._bound(),
                               (f for a in self._arenas or () for f in a))

    def _paged_step(self, phase: str, kind: str, make, arenas, table, ids,
                    starts, feed, seeds, temps, tks, tps, live: int):
        self._check_arenas(arenas)
        B = self.batch_capacity
        if np.shape(ids)[0] != B:
            raise ValueError(f"a chunk of {np.shape(ids)[0]} rows; the "
                             f"session's steps run {B}")
        values = (table, ids, starts, feed, seeds, temps, tks, tps)
        return self._run(phase, lambda: self._compiled(
            f"{kind}[{self._ptag}]", make, _CHUNK_TYPES, values), live)

    # -- steps (the engine calls these; generate() below too) -------------
    def prefill(self, arenas, table, ids, starts, feed_lens, seeds, temps,
                tks, tps, live_rows: Optional[int] = None):
        """Chunked paged prefill: write each row's ``feed_lens`` tokens at
        ``starts`` (a prefix-cache hit passes its cached length) and sample
        the next token; returns ``(tokens (B,) int32, arenas)``."""
        P = int(np.shape(ids)[1])
        fresh = not self.quantized and not np.any(np.asarray(starts))
        kind = f"pchunk0:{P}" if fresh else f"pchunk:{P}"
        live = live_rows if live_rows is not None else \
            int(np.count_nonzero(np.asarray(feed_lens)))
        tok = self._paged_step("prefill", kind,
                               lambda: self._make_chunk(P, fresh), arenas,
                               table, ids, starts, feed_lens, seeds, temps,
                               tks, tps, live)
        return tok, arenas

    def decode(self, arenas, table, tokens, positions, seeds, temps, tks,
               tps, live_rows: Optional[int] = None):
        """Paged decode: the chunk at width 1 (one capture for the
        session's life); returns ``(tokens (B,) int32, arenas)``."""
        ids = np.asarray(tokens, np.int32).reshape(-1, 1)
        ones = np.ones((ids.shape[0],), np.int32)
        live = len(ids) if live_rows is None else int(live_rows)
        tok = self._paged_step("decode", "pchunk:1",
                               lambda: self._make_chunk(1, False), arenas,
                               table, ids, positions, ones, seeds, temps,
                               tks, tps, live)
        return tok, arenas

    def verify(self, arenas, table, ids, positions, feed_lens, seeds, temps,
               tks, tps, live_rows: Optional[int] = None):
        """Speculative verify: ``ids (B, W)`` = the last token then the
        drafts per row; returns ``(tokens (B, W), arenas)``, the sampled
        successor of every window position."""
        W = int(np.shape(ids)[1])
        tok = self._paged_step("decode", f"pverify:{W}",
                               lambda: self._make_verify(W), arenas, table,
                               ids, positions, feed_lens, seeds, temps, tks,
                               tps, int(live_rows or 0))
        return tok, arenas

    def copy_blocks(self, arenas, src: Sequence[int], dst: Sequence[int]):
        """Copy-on-write: ``arena[dst[i]] = arena[src[i]]`` in every field
        of every layer, in place; pairs with a negative entry are skipped.
        Returns ``arenas``."""
        self._check_arenas(arenas)
        pairs = [(int(s), int(d)) for s, d in zip(src, dst)
                 if s >= 0 and d >= 0]
        if not pairs:
            return arenas
        with self._lock, torch.no_grad():
            s = torch.as_tensor([p[0] for p in pairs], dtype=torch.long,
                                device=self.device)
            d = torch.as_tensor([p[1] for p in pairs], dtype=torch.long,
                                device=self.device)
            for a in arenas:
                for f in a:
                    f.index_copy_(0, d, f.index_select(0, s))
            self.blocks_copied += len(pairs)
        return arenas

    # -- preemption swap (engine-driven) ------------------------------------
    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def swap_out_blocks(self, arenas, blocks: Sequence[int]):
        """Copy ``blocks``' contents (every field of every layer) to host
        memory, so that the engine can free the device blocks: on the card
        into one pinned staging block, on a side stream after the caller's
        stream, and this returns only once the copies have landed (the
        caller frees the blocks at once).  Returns the per-layer payload
        for :meth:`swap_in_blocks`."""
        from ..distributed.checkpoint import _Staging
        self._check_arenas(arenas)
        n = len(blocks)
        t0 = time.perf_counter()
        with self._lock, torch.no_grad():
            idx = torch.as_tensor(np.asarray(blocks, np.int64),
                                  device=self.device)
            fields = [((li, fi), f) for li, a in enumerate(arenas)
                      for fi, f in enumerate(a)]
            staging = _Staging()
            staging.prepare([(p, f[:n]) for p, f in fields])
            if self.device.type == "cuda":
                cur = torch.cuda.current_stream(self.device)
                side = self._side_stream()
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    for p, f in fields:
                        staging.views[p].copy_(f.index_select(0, idx),
                                               non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(side)
                done.synchronize()
            else:
                for p, f in fields:
                    staging.views[p].copy_(f.index_select(0, idx))
        payload = [tuple(staging.views[(li, fi)] for fi in range(len(a)))
                   for li, a in enumerate(arenas)]
        nbytes = sum(v.numel() * v.element_size()
                     for v in staging.views.values())
        self.swaps["out"].append(((time.perf_counter() - t0) * 1e3, nbytes))
        return payload

    def swap_in_blocks(self, arenas, blocks: Sequence[int], payload):
        """Write a :meth:`swap_out_blocks` payload (or a ``kv_wire`` one)
        into ``blocks`` in place; the contents are bit for bit what was
        swapped out, so a resumed stream equals its unpreempted stream (the
        block ids may differ: the table absorbs that).  Returns
        ``arenas``."""
        self._check_arenas(arenas)
        t0 = time.perf_counter()
        nbytes = 0
        with self._lock, torch.no_grad():
            idx = torch.as_tensor(np.asarray(blocks, np.int64),
                                  device=self.device)
            for a, fields in zip(arenas, payload):
                for f, h in zip(a, fields):
                    if not isinstance(h, torch.Tensor):
                        h = torch.from_numpy(np.array(h, copy=True))
                    if tuple(h.shape) != (len(blocks),) + tuple(f.shape[1:]) \
                            or h.dtype != f.dtype:
                        raise ValueError(
                            f"swap-in payload field {tuple(h.shape)} "
                            f"{h.dtype} does not fit {len(blocks)} blocks "
                            f"of {tuple(f.shape[1:])} {f.dtype}")
                    nbytes += h.numel() * h.element_size()
                    f.index_copy_(0, idx, h.to(self.device,
                                               non_blocking=True))
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        self.swaps["in"].append(((time.perf_counter() - t0) * 1e3, nbytes))
        return arenas

    # -- high-level generate -----------------------------------------------
    def generate(self, ids, prompt_lens=None, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 seeds=None, eos_token_id: Optional[int] = None,
                 stream_callback=None, speculative_k: int = 0,
                 spec_ngram: int = 2) -> List[np.ndarray]:
        """The paged twin of :meth:`GenerationSession.generate` (same
        contract, identity block table) plus speculative decoding:
        ``speculative_k`` drafts per step from the n-gram prompt-lookup
        drafter, committed through one verify call.  The streams equal
        those of ``speculative_k=0`` (the acceptance rule commits only
        tokens the sequential sampler produces)."""
        from .speculative import accept_span, draft_row, fill_verify_row
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
        batch = np.zeros((B, self.prompt_bucket(max_p)), np.int32)
        for i, (row, n) in enumerate(zip(ids_list, lens)):
            batch[i, :n] = row
        row_seeds = _seed_rows(seed, seeds, B)
        temps = np.full((B,), float(temperature) if do_sample else 0.0,
                        np.float32)
        tks = np.full((B,), int(top_k), np.int32)
        tps = np.full((B,), float(top_p), np.float32)
        feed = np.zeros((B,), np.int32)
        feed[:B_real] = lens

        arenas = self.init_arenas()
        table = self.identity_table()
        tok, arenas = self.prefill(arenas, table, batch,
                                   np.zeros((B,), np.int32), feed,
                                   row_seeds, temps, tks, tps,
                                   live_rows=B_real)
        out: List[List[int]] = [[] for _ in range(B_real)]
        done = [False] * B_real
        positions = feed.copy()             # where the sampled token sits
        max_new = max(int(max_new_tokens), 1)
        last = np.array(tok, np.int32)

        def absorb(i, t):
            out[i].append(t)
            if stream_callback is not None:
                stream_callback(i, t)
            if eos_token_id is not None and t == int(eos_token_id):
                done[i] = True
            elif len(out[i]) >= max_new:
                done[i] = True
            elif positions[i] + 1 >= self.max_length:
                done[i] = True              # cache full: hard stop

        for i in range(B_real):
            absorb(i, int(tok[i]))
        k_spec = max(int(speculative_k), 0)
        while not all(done):
            live = sum(1 for d in done if not d)
            if k_spec == 0:
                tok, arenas = self.decode(arenas, table, last, positions,
                                          row_seeds, temps, tks, tps,
                                          live_rows=live)
                positions = positions + 1
                for i in range(B_real):
                    if not done[i]:
                        last[i] = tok[i]
                        absorb(i, int(tok[i]))
                continue
            step_ids = np.zeros((B, k_spec + 1), np.int32)
            feed_w = np.zeros((B,), np.int32)
            drafts: List[List[int]] = [[] for _ in range(B)]
            for i in range(B_real):
                if done[i]:
                    continue
                ctx = np.concatenate([ids_list[i],
                                      np.asarray(out[i], np.int32)])
                room = self.max_length - int(positions[i])
                drafts[i] = draft_row(ctx, k_spec, room, ngram=spec_ngram)
                fill_verify_row(step_ids, feed_w, i, int(last[i]), drafts[i])
            toks, arenas = self.verify(arenas, table, step_ids, positions,
                                       feed_w, row_seeds, temps, tks, tps,
                                       live_rows=live)
            for i in range(B_real):
                if done[i]:
                    continue
                for t in accept_span(drafts[i], toks[i]):
                    positions[i] += 1
                    last[i] = t
                    absorb(i, int(t))
                    if done[i]:
                        break
        return [np.asarray(o, np.int32) for o in out]
