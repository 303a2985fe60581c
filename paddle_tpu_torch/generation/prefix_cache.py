"""Content-addressed prefix cache over the paged KV block pool — the
counterpart of ``paddle_tpu/generation/prefix_cache.py``.

Chat traffic is prefix-heavy: the same system prompt heads many
requests.  This cache keys **filled, refcounted, immutable block chains**
by the sha256 of the token ids they hold, so a prompt that shares a prefix
with an earlier one skips straight to its uncached suffix: shared prefixes
prefill once.

Structure: for a prompt, entry ``i`` of its chain is keyed by
``sha256(int32 tokens[: (i+1) * block_size])``, over the WHOLE prefix, so a
key match proves the entire token prefix matches.  A prompt that is not
block-aligned also caches its **partial tail** block under
``sha256(tokens[:prompt_len])`` with its filled count; a later request
that appends into a shared partial block copies it first (copy-on-write:
the :class:`~.paged_kv.BlockPool` refcounts make the share safe,
``PagedGenerationSession.copy_blocks`` copies).  The keys are the
reference's bytes, so :meth:`PrefixCache.hot_heads` equals the
reference's on the same traffic.

Why it is correct: position embeddings are absolute, so a shared prefix
sits at positions ``0..n-1`` in every request, and its keys and values
are functions of (token, position, weights) alone.  Slots past an entry's
``filled`` count are never read by a hitter (the mask excludes them).

Eviction: LRU under a block cap (``FLAGS_prefix_cache_blocks`` /
``GenerationEngineConfig.prefix_cache_blocks``); chains refresh whole on
hit and insert, and only childless entries are evictable, so a chain
evicts tail first.  Evicting an entry drops the cache's hold; blocks that
live requests still hold free when those retire.

Metrics: ``<name>.prefix_cache.hit`` / ``.miss`` / ``.evict`` counters,
``.hit_tokens`` (prefill work skipped), ``.blocks`` / ``.bytes`` gauges.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from ..utils import concurrency as _conc
from .paged_kv import BlockPool

__all__ = ["PrefixCache"]


class _Entry:
    __slots__ = ("key", "block", "filled", "parent", "children")

    def __init__(self, key: bytes, block: int, filled: int,
                 parent: Optional[bytes]):
        self.key = key
        self.block = block
        self.filled = int(filled)
        self.parent = parent
        self.children = 0


class PrefixCache:
    """sha256-keyed chains of filled KV blocks with LRU eviction.

    ``capacity_blocks`` bounds how many blocks the cache may hold
    (0 disables caching entirely — lookups miss, inserts no-op).
    """

    def __init__(self, pool: BlockPool, capacity_blocks: int,
                 name: str = "serving"):
        self.pool = pool
        self.capacity_blocks = int(capacity_blocks)
        self._lock = _conc.Lock(name=f"{name}.prefix_cache")
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        from ..profiler import metrics as _metrics
        p = f"{name}.prefix_cache"
        self._m_hit = _metrics.counter(
            f"{p}.hit", "lookups that found a non-empty cached prefix")
        self._m_miss = _metrics.counter(
            f"{p}.miss", "lookups that found nothing cached")
        self._m_evict = _metrics.counter(
            f"{p}.evict", "entries LRU-evicted under the block cap")
        self._m_hit_tokens = _metrics.counter(
            f"{p}.hit_tokens", "prompt tokens served from cache "
            "(prefill work skipped)")
        self._g_blocks = _metrics.gauge(
            f"{p}.blocks", "blocks currently held by the prefix cache")
        self._g_bytes = _metrics.gauge(
            f"{p}.bytes", "KV bytes currently held by the prefix cache")

    def __len__(self):
        with self._lock:
            return len(self._entries)

    @staticmethod
    def _key(toks: np.ndarray, n: int) -> bytes:
        return hashlib.sha256(
            np.ascontiguousarray(toks[:n], dtype=np.int32).tobytes()
        ).digest()

    def _gauges(self):
        self._g_blocks.set(len(self._entries))
        self._g_bytes.set(len(self._entries) * self.pool.block_bytes)

    # -- lookup --------------------------------------------------------
    def lookup(self, tokens) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: returns ``(blocks,
        cached_len)`` with one pool reference per block TRANSFERRED to
        the caller (the request must ``decref`` them at retirement
        like any other block it holds).  ``cached_len == 0`` on miss.
        Determinism: same prompt -> same sha256 walk -> same chain."""
        toks = np.ascontiguousarray(tokens, dtype=np.int32).reshape(-1)
        plen = int(toks.size)
        bs = self.pool.block_size
        # one incremental hasher advanced block-by-block (digests are
        # byte-identical to sha256(toks[:n]) — same stream): the walk
        # runs on the scheduler thread at every admission boundary, so
        # re-hashing the whole prefix per block (O(plen^2/bs)) would
        # serialize every live stream behind long prompts
        raw = toks.tobytes()
        isz = toks.itemsize
        with self._lock:
            if self.capacity_blocks <= 0 or not self._entries:
                self._m_miss.inc()
                return [], 0
            h = hashlib.sha256()         # hasher at position `covered`
            chain: List[_Entry] = []
            covered = 0
            n = bs
            while n <= plen:
                hn = h.copy()
                hn.update(raw[covered * isz:n * isz])
                e = self._entries.get(hn.digest())
                if e is None:
                    break
                h = hn
                chain.append(e)
                covered = n
                n += bs
            # partial-tail probe, longest first: a donor prompt of any
            # length whose content matches ``toks[:L]`` may have cached
            # its partial last block under sha256(toks[:L])
            hi = min(plen, covered + bs - 1)
            for L in range(hi, covered, -1):
                hp = h.copy()
                hp.update(raw[covered * isz:L * isz])
                e = self._entries.get(hp.digest())
                if e is not None and e.filled == L - covered:
                    chain.append(e)
                    covered = L
                    break
            if not chain:
                self._m_miss.inc()
                return [], 0
            blocks = [e.block for e in chain]
            for e in chain:                      # whole-chain refresh
                self._entries.move_to_end(e.key)
            self._m_hit.inc()
            self._m_hit_tokens.inc(covered)
            # incref UNDER the cache lock (cache -> pool order, same as
            # eviction): outside it, a concurrent insert's eviction
            # could free a chain block before the reference lands
            self.pool.incref(blocks)
        return blocks, covered

    # -- insert --------------------------------------------------------
    def insert(self, tokens, blocks: List[int]):
        """Offer a freshly prefilled prompt's blocks to the cache
        (called AFTER the prefill executable ran, so every offered
        block is filled).  Existing keys are kept — a concurrent
        first-fill race caches exactly one copy and the loser's blocks
        stay private to its request.  The cache takes its own pool
        reference per retained block."""
        toks = np.ascontiguousarray(tokens, dtype=np.int32).reshape(-1)
        plen = int(toks.size)
        bs = self.pool.block_size
        if self.capacity_blocks <= 0 or plen < 1:
            return
        raw = toks.tobytes()             # incremental walk, as lookup
        isz = toks.itemsize
        take: List[Tuple[bytes, int, int, Optional[bytes]]] = []
        with self._lock:
            h = hashlib.sha256()
            parent: Optional[bytes] = None
            nfull = plen // bs
            for i in range(nfull):
                h.update(raw[i * bs * isz:(i + 1) * bs * isz])
                key = h.digest()
                e = self._entries.get(key)
                if e is None:
                    take.append((key, blocks[i], bs, parent))
                else:
                    self._entries.move_to_end(key)
                parent = key
            rem = plen % bs
            if rem:
                h.update(raw[nfull * bs * isz:plen * isz])
                key = h.digest()
                if key not in self._entries:
                    take.append((key, blocks[nfull], rem, parent))
                else:
                    self._entries.move_to_end(key)
            # incref BEFORE eviction runs: a just-inserted entry can be
            # an immediate LRU victim under cap pressure, and evicting
            # it decrefs — without the cache's own reference in place
            # first, that decref would steal the caller's hold
            if take:
                self.pool.incref([blk for _k, blk, _f, _p in take])
            for key, blk, filled, par in take:
                ent = _Entry(key, blk, filled, par)
                self._entries[ent.key] = ent
                if par is not None and par in self._entries:
                    self._entries[par].children += 1
            self._evict_to_cap_locked()
            self._gauges()

    # -- eviction ------------------------------------------------------
    def _evict_to_cap_locked(self):
        while len(self._entries) > self.capacity_blocks:
            victim = None
            for e in self._entries.values():     # LRU-first iteration
                if e.children == 0:
                    victim = e
                    break
            if victim is None:                   # cannot happen: every
                break                            # chain has a leaf
            del self._entries[victim.key]
            if victim.parent is not None and \
                    victim.parent in self._entries:
                self._entries[victim.parent].children -= 1
            self.pool.decref([victim.block])
            self._m_evict.inc()

    def hot_heads(self, k: int, hexlen: int = 16) -> List[str]:
        """The ``k`` most-recently-used entry keys as ``hexlen``-char
        hex digests, MRU first — the bounded advertisement a fleet
        replica publishes in its registry heartbeat so the router can
        score dispatch by prefix locality.  Truncation is safe: a
        collision only misroutes one dispatch, correctness never
        depends on the hint (``kv_wire.chain_digests`` produces the
        matching digests on the router side)."""
        k = int(k)
        if k <= 0:
            return []
        with self._lock:
            keys = list(self._entries.keys())[-k:]
        return [key.hex()[:hexlen] for key in reversed(keys)]

    def clear(self):
        """Release every cached block (engine close / tests)."""
        with self._lock:
            blocks = [e.block for e in self._entries.values()]
            self._entries.clear()
            self._gauges()
        if blocks:
            self.pool.decref(blocks)
