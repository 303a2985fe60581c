"""Shape buckets and the executable cache — the counterpart of
``paddle_tpu/serving/bucketing.py``.

Bucketing rounds a dynamic dim up to the next power of two, so that the
steps of a server run at one of a few shapes whatever shapes clients send:
the batch dim always (:class:`BucketPolicy`, :func:`bucket_shape`,
:func:`pad_batch`), and for generation the prompt length
(:func:`seq_buckets`).

:class:`ExecutableCache` maps a bucket key to its executable, made once
per key: in the reference an XLA executable, in the port a
:class:`~paddle_tpu_torch.graphs.StepGraph` (on the card a captured CUDA
graph with its static inputs and outputs).  A per-key in-flight latch
keeps concurrent callers to one compile per key.  The cache publishes
the reference's ``<name>.executable_cache.hit`` and ``<name>.compile``
counters, keeps the same counts in :attr:`~ExecutableCache.hits` and
:attr:`~ExecutableCache.compiles` (per cache: the registry's are shared by
every cache of one name), and with memory accounting on records each
compile's wall time in memscope's compile ledger, under the cache's name
or the site its caller names.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..profiler import memscope as _memscope
from ..profiler import metrics as _metrics
from ..utils import concurrency as _conc

__all__ = ["next_bucket", "bucket_shape", "pad_batch", "seq_buckets",
           "BucketPolicy", "ExecutableCache"]


def next_bucket(n: int, min_bucket: int = 1, cap: Optional[int] = None
                ) -> int:
    """Smallest power of two >= ``n`` (and >= ``min_bucket``), clamped to
    ``cap`` when given.  ``n`` itself is returned when it exceeds the cap
    — the caller decided to admit it, so it gets its own bucket."""
    if n < 0:
        raise ValueError(f"bucket size for negative dim {n}")
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    if cap is not None and b > cap:
        return n if n > cap else cap
    return b


class BucketPolicy:
    """Which dims of each input get padded, and to what bucket.

    ``input_avals`` holds ``(shape, dtype)`` per input, ``-1`` or None
    marking a dynamic dim.  Dim 0 is the batch dim and is always bucketed;
    the other dynamic dims only with ``pad_dynamic_dims=True``, because
    zero-padding a content dim changes the math of a model without
    masking."""

    def __init__(self, input_avals: Sequence[Tuple[Sequence[int], str]],
                 max_batch_size: int = 8, min_batch_bucket: int = 1,
                 pad_dynamic_dims: bool = False):
        self.max_batch_size = int(max_batch_size)
        self.min_batch_bucket = int(min_batch_bucket)
        self.pad_dynamic_dims = bool(pad_dynamic_dims)
        # per input: indices of the non-batch dims declared dynamic
        self.dynamic_dims: List[Tuple[int, ...]] = [
            tuple(i for i, d in enumerate(shape)
                  if i > 0 and (d is None or int(d) < 0))
            for shape, _dt in input_avals or ()]

    def batch_bucket(self, rows: int) -> int:
        return next_bucket(rows, self.min_batch_bucket,
                           cap=self.max_batch_size)

    def bucket_shape(self, idx: int, shape: Sequence[int],
                     rows_bucket: int) -> Tuple[int, ...]:
        """Padded shape of input ``idx``: the batch dim -> ``rows_bucket``,
        dynamic dims -> power-of-two buckets when enabled, the rest as
        they are."""
        out = list(shape)
        out[0] = rows_bucket
        if self.pad_dynamic_dims and idx < len(self.dynamic_dims):
            for d in self.dynamic_dims[idx]:
                if d < len(out):
                    out[d] = next_bucket(out[d])
        return tuple(out)

    def max_buckets(self) -> int:
        """The number of batch buckets: the bound on executables when the
        non-batch shapes are fixed."""
        n, b = 1, max(self.min_batch_bucket, 1)
        while b < self.max_batch_size:
            b <<= 1
            n += 1
        return n


def seq_buckets(max_length: int, min_bucket: int = 8) -> List[int]:
    """All power-of-two sequence buckets in ``[min_bucket, max_length]``
    (the last clamps to ``max_length``): the prefill shapes a session can
    run, so ``len(seq_buckets(...)) + 1`` (with the decode step) bounds a
    session's executables."""
    out, b = [], max(1, int(min_bucket))
    cap = max(1, int(max_length))
    while b < cap:
        out.append(b)
        b <<= 1
    out.append(cap)
    return out


def bucket_shape(shape: Sequence[int], max_batch_size: int = 8
                 ) -> Tuple[int, ...]:
    """``shape`` with dim 0 bucketed (power of two, capped)."""
    out = list(shape)
    out[0] = next_bucket(out[0], cap=max_batch_size)
    return tuple(out)


def pad_batch(arr, target_shape: Sequence[int]):
    """Zero-pad ``arr`` up to ``target_shape`` (no dim may shrink); ``arr``
    itself when the shape already matches."""
    import numpy as np
    shape = tuple(arr.shape)
    target = tuple(int(t) for t in target_shape)
    if shape == target:
        return arr
    if len(shape) != len(target) or any(t < s for s, t in zip(shape,
                                                              target)):
        raise ValueError(f"cannot pad {shape} to {target}")
    out = np.zeros(target, dtype=arr.dtype)
    out[tuple(slice(0, s) for s in shape)] = np.asarray(arr)
    return out


class ExecutableCache:
    """``bucket key -> executable``, each made once.

    :meth:`get_or_compile` returns the key's entry (a hit) or runs
    ``compile_fn`` and keeps what it returns (a compile; on the card a
    capture).  A miss runs ``compile_fn`` exactly once per key even under
    concurrent callers: the first takes a per-key latch, the others wait on
    it and then read the entry, or compile themselves if it failed (a
    failing ``compile_fn`` publishes nothing).  ``valid(entry)``, when
    given, says whether an entry may still run; one that may not is
    dropped and made again (a captured step whose parameters were
    replaced).  ``site`` names the compile in memscope's ledger (the
    cache's name when not given)."""

    def __init__(self, name: str = "serving"):
        self.name = name
        self._lock = _conc.Lock(name=f"{name}.executable_cache")
        self._entries: Dict[Tuple, object] = {}
        self._inflight: Dict[Tuple, threading.Event] = {}
        self.hits = 0
        self.compiles = 0
        self._m_hits = _metrics.counter(
            f"{name}.executable_cache.hit",
            "bucketed executions served by an already-made executable")
        self._m_compiles = _metrics.counter(
            f"{name}.compile",
            "executable-cache misses == compiles (on the card: CUDA graph "
            "captures); bounded by the bucket count")

    def __len__(self):
        return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries)

    def entries(self):
        with self._lock:
            return dict(self._entries)

    def get_or_compile(self, key: Tuple, compile_fn: Callable[[], object],
                       valid: Optional[Callable[[object], bool]] = None,
                       site: Optional[str] = None):
        while True:
            with self._lock:
                exe = self._entries.get(key)
                if exe is not None:
                    if valid is None or valid(exe):
                        self.hits += 1
                        self._m_hits.inc()
                        return exe
                    del self._entries[key]
                latch = self._inflight.get(key)
                owner = latch is None
                if owner:
                    self._inflight[key] = latch = threading.Event()
            if not owner:
                latch.wait()
                continue            # re-read: the owner published or failed
            try:
                if _memscope.active:
                    t0 = time.perf_counter()
                    exe = compile_fn()
                    _memscope.compile_record(
                        site or self.name, key, time.perf_counter() - t0,
                        provenance="jit")
                else:
                    exe = compile_fn()
                with self._lock:
                    self._entries[key] = exe
                    self.compiles += 1
                    # under the lock: exact compile counts
                    self._m_compiles.inc()
                return exe
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                latch.set()
