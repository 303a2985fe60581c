"""The device prefetch stage — the counterpart of
``paddle_tpu/io/prefetch.py`` (``DevicePrefetcher`` :58).

A step should not wait for the host to collate its batch or copy it to
the card.  :class:`DevicePrefetcher` runs one epoch of a loader ahead of
its consumer:

- a background thread collates each batch (indexed mode: a map-style
  ``DataLoader`` without workers, whose batch plan is drawn from its
  sampler once, as the plain iterator draws it, with up to ``retries``
  refetches of a batch whose fetch raised) or pulls it from an iterable
  (iterator mode);
- on the card it copies every tensor leaf (numpy arrays become tensors)
  into pinned host memory and issues the host-to-device copy
  ``non_blocking`` on a CUDA stream of its own, then records an event;
- it parks the batch in a queue of ``depth`` batches.

The consumer takes a batch from the queue, makes its current stream wait
on the batch's event, and calls ``record_stream`` on each leaf, so that
the caching allocator does not hand a leaf's memory back to the copy
stream while the consumer's stream may still read it.  A step that takes
the batch (``StepGraph._load``) then copies device to device.  With
``device="cpu"`` nothing moves: the thread only collates.

Batch order is the unprefetched loader's, so a fixed seed gives the same
training with the stage on or off.  A prefetcher is one-shot: iterate it
once, and make a fresh one per epoch.  An error upstream reaches the
consumer in order, after the batches made before it.  ``stats`` counts
``gets``, ``nonempty_gets`` (the queue held a batch when asked),
``max_depth``, ``refetch`` and ``produced`` in plain integers.
"""
from __future__ import annotations

import contextlib
import queue as _queue
import threading
import warnings
from typing import Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DevicePrefetcher"]

# one copy stream per device, shared by every prefetcher, so that an
# epoch's batches reuse the memory the last epoch's freed
_STREAMS = {}


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _leaves(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _leaves(o)


class DevicePrefetcher:
    """One epoch of ``source`` fed ahead onto ``device`` (see the module
    docstring).  ``source`` is any iterable of batches (iterator mode), or
    a ``DataLoader`` given to :meth:`for_loader`.  ``device`` is the card
    unless ``"cpu"`` is asked for."""

    def __init__(self, source: Iterable, depth: int = 2, device=None,
                 retries: int = 3, name: str = "io.prefetch"):
        self._source = source
        self._plan = None          # indexed mode: list of index batches
        self._loader = None
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._retries = max(0, int(retries))
        self.name = name
        self._q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None
        self._started = False
        self._warned_refetch = False
        self.stats = {"gets": 0, "nonempty_gets": 0, "max_depth": 0,
                      "refetch": 0, "produced": 0}

    @classmethod
    def for_loader(cls, loader, depth: int = 2, device=None,
                   retries: int = 3) -> "DevicePrefetcher":
        """Prefetcher for a ``DataLoader``: a map-style loader without
        workers is collated on the prefetch thread (indexed mode, with
        refetch); a worker-backed or iterable one feeds its batches as
        they come."""
        pf = cls(loader, depth=depth, device=device, retries=retries)
        if getattr(loader, "batch_sampler", None) is not None and \
                getattr(loader, "num_workers", 0) == 0:
            # one sampler draw, as the plain iterator makes it
            pf._plan = list(loader.batch_sampler)
            pf._loader = loader
        else:
            pf._source = loader._iter_batches()
        return pf

    # -- producer side -------------------------------------------------
    def _to_device(self, obj):
        if isinstance(obj, np.ndarray):
            obj = torch.from_numpy(obj if obj.flags.writeable
                                   else obj.copy())
        if isinstance(obj, torch.Tensor):
            if self.device.type == "cpu" or obj.device == self.device:
                return obj
            if obj.device.type == "cpu" and not obj.is_pinned():
                obj = obj.pin_memory()
            return obj.to(self.device, non_blocking=True)
        if isinstance(obj, tuple):
            return tuple(self._to_device(o) for o in obj)
        if isinstance(obj, list):
            return [self._to_device(o) for o in obj]
        if isinstance(obj, dict):
            return {k: self._to_device(v) for k, v in obj.items()}
        return obj

    def _fetch_with_retry(self, i: int, indices):
        last = None
        for attempt in range(self._retries + 1):
            try:
                return self._loader._fetch(indices)
            except BaseException as e:
                last = e
                if attempt == self._retries:
                    break
                self.stats["refetch"] += 1
                if not self._warned_refetch:
                    self._warned_refetch = True
                    warnings.warn(
                        f"DevicePrefetcher: fetch of batch {i} failed "
                        f"({type(last).__name__}: {last}); refetching "
                        f"in place (no batch is lost)")
        raise RuntimeError(
            f"DevicePrefetcher: batch {i} still failing after "
            f"{self._retries} refetches") from last

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def _batches(self):
        if self._plan is not None:
            for i, indices in enumerate(self._plan):
                yield self._fetch_with_retry(i, indices)
        else:
            yield from self._source

    def _produce(self):
        cuda = self.device.type == "cuda"
        try:
            with torch.cuda.stream(self._stream) if cuda else \
                    contextlib.nullcontext():
                for batch in self._batches():
                    if self._stop.is_set():
                        return
                    batch = self._to_device(batch)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    self.stats["produced"] += 1
                    if not self._put(("b", (batch, event))):
                        return
        except BaseException as e:   # surfaces at the consumer, in order
            self._put(("e", e))
            return
        self._put(("end", None))

    # -- consumer side -------------------------------------------------
    def _start(self):
        self._started = True
        if self.device.type == "cuda":
            self._stream = _STREAMS.get(self.device)
            if self._stream is None:
                self._stream = _STREAMS[self.device] = torch.cuda.Stream(
                    device=self.device)
        self._thread = threading.Thread(target=self._produce,
                                        name="paddle-prefetch", daemon=True)
        self._thread.start()

    def _hand_over(self, batch, event):
        """Order the consumer's stream after the batch's copies, and keep
        the copies' memory from being reused before that stream is done
        with it."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for leaf in _leaves(batch):
            if leaf.device == self.device:
                leaf.record_stream(cur)

    def __iter__(self):
        if self._started:
            raise RuntimeError(
                "DevicePrefetcher is one-shot; build a fresh one per "
                "epoch (DataLoader(prefetch_to_device=N) does)")
        self._start()
        try:
            while True:
                try:
                    kind, payload = self._q.get_nowait()
                    nonempty = True
                except _queue.Empty:
                    kind, payload = self._q.get()
                    nonempty = False
                if kind == "end":
                    return
                if kind == "e":
                    raise payload
                self.stats["gets"] += 1
                if nonempty:
                    self.stats["nonempty_gets"] += 1
                self.stats["max_depth"] = max(self.stats["max_depth"],
                                              self._q.qsize())
                batch, event = payload
                if event is not None:
                    self._hand_over(batch, event)
                yield batch
        finally:
            self.close()

    def close(self):
        """Stop the producer and drop the queued batches (idempotent)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._thread = None
        # an upstream generator (a worker-backed loader) runs its own
        # clean-up when closed
        src_close = getattr(self._source, "close", None)
        if src_close is not None:
            try:
                src_close()
            except Exception:
                pass
        self._source = None

