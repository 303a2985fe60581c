"""Random state — the counterpart of ``paddle_tpu/core/random.py``
(``default_generator``, ``seed``).

The reference draws every random number from one process generator of
JAX keys.  The port keeps explicit ``torch.Generator``s in one
:class:`Generator`:

- a CPU generator for the seeds of the fused epilogue's hash dropout
  (:func:`~paddle_tpu_torch.ops.fused_ops.fused_bias_dropout_residual_layer_norm`):
  each call draws its seed on the host, so nothing waits for the card;
- one generator per device, made at first use, for dropout masks and for
  the fused layers' initial weights.

:func:`seed` reseeds all of them from one integer, the device generators
in place (a captured CUDA graph keeps the generator it was captured
with).  jax.random and torch draw different numbers from the same seed,
so the port does not repeat the reference's draws; parity tests hand
seeds and weights across.

A step captured in a CUDA graph (:mod:`~paddle_tpu_torch.graphs`) cannot
draw on the host when it is replayed.  While it is captured, its seeds
come from a :class:`SeedSlots` vector on the card, one slot a draw; before
each replay the host draws as many seeds, in the same order and from the
same generator, and copies them in.  A replay therefore draws the seeds
the uncaptured step would have drawn.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List

import torch

__all__ = ["Generator", "SeedSlots", "default_generator", "seed"]

_M64 = (1 << 64) - 1
# the SeedSlots a capture on this thread takes its seeds from
_local = threading.local()


def _mix(value: int) -> int:
    """splitmix64 of ``value``: the device streams' seed, so that they do
    not repeat the host stream of the same integer."""
    z = (value + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1          # torch seeds are < 2**63 here


class Generator:
    """A host stream of fused-epilogue seeds and a stream per device.
    :attr:`draws` counts the seeds drawn from the host stream."""

    def __init__(self, seed_val: int = 0):
        self._lock = threading.Lock()
        self._devices: Dict[torch.device, torch.Generator] = {}
        self.draws = 0
        self.manual_seed(seed_val)

    def manual_seed(self, seed_val: int) -> "Generator":
        with self._lock:
            self._seed = int(seed_val)
            self._host = torch.Generator().manual_seed(self._seed & _M64)
            for gen in self._devices.values():
                gen.manual_seed(_mix(self._seed))
        return self

    def _draw(self) -> int:
        self.draws += 1
        return int(torch.randint(0, 2**31 - 1, (), generator=self._host))

    def next_seed(self):
        """A seed in ``[0, 2**31 - 1)``, the reference's range
        (``ops/fused_ops.py:201``), drawn on the host; while a step is
        captured on this thread, the next slot of its :class:`SeedSlots`
        instead (a 1-element int64 tensor on the card)."""
        slots = getattr(_local, "slots", None)
        if slots is not None:
            return slots.take()
        with self._lock:
            return self._draw()

    def draw_seeds(self, n: int) -> List[int]:
        """``n`` seeds from the host stream, in order, as ``n`` calls of
        :meth:`next_seed` outside a capture would draw them."""
        with self._lock:
            return [self._draw() for _ in range(int(n))]

    def device(self, device) -> torch.Generator:
        """The stream of ``device``, made at first use."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            gen = self._devices.get(dev)
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(
                    _mix(self._seed))
                self._devices[dev] = gen
            return gen


default_generator = Generator(0)


def seed(seed_val: int) -> Generator:
    """Reseed the port's default random state (``paddle.seed``)."""
    return default_generator.manual_seed(seed_val)


class SeedSlots:
    """The seed vector of a captured step: ``capacity`` int64 slots on
    ``device``.  Inside :meth:`recording`, each :meth:`Generator.next_seed`
    on this thread takes the next slot (:meth:`take`) in place of a host
    draw; :meth:`refill` then draws :attr:`count` seeds from the
    generator and copies them into the slots, in draw order, before each
    replay."""

    def __init__(self, capacity: int, device):
        self.capacity = int(capacity)
        self.count = 0
        self.buf = torch.zeros((max(self.capacity, 1),), dtype=torch.int64,
                               device=device)

    def take(self) -> torch.Tensor:
        if self.count >= self.capacity:
            raise RuntimeError(
                f"the captured step draws more than the {self.capacity} "
                "seeds its uncaptured run drew")
        self.count += 1
        return self.buf[self.count - 1:self.count]

    @contextlib.contextmanager
    def recording(self):
        prev = getattr(_local, "slots", None)
        _local.slots = self
        try:
            yield self
        finally:
            _local.slots = prev

    def refill(self) -> List[int]:
        """Draw the seeds of one replay into the slots (from
        :data:`default_generator`); returns them."""
        vals = default_generator.draw_seeds(self.count)
        if vals:
            host = torch.tensor(vals, dtype=torch.int64)
            if self.buf.is_cuda:
                host = host.pin_memory()
            self.buf[:len(vals)].copy_(host, non_blocking=True)
        return vals
