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

__all__ = ["DrawLog", "Generator", "SeedSlots", "default_generator",
           "get_state", "seed", "set_state"]

_M64 = (1 << 64) - 1
# the SeedSlots a capture on this thread takes its seeds from, and the
# DrawLog a recomputed region on this thread records into or replays
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
        return logged(self._next_seed)

    def _next_seed(self):
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

    def get_state(self) -> Dict:
        """The whole random state as data (the port's form of the
        reference's ``rng_seed`` / ``rng_counter`` checkpoint leaves,
        ``hapi/model.py:715-717``): the seed, the host stream's state and
        :attr:`draws`, and each device stream's state by device name.
        A captured step draws its replay's seeds from the host stream
        before it replays (:meth:`SeedSlots.refill`), so the state read
        after a step is the state after that step's draws."""
        with self._lock:
            return {"seed": self._seed, "host": self._host.get_state(),
                    "draws": self.draws,
                    "devices": {str(d): g.get_state()
                                for d, g in self._devices.items()}}

    def set_state(self, state: Dict, seed: int = None) -> "Generator":
        """Set the state :meth:`get_state` returned, every stream in place
        (a captured graph keeps the device generator it was captured
        with).  With ``seed`` the host and device streams restart from it
        instead, keeping the draw count: the reference's cross-world
        resume (``hapi/model.py:784-793``), where ``seed`` is
        ``derive_rank_seed`` of the saved seed and the new rank.  Device
        streams of devices this process lacks are left out."""
        if seed is not None:
            self.manual_seed(seed)
            with self._lock:
                self.draws = int(state["draws"])
            return self
        devices = {}
        for name, st in state.get("devices", {}).items():
            dev = torch.device(name)
            if dev.type == "cuda" and not (
                    torch.cuda.is_available()
                    and (dev.index or 0) < torch.cuda.device_count()):
                continue
            devices[self.device(dev)] = torch.as_tensor(st, dtype=torch.uint8)
        with self._lock:
            self._seed = int(state["seed"])
            self._host.set_state(torch.as_tensor(state["host"],
                                                 dtype=torch.uint8))
            self.draws = int(state["draws"])
            for gen, st in devices.items():
                gen.set_state(st)
        return self

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


def logged(draw):
    """``draw()``, kept in the :class:`DrawLog` this thread records into;
    while one replays, its next value instead, and ``draw`` is not
    called."""
    log = getattr(_local, "log", None)
    if log is None:
        return draw()
    return log.next(draw)


def drawing() -> bool:
    """Whether this thread is inside a draw that a :class:`DrawLog`
    records (its ops need not be kept: the log replays the value)."""
    return getattr(_local, "drawing", False)


class DrawLog:
    """The draws of one recomputed region, in order: host seeds (ints),
    capture slots and dropout keep masks (tensors)."""

    def __init__(self):
        self.values: List = []
        self._pos = None                # None: recording

    def next(self, draw):
        if self._pos is None:
            _local.drawing = True
            try:
                value = draw()
            finally:
                _local.drawing = False
            self.values.append(value)
            return value
        if self._pos >= len(self.values):
            raise RuntimeError(
                f"a recomputed region draws more than the {len(self.values)} "
                "values its forward drew")
        self._pos += 1
        return self.values[self._pos - 1]

    @contextlib.contextmanager
    def _active(self, pos):
        prev = getattr(_local, "log", None)
        _local.log, self._pos = self, pos
        try:
            yield self
        finally:
            _local.log = prev

    def recording(self):
        """The region's forward: every draw on this thread is kept."""
        return self._active(None)

    def replaying(self):
        """The region's recompute: every draw on this thread takes the
        next kept value, from the first."""
        return self._active(0)


def seed(seed_val: int) -> Generator:
    """Reseed the port's default random state (``paddle.seed``)."""
    return default_generator.manual_seed(seed_val)


def _torch_generators() -> Dict[str, torch.Generator]:
    gens = {"cpu": torch.default_generator}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            gens[f"cuda:{i}"] = torch.cuda.default_generators[i]
    return gens


def get_state() -> Dict:
    """The process's whole random state as data: the port's
    :data:`default_generator` (:meth:`Generator.get_state`) and, under
    ``"torch"``, torch's own default generators, which modules such as
    ``torch.nn.Dropout`` draw from."""
    state = default_generator.get_state()
    state["torch"] = {name: g.get_state()
                      for name, g in _torch_generators().items()}
    return state


def set_state(state: Dict, seed: int = None) -> None:
    """Set what :func:`get_state` returned, in place (see
    :meth:`Generator.set_state`, including ``seed``, which reseeds torch's
    default generators too)."""
    default_generator.set_state(state, seed=seed)
    if seed is not None:
        torch.manual_seed(int(seed) & _M64)
        return
    gens = _torch_generators()
    for name, st in state.get("torch", {}).items():
        if name in gens:
            gens[name].set_state(torch.as_tensor(st, dtype=torch.uint8))


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
