"""RNG state management — the rest of ``paddle_tpu/core/random.py``
(``get_rng_state`` :157, ``set_rng_state`` :170, ``rng_scope`` :176,
``RNGStatesTracker`` :193, ``get_rng_tracker`` :206) on the port's
generators (``paddle_tpu_torch/random.py``).

Every draw of the eager core (creation ops, initializers, dropout) comes
from :data:`~paddle_tpu_torch.random.default_generator`: the device
stream of the tensor's device, reseeded by :func:`seed`.  torch's and
JAX's random bits differ, so the port's draws are held to their
statistics and to determinism under ``seed``, never to the reference's
bits.
"""
from __future__ import annotations

import contextlib
from typing import Dict

from ..random import Generator, default_generator
from ..random import seed as _seed

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "rng_scope", "RNGStatesTracker",
           "get_rng_tracker"]


def seed(seed_val: int) -> Generator:
    """``paddle.seed``: reseed the default generator (every stream, in
    place) and reset the named-stream tracker."""
    _seed(int(seed_val))
    get_rng_tracker().reset(int(seed_val))
    return default_generator


def get_rng_state() -> Dict:
    """The default generator's whole state, as data, for
    :func:`set_rng_state`."""
    return default_generator.get_state()


def set_rng_state(state: Dict) -> None:
    default_generator.set_state(state)


def _state_for(seed_val: int) -> Dict:
    """The state of a generator seeded with ``seed_val``, with a stream for
    every device the default generator has drawn on."""
    g = Generator(seed_val)
    for dev in list(default_generator._devices):
        g.device(dev)
    return g.get_state()


class rng_scope:
    """Draw from a generator seeded with ``key`` inside the block; the
    default generator's state is restored after it."""

    def __init__(self, key: int):
        self._key = int(key)

    def __enter__(self):
        self._saved = default_generator.get_state()
        default_generator.set_state(_state_for(self._key))
        return self

    def __exit__(self, *exc):
        default_generator.set_state(self._saved)
        return False


class RNGStatesTracker:
    """Named random streams for model-parallel determinism (reference
    ``parallel_layers/random.py``): ``rng_state(name)`` swaps the named
    stream into the default generator for the block."""

    def __init__(self):
        self._states: Dict[str, Dict] = {}

    def reset(self, base_seed: int = 0):
        self._states = {}
        self._base = base_seed

    def add(self, name: str, seed_val: int):
        if name in self._states:
            raise ValueError(f"rng state '{name}' already exists")
        self._states[name] = _state_for(int(seed_val))

    @contextlib.contextmanager
    def rng_state(self, name: str = "model_parallel_rng"):
        if name not in self._states:
            raise ValueError(f"rng state '{name}' not registered")
        saved = default_generator.get_state()
        default_generator.set_state(self._states[name])
        try:
            yield
        finally:
            self._states[name] = default_generator.get_state()
            default_generator.set_state(saved)


_tracker = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _tracker

