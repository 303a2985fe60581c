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

:func:`seed` reseeds all of them from one integer.  jax.random and torch
draw different numbers from the same seed, so the port does not repeat
the reference's draws; parity tests hand seeds and weights across.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

__all__ = ["Generator", "default_generator", "seed"]

_M64 = (1 << 64) - 1


def _mix(value: int) -> int:
    """splitmix64 of ``value``: the device streams' seed, so that they do
    not repeat the host stream of the same integer."""
    z = (value + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1          # torch seeds are < 2**63 here


class Generator:
    """A host stream of fused-epilogue seeds and a stream per device."""

    def __init__(self, seed_val: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed_val)

    def manual_seed(self, seed_val: int) -> "Generator":
        with self._lock:
            self._seed = int(seed_val)
            self._host = torch.Generator().manual_seed(self._seed & _M64)
            self._devices: Dict[torch.device, torch.Generator] = {}
        return self

    def next_seed(self) -> int:
        """A seed in ``[0, 2**31 - 1)``, the reference's range
        (``ops/fused_ops.py:201``), drawn on the host."""
        with self._lock:
            return int(torch.randint(0, 2**31 - 1, (), generator=self._host))

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
