"""Seeded token sampling — the counterpart of
``paddle_tpu/generation/sampling.py``.

The contract is the reference's:

1. **Per-row knobs.**  Temperature, top-k and top-p arrive as ``(B,)``
   tensors, so any per-row mix of settings runs in one call.  Greedy is
   ``temperature <= 0``.
2. **Batchmate independence.**  A row sees only its own logits and its own
   noise, so its stream is the same whether it runs alone or in any slot
   of a continuous batch.
3. **Determinism.**  The noise is a pure function of (request seed, token
   position, vocab index): no generator state is consumed, so a fixed
   seed reproduces the stream across runs and processes.

Selection is Gumbel-max over the top-k / top-p masked, temperature-scaled
logits, with the keep-sets computed exactly as the reference computes
them.  The Gumbel noise comes from a counter-based hash (murmur3's
32-bit finaliser) evaluated with integer tensor ops, so a sampled stream
is reproducible on one device but is not the reference's JAX bit stream.
"""
from __future__ import annotations

import torch

__all__ = ["sample", "sample_row", "gumbel_noise"]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, without
    overflowing int64 (the constant is split into 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise ``(B, vocab)`` fp32: row ``i`` is a pure function
    of ``(seeds[i], counters[i])`` — the request seed and the position of
    the token being sampled."""
    dev = seeds.device
    seeds = seeds.to(torch.long)
    h = _fmix32((seeds & _M32) ^ 0x243F6A88)
    h = _fmix32(h ^ ((seeds >> 32) & _M32))
    h = _fmix32(h ^ (counters.to(torch.long) & _M32))
    idx = _mul32(torch.arange(vocab, device=dev, dtype=torch.long),
                 0x9E3779B1)
    bits = _fmix32(h[:, None] ^ idx[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, seeds: torch.Tensor,
           counters: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Token ids ``(B,)`` from ``logits (B, V)`` with per-row ``seeds``,
    ``counters`` (token positions) and knobs, all ``(B,)``.

    ``temperature <= 0`` -> greedy argmax (noise unused).
    ``top_k <= 0`` -> no top-k cut; else keep the k highest.
    ``top_p`` outside (0, 1) -> no nucleus cut; else keep the smallest
    prefix of the probability-sorted vocab whose cumulative mass reaches
    ``top_p`` (the argmax token is always kept)."""
    logits = logits.to(torch.float32)
    B, V = logits.shape
    dev = logits.device
    temperature = temperature.to(device=dev, dtype=torch.float32)
    top_k = top_k.to(device=dev, dtype=torch.long)
    top_p = top_p.to(device=dev, dtype=torch.float32)
    greedy = temperature <= 0
    t = torch.where(greedy, torch.ones_like(temperature),
                    temperature.clamp_min(1e-6))
    scaled = logits / t[:, None]

    order = torch.argsort(-scaled, dim=-1, stable=True)   # descending
    sorted_desc = scaled.gather(-1, order)

    # top-k: keep scores >= the k-th highest (k <= 0 means all)
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, V),
                        top_k.clamp(1, V))
    kth = sorted_desc.gather(-1, (k_eff - 1).clamp(0, V - 1)[:, None])
    keep_k = scaled >= kth

    # top-p over the sorted softmax: a token is kept while the mass
    # before it is still under p (so the argmax always survives)
    p_eff = torch.where((top_p <= 0) | (top_p >= 1), torch.ones_like(top_p),
                        top_p)
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    keep_sorted = cum_before < p_eff[:, None]
    keep_sorted[:, 0] = True
    keep_p = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)

    masked = torch.where(keep_k & keep_p, scaled,
                         torch.full_like(scaled, float("-inf")))
    g = gumbel_noise(seeds.to(dev), counters.to(dev), V)
    sampled = torch.argmax(masked + g, dim=-1)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)


def sample_row(logits: torch.Tensor, seed, counter, temperature, top_k,
               top_p) -> torch.Tensor:
    """One token id from one row's ``(V,)`` logits (see :func:`sample`)."""
    dev = logits.device

    def one(x, dtype):
        return torch.as_tensor([x], dtype=dtype, device=dev).reshape(1)

    return sample(logits[None], one(seed, torch.long),
                  one(counter, torch.long), one(temperature, torch.float32),
                  one(top_k, torch.long), one(top_p, torch.float32))[0]
