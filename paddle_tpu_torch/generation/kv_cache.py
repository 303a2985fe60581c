"""Fixed-capacity KV cache — the counterpart of
``paddle_tpu/generation/kv_cache.py``.

Each layer holds pre-allocated ``(B, capacity, H, D)`` key and value
buffers; a step writes its new keys and values at per-row offsets and
attends over the whole capacity axis under a length mask, so shapes never
change from step to step.

Unlike the reference, whose arrays are immutable, the port updates the
buffers **in place**: :func:`write_kv` and :func:`write` mutate the cache
they are given and return it.  :func:`write` and :func:`kv_view` dispatch
on the cache's structure: a paged cache
(:class:`~paddle_tpu_torch.generation.paged_kv.PagedKV`) takes the
block-table write and gather, so the attention layers read every layout
through the same two calls.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["KVCache", "init_layer_cache", "init_caches", "write_kv",
           "write", "kv_view", "attention_mask"]


class KVCache(NamedTuple):
    """One attention layer's cache: ``k``/``v`` of shape
    ``(B, capacity, num_heads, head_dim)``."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.k.shape[1])

    @property
    def batch(self) -> int:
        return int(self.k.shape[0])


def init_layer_cache(batch: int, capacity: int, num_heads: int,
                     head_dim: int, *, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> KVCache:
    """Zero-filled cache for one attention layer."""
    shape = (int(batch), int(capacity), int(num_heads), int(head_dim))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_caches(num_layers: int, batch: int, capacity: int, num_heads: int,
                head_dim: int, *, device: torch.device,
                dtype: torch.dtype = torch.float32) -> Tuple[KVCache, ...]:
    """Per-layer tuple of zero caches."""
    return tuple(init_layer_cache(batch, capacity, num_heads, head_dim,
                                  device=device, dtype=dtype)
                 for _ in range(int(num_layers)))


def write_kv(buf: torch.Tensor, new: torch.Tensor,
             starts: torch.Tensor) -> torch.Tensor:
    """Write ``new`` ``(B, S, H, D)`` into ``buf`` ``(B, C, H, D)`` at
    per-row offsets ``starts`` ``(B,)``, in place; returns ``buf``.  A
    start that would run past the capacity clamps to ``C - S``, as the
    reference's ``dynamic_update_slice`` does."""
    B, S = new.shape[0], new.shape[1]
    C = buf.shape[1]
    starts = torch.as_tensor(starts, dtype=torch.long, device=buf.device)
    starts = starts.clamp(0, max(C - S, 0))
    idx = starts[:, None] + torch.arange(S, device=buf.device)[None, :]
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, idx] = new.to(buf.dtype)
    return buf


def write(cache, k_new: torch.Tensor, v_new: torch.Tensor,
          starts: torch.Tensor):
    """Write one step's keys and values into ``cache`` in place (a paged
    cache through its block table); returns ``cache``."""
    if not isinstance(cache, KVCache):
        from .paged_kv import PagedKV, write_paged
        if not isinstance(cache, PagedKV):
            raise TypeError(f"expected a KVCache or a PagedKV, got "
                            f"{type(cache).__name__}")
        return write_paged(cache, k_new, v_new, starts)
    write_kv(cache.k, k_new, starts)
    write_kv(cache.v, v_new, starts)
    return cache


def kv_view(cache) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``(B, capacity, H, D)`` key and value views: the buffers of a
    :class:`KVCache`, or the block-table gather (dequantized when int8) of
    a paged cache."""
    if isinstance(cache, KVCache):
        return cache.k, cache.v
    from .paged_kv import paged_view
    return paged_view(cache)


def attention_mask(starts: torch.Tensor, q_len: int, capacity: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive mask ``(B, 1, q_len, capacity)`` for a query block written
    at per-row offsets ``starts``: query ``t`` of row ``i`` (absolute
    position ``starts[i] + t``) may attend slots ``j <= starts[i] + t``;
    every other slot gets the dtype's most negative finite value."""
    starts = torch.as_tensor(starts, dtype=torch.long)
    dev = starts.device
    jpos = torch.arange(capacity, device=dev)[None, None, :]
    qpos = starts[:, None, None] + torch.arange(q_len, device=dev)[None, :,
                                                                    None]
    allow = jpos <= qpos
    # both values filled on the device: no host-to-device copy, so the
    # mask can be built inside a captured CUDA graph
    big_neg = torch.full((), torch.finfo(dtype).min, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return torch.where(allow, zero, big_neg)[:, None]
