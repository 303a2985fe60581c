"""Generation: fixed-capacity KV cache, seeded sampling, and the
prefill/decode session."""
from .kv_cache import (KVCache, attention_mask, init_caches,
                       init_layer_cache, kv_view, write, write_kv)
from .sampling import gumbel_noise, sample, sample_row
from .session import GenerationSession

__all__ = ["KVCache", "attention_mask", "init_caches", "init_layer_cache",
           "kv_view", "write", "write_kv", "gumbel_noise", "sample",
           "sample_row", "GenerationSession"]
