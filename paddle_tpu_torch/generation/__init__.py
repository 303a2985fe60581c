"""Generation: fixed-capacity and paged KV caches, seeded sampling, the
prefill/decode sessions, the prefix cache, speculative decoding and the
KV chain wire format."""
from .kv_cache import (KVCache, attention_mask, init_caches,
                       init_layer_cache, kv_view, write, write_kv)
from .kv_wire import (KVTransferCorrupt, chain_digests, deserialize_chain,
                      serialize_chain)
from .paged_kv import (BlockPool, BlockPoolExhausted, KVArena, KVArenaQ,
                       PagedGenerationSession, PagedKV, arena_blocks,
                       blocks_for_tokens, init_arenas, paged_view,
                       write_paged)
from .prefix_cache import PrefixCache
from .sampling import gumbel_noise, sample, sample_row
from .session import GenerationSession
from .speculative import (accept_span, draft_row, fill_verify_row,
                          propose_drafts)

__all__ = ["KVCache", "attention_mask", "init_caches", "init_layer_cache",
           "kv_view", "write", "write_kv", "gumbel_noise", "sample",
           "sample_row", "GenerationSession", "KVArena", "KVArenaQ",
           "PagedKV", "BlockPool", "BlockPoolExhausted",
           "PagedGenerationSession", "init_arenas", "write_paged",
           "paged_view", "blocks_for_tokens", "arena_blocks", "PrefixCache",
           "propose_drafts", "accept_span", "draft_row", "fill_verify_row",
           "KVTransferCorrupt", "serialize_chain", "deserialize_chain",
           "chain_digests"]
