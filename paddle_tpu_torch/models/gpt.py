"""GPT-style decoder LM — the counterpart of ``paddle_tpu/models/gpt.py``.

Same structure, names and math as the reference's eager GPT: token and
position embeddings, pre-LN blocks (LayerNorm -> fused QKV projection ->
causal attention -> output projection; LayerNorm -> exact-erf GELU FFN),
a final LayerNorm and an untied LM head.  Attention goes through
:func:`~paddle_tpu_torch.ops.nn_misc.scaled_dot_product_attention`, which
takes the hand-written flash-attention kernels for CUDA tensors: the
forward, and under autograd the forward with lse and the backward.

``forward(ids)`` scores a whole sequence; under autograd, in ``train()``
mode, it is the forward of the eager train path
(:class:`~paddle_tpu_torch.Model`).  Dropout is 0 in the default config,
as in the reference.  With ``caches`` it runs the
generation steps over fixed-capacity KV caches, which it updates **in
place**: a decode step (``positions`` given) writes one token's keys and
values per row and attends over the capacity axis under a length mask; a
prefill (no ``positions``) starts every row at position 0 of a zeroed
cache, where the reference's length mask is exactly causal attention over
the prompt bucket, so the prefill attends through the kernel.  A paged
cache (:class:`~paddle_tpu_torch.generation.paged_kv.PagedKV`, from
:meth:`GPT.gen_arenas`) goes through the same calls: a chunk whose rows all
start at 0 (``fresh``) attends through the kernel over its window, every
other chunk with the masked math over the gathered view.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..generation import kv_cache as _kv
from ..ops.nn_misc import scaled_dot_product_attention

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPT"]


@dataclass
class GPTConfig:
    vocab_size: int = 8192
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    max_seq_len: int = 512
    ffn_mult: int = 4
    dropout: float = 0.0


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = D // cfg.num_heads
        self.qkv = nn.Linear(D, 3 * D)
        self.out = nn.Linear(D, D)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor, cache: Optional[_kv.KVCache] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, D = x.shape
        h, hd = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).reshape(B, T, 3, h, hd).unbind(2)
        if cache is None or positions is None:
            if cache is not None:
                # zeroed cache, every row at position 0
                cache.k[:, :T] = k
                cache.v[:, :T] = v
            ctx = scaled_dot_product_attention(q, k, v, is_causal=True)
        else:
            _kv.write(cache, k, v, positions)
            if getattr(cache, "fresh", False):
                # a paged chunk with every row at position 0: the length
                # mask is exactly causal over the window
                ctx = scaled_dot_product_attention(q, k, v, is_causal=True)
            else:
                kv_k, kv_v = _kv.kv_view(cache)
                mask = _kv.attention_mask(positions, T, kv_k.shape[1],
                                          dtype=q.dtype)
                ctx = scaled_dot_product_attention(q, kv_k, kv_v,
                                                   attn_mask=mask)
        return self.dropout(self.out(ctx.reshape(B, T, D)))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.ln1 = nn.LayerNorm(D, eps=1e-5)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(D, eps=1e-5)
        self.up = nn.Linear(D, cfg.ffn_mult * D)
        self.down = nn.Linear(cfg.ffn_mult * D, D)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor, cache: Optional[_kv.KVCache] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), cache=cache, positions=positions)
        return x + self.dropout(self.down(F.gelu(self.up(self.ln2(x)))))


class GPT(nn.Module):
    """Decoder-only LM; ``forward(ids) -> logits (B, T, V)``.

    Built on ``device`` (the card unless ``device="cpu"``) with weights
    drawn from ``seed`` in the reference's distributions: Xavier-normal
    linear weights, zero biases, N(0, 1) embeddings, LayerNorm 1 and 0.
    """

    def __init__(self, cfg: GPTConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        with torch.device("meta"):
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
            self.blocks = nn.ModuleList([GPTBlock(cfg)
                                         for _ in range(cfg.num_layers)])
            self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
            self.head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False)
        self.to_empty(device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        """Redraw every weight from ``seed`` on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                                   generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=gen)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, ids: torch.Tensor,
                caches: Optional[Sequence[_kv.KVCache]] = None,
                positions=None):
        """Logits ``(B, T, V)``; with ``caches``, ``(logits, caches)``.

        A cached step writes at per-row ``positions`` ``(B,)``; without
        ``positions`` it is a prefill, which writes every row from 0 into
        zeroed caches.  Cached positions clip to ``max_seq_len - 1``."""
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        B, T = ids.shape
        steps = torch.arange(T, device=self.device)
        if caches is None:
            x = self.wte(ids) + self.wpe(steps[None])
            for blk in self.blocks:
                x = blk(x)
            return self.head(self.ln_f(x))
        if positions is None:
            if T > caches[0].capacity:
                raise ValueError(f"a prefill of {T} tokens overruns the "
                                 f"cache capacity {caches[0].capacity}")
            starts = None
            x = self.wte(ids) + self.wpe(steps[None])
        else:
            starts = torch.as_tensor(positions, dtype=torch.long,
                                     device=self.device)
            idx = (starts[:, None] + steps[None, :]).clamp(
                0, self.cfg.max_seq_len - 1)
            x = self.wte(ids) + self.wpe(idx)
        for blk, c in zip(self.blocks, caches):
            x = blk(x, cache=c, positions=starts)
        return self.head(self.ln_f(x)), caches

    def gen_caches(self, batch: int, capacity: Optional[int] = None
                   ) -> Tuple[_kv.KVCache, ...]:
        """Zero fixed-capacity caches on the model's device, one per block,
        each ``(batch, capacity, num_heads, head_dim)``; ``capacity``
        defaults to (and is bounded by) ``cfg.max_seq_len``."""
        cap = int(capacity or self.cfg.max_seq_len)
        if cap > self.cfg.max_seq_len:
            raise ValueError(f"capacity {cap} exceeds max_seq_len "
                             f"{self.cfg.max_seq_len}")
        return _kv.init_caches(self.cfg.num_layers, batch, cap,
                               self.cfg.num_heads,
                               self.cfg.hidden_size // self.cfg.num_heads,
                               device=self.device,
                               dtype=self.wte.weight.dtype)

    def gen_arenas(self, num_blocks: int, block_size: int,
                   quantized: bool = False):
        """Zero paged KV arenas on the model's device, one per block:
        ``(num_blocks + 1, block_size, num_heads, head_dim)`` each, the
        last block the sink of invalid writes (int8 with fp32 scales when
        ``quantized``).  Block tables, not the arena's shape, decide which
        request owns which block."""
        from ..generation import paged_kv as _paged
        return _paged.init_arenas(self.cfg.num_layers, num_blocks,
                                  block_size, self.cfg.num_heads,
                                  self.cfg.hidden_size // self.cfg.num_heads,
                                  quantized=quantized, device=self.device,
                                  dtype=self.wte.weight.dtype)

    def generate(self, ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 seeds=None, eos_token_id=None, max_length=None,
                 batch_capacity=None, stream_callback=None
                 ) -> list:
        """Continue ``ids`` (``(P,)``/``(B, P)`` or a ragged list of
        prompts) -> one int32 array of generated tokens per row (eos, when
        hit, included).  Greedy by default; ``do_sample=True`` samples
        with per-row seeds, reproducibly across runs and batch positions.
        Runs a :class:`~paddle_tpu_torch.generation.GenerationSession`
        built for the batch."""
        from ..generation.session import GenerationSession
        from ..serving.bucketing import next_bucket
        rows, _ = GenerationSession._normalize_prompts(ids, None)
        cap_b = int(batch_capacity or next_bucket(max(len(rows), 1)))
        sess = GenerationSession(self, batch_capacity=cap_b,
                                 max_length=max_length)
        return sess.generate(
            rows, max_new_tokens=max_new_tokens, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            seeds=seeds, eos_token_id=eos_token_id,
            stream_callback=stream_callback)

