"""GPT-style decoder LM — the counterpart of ``paddle_tpu/models/gpt.py``.

The flagship eager model, built as the reference builds it from the
framework's own layers: ``nn.Layer``\\ s of ``nn.Linear`` (weights
``[in, out]``), ``nn.LayerNorm``, ``nn.Embedding``, ``nn.Dropout`` and
``nn.LayerList``, with the reference's structure and parameter names, so
its ``state_dict()`` as numpy arrays loads through ``set_state_dict`` as
it is.  Token and position embeddings, pre-LN blocks (LayerNorm -> fused
QKV projection -> causal attention -> output projection; LayerNorm ->
exact-erf GELU FFN), a final LayerNorm and an untied LM head.

``forward`` is written on Tensors through the port's tensor functions
(``reshape`` / ``split`` / ``squeeze``, the Tensor entry point of
``scaled_dot_product_attention``, ``nn.functional.gelu``), so the op
dispatch sees every op of the model: its ``op::`` spans, AMP casts and
checks.  Attention takes the hand-written flash-attention kernels for
CUDA tensors: the forward, and under autograd the forward with lse and
the backward.  Called with torch tensors (``Model``, the generation
sessions, CUDA-graph capture) the model returns torch tensors, as every
``Layer`` does.

``forward(ids)`` scores a whole sequence; under autograd, in ``train()``
mode, it is the forward of the eager train path
(:class:`~paddle_tpu_torch.Model`).  Dropout is 0 in the default config,
as in the reference.  With ``caches`` it runs the generation steps over
fixed-capacity KV caches, which it updates **in place** (the caches'
torch tensors, so a captured graph's writes land in the session's own
storage): a decode step (``positions`` given) writes one token's keys and
values per row and attends over the capacity axis under a length mask; a
prefill (no ``positions``) starts every row at position 0 of a zeroed
cache, where the reference's length mask is exactly causal attention over
the prompt bucket, so the prefill attends through the kernel.  A paged
cache (:class:`~paddle_tpu_torch.generation.paged_kv.PagedKV`, from
:meth:`GPT.gen_arenas`) goes through the same calls: a chunk whose rows all
start at 0 (``fresh``) attends through the kernel over its window, every
other chunk with the masked math over the gathered view.

``GPT.generate`` keeps one
:class:`~paddle_tpu_torch.generation.GenerationSession` per (batch
bucket, max length) on the model, made under a module lock, so repeated
and concurrent calls share one set of captured steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import nn
from ..core.errors import UnimplementedError
from ..core.place import current_place, place_guard
from ..core.tensor import Tensor, unwrap
from ..device import resolve_device
from ..generation import kv_cache as _kv
from ..nn import functional as F
from ..nn.initializer import generator_guard
from ..nn.layer_base import _map
from ..ops.manipulation import reshape, split, squeeze
from ..ops.nn_ops import scaled_dot_product_attention
from ..utils import concurrency as _conc

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPT"]

# guards generate()'s per-model session cache (check, then insert)
_GEN_SESSION_LOCK = _conc.Lock(name="models.gpt.gen_sessions", lazy=True)


@dataclass
class GPTConfig:
    vocab_size: int = 8192
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    max_seq_len: int = 512
    ffn_mult: int = 4
    dropout: float = 0.0
    tensor_parallel: bool = False

    def __post_init__(self):
        if self.tensor_parallel:
            raise UnimplementedError(
                "GPTConfig(tensor_parallel=True): the model-parallel layers "
                "are not ported; see ROADMAP.md A5 (distributed): only the "
                "one-device path is ported")


def _token_ids(ids, dev: torch.device) -> Tensor:
    """``ids`` as a Tensor of integers on ``dev`` (the same Tensor when it
    is one); ``summary`` and ``flops`` feed fp32 zeros."""
    a = torch.as_tensor(unwrap(ids), device=dev)
    if a.is_floating_point():
        a = a.long()
    return ids if isinstance(ids, Tensor) and a is ids._data else Tensor(a)


class GPTAttention(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = D // cfg.num_heads
        self.qkv = nn.Linear(D, 3 * D)
        self.out = nn.Linear(D, D)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x, cache=None, positions=None):
        B, T, D = x.shape
        h, hd = self.num_heads, self.head_dim
        qkv = reshape(self.qkv(x), [B, T, 3, h, hd])
        q, k, v = [squeeze(s, axis=2) for s in split(qkv, 3, axis=2)]
        if cache is None:
            ctx = scaled_dot_product_attention(q, k, v, is_causal=True,
                                               training=self.training)
            return self.dropout(self.out(reshape(ctx, [B, T, D])))
        # the cache's own torch tensors (a call with torch tensors wraps
        # them): writes land in the caller's storage
        cache = _map(unwrap, cache)
        if positions is None:
            # a prefill: every row at position 0 of a zeroed cache, where
            # the length mask is exactly causal over the prompt
            cache.k[:, :T] = k._data
            cache.v[:, :T] = v._data
            ctx = scaled_dot_product_attention(q, k, v, is_causal=True,
                                               training=self.training)
        else:
            _kv.write(cache, k._data, v._data, positions)
            if getattr(cache, "fresh", False):
                # a paged chunk with every row at position 0: the length
                # mask is exactly causal over the window
                ctx = scaled_dot_product_attention(
                    q, k, v, is_causal=True, training=self.training)
            else:
                kv_k, kv_v = _kv.kv_view(cache)
                mask = _kv.attention_mask(positions, T, kv_k.shape[1],
                                          dtype=q.dtype)
                ctx = scaled_dot_product_attention(
                    q, Tensor(kv_k), Tensor(kv_v), attn_mask=Tensor(mask),
                    training=self.training)
        return self.dropout(self.out(reshape(ctx, [B, T, D]))), cache


class GPTBlock(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.ln1 = nn.LayerNorm(D)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(D)
        self.up = nn.Linear(D, cfg.ffn_mult * D)
        self.down = nn.Linear(cfg.ffn_mult * D, D)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x, cache=None, positions=None):
        if cache is None:
            x = x + self.attn(self.ln1(x))
        else:
            a, cache = self.attn(self.ln1(x), cache=cache,
                                 positions=positions)
            x = x + a
        x = x + self.dropout(self.down(F.gelu(self.up(self.ln2(x)))))
        return x if cache is None else (x, cache)


class GPT(nn.Layer):
    """Decoder-only LM; ``forward(ids) -> logits (B, T, V)``.

    ``GPT(cfg)`` is built on the current place and draws from the port's
    stream, as ``paddle_tpu_torch.seed`` set it, as the reference draws.
    With ``device=`` or ``seed=`` (the port's callers) it is built on
    ``device`` (the card unless ``device="cpu"``) and draws from a
    ``torch.Generator`` of that device seeded with ``seed`` (default 0),
    leaving the port's stream where it was.  Either way the weights
    follow the reference's distributions: Xavier-normal linear weights,
    zero biases, N(0, 1) embeddings, LayerNorm 1 and 0.
    """

    def __init__(self, cfg: GPTConfig, *, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        if device is None and seed is None:
            self._build(cfg)
            return
        dev = resolve_device(device) if device is not None \
            else current_place().torch_device()
        gen = torch.Generator(device=dev).manual_seed(int(seed or 0))
        with place_guard(dev), generator_guard(gen):
            self._build(cfg)

    def _build(self, cfg: GPTConfig):
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                              bias_attr=False)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
        self.blocks = nn.LayerList([GPTBlock(cfg)
                                    for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size)

    @property
    def device(self) -> torch.device:
        return self.wte.weight._data.device

    def forward(self, ids, caches=None, positions=None):
        """Logits ``(B, T, V)``; with ``caches``, ``(logits, caches)``.

        A cached step writes at per-row ``positions`` ``(B,)``; without
        ``positions`` it is a prefill, which writes every row from 0 into
        zeroed caches.  Cached positions clip to ``max_seq_len - 1``."""
        dev = self.device
        ids = _token_ids(ids, dev)
        T = ids.shape[1]
        steps = torch.arange(T, device=dev)
        if caches is None:
            x = self.wte(ids) + self.wpe(Tensor(steps[None]))
            for blk in self.blocks:
                x = blk(x)
            return self.head(self.ln_f(x))
        if positions is None:
            capacity = int(caches[0].k.shape[1])
            if T > capacity:
                raise ValueError(f"a prefill of {T} tokens overruns the "
                                 f"cache capacity {capacity}")
            starts, idx = None, steps[None]
        else:
            starts = torch.as_tensor(unwrap(positions), dtype=torch.long,
                                     device=dev)
            idx = (starts[:, None] + steps[None, :]).clamp(
                0, self.cfg.max_seq_len - 1)
        x = self.wte(ids) + self.wpe(Tensor(idx))
        new_caches = []
        for blk, c in zip(self.blocks, caches):
            x, c = blk(x, cache=c, positions=starts)
            new_caches.append(c)
        return self.head(self.ln_f(x)), tuple(new_caches)

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

        Runs the model's :class:`~paddle_tpu_torch.generation.
        GenerationSession` of the batch bucket and ``max_length``
        (``cfg.max_seq_len`` by default), made at its first call and kept
        on the model, so later calls replay its captured steps; weights
        are read at call time, so training in between is seen."""
        from ..generation.session import GenerationSession
        from ..serving.bucketing import next_bucket
        rows, _ = GenerationSession._normalize_prompts(ids, None)
        cap_b = int(batch_capacity or next_bucket(max(len(rows), 1)))
        max_len = int(max_length or self.cfg.max_seq_len)
        key = (cap_b, max_len)
        with _GEN_SESSION_LOCK:
            # concurrent first calls share one session (and its captures)
            sessions = self.__dict__.setdefault("_gen_sessions", {})
            if key not in sessions:
                sessions[key] = GenerationSession(
                    self, batch_capacity=cap_b, max_length=max_len)
        return sessions[key].generate(
            rows, max_new_tokens=max_new_tokens, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            seeds=seeds, eos_token_id=eos_token_id,
            stream_callback=stream_callback)
