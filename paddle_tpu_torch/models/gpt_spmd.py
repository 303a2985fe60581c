"""The flagship GPT train step on one device — the one-device path of
``paddle_tpu/models/gpt_spmd.py``.

Parameters are a nested dictionary with the reference's names and its
stacked block layout: ``wte``, ``wpe``, ``blocks`` (every block weight
stacked on a leading layer axis, ``(L, ...)``), ``ln_f_g``, ``ln_f_b``,
``head_w``.  Linear weights are ``(in, out)``.  The math is the
reference's:

- pre-LN blocks with tanh GELU (``jax.nn.gelu``'s default) and LayerNorm
  over the population variance;
- attention straight from the packed QKV projection
  (:func:`~paddle_tpu_torch.ops.flash_attention_qkv.flash_attention_qkv`,
  kernels in both directions on the card);
- with ``compute_dtype`` bf16 or fp16, every fp32 master is cast to that
  type before the trunk (the LayerNorms too; no autocast, and in fp16 no
  loss scaling, as in the reference) and grads land on the fp32 masters
  through the casts;
- the loss: on a CUDA device the fused LM head
  (:func:`~paddle_tpu_torch.ops.softmax_xent.softmax_xent_loss`, as the
  reference does on one accelerator), on the CPU the chunked
  cross-entropy;
- AdamW that decays every leaf, with eps outside the square root and bias
  corrections from the fp32 step count held in ``opt_state["step"]``.

Remat policies (the reference's five), with the attention forward
kernel's launches per block and step:

- ``"none"``: autograd keeps what the backward needs; 1;
- ``"full"``: each block is recomputed for its backward; 2;
- ``"ctx"``: each block keeps its attention output and log-sum-exp (the
  reference's ``"attn_ctx"``) and recomputes the rest; 1;
- ``"ctx_ffn"``: as ``"ctx"``, and keeps the GELU output (the reference's
  ``"ffn_up"``), so the recompute skips the GELU; its derivative still
  needs the up projection's output, which is recomputed, as the reference
  recomputes it; 1;
- ``"dots"``: keeps the output of every product (the reference's
  ``dots_saveable``: the QKV, output, up and down projections) and
  recomputes the rest, the attention among it, since its kernel is no
  product; 2.  The reference keeps three of the four, because XLA never
  recomputes the down projection, whose output no gradient reads; the
  port's recompute replays the whole block, so it keeps that output too
  rather than multiply again.

The last three run :class:`_KeepRemat`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import flash_attention_qkv as fq
from ..ops.softmax_xent import matmul_f32, softmax_xent_loss
from .gpt import GPTConfig

__all__ = ["init_gpt_params", "make_block_fn", "trunk", "forward",
           "chunked_ce", "loss_fn", "adamw_update", "build_spmd_train_step",
           "init_opt_state", "REMAT_POLICIES", "CE_CHUNK"]

REMAT_POLICIES = ("none", "full", "ctx", "ctx_ffn", "dots")
# the values each keeping policy saves from a block's forward
# (:class:`_KeepRemat`), by the reference's names where it has them
_KEPT = {"ctx": ("attn_ctx",), "ctx_ffn": ("attn_ctx", "ffn_up"),
         "dots": ("qkv", "out", "up", "down")}
CE_CHUNK = 4096       # rows per chunk of the CPU cross-entropy
_LATER = ("see ROADMAP.md A5 (distributed): only the one-device path is "
          "ported")

Params = Dict[str, object]


def _glorot(gen: torch.Generator, shape: Sequence[int], device
            ) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return torch.randn(tuple(shape), generator=gen, device=device) * std


def init_gpt_params(cfg: GPTConfig, generator: torch.Generator,
                    device=None) -> Params:
    """The reference's parameter tree (same names, shapes and
    distributions), drawn from ``generator`` in fp32 on ``device``."""
    dev = resolve_device(device)
    V, D, L = cfg.vocab_size, cfg.hidden_size, cfg.num_layers
    Hf = cfg.ffn_mult * D

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    blocks = {
        "ln1_g": ones(L, D), "ln1_b": zeros(L, D),
        "qkv_w": _glorot(generator, (L, D, 3 * D), dev),
        "qkv_b": zeros(L, 3 * D),
        "out_w": _glorot(generator, (L, D, D), dev), "out_b": zeros(L, D),
        "ln2_g": ones(L, D), "ln2_b": zeros(L, D),
        "up_w": _glorot(generator, (L, D, Hf), dev), "up_b": zeros(L, Hf),
        "down_w": _glorot(generator, (L, Hf, D), dev),
        "down_b": zeros(L, D),
    }
    return {
        "wte": torch.randn((V, D), generator=generator, device=dev) * 0.02,
        "wpe": torch.randn((cfg.max_seq_len, D), generator=generator,
                           device=dev) * 0.02,
        "blocks": blocks,
        "ln_f_g": ones(D), "ln_f_b": zeros(D),
        "head_w": _glorot(generator, (D, V), dev),
    }


def _leaves(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"blocks.qkv_w": tensor, ...}`` in the tree's order."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _rebuild(tree: Mapping, flat: Mapping[str, torch.Tensor],
             prefix: str = "") -> Params:
    return {k: _rebuild(v, flat, f"{prefix}{k}.") if isinstance(v, Mapping)
            else flat[prefix + k] for k, v in tree.items()}


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


class _Sites:
    """The block's named points, computed plainly: the attention (the
    kernels in both directions), each product by its name (``"qkv"``,
    ``"out"``, ``"up"``, ``"down"``) and the GELU.  :class:`_KeepRemat`
    records and replays them through its subclasses."""

    def attend(self, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        return fq.flash_attention_qkv(qkv, heads, causal=True)

    def product(self, name: str, a: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
        return a @ w

    def gelu(self, h: torch.Tensor) -> torch.Tensor:
        return F.gelu(h, approximate="tanh")


_PLAIN = _Sites()


def make_block_fn(cfg: GPTConfig):
    """``block_fn(p, x, sites)``: one pre-LN block over ``x (B, T, D)``
    with the layer's weights ``p``; ``sites`` (:class:`_Sites`, the
    default) computes its attention, products and GELU."""
    heads = cfg.num_heads

    def block_fn(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 sites: _Sites = _PLAIN) -> torch.Tensor:
        y = _layernorm(x, p["ln1_g"], p["ln1_b"])
        qkv = sites.product("qkv", y, p["qkv_w"]) + p["qkv_b"]
        ctx = sites.attend(qkv, heads)
        x = x + sites.product("out", ctx, p["out_w"]) + p["out_b"]
        y = _layernorm(x, p["ln2_g"], p["ln2_b"])
        up = sites.gelu(sites.product("up", y, p["up_w"]) + p["up_b"])
        return x + sites.product("down", up, p["down_w"]) + p["down_b"]

    return block_fn


class _Record(_Sites):
    """The forward of :class:`_KeepRemat`: computes plainly (the attention
    forward kernel alone) and keeps the values of ``names``."""

    def __init__(self, names: Sequence[str]):
        self.names, self.kept = names, {}

    def attend(self, qkv, heads):
        out, lse = fq.flash_qkv_fwd(qkv, heads, causal=True)
        if "attn_ctx" in self.names:
            self.kept["attn_ctx"] = (out, lse)
        return out

    def product(self, name, a, w):
        y = a @ w
        if name in self.names:
            self.kept[name] = (y,)
        return y

    def gelu(self, h):
        y = super().gelu(h)
        if "ffn_up" in self.names:
            self.kept["ffn_up"] = (y,)
        return y


class _KeptProduct(torch.autograd.Function):
    """``a @ w`` whose value was kept: the forward returns it, the
    backward is autograd's for the product (``a`` folded to rows)."""

    @staticmethod
    def forward(ctx, a, w, kept):
        ctx.save_for_backward(a, w)
        return kept

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        return (g2.mm(w.t()).reshape(a.shape),
                a.reshape(-1, a.shape[-1]).t().mm(g2), None)


class _KeptGelu(torch.autograd.Function):
    """``gelu(h)`` whose value was kept: the forward returns it, the
    backward is autograd's for the tanh GELU, from ``h``."""

    @staticmethod
    def forward(ctx, h, kept):
        ctx.save_for_backward(h)
        return kept

    @staticmethod
    def backward(ctx, g):
        h, = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(g, h, approximate="tanh"), None


class _Replay(_Sites):
    """The recompute of :class:`_KeepRemat`'s backward: a kept value is
    returned with its own backward, the rest is computed again."""

    def __init__(self, kept: Mapping[str, Tuple[torch.Tensor, ...]]):
        self.kept = kept

    def attend(self, qkv, heads):
        return fq.flash_attention_qkv(qkv, heads, causal=True,
                                      saved=self.kept.get("attn_ctx"))

    def product(self, name, a, w):
        if name not in self.kept:
            return a @ w
        return _KeptProduct.apply(a, w, *self.kept[name])

    def gelu(self, h):
        if "ffn_up" not in self.kept:
            return super().gelu(h)
        return _KeptGelu.apply(h, *self.kept["ffn_up"])


class _KeepRemat(torch.autograd.Function):
    """A block whose backward recomputes it from its input, keeping the
    forward's values named in ``keep`` (:data:`_KEPT`): the recompute returns
    them instead of computing them again (``FlashQKV`` with ``saved`` for
    the attention), each with its own backward.  The counterpart of the
    reference's ``jax.checkpoint`` policies ``save_only_these_names``
    (``"ctx"``, ``"ctx_ffn"``) and ``dots_saveable`` (``"dots"``)."""

    @staticmethod
    def forward(ctx, block_fn, names, keep, x, *weights):
        record = _Record(keep)
        with torch.no_grad():
            y = block_fn(dict(zip(names, weights)), x, record)
        kept = tuple(record.kept.items())
        ctx.block_fn, ctx.names = block_fn, names
        ctx.kept = tuple((k, len(v)) for k, v in kept)
        ctx.save_for_backward(x, *weights, *(t for _, v in kept for t in v))
        return y

    @staticmethod
    def backward(ctx, gy):
        x, *rest = ctx.saved_tensors
        weights, values = rest[:len(ctx.names)], rest[len(ctx.names):]
        kept, i = {}, 0
        for k, n in ctx.kept:
            kept[k], i = tuple(values[i:i + n]), i + n
        inputs = [x.detach().requires_grad_()] + [
            w.detach().requires_grad_() for w in weights]
        with torch.enable_grad():
            y = ctx.block_fn(dict(zip(ctx.names, inputs[1:])), inputs[0],
                             _Replay(kept))
        grads = torch.autograd.grad(y, inputs, gy)
        return (None, None, None) + tuple(grads)


def _run_block(block_fn, p: Dict[str, torch.Tensor], x: torch.Tensor,
               remat_policy: str) -> torch.Tensor:
    if remat_policy == "none":
        return block_fn(p, x)
    if remat_policy == "full":
        return checkpoint(block_fn, p, x, use_reentrant=False)
    names = tuple(p)
    return _KeepRemat.apply(block_fn, names, _KEPT[remat_policy], x,
                            *(p[n] for n in names))


def _check_remat(remat_policy: str) -> None:
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}; the port "
                         f"has {REMAT_POLICIES}")


def trunk(params: Params, ids: torch.Tensor, cfg: GPTConfig, *,
          compute_dtype: torch.dtype = torch.float32,
          remat_policy: str = "full") -> torch.Tensor:
    """Embeddings, the blocks and the final LayerNorm: ``(B, T, D)`` in
    ``compute_dtype``.  In bf16 and fp16 every fp32 parameter is cast
    first."""
    _check_remat(remat_policy)
    if compute_dtype != torch.float32:
        params = _rebuild(params, {
            k: v.to(compute_dtype) if v.dtype == torch.float32 else v
            for k, v in _leaves(params).items()})
    x = F.embedding(ids, params["wte"]) + params["wpe"][:ids.shape[1]][None]
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    block_fn = make_block_fn(cfg)
    for i in range(cfg.num_layers):
        p_i = {k: v[i] for k, v in layers.items()}
        x = _run_block(block_fn, p_i, x, remat_policy)
    return _layernorm(x, params["ln_f_g"], params["ln_f_b"])


def forward(params: Params, ids: torch.Tensor, cfg: GPTConfig, *,
            compute_dtype: torch.dtype = torch.float32,
            remat_policy: str = "full") -> torch.Tensor:
    """Logits ``(B, T, V)`` in ``compute_dtype``."""
    x = trunk(params, ids, cfg, compute_dtype=compute_dtype,
              remat_policy=remat_policy)
    return x @ params["head_w"].to(x.dtype)


def _ce_rows(xc: torch.Tensor, head_w: torch.Tensor, lc: torch.Tensor
             ) -> torch.Tensor:
    """Summed cross-entropy of hidden rows ``xc (C, D)`` against ``lc``,
    from fp32 logits."""
    logits = matmul_f32(xc, head_w)
    m = logits.amax(-1, keepdim=True).detach()
    lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(-1))
    at = logits.gather(-1, lc.long()[:, None])[:, 0]
    return (lse - at).sum()


def chunked_ce(x: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor
               ) -> torch.Tensor:
    """Mean cross-entropy over chunks of :data:`CE_CHUNK` rows, each
    recomputed for its backward, so live logits are a chunk by V."""
    B, T, D = x.shape
    n = B * T
    xf, lf = x.reshape(n, D), labels.reshape(n)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, n, CE_CHUNK):
        total = total + checkpoint(_ce_rows, xf[c0:c0 + CE_CHUNK], head_w,
                                   lf[c0:c0 + CE_CHUNK], use_reentrant=False)
    return total / n


def loss_fn(params: Params, ids: torch.Tensor, labels: torch.Tensor,
            cfg: GPTConfig, *, compute_dtype: torch.dtype = torch.float32,
            remat_policy: str = "full") -> torch.Tensor:
    """Mean next-token cross-entropy (fp32 scalar).  On a CUDA device the
    head is the fused kernel, on the CPU the chunked cross-entropy."""
    x = trunk(params, ids, cfg, compute_dtype=compute_dtype,
              remat_policy=remat_policy)
    head_w = params["head_w"].to(x.dtype)
    if x.is_cuda:
        B, T, D = x.shape
        return softmax_xent_loss(x.reshape(B * T, D), head_w,
                                 labels.reshape(B * T))
    return chunked_ce(x, head_w, labels)


@torch.no_grad()
def adamw_update(params: Params, grads: Params, opt_state: Dict, *,
                 learning_rate: float = 1e-3, weight_decay: float = 0.01
                 ) -> Tuple[Params, Dict]:
    """The reference's AdamW, **in place**: params, ``m``, ``v`` and
    ``step`` are updated where they lie and returned."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    step = opt_state["step"]
    step += 1
    c1 = 1 - torch.pow(b1, step.float())
    c2 = 1 - torch.pow(b2, step.float())
    p_l, g_l = _leaves(params), _leaves(grads)
    m_l, v_l = _leaves(opt_state["m"]), _leaves(opt_state["v"])
    for k, p in p_l.items():
        g, m, v = g_l[k], m_l[k], v_l[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p.mul_(1 - learning_rate * weight_decay).sub_(
            learning_rate * (m / c1) / (torch.sqrt(v / c2) + eps))
    return params, opt_state


def build_spmd_train_step(cfg: GPTConfig, mesh: Optional[Mapping] = None,
                          num_microbatches: int = 1,
                          learning_rate: float = 1e-3,
                          weight_decay: float = 0.01,
                          compute_dtype: torch.dtype = torch.float32,
                          schedule_mode: str = "F-then-B",
                          offload: bool = False,
                          remat_policy: str = "full", device=None):
    """Returns ``(step, init_fn)`` for one device.

    ``step(params, opt_state, ids, labels) -> (loss, params, opt_state)``
    takes one AdamW step; it updates ``params`` and ``opt_state`` **in
    place** and returns them.  ``init_fn(seed) -> (params, opt_state)``
    draws fresh parameters on the device.  ``device`` is the card unless
    ``device="cpu"``.  ``mesh`` is ``None`` or a mapping of axis sizes;
    a mesh of more than one device (ZeRO included: a ``"sharding"`` axis),
    micro-batching and the 1F1B schedule are not ported (``ROADMAP.md``
    A5).  ``offload`` is the reference's ZeRO offload, which moves the
    state to pinned host memory only with a ``"sharding"`` axis over 1
    (``paddle_tpu/models/gpt_spmd.py:495-503``, waiting for A5 here): on
    one device it changes nothing, there and here."""
    dev = resolve_device(device)
    sizes = dict(mesh or {})
    if any(int(n) > 1 for n in sizes.values()):
        raise NotImplementedError(f"mesh {sizes} spans several devices; "
                                  + _LATER)
    if num_microbatches != 1:
        raise NotImplementedError("num_microbatches > 1 (pipeline "
                                  "micro-batching); " + _LATER)
    if schedule_mode != "F-then-B":
        raise NotImplementedError(f"schedule_mode {schedule_mode!r}; "
                                  + _LATER)
    if compute_dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"compute_dtype {compute_dtype}: fp32, bf16 or "
                         f"fp16")
    _check_remat(remat_policy)
    opts = dict(compute_dtype=compute_dtype, remat_policy=remat_policy)

    def step(params, opt_state, ids, labels):
        flat = _leaves(params)
        live = {k: v.detach().requires_grad_() for k, v in flat.items()}
        loss = loss_fn(_rebuild(params, live), ids, labels, cfg, **opts)
        grads = torch.autograd.grad(loss, list(live.values()))
        params, opt_state = adamw_update(
            params, _rebuild(params, dict(zip(live, grads))), opt_state,
            learning_rate=learning_rate, weight_decay=weight_decay)
        return loss.detach(), params, opt_state

    def init_fn(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = init_gpt_params(cfg, gen, dev)
        return params, init_opt_state(params)

    return step, init_fn


def init_opt_state(params: Params) -> Dict:
    """Zero AdamW moments shaped like ``params`` and a step count of 0."""
    flat = _leaves(params)

    def zeros():
        return _rebuild(params, {k: torch.zeros_like(v)
                                 for k, v in flat.items()})

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(flat.values())).device)}
