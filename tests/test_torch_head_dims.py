"""Head dims and the fp32 product of paddle_tpu_torch's attention kernels.

- The kernels are built at every head dim of ``HEAD_DIMS`` (16, 32, 64,
  80, 96, 128): the split-layout check (``_check_cuda``) and the packed
  entry's (``flash_attention_qkv._route``) take those and raise
  ``ValueError``, with the list, at any other d.  No fallback.
- The reference's dryrun model (``__graft_entry__.py:101-102``: V 128,
  hidden 32 over 2 heads, so head dim 16) takes the same step in the
  port's compiled train step as in the reference's
  ``build_spmd_train_step``.  fp32, from the reference's ``init_fn(0)``
  and ``np.random.RandomState(0)`` ids and labels; tolerances of
  ``tests/test_torch_train_step.py``: loss rtol 1e-5, grads atol 5e-5.
- The fp32 kernels multiply on the tensor cores in split precision
  (3xTF32, ``csrc/tile_common.cuh``).  A torch emulation of that product
  (each operand rounded to tf32 as ``cvt.rna`` does, the remainder read
  as tf32 by truncation, then the three partial products) carried
  through attention's forward, lse and backward stays within the fp32
  tolerances of the JAX reference's plain
  attention (``_xla_attention`` and its ``jax.vjp``; lse as logsumexp of
  its scores): out atol 2e-5, grads 5e-5, lse 1e-5
  (``tests/test_pallas_kernels.py``).  One tf32 product alone does not,
  which the last test shows.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.topology import build_mesh
from paddle_tpu.models import GPTConfig as RefConfig
from paddle_tpu.models import gpt_spmd as rspmd

from paddle_tpu_torch.models import (GPTConfig, build_spmd_train_step,
                                     gpt_spmd_state_from_paddle_tpu)
from paddle_tpu_torch.models import gpt_spmd as pspmd
from paddle_tpu_torch.ops import flash_attention as pfa
from paddle_tpu_torch.ops import flash_attention_qkv as fq

rfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

FWD_ATOL, GRAD_ATOL, LSE_ATOL = 2e-5, 5e-5, 1e-5
DRYRUN = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
              max_seq_len=32, ffn_mult=2)
DRYRUN_B, DRYRUN_T, B1 = 4, 16, 0.9


# -- head dims -------------------------------------------------------------------
def test_head_dims_cover_the_reference_configs():
    assert set(pfa.HEAD_DIMS) == {16, 32, 64, 80, 96, 128}
    assert fq.HEAD_DIMS == pfa.HEAD_DIMS
    assert DRYRUN["hidden_size"] // DRYRUN["num_heads"] in pfa.HEAD_DIMS


@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_check_takes_every_built_head_dim(d, dtype):
    q, k, v = torch.rand(3, 2, 8, 2, d).to(dtype).unbind(0)
    pfa._check_cuda("flash_attn_fwd", q, k, v)


@pytest.mark.parametrize("d", [8, 24, 48, 256])
def test_split_check_refuses_other_head_dims(d):
    q = torch.rand(2, 8, 2, d)
    with pytest.raises(ValueError, match=r"head dim %d not built.*"
                       r"\(16, 32, 64, 80, 96, 128\)" % d):
        pfa._check_cuda("flash_attn_fwd", q, q, q)


@pytest.mark.parametrize("d,built", [(16, True), (80, True), (96, True),
                                     (24, False), (256, False)])
def test_packed_route_check_agrees(d, built):
    # a tensor off the CPU meets the head-dim check first: a built d goes
    # on to the device check (meta is not CUDA), any other raises there
    qkv = torch.empty((1, 8, 3 * 2 * d), device="meta")
    match = "runs on CUDA or CPU" if built else \
        r"head dim %d not built.*\(16, 32, 64, 80, 96, 128\)" % d
    with pytest.raises(ValueError, match=match):
        fq._route("flash_qkv_fwd", qkv, 2)
    # the CPU takes the plain version at any d
    assert fq._route("flash_qkv_fwd", torch.rand(1, 8, 3 * 2 * d), 2) \
        is False


# -- the dryrun model's compiled step ---------------------------------------------
def _flat(tree):
    return {k: np.array(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in pspmd._leaves(tree).items()}


def test_dryrun_config_step_matches_reference():
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    rstep, rinit = rspmd.build_spmd_train_step(RefConfig(**DRYRUN), mesh)
    rp, ro = rinit(seed=0)
    params, opt = gpt_spmd_state_from_paddle_tpu(
        jax.tree.map(np.asarray, rp), device="cpu")
    step, _ = build_spmd_train_step(GPTConfig(**DRYRUN), device="cpu")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, DRYRUN["vocab_size"],
                      (DRYRUN_B, DRYRUN_T)).astype(np.int32)
    labels = rng.randint(0, DRYRUN["vocab_size"],
                         (DRYRUN_B, DRYRUN_T)).astype(np.int32)
    rl, _, ro = rstep(rp, ro, jnp.asarray(ids), jnp.asarray(labels))
    ref_m = _flat(ro["m"])
    loss, _, opt = step(params, opt, torch.from_numpy(ids),
                        torch.from_numpy(labels))
    m = _flat(opt["m"])
    np.testing.assert_allclose(loss.item(), float(rl), rtol=1e-5)
    assert set(m) == set(ref_m)
    for name, want in ref_m.items():
        np.testing.assert_allclose(m[name] / (1 - B1), want / (1 - B1),
                                   atol=5e-5, err_msg=name)


# -- the 3xTF32 product ---------------------------------------------------------
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 read as tf32 by the tensor cores: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the kernels form it: big = tf32(x) and small = x - big,
    read as tf32 (truncated); small*big + big*small, then big*big, in fp32
    (``passes=1``: big*big alone, one tf32 product)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    sa, sb = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    return (sa @ bb + ab @ sb) + ab @ bb


def _emulated(q, k, v, g, causal, scale, passes=3):
    """Forward (out, lse) and backward (dq, dk, dv) of attention with every
    product through :func:`_mm3`; softmax statistics and delta in fp32."""
    tq, tk = q.shape[1], k.shape[1]
    s = _mm3(q, k.transpose(1, 2), passes) * scale
    if causal:
        vis = torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)
        s = s.masked_fill(~vis, pfa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    out = _mm3(e, v, passes) / l
    lse = (m + torch.log(l)).squeeze(-1)
    p = torch.exp(s - lse[..., None])
    dp = _mm3(g, v.transpose(1, 2), passes)
    delta = (g * out).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dv = _mm3(p.transpose(1, 2), g, passes)
    dq = _mm3(ds, k, passes) * scale
    dk = _mm3(ds.transpose(1, 2), q, passes) * scale
    return out, lse, (dq, dk, dv)


def _reference(q, k, v, g, causal, scale):
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: rfa._xla_attention(a, b, c, scale,
                                                          causal),
                       jq, jk, jv)
    s = jnp.einsum("bqd,bkd->bqk", jq, jk) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        s = jnp.where(jnp.tril(jnp.ones((tq, tk), bool), k=tk - tq), s,
                      rfa.NEG_INF)
    lse = jax.nn.logsumexp(s, axis=-1)
    return out, lse, vjp(jnp.asarray(g))


def _inputs(seed, T, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.rand(2, T, d).astype(np.float32) for _ in range(4))


@pytest.mark.parametrize("T,d,causal", [
    (128, 16, True), (128, 64, False), (128, 128, True),
    (512, 16, True), (512, 64, True), (512, 128, False),
    (1024, 16, True), (1024, 64, True), (1024, 128, True)])
def test_split_tf32_product_keeps_fp32_parity(T, d, causal):
    q, k, v, g = _inputs(T + d, T, d)
    scale = 1.0 / np.sqrt(d)
    out, lse, grads = _emulated(*(torch.from_numpy(x) for x in (q, k, v, g)),
                                causal, scale)
    r_out, r_lse, r_grads = _reference(q, k, v, g, causal, scale)
    np.testing.assert_allclose(out.numpy(), r_out, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), r_lse, atol=LSE_ATOL, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), grads, r_grads):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


def test_one_tf32_product_breaks_fp32_parity():
    # why the split: a single tf32 product misses the tolerances
    q, k, v, g = _inputs(7, 512, 64)
    scale = 1.0 / 8.0
    out, lse, grads = _emulated(*(torch.from_numpy(x) for x in (q, k, v, g)),
                                True, scale, passes=1)
    r_out, r_lse, r_grads = _reference(q, k, v, g, True, scale)
    errs = [np.abs(out.numpy() - r_out).max() / FWD_ATOL,
            np.abs(lse.numpy() - r_lse).max() / LSE_ATOL] + [
        np.abs(a.numpy() - b).max() / GRAD_ATOL
        for a, b in zip(grads, r_grads)]
    assert max(errs) > 1.0
