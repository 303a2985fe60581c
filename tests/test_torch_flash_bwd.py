"""paddle_tpu_torch attention backward and lse-forward against the JAX
reference's Pallas kernels.

On the CPU the port's wrappers compute their plain versions
(``flash_attn_fwd_ref`` with lse, ``flash_attn_bwd_ref`` from lse and
delta = rowsum(dO∘O)); these tests hold them against the reference's
kernels run as the JAX package's own tests run them here, in interpret
mode: ``_small_flash_bwd`` (row 6), ``_tiled_flash_bwd`` (row 7),
``_flash_fwd`` (row 2) and ``_flash_bwd`` (rows 8 and 9) with 128 blocks,
and ``flash_attention`` under ``PADDLE_PALLAS_FORCE=1`` with ``jax.vjp``.
The CUDA kernels are checked against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

Tolerances (fp32, ``tests/test_pallas_kernels.py``): forward atol 2e-5,
grads 5e-5, lse 1e-5.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import flash_attention as pfa

rfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

FWD_ATOL, GRAD_ATOL, LSE_ATOL = 2e-5, 5e-5, 1e-5


def _folded(seed, BH, tq, tk, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.rand(BH, t, d).astype(np.float32)
                 for t in (tq, tk, tk, tq))           # q, k, v, dout


def _port_grads(q, k, v, g, causal):
    q_t, k_t, v_t, g_t = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = pfa.flash_attn_fwd(q_t, k_t, v_t, causal=causal,
                                  return_lse=True)
    grads = pfa.flash_attn_bwd(q_t, k_t, v_t, out, lse, g_t, causal=causal)
    return out, lse, grads


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(128, 128), (128, 256)])
def test_backward_matches_small_bwd_kernel(causal, tq, tk):
    # row 6, _small_bwd_kernel: lse and delta rebuilt in-kernel there,
    # taken from the forward here
    q, k, v, g = _folded(0, 2, tq, tk, 32)
    scale = 1.0 / np.sqrt(32)
    want = rfa._small_flash_bwd(*(jnp.asarray(a) for a in (q, k, v, g)),
                                scale, causal, interpret=True)
    _, _, got = _port_grads(q, k, v, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), b, GRAD_ATOL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_tiled_bwd_kernel(causal):
    # row 7, _tiled_bwd_kernel: q-block tiled with f32 dK/dV accumulators
    q, k, v, g = _folded(1, 2, 256, 256, 32)
    scale = 1.0 / np.sqrt(32)
    want = rfa._tiled_flash_bwd(*(jnp.asarray(a) for a in (q, k, v, g)),
                                scale, causal, interpret=True)
    _, _, got = _port_grads(q, k, v, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), b, GRAD_ATOL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_streaming_forward_and_backward_match(causal):
    # rows 2, 8 and 9: _flash_fwd writes lse (BH, T, 1); _flash_bwd takes
    # it with out, as the port's backward does
    q, k, v, g = _folded(2, 2, 256, 256, 32)
    scale = 1.0 / np.sqrt(32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    r_out, r_lse = rfa._flash_fwd(jq, jk, jv, scale, causal, block_q=128,
                                  block_k=128, interpret=True)
    want = rfa._flash_bwd(jq, jk, jv, r_out, r_lse, jg, scale, causal,
                          block_q=128, block_k=128, interpret=True)
    out, lse, got = _port_grads(q, k, v, g, causal)
    _close(out.numpy(), r_out, FWD_ATOL, "out")
    _close(lse.numpy(), np.asarray(r_lse)[..., 0], LSE_ATOL, "lse")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), b, GRAD_ATOL, name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(256, 256), (128, 256)])
def test_autograd_matches_reference_vjp(monkeypatch, causal, tq, tk):
    # the (B, S, H, D) entry through FlashAttention against the
    # reference's flash_attention and its custom VJP (mode "small")
    monkeypatch.setenv("PADDLE_PALLAS_FORCE", "1")
    assert rfa._pallas_mode(tq, tk, causal)[0] == "small"
    rs = np.random.RandomState(3)
    q, k, v, g = (rs.rand(2, t, 2, 32).astype(np.float32)
                  for t in (tq, tk, tk, tq))
    out, vjp = jax.vjp(lambda a, b, c: rfa.flash_attention(
        a, b, c, causal=causal), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = pfa.flash_attention(*leaves, causal=causal)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), out, FWD_ATOL, "out")
    for name, leaf, b in zip(("dq", "dk", "dv"), leaves, want):
        _close(leaf.grad.numpy(), b, GRAD_ATOL, name)


@pytest.mark.parametrize("length,aligned", [
    (512, 512), (513, 640), (1024, 1024), (1025, 1152), (4096, 4096),
    (4097, 4224)])
def test_mode_copy_matches_reference_routing(monkeypatch, length, aligned):
    # the reference routes only multiples of 128 to its kernels; the port
    # masks the ragged edge, so `length` routes as its aligned neighbour
    monkeypatch.setenv("PADDLE_PALLAS_FORCE", "1")
    for causal in (False, True):
        want = rfa._pallas_mode(aligned, aligned, causal)[0]
        assert pfa._pallas_mode(length, length, causal) == want
        assert pfa._pallas_mode(aligned, aligned, causal) == want
    assert rfa._pallas_mode(8, 4, True)[0] == "xla"
    assert pfa._pallas_mode(8, 4, True) == "math"
    assert pfa._pallas_mode(8, 4, False) == "small"


def test_reference_rows_follow_the_backward_routing():
    assert pfa.reference_rows("fwd", "small", 512) == (1,)
    assert pfa.reference_rows("fwd", "mid", 2048) == (1,)
    assert pfa.reference_rows("fwd", "stream", 8192) == (2,)
    assert pfa.reference_rows("bwd", "small", 512) == (6,)
    assert pfa.reference_rows("bwd", "small", 1024) == (7,)
    assert pfa.reference_rows("bwd", "mid", 4096) == (7,)
    assert pfa.reference_rows("bwd", "stream", 8192) == (8, 9)


def test_strided_views_and_folded_layout_agree():
    # a packed projection's head views (B, S, H, D) and the folded
    # (B*H, S, D) copies give the same results, lse and grads
    rs = np.random.RandomState(4)
    B, T, H, d = 2, 40, 3, 16
    qkv = torch.from_numpy(rs.rand(B, T, 3, H, d).astype(np.float32))
    g = torch.from_numpy(rs.rand(B, T, H, d).astype(np.float32))
    q, k, v = qkv.unbind(2)
    out, lse = pfa.flash_attn_fwd(q, k, v, causal=True, return_lse=True)
    grads = pfa.flash_attn_bwd(q, k, v, out, lse, g, causal=True)
    assert out.shape == (B, T, H, d) and lse.shape == (B, H, T)

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, T, d)

    f_out, f_lse = pfa.flash_attn_fwd(fold(q), fold(k), fold(v), causal=True,
                                      return_lse=True)
    f_grads = pfa.flash_attn_bwd(fold(q), fold(k), fold(v), f_out, f_lse,
                                 fold(g), causal=True)
    torch.testing.assert_close(fold(out), f_out, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse.reshape(B * H, T), f_lse, rtol=0,
                               atol=1e-6)
    for a, b in zip(grads, f_grads):
        torch.testing.assert_close(fold(a), b, rtol=0, atol=1e-6)


def test_cpu_launches_nothing_and_counts_nothing():
    q, k, v, g = (torch.from_numpy(a) for a in _folded(5, 2, 16, 16, 32))
    f0, b0 = pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES
    modes = dict(pfa.MODE_LAUNCHES)
    out, lse = pfa.flash_attn_fwd(q, k, v, return_lse=True)
    pfa.flash_attn_bwd(q, k, v, out, lse, g)
    assert (pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES) == (f0, b0)
    assert pfa.MODE_LAUNCHES == modes


def test_backward_refuses_what_it_does_not_fit():
    q, k, v, g = (torch.from_numpy(a) for a in _folded(6, 2, 8, 8, 32))
    out, lse = pfa.flash_attn_fwd(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        pfa.flash_attn_bwd(q, k, v, out, lse[:, :4], g)
    with pytest.raises(ValueError, match="does not match"):
        pfa.flash_attn_bwd(q, k, v, out, lse, g[:, :4])
    with pytest.raises(ValueError, match="causal"):
        pfa.flash_attn_bwd(q, k[:, :4], v[:, :4], out, lse, g, causal=True)
