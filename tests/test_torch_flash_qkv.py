"""paddle_tpu_torch packed-QKV flash attention against the JAX reference.

On the CPU, ``flash_attention_qkv`` runs its autograd function with the
plain versions of both kernels (``flash_qkv_fwd_ref``,
``flash_qkv_bwd_ref``).  These tests hold its forward and its dqkv
against the reference's ``flash_attention_qkv`` with its Pallas kernels in
interpret mode (``PADDLE_PALLAS_FORCE=1``, as tests/test_pallas_kernels.py
runs them), and, for a length the Pallas kernels do not take, against the
reference's XLA path.  The CUDA kernels are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import flash_attention_qkv as fq

rfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5     # tests/test_pallas_kernels.py:57,64


def _inputs(seed, B, T, H, d):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, T, 3 * H * d).astype(np.float32),
            rs.rand(B, T, H * d).astype(np.float32))


def _reference(qkv, g, H, causal):
    out, vjp = jax.vjp(
        lambda x: rfa.flash_attention_qkv(x, H, causal=causal),
        jnp.asarray(qkv))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port(qkv, g, H, causal):
    x = torch.from_numpy(qkv).requires_grad_()
    out = fq.flash_attention_qkv(x, H, causal=causal)
    (dqkv,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    return out.detach().numpy(), dqkv.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,d", [(4, 64), (2, 128)])
def test_matches_pallas_kernels_in_interpret_mode(monkeypatch, causal, H, d):
    monkeypatch.setenv("PADDLE_PALLAS_FORCE", "1")
    assert rfa._pallas_mode(256, 256, causal) == ("small", True)
    qkv, g = _inputs(0, 2, 256, H, d)
    want, want_d = _reference(qkv, g, H, causal)
    got, got_d = _port(qkv, g, H, causal)
    assert got.shape == (2, 256, H * d) and got_d.shape == qkv.shape
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    np.testing.assert_allclose(got_d, want_d, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_matches_reference_xla_path(causal):
    # the reference hands T % 128 != 0 to its split XLA math; the port's
    # kernels mask the ragged edge and their plain versions compute the same
    assert rfa._pallas_mode(100, 100, causal)[0] == "xla"
    qkv, g = _inputs(1, 2, 100, 2, 32)
    want, want_d = _reference(qkv, g, 2, causal)
    got, got_d = _port(qkv, g, 2, causal)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    np.testing.assert_allclose(got_d, want_d, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_kernels_match_the_plain_differentiable_function(causal):
    qkv, g = _inputs(2, 2, 64, 3, 32)
    x = torch.from_numpy(qkv).requires_grad_()
    ref = fq.flash_attention_qkv_ref(x, 3, causal=causal)
    (ref_d,) = torch.autograd.grad(ref, x, torch.from_numpy(g))
    out, lse = fq.flash_qkv_fwd(x.detach(), 3, causal=causal)
    dqkv = fq.flash_qkv_bwd(x.detach(), out, lse, torch.from_numpy(g), 3,
                            causal=causal)
    torch.testing.assert_close(out, ref.detach(), rtol=0, atol=FWD_ATOL)
    torch.testing.assert_close(dqkv, ref_d, rtol=0, atol=GRAD_ATOL)
    # lse is the log-sum-exp of the masked, scaled scores
    q, k, _ = x.detach().reshape(2, 64, 3, 3, 32).permute(2, 0, 3, 1, 4)
    s = q @ k.transpose(-1, -2) / np.sqrt(32)
    if causal:
        s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(),
                          fq.NEG_INF)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)


def test_saved_forward_is_reused_without_a_forward_call(monkeypatch):
    qkv, g = _inputs(3, 1, 32, 2, 32)
    x = torch.from_numpy(qkv).requires_grad_()
    saved = fq.flash_qkv_fwd(x.detach(), 2, causal=True)
    calls = []
    monkeypatch.setattr(fq, "flash_qkv_fwd",
                        lambda *a, **k: calls.append(1))
    out = fq.flash_attention_qkv(x, 2, causal=True, saved=saved)
    (dqkv,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    assert not calls
    assert torch.equal(out.detach(), saved[0])
    want = fq.flash_qkv_bwd(x.detach(), *saved, torch.from_numpy(g), 2,
                            causal=True)
    assert torch.equal(dqkv, want)


def test_bf16_plain_version_casts_like_the_reference(monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_FORCE", "1")
    qkv, g = _inputs(4, 1, 128, 2, 64)
    xb = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(rfa.flash_attention_qkv(xb, 2, causal=True)
                      .astype(jnp.float32))
    got = fq.flash_attention_qkv(torch.from_numpy(qkv).bfloat16(), 2,
                                 causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="3·H·d"):
        fq.flash_qkv_fwd(torch.rand(1, 4, 10), 2)
    with pytest.raises(ValueError, match=r"\(B, T, 3·H·d\)"):
        fq.flash_qkv_fwd(torch.rand(4, 12), 2)
    meta = torch.empty((1, 8, 3 * 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fq.flash_qkv_fwd(meta, 1)
