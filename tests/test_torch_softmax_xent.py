"""paddle_tpu_torch fused LM head against the JAX reference.

On the CPU, ``softmax_xent_fwd`` computes its plain version and
``softmax_xent_loss`` runs its chunked backward; these tests hold both
against the reference's ``softmax_xent_fwd`` / ``softmax_xent_loss`` with
the Pallas kernel in interpret mode (the posture of
tests/test_pallas_kernels.py::TestSoftmaxXentHead, same tolerances).  The
CUDA kernel is checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import softmax_xent as sx

rsx = importlib.import_module("paddle_tpu.ops.pallas.softmax_xent")

LOSS_RTOL, GRAD_ATOL, STAT_ATOL = 1e-6, 2e-6, 1e-5   # test_pallas_kernels


def _inputs(seed, N, D, V, wscale=0.05):
    rs = np.random.RandomState(seed)
    return (rs.randn(N, D).astype(np.float32),
            (rs.randn(D, V) * wscale).astype(np.float32),
            rs.randint(0, V, (N,)).astype(np.int32))


@pytest.mark.parametrize("V", [512, 700, 1000])
def test_loss_and_grads_match_reference(V):
    x, w, lab = _inputs(0, 256, 64, V)
    jx, jw, jl = jnp.asarray(x), jnp.asarray(w), jnp.asarray(lab)
    want = float(rsx.softmax_xent_loss(jx, jw, jl, True))
    want_dx, want_dw = jax.grad(
        lambda a, b: rsx.softmax_xent_loss(a, b, jl, True), (0, 1))(jx, jw)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = sx.softmax_xent_loss(tx, tw, torch.from_numpy(lab))
    dx, dw = torch.autograd.grad(loss, (tx, tw))
    np.testing.assert_allclose(loss.item(), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw),
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("N,D,V", [(128, 32, 384), (64, 48, 700)])
def test_forward_statistics_match_reference_kernel(N, D, V):
    x, w, lab = _inputs(1, N, D, V, wscale=0.1)
    want_lse, want_at = rsx.softmax_xent_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(lab), interpret=True)
    lse, at = sx.softmax_xent_fwd(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(lab))
    assert lse.dtype == at.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=STAT_ATOL)
    np.testing.assert_allclose(at.numpy(), np.asarray(want_at),
                               atol=STAT_ATOL)


def test_bf16_inputs_match_reference():
    # both sides take fp32 logits from exact bf16 products; dx rounds to
    # bf16 (|dx| < 2e-4 here, so half an ulp is under 1e-6)
    x, w, lab = _inputs(2, 128, 32, 512)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jl = jnp.asarray(lab)
    want = float(rsx.softmax_xent_loss(jx, jw, jl, True))
    want_dx, want_dw = jax.grad(
        lambda a, b: rsx.softmax_xent_loss(a, b, jl, True), (0, 1))(jx, jw)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    loss = sx.softmax_xent_loss(tx, tw, torch.from_numpy(lab))
    dx, dw = torch.autograd.grad(loss, (tx, tw))
    assert dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx.astype(jnp.float32)),
                               atol=1e-6)
    np.testing.assert_allclose(dw.float().numpy(),
                               np.asarray(want_dw.astype(jnp.float32)),
                               atol=1e-5)


def test_backward_chunks_match_unchunked_autograd():
    # 6144 rows: chunks of 2048 (the largest power-of-two divisor <= 4096)
    x, w, lab = _inputs(3, 6144, 16, 40)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    labels = torch.from_numpy(lab)
    assert sx._chunk(6144) == 2048
    dx, dw = torch.autograd.grad(sx.softmax_xent_loss(tx, tw, labels),
                                 (tx, tw))
    ref = torch.nn.functional.cross_entropy(tx @ tw, labels.long())
    rdx, rdw = torch.autograd.grad(ref, (tx, tw))
    torch.testing.assert_close(dx, rdx, rtol=0, atol=1e-7)
    torch.testing.assert_close(dw, rdw, rtol=0, atol=1e-6)


def test_plain_version_leaves_out_of_range_labels_at_zero():
    x, w, _ = _inputs(4, 4, 8, 10)
    lse, at = sx.softmax_xent_fwd(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.tensor([0, 9, 10, -1]))
    logits = torch.from_numpy(x) @ torch.from_numpy(w)
    torch.testing.assert_close(at, torch.stack(
        [logits[0, 0], logits[1, 9], torch.tensor(0.), torch.tensor(0.)]))
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))


def test_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="x \\(N, D\\)"):
        sx.softmax_xent_fwd(torch.rand(4, 8), torch.rand(7, 3),
                            torch.zeros(4, dtype=torch.long))
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sx.softmax_xent_fwd(meta, torch.empty((8, 3), device="meta"),
                            torch.empty(4, device="meta", dtype=torch.long))
