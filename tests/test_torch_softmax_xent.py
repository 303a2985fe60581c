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


@pytest.mark.parametrize("V,dtype", [(384, "float32"), (700, "float32"),
                                     (700, "bfloat16")])
def test_dlogits_plain_version_matches_reference_kernel(V, dtype):
    # V 700 is not a multiple of the reference's 512-column block: its pad
    # columns are sliced off and must be zero.  fp32 atol 1e-5
    # (tests/test_pallas_kernels.py:322); bf16: both round the same fp32
    # value, which differs in its last bits, so one bf16 ulp of |g|
    x, w, lab = _inputs(5, 128, 32, V, wscale=0.1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    lse = np.array(jax.scipy.special.logsumexp(
        jnp.matmul(jx, jw, preferred_element_type=jnp.float32), -1))
    want = rsx.softmax_xent_dlogits(jx, jw, jnp.asarray(lab),
                                    jnp.asarray(lse), 2.0, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert not want[:, V:].any()
    tdt = getattr(torch, dtype)
    got = sx.softmax_xent_dlogits(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        torch.from_numpy(lab), torch.from_numpy(lse), torch.tensor(2.0))
    assert got.shape == (128, V) and got.dtype == tdt
    atol = 1e-5 if dtype == "float32" else 2.0 * 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want[:, :V], atol=atol,
                               rtol=0)


def _pr3_backward(x, w, labels, lse, g):
    """The head backward as it stood before the dlogits kernel: pb formed
    by three plain passes per chunk."""
    N, D = x.shape
    gs = g.float() / N
    dx = torch.empty_like(x)
    dw = torch.zeros((D, w.shape[1]), dtype=torch.float32)
    c = sx._chunk(N)
    rows = torch.arange(c)
    for c0 in range(0, N, c):
        xc = x[c0:c0 + c]
        p = torch.exp(sx.matmul_f32(xc, w) - lse[c0:c0 + c, None])
        p[rows, labels[c0:c0 + c].long()] -= 1.0
        pb = (p * gs).to(x.dtype)
        dx[c0:c0 + c] = torch.matmul(pb, w.t())
        dw += sx.matmul_f32(xc.t(), pb)
    return dx, dw.to(w.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_backward_through_plain_dlogits_equals_the_old_backward(dtype):
    # 6144 rows: three chunks of 2048
    x, w, lab = _inputs(6, 6144, 16, 40)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    labels = torch.from_numpy(lab)
    loss = sx.softmax_xent_loss(tx, tw, labels)
    g = torch.tensor(1.7)
    dx, dw = torch.autograd.grad(loss, (tx, tw), g)
    lse, _ = sx.softmax_xent_fwd(tx.detach(), tw.detach(), labels)
    want_dx, want_dw = _pr3_backward(tx.detach(), tw.detach(), labels, lse,
                                     g)
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)


def test_dlogits_leaves_out_of_range_labels_alone():
    x, w, _ = _inputs(7, 4, 8, 10)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    lse = torch.logsumexp(tx @ tw, -1)
    g = torch.tensor(0.5)
    got = sx.softmax_xent_dlogits(tx, tw, torch.tensor([0, 9, 10, -1]), lse,
                                  g)
    p = torch.softmax(tx @ tw, -1)
    p[0, 0] -= 1.0
    p[1, 9] -= 1.0
    torch.testing.assert_close(got, p * 0.5, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="labels \\(C,\\)"):
        sx.softmax_xent_dlogits(tx, tw, torch.zeros(3, dtype=torch.long),
                                lse, g)
