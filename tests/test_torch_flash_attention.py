"""paddle_tpu_torch flash attention against the JAX reference.

On the CPU the port's wrapper computes its plain version
(``flash_attention_ref``); these tests hold that against the reference's
Pallas forward run in interpret mode (``PADDLE_PALLAS_FORCE=1``) and, for
lengths the Pallas kernel does not take, against the reference's XLA math.
The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops import flash_attention as pfa
from paddle_tpu_torch.ops.nn_misc import scaled_dot_product_attention

rfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
rnn = importlib.import_module("paddle_tpu.ops.nn_misc")

FP32_ATOL = 2e-5     # tests/test_pallas_kernels.py:57


def _inputs(seed, B, tq, tk, H, D):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, tq, H, D).astype(np.float32),
            rs.rand(B, tk, H, D).astype(np.float32),
            rs.rand(B, tk, H, D).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(256, 256), (128, 256)])
def test_ref_matches_pallas_forward_interpret(monkeypatch, causal, tq, tk):
    monkeypatch.setenv("PADDLE_PALLAS_FORCE", "1")
    assert rfa._pallas_mode(tq, tk, causal)[0] == "small"
    q, k, v = _inputs(0, 2, tq, tk, 2, 64)
    want = np.asarray(rfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = pfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert got.shape == (2, tq, 2, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(7, 7), (100, 100), (7, 100)])
def test_unaligned_lengths_match_reference_math(causal, tq, tk):
    # the reference hands unaligned T to its XLA math; the port's kernel
    # masks the ragged edge, and its plain version computes the same
    q, k, v = _inputs(1, 2, tq, tk, 2, 64)

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(4, x.shape[1], 64)

    want = np.asarray(rfa._xla_attention(
        jnp.asarray(fold(q)), jnp.asarray(fold(k)), jnp.asarray(fold(v)),
        1.0 / np.sqrt(64), causal))
    got = pfa.flash_attn_fwd(torch.from_numpy(fold(q)),
                             torch.from_numpy(fold(k)),
                             torch.from_numpy(fold(v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 1, 16, 16, 2, 32))
    before = pfa.FWD_LAUNCHES
    out = scaled_dot_product_attention(q, k, v, is_causal=True)
    assert pfa.FWD_LAUNCHES == before
    ref = pfa.flash_attention_ref(
        *(x.permute(0, 2, 1, 3).reshape(2, 16, 32) for x in (q, k, v)),
        causal=True).reshape(1, 2, 16, 32).permute(0, 2, 1, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_masked_sdpa_matches_reference_xla_math():
    # a mask routes to plain masked math in both packages
    rs = np.random.RandomState(3)
    q, k, v = _inputs(3, 2, 3, 9, 2, 16)
    mask = np.where(rs.rand(2, 1, 3, 9) < 0.3,
                    np.finfo(np.float32).min, 0.0).astype(np.float32)
    mask[..., 0] = 0.0
    want = np.asarray(rnn._sdpa_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(mask),
                                    has_mask=True))
    got = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.rand(2, 8, 32)
    k = torch.rand(2, 4, 32)
    with pytest.raises(ValueError, match="causal"):
        pfa.flash_attn_fwd(q, k, k, causal=True)
    with pytest.raises(ValueError, match="shape"):
        pfa.flash_attn_fwd(q, k, torch.rand(2, 4, 16))
    with pytest.raises(ValueError, match="zero keys"):
        pfa.flash_attn_fwd(q, k[:, :0], k[:, :0])
    with pytest.raises(ValueError, match=r"\(BH, T, d\)"):
        pfa.flash_attn_fwd(q[0], k[0], k[0])
