"""Two faults of the port's attention, each held against the reference.

1. Causal attention with more queries than keys: the reference routes it
   to its XLA math (``_pallas_mode`` returns "xla" when causal and
   Sq > Sk), where the fully masked rows average V; the port answers the
   same through its masked math instead of raising.
2. Gradients through the kernel: on the card they come from the
   hand-written backward (``tests/test_torch_cuda.py``,
   ``test_sdpa_gradients_flow_through_the_kernels``); here the same
   autograd function runs the plain versions, and the gradients match the
   reference's.

fp32, atol 2e-6 for outputs (the same masked softmax in another order).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import flash_attention as pfa
from paddle_tpu_torch.ops.nn_misc import scaled_dot_product_attention

rnn = importlib.import_module("paddle_tpu.ops.nn_misc")

ATOL = 2e-6


def _inputs(seed, B, sq, sk, H, D):
    rs = np.random.RandomState(seed)
    return tuple(rs.rand(B, s, H, D).astype(np.float32)
                 for s in (sq, sk, sk))


def _reference(q, k, v, **kw):
    return np.asarray(rnn.scaled_dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v)), **kw)._data)


@pytest.mark.parametrize("sq,sk", [(8, 4), (5, 1), (9, 7)])
def test_causal_with_more_queries_than_keys_answers(sq, sk):
    q, k, v = _inputs(0, 1, sq, sk, 2, 16)
    want = _reference(q, k, v, is_causal=True)
    f0 = pfa.FWD_LAUNCHES
    got = scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), is_causal=True)
    assert got.shape == (1, sq, 2, 16)
    assert pfa.FWD_LAUNCHES == f0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the rows that see no key average V, as the reference's do
    np.testing.assert_allclose(got[0, :sq - sk].numpy(),
                               np.broadcast_to(v[0].mean(0),
                                               (sq - sk, 2, 16)),
                               atol=ATOL)


def test_causal_with_more_queries_than_keys_is_differentiable():
    q, k, v = _inputs(1, 2, 8, 4, 2, 16)
    g = np.random.RandomState(2).rand(2, 8, 2, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: rnn._sdpa_xla(a, b, c, causal=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    scaled_dot_product_attention(*leaves, is_causal=True).backward(
        torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=5e-5)


def test_masked_call_takes_the_masked_math():
    rs = np.random.RandomState(3)
    q, k, v = _inputs(3, 2, 8, 4, 2, 16)
    mask = np.where(rs.rand(2, 1, 8, 4) < 0.3, -1e9, 0.0).astype(np.float32)
    want = _reference(q, k, v, attn_mask=jnp.asarray(mask), is_causal=True)
    got = scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        attn_mask=torch.from_numpy(mask), is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_gradients_flow_through_the_attention_function():
    # the CPU runs FlashAttention with the plain versions: what reaches q,
    # k and v is the reference's gradient
    q, k, v = _inputs(4, 2, 16, 16, 2, 32)
    g = np.random.RandomState(5).rand(2, 16, 2, 32).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: rnn._sdpa_xla(a, b, c, causal=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = scaled_dot_product_attention(*leaves, is_causal=True)
    assert out.grad_fn is not None and "FlashAttention" in str(out.grad_fn)
    out.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=5e-5)
