"""paddle_tpu_torch GPT against the JAX reference GPT on the CPU.

The reference's weights are carried across with
``gpt_state_from_paddle_tpu``; the same token ids go through both models.
Tolerances: 1e-4 on logits (XLA and PyTorch sum in different orders on
the CPU), 1e-6 on cache contents (a copy of the same projections).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.generation import kv_cache as rkv
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

from paddle_tpu_torch.generation import kv_cache as pkv
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.models.convert import LINEAR_WEIGHTS
from paddle_tpu_torch.ops import flash_attention as pfa

WIDTH = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    ref = RefGPT(RefConfig(**WIDTH))
    params = {k: np.asarray(v) for k, v in ref.functional_state()[0].items()}
    net = GPT(GPTConfig(**WIDTH), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(params, device="cpu"),
                        strict=True)
    return ref, net, params


def _ids(seed, B, T):
    return np.random.RandomState(seed).randint(
        0, WIDTH["vocab_size"], (B, T)).astype(np.int32)


def test_weight_names_and_shapes_map(pair):
    _ref, net, params = pair
    state = net.state_dict()
    assert set(state) == set(params)
    for name, arr in params.items():
        want = arr.T.shape if name.endswith(LINEAR_WEIGHTS) else arr.shape
        assert tuple(state[name].shape) == want, name
    np.testing.assert_array_equal(
        state["blocks.0.attn.qkv.weight"].numpy(),
        params["blocks.0.attn.qkv.weight"].T)
    with pytest.raises(ValueError, match="matrix"):
        gpt_state_from_paddle_tpu({"head.weight": np.zeros(3)},
                                  device="cpu")


def test_seeded_init_follows_the_reference_distributions():
    a = GPT(GPTConfig(**WIDTH), device="cpu", seed=3)
    b = GPT(GPTConfig(**WIDTH), device="cpu", seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    qkv = a.blocks[0].attn.qkv
    assert abs(qkv.weight.std().item() - (2.0 / (32 + 96)) ** 0.5) < 0.02
    assert qkv.bias.abs().max().item() == 0.0
    assert abs(a.wte.weight.std().item() - 1.0) < 0.1
    assert a.ln_f.weight.eq(1).all() and a.ln_f.bias.eq(0).all()


@pytest.mark.parametrize("B,T", [(2, 16), (1, 64), (3, 7)])
def test_uncached_logits_match(pair, B, T):
    ref, net, _ = pair
    ids = _ids(T, B, T)
    want = np.asarray(ref(Tensor(jnp.asarray(ids)))._data)
    before = pfa.LAUNCHES
    with torch.inference_mode():
        got = net(torch.from_numpy(ids))
    assert pfa.LAUNCHES == before          # CPU: the plain version
    assert got.shape == (B, T, WIDTH["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)


@pytest.mark.parametrize("prefill", [True, False])
def test_cached_prefill_then_decode_match(pair, prefill):
    # prefill=True passes no positions: the port's kernel route for a
    # prefill from zero; prefill=False passes zeros and takes the masked
    # path, as the reference does
    ref, net, _ = pair
    B, P, C = 2, 12, 32
    ids = _ids(5, B, P)
    r_caches = ref.gen_caches(B, C)
    r_logits, r_caches = ref(Tensor(jnp.asarray(ids)), caches=r_caches,
                             positions=jnp.zeros((B,), jnp.int32))
    caches = net.gen_caches(B, C)
    with torch.inference_mode():
        if prefill:
            logits, caches = net(torch.from_numpy(ids), caches=caches)
        else:
            logits, caches = net(torch.from_numpy(ids), caches=caches,
                                 positions=torch.zeros(B, dtype=torch.long))
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits._data),
                               atol=LOGIT_ATOL)
    pos = np.array([P, P - 3], np.int32)      # ragged rows
    for step in range(3):
        tok = _ids(10 + step, B, 1)
        r_logits, r_caches = ref(Tensor(jnp.asarray(tok)), caches=r_caches,
                                 positions=jnp.asarray(pos))
        with torch.inference_mode():
            logits, caches = net(torch.from_numpy(tok), caches=caches,
                                 positions=torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(r_logits._data),
                                   atol=LOGIT_ATOL)
        pos = pos + 1
    for rc, pc in zip(r_caches, caches):
        np.testing.assert_allclose(pc.k.numpy(), np.asarray(rc.k),
                                   atol=1e-6)
        np.testing.assert_allclose(pc.v.numpy(), np.asarray(rc.v),
                                   atol=1e-6)


def test_prefill_refuses_positions(pair):
    _ref, net, _ = pair
    # a prefill (no positions) refuses to run past the cache's capacity
    with pytest.raises(ValueError, match="prefill"):
        net(torch.zeros((1, 9), dtype=torch.long),
            caches=net.gen_caches(1, 8))
    with pytest.raises(ValueError, match="capacity"):
        net.gen_caches(1, 65)


def test_positions_clip_to_max_seq_len(pair):
    ref, net, _ = pair
    C = WIDTH["max_seq_len"]
    tok = _ids(7, 1, 1)
    pos = np.array([C + 5], np.int32)         # past the position table
    r_logits, _ = ref(Tensor(jnp.asarray(tok)), caches=ref.gen_caches(1, C),
                      positions=jnp.asarray(pos))
    with torch.inference_mode():
        logits, _ = net(torch.from_numpy(tok), caches=net.gen_caches(1, C),
                        positions=torch.from_numpy(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits._data),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("starts,S", [([0, 4], 3), ([6, 1], 2), ([7, 0], 1)])
def test_write_kv_matches_reference(starts, S):
    rs = np.random.RandomState(S)
    buf = rs.rand(2, 8, 2, 4).astype(np.float32)
    new = rs.rand(2, S, 2, 4).astype(np.float32)
    want = np.asarray(rkv.write_kv(jnp.asarray(buf), jnp.asarray(new),
                                   jnp.asarray(starts, jnp.int32)))
    t = torch.from_numpy(buf.copy())
    out = pkv.write_kv(t, torch.from_numpy(new), torch.tensor(starts))
    assert out is t                             # in place
    np.testing.assert_array_equal(out.numpy(), want)


def test_write_clamps_like_dynamic_update_slice():
    buf = np.zeros((1, 8, 1, 1), np.float32)
    new = np.ones((1, 3, 1, 1), np.float32)
    want = np.asarray(rkv.write_kv(jnp.asarray(buf), jnp.asarray(new),
                                   jnp.asarray([7], jnp.int32)))
    cache = pkv.KVCache(torch.zeros(1, 8, 1, 1), torch.zeros(1, 8, 1, 1))
    pkv.write(cache, torch.ones(1, 3, 1, 1), torch.ones(1, 3, 1, 1),
              torch.tensor([7]))
    np.testing.assert_array_equal(cache.k.numpy(), want)
    assert cache.capacity == 8 and cache.batch == 1
    with pytest.raises(TypeError, match="KVCache"):
        pkv.write((cache.k, cache.v), cache.k, cache.v, [0])


@pytest.mark.parametrize("q_len,capacity", [(1, 6), (2, 6), (5, 9)])
def test_attention_mask_matches_reference(q_len, capacity):
    starts = np.array([0, 3, 1], np.int32)
    want = np.asarray(rkv.attention_mask(jnp.asarray(starts), q_len,
                                         capacity))
    got = pkv.attention_mask(torch.from_numpy(starts), q_len, capacity)
    assert got.shape == (3, 1, q_len, capacity)
    np.testing.assert_array_equal(got.numpy(), want)
