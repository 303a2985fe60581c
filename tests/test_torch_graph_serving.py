"""The session and engine through the executable cache, on the CPU (where
an entry is the plain step function): a prefill with a partial update
mask against the reference session's, the engine's warmup, the caches a
session binds, the cache's keys and counts, and an entry made again when
a parameter is replaced rather than copied into."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.generation import GenerationSession as RefSession
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

from paddle_tpu_torch.generation import GenerationSession
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.serving import (ExecutableCache, GenerationEngine,
                                      GenerationEngineConfig, seq_buckets)

WIDTH = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64)
V, B, C = WIDTH["vocab_size"], 4, 32
CACHE_ATOL = 1e-6                    # tests/test_torch_gpt.py's cache check


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    ref = RefGPT(RefConfig(**WIDTH))
    params = {k: np.asarray(v) for k, v in ref.functional_state()[0].items()}
    net = GPT(GPTConfig(**WIDTH), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(params, device="cpu"))
    return ref, net


def _knobs():
    return (np.zeros((B,), np.float32), np.zeros((B,), np.int32),
            np.ones((B,), np.float32))


def test_partial_mask_prefill_matches_the_reference(pair):
    ref, net = pair
    rs = np.random.RandomState(3)
    rsess, sess = RefSession(ref, batch_capacity=B, max_length=C), \
        GenerationSession(net, batch_capacity=B, max_length=C)
    keys, seeds = np.zeros((B, 2), np.uint32), np.zeros((B,), np.int64)
    r_caches, caches = rsess.init_caches(), sess.init_caches()
    # every row filled by a first prefill (bucket 16), then rows 1 and 3
    # replaced by a second one (bucket 8)
    steps = [(rs.randint(1, V, (B, 16)).astype(np.int32),
              np.array([16, 9, 12, 5], np.int32), np.ones((B,), bool)),
             (rs.randint(1, V, (B, 8)).astype(np.int32),
              np.array([1, 7, 1, 8], np.int32),
              np.array([False, True, False, True]))]
    for ids, plens, mask in steps:
        before = [(c.k.clone(), c.v.clone()) for c in caches]
        want, r_caches = rsess.prefill(r_caches, ids, plens, mask, keys,
                                       *_knobs())
        got, out = sess.prefill(caches, ids, plens, mask, seeds, *_knobs())
        assert out is caches
        np.testing.assert_array_equal(got[mask], np.asarray(want)[mask])
        for rc, pc, (k0, v0) in zip(r_caches, caches, before):
            np.testing.assert_allclose(pc.k.numpy(), np.asarray(rc.k),
                                       atol=CACHE_ATOL)
            np.testing.assert_allclose(pc.v.numpy(), np.asarray(rc.v),
                                       atol=CACHE_ATOL)
            keep = torch.from_numpy(~mask)
            assert torch.equal(pc.k[keep], k0[keep])     # bit for bit
            assert torch.equal(pc.v[keep], v0[keep])
            P = ids.shape[1]
            assert not pc.k[torch.from_numpy(mask), P:].any()
    assert sess.steps["prefill"] == 2 and sess.tokens_out == 6
    assert sorted(k[0] for k in sess._cache.keys()) == ["prefill:16",
                                                        "prefill:8"]


def test_generate_compiles_once_per_bucket_and_decode(pair):
    _ref, net = pair
    sess = GenerationSession(net, batch_capacity=B, max_length=C)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(1, V, n).astype(np.int32) for n in (3, 7, 5)]
    sess.generate(prompts, max_new_tokens=6)
    cache = sess._cache
    assert sorted(k[0] for k in cache.keys()) == ["decode", "prefill:8"]
    assert cache.compiles == 2 and cache.hits == 4     # 5 decodes
    assert all(k[1:3] == (B, C) for k in cache.keys())
    sess.generate([prompts[0]], max_new_tokens=4)      # same buckets
    assert cache.compiles == 2 and cache.hits == 8
    assert sess.steps == {"prefill": 2, "decode": 8}


def test_foreign_caches_raise(pair):
    _ref, net = pair
    sess = GenerationSession(net, batch_capacity=B, max_length=C)
    ids, plens = np.ones((B, 8), np.int32), np.ones((B,), np.int32)
    args = (ids, plens, np.ones((B,), bool), np.zeros((B,), np.int64),
            *_knobs())
    with pytest.raises(ValueError, match="not this session's"):
        sess.prefill(net.gen_caches(B, C), *args)      # before init_caches
    own = sess.init_caches()
    with pytest.raises(ValueError, match="by address"):
        sess.prefill(net.gen_caches(B, C), *args)
    with pytest.raises(ValueError, match="not this session's"):
        sess.decode(tuple(own)[:1], np.ones((B,), np.int32), plens,
                    np.zeros((B,), np.int64), *_knobs())
    sess.prefill(tuple(own), *args)           # the same set, any sequence
    assert sess.init_caches() is own and not any(c.k.any() for c in own)


def _serve(net, prompts, **cfg):
    engine = GenerationEngine(net, GenerationEngineConfig(
        max_slots=B, max_length=C, max_new_tokens=5, **cfg))
    try:
        streams = [engine.submit(p, **kw) for p, kw in prompts]
        out = [s.result(timeout=120) for s in streams]
        assert engine.ready
        return out, engine
    finally:
        engine.close()


def test_engine_warmup_is_inert(pair):
    _ref, net = pair
    rs = np.random.RandomState(7)
    prompts = [(rs.randint(1, V, n).astype(np.int32),
                dict(do_sample=i % 2 == 1, temperature=0.9, seed=i))
               for i, n in enumerate((3, 12, 20, 9, 1, 17))]
    cold, e0 = _serve(net, prompts)
    warm, e1 = _serve(net, prompts, warmup=True)
    late, e2 = _serve(net, prompts, warmup="async")
    for a, b, c in zip(cold, warm, late):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    want = len(seq_buckets(C, 8)) + 1
    assert e0.warmed_buckets == 0
    assert e1.warmed_buckets == e2.warmed_buckets == want
    assert e1.session._cache.compiles == want
    assert len(e1.session._cache) == want
    # the warmup's steps serve no row: neither counted nor timed
    assert e1.stats()["prefill_steps"] == e0.stats()["prefill_steps"]
    assert e1.stats()["decode_steps"] == e0.stats()["decode_steps"]
    assert e1.session.tokens_out == e0.session.tokens_out


def test_copied_weights_are_read_and_replaced_ones_recompile():
    net = GPT(GPTConfig(**WIDTH), device="cpu", seed=1)
    sess = GenerationSession(net, batch_capacity=B, max_length=C)
    prompt = [np.arange(1, 9, dtype=np.int32)]
    first = sess.generate(prompt, max_new_tokens=4)[0]
    other = GPT(GPTConfig(**WIDTH), device="cpu", seed=2)
    net.load_state_dict(other.state_dict())              # copies in place
    copied = sess.generate(prompt, max_new_tokens=4)[0]
    assert sess._cache.compiles == 2
    np.testing.assert_array_equal(
        copied, GenerationSession(other, batch_capacity=B, max_length=C)
        .generate(prompt, max_new_tokens=4)[0])
    assert not np.array_equal(first, copied)
    net.head.weight = torch.nn.Parameter(net.head.weight.detach().clone())
    again = sess.generate(prompt, max_new_tokens=4)[0]
    assert sess._cache.compiles == 4              # both entries made again
    np.testing.assert_array_equal(again, copied)


def test_sessions_may_share_one_cache(pair):
    _ref, net = pair
    shared = ExecutableCache(name="shared")
    a = GenerationSession(net, batch_capacity=B, max_length=C,
                          executable_cache=shared)
    b = GenerationSession(net, batch_capacity=B, max_length=C,
                          executable_cache=shared, name="b")
    p = [np.arange(1, 6, dtype=np.int32)]
    np.testing.assert_array_equal(a.generate(p, max_new_tokens=3)[0],
                                  b.generate(p, max_new_tokens=3)[0])
    # an entry binds its session's caches: one set of keys a session
    assert shared.compiles == 4 and len(shared) == 4
    assert b.name == "b" and a.name == "generation"
