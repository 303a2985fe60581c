"""paddle_tpu_torch generation and serving against the JAX reference.

Greedy streams must equal the reference's token for token.  Sampled
streams cannot (the port's noise is a counter-based hash, the
reference's is jax.random), so the keep-sets are held against the
reference exactly and the streams are held to the contract: reproducible
across runs and independent of batch position and batchmates.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.generation import GenerationSession as RefSession
from paddle_tpu.generation import sampling as rsampling
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

from paddle_tpu_torch.generation import GenerationSession, sample
from paddle_tpu_torch.generation import sampling as psampling
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.serving import (AdmissionController, DeadlineExceeded,
                                      EngineClosed, GenerationEngine,
                                      GenerationEngineConfig,
                                      RequestRejected, next_bucket,
                                      seq_buckets)

WIDTH = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64)
V = WIDTH["vocab_size"]


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    ref = RefGPT(RefConfig(**WIDTH))
    params = {k: np.asarray(v) for k, v in ref.functional_state()[0].items()}
    net = GPT(GPTConfig(**WIDTH), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(params, device="cpu"))
    return ref, net


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(1, V, n).astype(np.int32) for n in (3, 9, 5)]


def test_greedy_streams_equal_reference(pair, prompts):
    ref, net = pair
    want = RefSession(ref, batch_capacity=4).generate(prompts,
                                                      max_new_tokens=10)
    got = GenerationSession(net, batch_capacity=4).generate(
        prompts, max_new_tokens=10)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_capacity_stop_equals_reference(pair, prompts):
    ref, net = pair
    want = RefSession(ref, batch_capacity=1, max_length=16).generate(
        prompts[1], max_new_tokens=100)[0]
    got = GenerationSession(net, batch_capacity=1, max_length=16).generate(
        prompts[1], max_new_tokens=100)[0]
    assert len(got) == 16 - len(prompts[1])       # cache full: hard stop
    np.testing.assert_array_equal(got, want)


def test_eos_stops_a_row_and_is_kept(pair, prompts):
    _ref, net = pair
    sess = GenerationSession(net, batch_capacity=4)
    full = sess.generate(prompts, max_new_tokens=10)
    eos = int(full[0][3])
    first = int(np.flatnonzero(full[0] == eos)[0])
    streamed = []
    out = sess.generate(prompts, max_new_tokens=10, eos_token_id=eos,
                        stream_callback=lambda r, t: streamed.append((r, t)))
    np.testing.assert_array_equal(out[0], full[0][:first + 1])
    for r in range(3):
        hit = np.flatnonzero(full[r] == eos)
        n = hit[0] + 1 if len(hit) else 10
        np.testing.assert_array_equal(out[r], full[r][:n])
        assert [t for rr, t in streamed if rr == r] == out[r].tolist()


def test_top_k_1_is_greedy(pair, prompts):
    _ref, net = pair
    sess = GenerationSession(net, batch_capacity=4)
    greedy = sess.generate(prompts, max_new_tokens=8)
    top1 = sess.generate(prompts, max_new_tokens=8, do_sample=True,
                         temperature=0.7, top_k=1, seed=11)
    for g, t in zip(greedy, top1):
        np.testing.assert_array_equal(t, g)


def test_samples_stay_inside_the_top_k_support():
    logits = torch.from_numpy(np.random.RandomState(1).randn(V)
                              .astype(np.float32) * 3)
    top5 = set(torch.topk(logits, 5).indices.tolist())
    B = 64
    toks = sample(logits.expand(B, V), torch.full((B,), 7),
                  torch.arange(B), torch.full((B,), 1.5),
                  torch.full((B,), 5), torch.ones(B))
    assert set(toks.tolist()) <= top5
    assert len(set(toks.tolist())) > 1            # it does sample


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.8, 5, 1.0), (1.0, 0, 0.9), (0.7, 10, 0.5),
    (1.3, 3, 0.95), (1.0, 200, 0.0), (0.5, 0, 0.999)])
def test_keep_sets_equal_reference(monkeypatch, temperature, top_k, top_p):
    # noise that is huge at one vocab index per row: a row returns its
    # index exactly when that token is in the keep-set.  Logits of unit
    # spread keep every token's mass far above fp32 resolution: where the
    # cumulative mass rounds to 1.0 the two cumsums may round apart.
    logits = np.random.RandomState(2).randn(V).astype(np.float32)
    rows = np.tile(logits, (V, 1))

    def ref_gumbel(key, shape, dtype):
        return jnp.where(jnp.arange(shape[0]) == key[1], 1e6,
                         0.0).astype(dtype)

    monkeypatch.setattr(jax.random, "gumbel", ref_gumbel)
    keys = np.stack([np.zeros(V), np.arange(V)], 1).astype(np.uint32)
    ref_tok = np.asarray(rsampling.sample(
        jnp.asarray(rows), jnp.asarray(keys),
        jnp.full((V,), temperature), jnp.full((V,), top_k),
        jnp.full((V,), top_p)))

    def port_gumbel(seeds, counters, vocab):
        return (torch.arange(vocab)[None, :] == seeds[:, None]).float() * 1e6

    monkeypatch.setattr(psampling, "gumbel_noise", port_gumbel)
    port_tok = sample(torch.from_numpy(rows), torch.arange(V),
                      torch.zeros(V, dtype=torch.long),
                      torch.full((V,), temperature), torch.full((V,), top_k),
                      torch.full((V,), top_p)).numpy()
    want = ref_tok == np.arange(V)
    assert want.any()
    np.testing.assert_array_equal(port_tok == np.arange(V), want)


def test_gumbel_noise_is_a_pure_function_of_seed_and_position():
    a = psampling.gumbel_noise(torch.tensor([5, 5, 6, -3]),
                               torch.tensor([9, 10, 9, 9]), 1000)
    b = psampling.gumbel_noise(torch.tensor([6, 5]), torch.tensor([9, 9]),
                               1000)
    torch.testing.assert_close(a[2], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[0], b[1], rtol=0, atol=0)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert torch.isfinite(a).all()
    # Gumbel(0, 1): mean is the Euler-Mascheroni constant, sd pi/sqrt(6)
    assert abs(a.mean().item() - 0.5772) < 0.05
    assert abs(a.std().item() - 1.2825) < 0.05


def test_seeded_sampling_reproducible_and_position_independent(pair,
                                                               prompts):
    _ref, net = pair
    sess = GenerationSession(net, batch_capacity=4)
    kw = dict(max_new_tokens=12, do_sample=True, temperature=0.9, top_p=0.9)
    a = sess.generate(prompts, seeds=[1, 2, 3], **kw)
    b = sess.generate(prompts, seeds=[1, 2, 3], **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    rev = sess.generate(prompts[::-1], seeds=[3, 2, 1], **kw)
    for x, y in zip(a, rev[::-1]):
        np.testing.assert_array_equal(x, y)
    solo = sess.generate([prompts[1]], seeds=[2], **kw)[0]
    np.testing.assert_array_equal(a[1], solo)
    other = sess.generate(prompts, seeds=[4, 5, 6], **kw)
    assert any(not np.array_equal(x, y) for x, y in zip(a, other))


def test_engine_streams_equal_solo_session_streams(pair):
    _ref, net = pair
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(1, V, rs.randint(2, 20)).astype(np.int32),
             dict(do_sample=i % 3 == 2, temperature=0.8, top_p=0.9,
                  seed=100 + i)) for i in range(10)]
    results = [None] * len(reqs)
    engine = GenerationEngine(net, GenerationEngineConfig(
        max_slots=4, max_new_tokens=12))
    try:
        def client(c):
            streams = [(i, engine.submit(reqs[i][0], **reqs[i][1]))
                       for i in range(c, len(reqs), 3)]
            for i, s in streams:
                results[i] = (list(s), s.result(timeout=120),
                              s.finish_reason)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = engine.stats()
    finally:
        engine.close()
    solo = GenerationSession(net, batch_capacity=4)
    for (prompt, kw), (streamed, out, reason) in zip(reqs, results):
        want = solo.generate([prompt], max_new_tokens=12, **kw)[0]
        np.testing.assert_array_equal(out, want)
        assert streamed == out.tolist() and reason == "max_new_tokens"
    assert stats["completed"] == len(reqs)
    assert stats["admitted"] == len(reqs)


def test_engine_rejections_are_typed(pair):
    _ref, net = pair
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=2, max_queue=0)) as engine:
        with pytest.raises(RequestRejected) as e:
            engine.submit([1, 2, 3])
        assert e.value.reason == "queue_full"
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=2, max_length=32, max_tokens_in_flight=40)) as engine:
        with pytest.raises(RequestRejected) as e:
            engine.submit(np.ones(32, np.int32))
        assert e.value.reason == "too_large"      # fills the cache
        with pytest.raises(RequestRejected) as e:
            engine.submit(np.ones(10, np.int32), max_new_tokens=31)
        assert e.value.reason == "too_large"      # over the whole budget
        with pytest.raises(DeadlineExceeded):
            engine.generate([1, 2], max_new_tokens=3, deadline_ms=-1.0,
                            timeout=60)
        assert engine.stats()["shed_deadline"] == 1
        out = engine.generate([1, 2], max_new_tokens=3, timeout=60)
        assert len(out) == 3
        assert engine.stats()["rejected.too_large"] == 2
    with pytest.raises(EngineClosed) as e:
        engine.submit([1, 2])
    assert e.value.reason == "closed"


def test_admission_token_budget_and_release():
    adm = AdmissionController(max_queue=2, max_tokens=10)
    adm.acquire(tokens=6)
    with pytest.raises(RequestRejected) as e:
        adm.acquire(tokens=5)
    assert e.value.reason == "token_budget"
    adm.acquire(tokens=4)
    with pytest.raises(RequestRejected) as e:
        adm.acquire(tokens=0)
    assert e.value.reason == "queue_full"
    adm.release()
    adm.release_tokens(6)
    adm.acquire(tokens=5)
    assert adm.depth == 2 and adm.tokens_in_flight == 9
    adm.close()
    with pytest.raises(EngineClosed):
        adm.acquire()
    assert adm.counts["rejected.closed"] == 1


def test_close_joins_the_scheduler_thread(pair):
    _ref, net = pair
    engine = GenerationEngine(net, GenerationEngineConfig(max_slots=2))
    s = engine.submit([3, 4, 5], max_new_tokens=4)
    engine.close()               # lets running work finish, then joins
    assert not engine._scheduler.is_alive()
    assert len(s.result(timeout=1)) == 4


def test_cancel_retires_at_the_next_token_boundary(pair):
    _ref, net = pair
    with GenerationEngine(net, GenerationEngineConfig(max_slots=2)) as engine:
        s = engine.submit([3, 4, 5], max_new_tokens=50)
        seen = []
        for tok in s:
            seen.append(tok)
            if len(seen) == 2:
                s.cancel()
        out = s.result(timeout=60)
        assert 2 <= len(out) < 50 and out.tolist() == seen
        assert s.finish_reason == "cancelled"
        assert engine.stats()["cancelled"] == 1


def test_buckets_match_reference():
    from paddle_tpu.serving import bucketing as rb
    for n, mb, cap in [(0, 1, None), (5, 1, None), (5, 8, None),
                       (9, 1, 8), (100, 1, 64), (64, 1, 64)]:
        assert next_bucket(n, mb, cap) == rb.next_bucket(n, mb, cap)
    for m, mb in [(64, 8), (100, 8), (8, 8), (5, 8)]:
        assert seq_buckets(m, mb) == rb.seq_buckets(m, mb)
    with pytest.raises(ValueError):
        next_bucket(-1)
