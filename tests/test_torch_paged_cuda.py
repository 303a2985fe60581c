"""paddle_tpu_torch's paged KV cache and paged engine on the card.

Every test needs an NVIDIA card and skips without one.  The file imports no
JAX, so it runs on the card's machine (without the repo's conftest, which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_paged_cuda.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.ops import flash_attention as pfa
from paddle_tpu_torch.quantization import quantize_int8
from paddle_tpu_torch.serving import (GenerationEngine,
                                      GenerationEngineConfig,
                                      PagedGenerationEngine)

pytestmark = pytest.mark.cuda

WIDTH = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128)                    # head dim 64
BS = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the paged steps are captured "
                    "CUDA graphs over the flash-attention kernel")


def _requests(n=6):
    rs = np.random.RandomState(0)
    return [(rs.randint(1, WIDTH["vocab_size"], k).astype(np.int32),
             dict(do_sample=i % 2 == 1, temperature=0.8, top_p=0.9, seed=i))
            for i, k in enumerate((3, 20, 9, 5, 17, 2, 40, 33)[:n])]


def test_paged_engine_streams_equal_contiguous_on_the_card(card):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    reqs = _requests()
    cfg = dict(max_slots=4, max_new_tokens=16)
    with GenerationEngine(net, GenerationEngineConfig(**cfg)) as engine:
        want = [s.result(timeout=120)
                for s in [engine.submit(p, **kw) for p, kw in reqs]]
    with PagedGenerationEngine(net, GenerationEngineConfig(
            block_size=BS, prefix_cache_blocks=0, warmup=True,
            name="cuda_paged", **cfg)) as engine:
        # after the warmup, whose captures run each step once
        before = pfa.FWD_LAUNCHES
        compiles = engine.session._cache.compiles
        got = [s.result(timeout=120)
               for s in [engine.submit(p, **kw) for p, kw in reqs]]
        groups = engine.stats()["prefill_steps"]
        assert engine.session._cache.compiles == compiles
        assert all(e.graph is not None
                   for e in engine.session._cache.entries().values())
    assert pfa.FWD_LAUNCHES - before == WIDTH["num_layers"] * groups
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert engine.pool.available == engine.pool.num_blocks


def test_drop_marker_on_the_card(card):
    """Writes into unallocated entries land in the sink, with no
    device-side assert, inside a captured graph too."""
    arena = pgen.init_arenas(1, 4, 4, 2, 64, device="cuda")[0]
    arena.k.fill_(7.0)
    cache = pgen.PagedKV(arena, torch.full((1, 2), -1, dtype=torch.long,
                                           device="cuda"),
                         torch.tensor([8], device="cuda"))
    new = torch.ones((1, 2, 2, 64), device="cuda")
    starts = torch.zeros(1, dtype=torch.long, device="cuda")
    pgen.write_paged(cache, new, new, starts)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            pgen.write_paged(cache, 2 * new, 2 * new, starts)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert bool((arena.k[:4] == 7.0).all())
    assert bool((arena.k[4, :2] == 2.0).all())


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_swap_round_trip_through_pinned_memory(card, kv_dtype):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    sess = pgen.PagedGenerationSession(net, batch_capacity=2, block_size=BS,
                                       kv_dtype=kv_dtype)
    arenas = sess.init_arenas()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for a in arenas:
        for f in a:
            if f.dtype == torch.int8:
                f.copy_(torch.randint(-127, 128, f.shape, generator=gen,
                                      device="cuda"))
            else:
                f.copy_(torch.randn(f.shape, generator=gen, device="cuda"))
    snap = [[f.clone() for f in a] for a in arenas]
    payload = sess.swap_out_blocks(arenas, [5, 2, 9])
    assert all(h.is_pinned() for layer in payload for h in layer)
    for a in arenas:
        for f in a:
            f.zero_()
    sess.swap_in_blocks(arenas, [0, 1, 3], payload)
    for a, b in zip(arenas, snap):
        for f, g in zip(a, b):
            assert torch.equal(f[0], g[5]) and torch.equal(f[1], g[2])
            assert torch.equal(f[3], g[9])
    sess.copy_blocks(arenas, [0], [7])
    for a in arenas:
        for f in a:
            assert torch.equal(f[7], f[0])


def test_quantize_int8_card_equals_cpu(card):
    gen = torch.Generator().manual_seed(1)
    x = 3 * torch.randn((64, 16, 12, 64), generator=gen)
    q, s = quantize_int8(x)
    qc, sc = quantize_int8(x.cuda())
    assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_speculative_equals_plain_on_the_card(card, sampled, monkeypatch):
    """The n-gram drafter, then an oracle that drafts each stream's own
    continuation (every draft accepted: the verify step's tokens, sampled
    from logits at B·W rows, must be decode's)."""
    from paddle_tpu_torch.generation import speculative
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    sess = pgen.PagedGenerationSession(net, batch_capacity=4, block_size=BS)
    rs = np.random.RandomState(2)
    rep = [np.tile(rs.randint(1, 97, 16).astype(np.int32), 3)
           for _ in range(4)]
    kw = dict(do_sample=True, temperature=0.8, top_p=0.95,
              seeds=[1, 2, 3, 4]) if sampled else {}
    want = sess.generate(rep, max_new_tokens=24, **kw)
    got = sess.generate(rep, max_new_tokens=24, speculative_k=4, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    truth = {tuple(p.tolist()): list(w) for p, w in zip(rep, want)}

    def oracle(context, k, ngram=2):
        ctx = [int(t) for t in context]
        cont = truth[tuple(ctx[:48])]
        return cont[len(ctx) - 48:len(ctx) - 48 + int(k)]
    monkeypatch.setattr(speculative, "propose_drafts", oracle)
    steps = sess.steps["decode"]
    got = sess.generate(rep, max_new_tokens=24, speculative_k=4, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert sess.steps["decode"] - steps <= 6


def test_preempt_resume_on_the_card(card):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    pA = np.arange(1, 9, dtype=np.int32)
    pB = np.arange(1, 41, dtype=np.int32)
    kw = dict(max_new_tokens=30, do_sample=True, temperature=0.9, seed=7)
    cfg = dict(max_slots=2, max_length=64, max_new_tokens=8, block_size=BS,
               num_blocks=3, prefix_cache_blocks=0)
    with PagedGenerationEngine(net, GenerationEngineConfig(
            name="cuda_pre_ref", **cfg)) as eng:
        want = eng.generate(pA, timeout=120, **kw)
    with PagedGenerationEngine(net, GenerationEngineConfig(
            name="cuda_pre", **cfg)) as eng:
        sA = eng.submit(pA, priority="batch", **kw)
        it = iter(sA)
        head = [next(it) for _ in range(3)]
        eng.generate(pB, max_new_tokens=4, priority="interactive",
                     timeout=120)
        got = np.asarray(head + list(it), np.int32)
        assert len(eng.session.swaps["out"]) == 1
        assert len(eng.session.swaps["in"]) == 1
    np.testing.assert_array_equal(got, want)
    assert eng.pool.available == eng.pool.num_blocks
