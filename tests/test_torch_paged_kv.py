"""paddle_tpu_torch's paged KV cache, prefix cache, speculative helpers,
int8 quantization and KV wire format against the JAX reference.

The model is the reference test's (``tests/test_paged_kv.py``: V 97, D 32,
L 2, H 2, T 64, ffn 2, block 16), its weights carried across with
``gpt_state_from_paddle_tpu``; inputs are drawn with numpy from seeds.
fp32 writes, views and int8 quantization are held to the reference bit for
bit, greedy streams token for token.
"""
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as rgen
from paddle_tpu.generation import kv_wire as rwire
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig
from paddle_tpu.quantization import dequantize_int8_jnp, quantize_int8_jnp

from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import kv_wire as pwire
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.quantization import dequantize_int8, quantize_int8

WIDTH = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64, ffn_mult=2)
V, H, D = 97, 2, 16
BS = 16


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
    rs = np.random.RandomState(11)
    return [rs.randint(1, V, n).astype(np.int32) for n in (5, 9, 13, 7)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# -- BlockPool -----------------------------------------------------------------
def _pool_script(pool, exhausted):
    """One script of pool operations; the log of what each returned or
    raised."""
    log = []

    def do(name, fn):
        try:
            log.append((name, fn()))
        except exhausted:
            log.append((name, "exhausted"))
        except ValueError:
            log.append((name, "ValueError"))
        log.append(("available", pool.available))

    a = []
    do("alloc3", lambda: a.extend(pool.alloc(3)) or list(a))
    do("incref", lambda: pool.incref(a[:2]))
    do("refcounts", lambda: [pool.refcount(b) for b in range(pool.num_blocks)])
    do("decref", lambda: pool.decref(a))
    do("alloc_too_many", lambda: pool.alloc(pool.available + 1))
    do("alloc2", lambda: pool.alloc(2))
    do("decref_twice", lambda: pool.decref([a[2]]))
    do("incref_free", lambda: pool.incref([a[2]]))
    do("decref_rest", lambda: pool.decref(a[:2]))
    do("alloc0", lambda: pool.alloc(0))
    do("alloc_all", lambda: pool.alloc(pool.available))
    do("refcounts", lambda: [pool.refcount(b) for b in range(pool.num_blocks)])
    return log


def test_block_pool_scripts_equal_reference():
    want = _pool_script(rgen.BlockPool(6, BS, name="tpp_pool_r"),
                        rgen.BlockPoolExhausted)
    got = _pool_script(pgen.BlockPool(6, BS, name="tpp_pool_p"),
                       pgen.BlockPoolExhausted)
    assert got == want
    assert ("alloc_too_many", "exhausted") in got


def test_block_pool_metric_names():
    from paddle_tpu_torch.profiler import metrics
    pool = pgen.BlockPool(3, BS, name="tpp_pool_m")
    pool.alloc(2)
    with pytest.raises(pgen.BlockPoolExhausted):
        pool.alloc(2)
    assert metrics.get("tpp_pool_m.kv.blocks_in_flight").value == 2
    assert metrics.get("tpp_pool_m.kv.block_allocs").value == 2
    assert metrics.get("tpp_pool_m.kv.alloc_exhausted").value == 1


# -- writes and views ----------------------------------------------------------
def _arena_case(rs, N, quantized):
    shape = (N, BS, H, D)
    if quantized:
        return [rs.randint(-127, 128, shape).astype(np.int8),
                rs.randint(-127, 128, shape).astype(np.int8),
                rs.rand(N, BS, H).astype(np.float32),
                rs.rand(N, BS, H).astype(np.float32)]
    return [rs.randn(*shape).astype(np.float32) for _ in range(2)]


def _port_arena(fields, quantized):
    """The port's arena over ``fields`` with a zero sink block appended."""
    ts = [torch.from_numpy(np.concatenate(
        [f, np.zeros((1,) + f.shape[1:], f.dtype)])) for f in fields]
    return (pgen.KVArenaQ if quantized else pgen.KVArena)(*ts)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float32", "int8"])
def test_write_and_view_equal_reference(quantized):
    rs = np.random.RandomState(3)
    N, B, T, M = 10, 3, 7, 4
    fields = _arena_case(rs, N, quantized)
    table = np.full((B, M), -1, np.int32)
    table[0, :3] = [4, 1, 7]
    table[1, :2] = [0, 9]
    table[2, :4] = [2, 3, 5, 6]
    starts = np.array([13, 3, 40], np.int32)
    limits = np.array([18, 10, 45], np.int32)     # row 2 writes 5 of 7
    k_new = (3 * rs.randn(B, T, H, D)).astype(np.float32)
    v_new = rs.randn(B, T, H, D).astype(np.float32)

    rcls = rgen.KVArenaQ if quantized else rgen.KVArena
    rcache = rgen.PagedKV(rcls(*[jnp.asarray(f) for f in fields]),
                          jnp.asarray(table), jnp.asarray(limits))
    rout = rgen.write_paged(rcache, jnp.asarray(k_new), jnp.asarray(v_new),
                            jnp.asarray(starts))
    arena = _port_arena(fields, quantized)
    pcache = pgen.PagedKV(arena, torch.from_numpy(table),
                          torch.from_numpy(limits))
    pgen.write_paged(pcache, torch.from_numpy(k_new), torch.from_numpy(v_new),
                     torch.from_numpy(starts))
    for want, got in zip(rout.arena, arena):
        np.testing.assert_array_equal(_bits(got[:N].numpy()), _bits(want))
    for want, got in zip(rgen.paged_view(rout), pgen.paged_view(pcache)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_drop_marker_changes_no_block(pair):
    """A write into an unallocated table entry changes no block, the last
    one included (a -1 index would wrap to it); it lands in the sink."""
    _ref, net = pair
    arenas = net.gen_arenas(4, 4)
    arena = arenas[0]
    assert pgen.arena_blocks(arena) == 4 and arena.k.shape[0] == 5
    arena.k.fill_(7.0)
    arena.v.fill_(7.0)
    cache = pgen.PagedKV(arena, torch.full((1, 2), -1, dtype=torch.int32),
                         torch.tensor([8]))
    new = torch.ones((1, 2, H, D))
    pgen.write_paged(cache, new, new, torch.tensor([0]))
    assert bool((arena.k[:4] == 7.0).all()) and bool((arena.v[:4] == 7.0).all())
    assert bool((arena.k[4, :2] == 1.0).all())        # the sink took them
    # and a write past the limit, into an allocated block, is dropped too
    cache = pgen.PagedKV(arena, torch.tensor([[3, 2]], dtype=torch.int32),
                         torch.tensor([1]))
    pgen.write_paged(cache, 2 * new, 2 * new, torch.tensor([0]))
    assert bool((arena.k[3, 0] == 2.0).all())
    assert bool((arena.k[3, 1:] == 7.0).all()) and bool((arena.k[:3] == 7.0)
                                                        .all())


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_copy_blocks_and_swap_round_trip(pair, kv_dtype):
    _ref, net = pair
    sess = pgen.PagedGenerationSession(net, batch_capacity=2, max_length=64,
                                       block_size=BS, num_blocks=8,
                                       kv_dtype=kv_dtype)
    arenas = sess.init_arenas()
    gen = torch.Generator().manual_seed(0)
    for a in arenas:
        for f in a:
            if f.dtype == torch.int8:
                f.copy_(torch.randint(-127, 128, f.shape, generator=gen))
            else:
                f.copy_(torch.randn(f.shape, generator=gen))
    before = [[f.clone() for f in a] for a in arenas]
    sess.copy_blocks(arenas, [1, -1, 5], [6, 2, 0])
    for a, b in zip(arenas, before):
        for f, g in zip(a, b):
            want = g.clone()
            want[6], want[0] = g[1], g[5]
            assert torch.equal(f, want)
    assert sess.blocks_copied == 2
    snap = [[f.clone() for f in a] for a in arenas]
    payload = sess.swap_out_blocks(arenas, [3, 6])
    assert len(payload) == 2 and payload[0][0].shape[0] == 2
    for a in arenas:
        for f in a:
            f[3] = 0
            f[6] = 0
    sess.swap_in_blocks(arenas, [3, 6], payload)
    for a, b in zip(arenas, snap):
        for f, g in zip(a, b):
            assert torch.equal(f, g)
    # into other blocks: the same bytes under new ids
    sess.swap_in_blocks(arenas, [1, 2], payload)
    for a, b in zip(arenas, snap):
        for f, g in zip(a, b):
            assert torch.equal(f[1], g[3]) and torch.equal(f[2], g[6])
    (out_ms, out_bytes), (in_ms, in_bytes) = sess.swaps["out"][0], \
        sess.swaps["in"][0]
    assert out_bytes == in_bytes == 2 * sess.arena_bytes_per_block()
    with pytest.raises(ValueError, match="not this session's"):
        sess.copy_blocks(net.gen_arenas(8, BS), [0], [1])


# -- int8 quantization -------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_quantize_int8_bit_equal_reference(scale):
    rs = np.random.RandomState(int(scale * 1000) % 97)
    x = (scale * rs.randn(4, 9, 3, 16)).astype(np.float32)
    x[0, 0] = 0.0                            # an all-zero slice: 1e-8 floor
    x[1, 1, 1, :2] = [0.5 * scale, -0.5 * scale]
    q, s = quantize_int8_jnp(jnp.asarray(x), axis=-1)
    pq, ps = quantize_int8(torch.from_numpy(x), axis=-1)
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(_bits(ps.numpy()), _bits(s))
    np.testing.assert_array_equal(
        _bits(dequantize_int8(pq, ps).numpy()),
        _bits(dequantize_int8_jnp(q, s, axis=-1)))


# -- prefix cache --------------------------------------------------------------
def _prefix_script(gen_mod, name):
    pool = gen_mod.BlockPool(24, 4, name=name)
    cache = gen_mod.PrefixCache(pool, capacity_blocks=5, name=name)
    rs = np.random.RandomState(5)
    base = rs.randint(1, 90, 10).astype(np.int32)
    log = []
    for i, extra in enumerate(([], [91, 92], [93], list(range(1, 9)))):
        toks = np.concatenate([base, np.int32(extra)])
        got, covered = cache.lookup(toks)
        log.append(("lookup", i, got, covered))
        blocks = pool.alloc(gen_mod.blocks_for_tokens(len(toks), 4))
        cache.insert(toks, blocks)
        pool.decref(blocks)
        if got:
            pool.decref(got)
        log.append(("cached", len(cache), pool.available,
                    cache.hot_heads(3), cache.hot_heads(2, hexlen=8)))
    other = rs.randint(1, 90, 8).astype(np.int32)
    blocks = pool.alloc(2)
    cache.insert(other, blocks)               # evicts under the cap of 5
    pool.decref(blocks)
    log.append(("evicted", len(cache), pool.available, cache.hot_heads(8)))
    got, covered = cache.lookup(np.concatenate([base, np.int32([91, 92])]))
    log.append(("relookup", got, covered))
    pool.decref(got)
    cache.clear()
    log.append(("cleared", len(cache), pool.available))
    return log


def test_prefix_cache_keys_lru_and_hot_heads_equal_reference():
    want = _prefix_script(rgen, "tpp_pc_r")
    got = _prefix_script(pgen, "tpp_pc_p")
    assert got == want
    assert want[-1] == ("cleared", 0, 24)


def test_prefix_cache_concurrent_first_fill_caches_once():
    pool = pgen.BlockPool(16, 4, name="tpp_pc_race")
    cache = pgen.PrefixCache(pool, capacity_blocks=8, name="tpp_pc_race")
    toks = np.arange(1, 9, dtype=np.int32)
    mine = [pool.alloc(2) for _ in range(2)]
    barrier = threading.Barrier(2)

    def racer(i):
        barrier.wait()
        cache.insert(toks, mine[i])
    threads = [threading.Thread(target=racer, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got, covered = cache.lookup(toks)
    assert covered == 8 and set(got) in (set(mine[0]), set(mine[1]))
    loser = mine[1] if set(got) == set(mine[0]) else mine[0]
    assert [pool.refcount(b) for b in loser] == [1, 1]
    assert [pool.refcount(b) for b in got] == [3, 3]
    pool.decref(got)


# -- speculative helpers -------------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(ctx=st.lists(st.integers(0, 5), min_size=0, max_size=40),
       k=st.integers(0, 6), ngram=st.integers(1, 4), room=st.integers(0, 8))
def test_speculative_helpers_equal_reference(ctx, k, ngram, room):
    from paddle_tpu.generation import speculative as rspec
    from paddle_tpu_torch.generation import speculative as pspec
    assert pspec.propose_drafts(ctx, k, ngram) == \
        rspec.propose_drafts(ctx, k, ngram)
    assert pspec.draft_row(ctx, k, room, ngram) == \
        rspec.draft_row(ctx, k, room, ngram)
    drafts = rspec.propose_drafts(ctx, k, ngram)
    sampled = (list(drafts[:len(drafts) // 2]) + [99] * (k + 1))[:len(drafts)
                                                                + 1]
    assert pspec.accept_span(drafts, sampled) == \
        rspec.accept_span(drafts, sampled)
    ids_r, feed_r = np.zeros((2, k + 1), np.int32), np.zeros(2, np.int32)
    ids_p, feed_p = ids_r.copy(), feed_r.copy()
    rspec.fill_verify_row(ids_r, feed_r, 1, 7, drafts[:k])
    pspec.fill_verify_row(ids_p, feed_p, 1, 7, drafts[:k])
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(feed_p, feed_r)


# -- the KV wire format --------------------------------------------------------
@pytest.mark.parametrize("n", [1, 15, 16, 17, 40])
def test_chain_digests_equal_reference(n):
    toks = np.random.RandomState(n).randint(1, V, n).astype(np.int32)
    assert pwire.chain_digests(toks, BS) == rwire.chain_digests(toks, BS)
    assert pwire.chain_digests(toks, BS, hexlen=64) == \
        rwire.chain_digests(toks, BS, hexlen=64)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_blobs_cross_between_packages(kv_dtype):
    rs = np.random.RandomState(9)
    covered = 21
    toks = rs.randint(1, V, covered).astype(np.int32)
    payload = [tuple(f[:2] for f in _arena_case(rs, 2, kv_dtype == "int8"))
               for _ in range(2)]
    spec = [[(str(f.dtype), f.shape[1:]) for f in layer] for layer in payload]
    ref_blob = rwire.serialize_chain(toks, covered, BS, payload)
    port_blob = pwire.serialize_chain(
        toks, covered, BS,
        [tuple(torch.from_numpy(f) for f in layer) for layer in payload])
    assert port_blob == ref_blob
    for blob, read in ((ref_blob, pwire.deserialize_chain),
                       (port_blob, rwire.deserialize_chain)):
        doc = read(blob, expect_block_size=BS, expect_spec=spec)
        assert doc["covered"] == covered
        np.testing.assert_array_equal(doc["tokens"], toks)
        for got, want in zip(doc["payload"], payload):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_bits(g), _bits(w))
    bad = bytearray(port_blob)
    bad[-1] ^= 1
    with pytest.raises(pwire.KVTransferCorrupt):
        pwire.deserialize_chain(bytes(bad))
    with pytest.raises(pwire.KVTransferCorrupt):
        pwire.deserialize_chain(port_blob, expect_block_size=8)


# -- paged generation ---------------------------------------------------------
def test_paged_greedy_equals_reference_and_contiguous(pair, prompts):
    ref, net = pair
    want = rgen.PagedGenerationSession(ref, batch_capacity=4, max_length=64,
                                       block_size=BS).generate(
        prompts, max_new_tokens=8)
    sess = pgen.PagedGenerationSession(net, batch_capacity=4, max_length=64,
                                       block_size=BS)
    got = sess.generate(prompts, max_new_tokens=8)
    contiguous = pgen.GenerationSession(net, batch_capacity=4,
                                        max_length=64).generate(
        prompts, max_new_tokens=8)
    for w, g, c in zip(want, got, contiguous):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, c)
    # the fresh prefill route at the prompts' bucket, the decode chunk
    assert {k[0] for k in sess._cache.keys()} == {"pchunk0:16[16x16]",
                                                  "pchunk:1[16x16]"}


def test_paged_sampled_equals_contiguous(pair, prompts):
    _ref, net = pair
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.8, top_k=12,
              top_p=0.95, seeds=[7, 8, 9, 10])
    got = pgen.PagedGenerationSession(net, batch_capacity=4, max_length=64,
                                      block_size=BS).generate(prompts, **kw)
    want = pgen.GenerationSession(net, batch_capacity=4,
                                  max_length=64).generate(prompts, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_int8_greedy_equals_reference_int8(pair, prompts):
    ref, net = pair
    want = rgen.PagedGenerationSession(ref, batch_capacity=4, max_length=64,
                                       block_size=BS, kv_dtype="int8"
                                       ).generate(prompts, max_new_tokens=8)
    sess = pgen.PagedGenerationSession(net, batch_capacity=4, max_length=64,
                                       block_size=BS, kv_dtype="int8")
    got = sess.generate(prompts, max_new_tokens=8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert all(k[0].startswith("pchunk:") for k in sess._cache.keys())
    # per block and layer: int8 keys and values plus two fp32 scales per
    # token and head, against fp32 keys and values
    L = WIDTH["num_layers"]
    assert sess.arena_bytes_per_block() == L * (2 * BS * H * D
                                                + 2 * BS * H * 4)
    assert pgen.PagedGenerationSession(
        net, batch_capacity=1, max_length=64, block_size=BS
    ).arena_bytes_per_block() == L * 2 * BS * H * D * 4


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_speculative_k3_equals_k0(pair, sampled):
    _ref, net = pair
    sess = pgen.PagedGenerationSession(net, batch_capacity=4, max_length=64,
                                       block_size=BS)
    rep = [np.tile(np.int32([5, 6, 7]), 6), np.tile(np.int32([9, 4]), 8)]
    kw = dict(do_sample=True, temperature=0.9, top_k=12, top_p=0.95,
              seeds=[3, 4]) if sampled else {}
    want = sess.generate(rep, max_new_tokens=12, **kw)
    got = sess.generate(rep, max_new_tokens=12, speculative_k=3, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert ("pverify:4[16x16]", 4, 64, sess._serial) in sess._cache.keys()


def test_offset_chunk_equals_fresh_prefill(pair, prompts):
    """A prompt fed in two chunks (the second at start > 0, the masked
    route) samples the token a one-chunk prefill samples, and leaves the
    same keys and values."""
    _ref, net = pair
    p = prompts[2]                                  # 13 tokens
    sess = pgen.PagedGenerationSession(net, batch_capacity=1, max_length=64,
                                       block_size=BS)
    arenas = sess.init_arenas()
    table = sess.identity_table()
    knobs = (np.zeros(1, np.int64), np.zeros(1, np.float32),
             np.zeros(1, np.int32), np.ones(1, np.float32))
    ids = np.zeros((1, 16), np.int32)
    ids[0, :13] = p
    one, _ = sess.prefill(arenas, table, ids, np.zeros(1, np.int32),
                          np.array([13], np.int32), *knobs)
    snap = [(a.k[:1].clone(), a.v[:1].clone()) for a in arenas]
    sess.init_arenas()
    ids5 = np.zeros((1, 8), np.int32)
    ids5[0, :5] = p[:5]
    sess.prefill(arenas, table, ids5, np.zeros(1, np.int32),
                 np.array([5], np.int32), *knobs)
    ids8 = np.zeros((1, 8), np.int32)
    ids8[0] = p[5:]
    two, _ = sess.prefill(arenas, table, ids8, np.array([5], np.int32),
                          np.array([8], np.int32), *knobs)
    assert int(two[0]) == int(one[0])
    for a, (k, v) in zip(arenas, snap):
        torch.testing.assert_close(a.k[:1, :13], k[:, :13], rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(a.v[:1, :13], v[:, :13], rtol=0,
                                   atol=1e-5)
    assert {k[0] for k in sess._cache.keys()} == {"pchunk0:16[4x16]",
                                                  "pchunk0:8[4x16]",
                                                  "pchunk:8[4x16]"}
