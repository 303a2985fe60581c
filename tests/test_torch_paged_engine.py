"""paddle_tpu_torch's PagedGenerationEngine: block lifecycle, prefix hits,
typed sheds, preemption to host memory, priority order, speculative
decoding and the prefix-chain export and import.

The scenarios follow the reference's ``tests/test_paged_kv.py`` and
``tests/test_slo_serving.py`` on the same model (V 97, D 32, L 2, H 2,
T 64, block 16), whose weights are carried across from the reference's
with ``gpt_state_from_paddle_tpu``; greedy streams are held to the
reference's token for token, and every stream to the port's contiguous
engine or to its own run without pressure.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.generation import PagedGenerationSession as RefPagedSession
from paddle_tpu.generation import kv_wire as rwire
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

import paddle_tpu_torch
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.profiler import flight, metrics
from paddle_tpu_torch.serving import (DeadlineExceeded, GenerationEngine,
                                      GenerationEngineConfig,
                                      PagedGenerationEngine, RequestRejected)
from paddle_tpu_torch.serving.engine import _GenRequest
from paddle_tpu_torch.utils import chaos

WIDTH = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64, ffn_mult=2)
V, BS = 97, 16


def val(name):
    m = metrics.get(name)
    return m.value if m is not None else 0


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
    return [rs.randint(1, V, n).astype(np.int32)
            for n in (5, 9, 13, 7, 21, 4)]


def paged_engine(net, name, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_length", 64)
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("block_size", BS)
    kw.setdefault("prefix_cache_blocks", 0)
    return PagedGenerationEngine(net, GenerationEngineConfig(name=name, **kw))


def all_free(eng):
    return eng.pool.available == eng.pool.num_blocks


# -- streams -------------------------------------------------------------------
def test_engine_greedy_equals_reference_and_contiguous(pair, prompts):
    ref, net = pair
    want = []
    for i in range(0, len(prompts), 4):
        want += RefPagedSession(ref, batch_capacity=4, max_length=64,
                                block_size=BS).generate(
            prompts[i:i + 4], max_new_tokens=8)
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=4, max_length=64, max_new_tokens=8,
            name="tpe_c")) as ceng:
        contiguous = [ceng.generate(p, timeout=120) for p in prompts]
    with paged_engine(net, "tpe_p") as eng:
        streams = [eng.submit(p) for p in prompts]
        got = [s.result(timeout=120) for s in streams]
    for w, c, g in zip(want, contiguous, got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, c)
    assert all_free(eng)


def test_engine_sampled_equals_contiguous(pair, prompts):
    _ref, net = pair
    kw = [dict(do_sample=True, temperature=0.8, top_p=0.95, top_k=20,
               seed=100 + i) for i in range(len(prompts))]
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=4, max_length=64, max_new_tokens=8,
            name="tpe_cs")) as ceng:
        want = [ceng.generate(p, timeout=120, **k)
                for p, k in zip(prompts, kw)]
    with paged_engine(net, "tpe_ps", warmup=True) as eng:
        streams = [eng.submit(p, **k) for p, k in zip(prompts, kw)]
        got = [s.result(timeout=120) for s in streams]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # warmup: the fresh route at every bucket (8, 16, 32, 64) and decode
    assert eng.warmed_buckets == 5
    assert eng.session._cache.compiles == 5


def test_pool_all_free_after_mixed_retirement(pair, prompts):
    """finish + eos + cancel + close: the pool drains to all free (the
    prefix cache cleared at close)."""
    _ref, net = pair
    with paged_engine(net, "tpe_leak", prefix_cache_blocks=4) as eng:
        eng.generate(prompts[0], max_new_tokens=6, timeout=120)
        eos = int(eng.generate(prompts[1], max_new_tokens=1, timeout=120)[0])
        out = eng.generate(prompts[1], max_new_tokens=4, timeout=120,
                           eos_token_id=eos)
        assert list(out) == [eos]
        s = eng.submit(prompts[2], max_new_tokens=8)
        next(iter(s))
        s.cancel()
        s.result(timeout=120)
        assert len(eng.prefix_cache) > 0
        bd = eng.memory_breakdown()
        assert bd["mem_prefix_cache_bytes"] == \
            len(eng.prefix_cache) * eng.pool.block_bytes
        assert bd["mem_kv_arena_bytes"] == \
            (eng.pool.num_blocks + 1) * eng.pool.block_bytes
    assert all_free(eng)
    assert len(eng.prefix_cache) == 0


def test_prefix_hits_skip_prefill(pair):
    _ref, net = pair
    sys_prompt = np.tile(np.int32([11, 12, 13, 14]), 5)       # 20 tokens
    mk = lambda tail: np.concatenate([sys_prompt, np.int32(tail)])  # noqa
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=4, max_length=64, max_new_tokens=6,
            name="tpe_hits_c")) as ceng:
        want = [ceng.generate(mk(t), timeout=120)
                for t in ([21, 22], [31, 32], [21, 22])]
    with paged_engine(net, "tpe_hits", prefix_cache_blocks=8,
                      max_new_tokens=6) as eng:
        fed, prefill = [], eng.session.prefill

        def counting(arenas, table, ids, starts, feed, *a, **k):
            fed.append(int(np.sum(feed)))
            return prefill(arenas, table, ids, starts, feed, *a, **k)
        eng.session.prefill = counting
        first = eng.generate(mk([21, 22]), timeout=120)
        assert val("tpe_hits.prefix_cache.hit") == 0
        second = eng.generate(mk([31, 32]), timeout=120)
        assert val("tpe_hits.prefix_cache.hit") == 1
        assert val("tpe_hits.prefix_cache.hit_tokens") >= BS
        again = eng.generate(mk([21, 22]), timeout=120)
        # the whole 22-token prompt is cached: it feeds its last token
        # into a copy of the tail block (copy-on-write)
        assert val("tpe_hits.prefix_cache.hit") == 2
        assert eng.session.blocks_copied == 1
        # prefill fed the whole prompt, the suffix past the shared full
        # block, and the repeat's last token
        assert fed == [22, 6, 1]
        keys = {k[0] for k in eng.session._cache.keys()}
        assert "pchunk:8[16x16]" in keys           # the offset route ran
    for w, g in zip(want, (first, second, again)):
        np.testing.assert_array_equal(g, w)
    assert all_free(eng)


# -- typed sheds --------------------------------------------------------------
def test_chaos_shed_is_typed_and_leak_free(pair, prompts):
    _ref, net = pair
    with paged_engine(net, "tpe_chaos") as eng:
        ref = eng.generate(prompts[0], max_new_tokens=6, timeout=120)
        chaos.configure("kv.block_alloc:fail@1")
        try:
            with pytest.raises(RequestRejected) as ei:
                eng.generate(prompts[1], max_new_tokens=6, timeout=120)
            assert ei.value.reason == "kv_blocks"
        finally:
            chaos.configure("")
        got = eng.generate(prompts[0], max_new_tokens=6, timeout=120)
        np.testing.assert_array_equal(got, ref)
        assert val("tpe_chaos.request.shed_kv_blocks") == 1
        assert val("tpe_chaos.kv.alloc_exhausted") == 1
        assert eng.stats()["shed_kv_blocks"] == 1
    assert all_free(eng)


def test_organic_exhaustion_sheds_not_corrupts(pair):
    _ref, net = pair
    long_p = np.tile(np.int32([3, 4, 5]), 9)                # 27 tokens
    with paged_engine(net, "tpe_solo", max_slots=2) as eng:
        solo = eng.generate(long_p, max_new_tokens=20, timeout=120)
    with paged_engine(net, "tpe_tiny", max_slots=2, num_blocks=3) as eng:
        s1 = eng.submit(long_p, max_new_tokens=20)        # grows to 3
        shed = 0
        for _ in range(4):
            try:
                eng.generate(long_p + 1, max_new_tokens=20, timeout=120)
            except RequestRejected as e:
                assert e.reason == "kv_blocks"
                shed += 1
        np.testing.assert_array_equal(s1.result(timeout=120), solo)
        assert shed >= 1
    assert all_free(eng)


# -- preemption to host memory -----------------------------------------------
def preempt_scenario(net, name, do_sample):
    """Request A (batch) on a 3-block pool, then an interactive request
    needing all 3 blocks: A is preempted and resumed.  Returns A's stream
    without pressure, A's stream with it, and the engine."""
    pA = np.arange(1, 9, dtype=np.int32)          # 1 block at prefill
    pB = np.arange(1, 41, dtype=np.int32)         # 3 blocks
    kwA = dict(max_new_tokens=30, do_sample=do_sample, seed=7)
    if do_sample:
        kwA.update(temperature=0.9, top_k=0, top_p=1.0)
    with paged_engine(net, f"{name}_ref", max_slots=2,
                      num_blocks=3) as ref_eng:
        ref = ref_eng.generate(pA, timeout=120, **kwA)
    flight.clear()
    with paged_engine(net, name, max_slots=2, num_blocks=3) as eng:
        sA = eng.submit(pA, priority="batch", tenant="bulk", **kwA)
        it = iter(sA)
        head = [next(it) for _ in range(3)]           # A is mid-decode
        outB = eng.submit(pB, max_new_tokens=4, priority="interactive",
                          tenant="live").result(timeout=120)
        outA = np.asarray(head + list(it), np.int32)
        assert len(outB) == 4
    return ref, outA, eng


@pytest.mark.parametrize("do_sample", [False, True],
                         ids=["greedy", "sampled"])
def test_preempt_resume_bit_exact(pair, do_sample):
    _ref, net = pair
    name = f"tpe_pre_{int(do_sample)}"
    ref, outA, eng = preempt_scenario(net, name, do_sample)
    np.testing.assert_array_equal(outA, ref)      # one seamless stream
    c = flight.counts()
    assert c.get("serve.preempt", 0) == 1        # the reference's counts
    assert c.get("serve.resume", 0) == 1
    assert val(f"{name}.request.preempted") == 1
    assert val(f"{name}.request.resumed") == 1
    assert val(f"{name}.requests_parked") == 0
    assert val(f"{name}.tenant.bulk.preempted") == 1
    assert val(f"{name}.tenant.live.completed") == 1
    (f,) = [f for _t, cat, ev, f in flight.events()
            if cat == "serve" and ev == "preempt"]
    assert f["tenant"] == "bulk" and f["priority"] == "batch"
    assert f["blocks"] == 1 and f["position"] >= 8
    (out_ms, out_bytes), = eng.session.swaps["out"]
    (in_ms, in_bytes), = eng.session.swaps["in"]
    assert out_bytes == in_bytes == eng.session.arena_bytes_per_block()
    assert all_free(eng)


def test_no_preempt_within_one_class(pair):
    _ref, net = pair
    pA = np.arange(1, 9, dtype=np.int32)
    pB = np.arange(1, 41, dtype=np.int32)
    flight.clear()
    with paged_engine(net, "tpe_peer", max_slots=2, num_blocks=3) as eng:
        sA = eng.submit(pA, max_new_tokens=30, priority="batch")
        it = iter(sA)
        for _ in range(3):
            next(it)
        with pytest.raises(RequestRejected) as ei:
            eng.submit(pB, max_new_tokens=4,
                       priority="batch").result(timeout=120)
        assert ei.value.reason == "kv_blocks"
        assert flight.counts().get("serve.preempt", 0) == 0
        list(it)                                   # A runs to its end
    assert all_free(eng)


def test_parked_deadline_sheds_deadline_preempted(pair):
    _ref, net = pair
    pA = np.arange(1, 9, dtype=np.int32)
    pB = np.arange(1, 41, dtype=np.int32)
    flight.clear()
    with paged_engine(net, "tpe_dead", max_slots=2, num_blocks=3) as eng:
        sA = eng.submit(pA, max_new_tokens=40, priority="batch",
                        deadline_ms=60_000.0)
        it = iter(sA)
        for _ in range(3):
            next(it)
        sB = eng.submit(pB, max_new_tokens=8, priority="interactive")
        sA._req.deadline = time.monotonic() - 1.0
        sB.result(timeout=120)
        with pytest.raises(DeadlineExceeded) as ei:
            sA.result(timeout=120)
        assert ei.value.reason == "deadline_preempted"
        c = flight.counts()
        assert c.get("serve.preempt", 0) == 1
        assert c.get("serve.resume", 0) == 0
        assert c.get("admission.deadline_preempted", 0) == 1
        assert val("tpe_dead.request.shed_deadline_preempted") == 1
        assert eng.stats()["shed_deadline_preempted"] == 1
    assert all_free(eng)


def test_preempt_chaos_sheds_the_victim(pair):
    _ref, net = pair
    pA = np.arange(1, 9, dtype=np.int32)
    pB = np.arange(1, 41, dtype=np.int32)
    with paged_engine(net, "tpe_pchaos", max_slots=2, num_blocks=3) as eng:
        sA = eng.submit(pA, max_new_tokens=30, priority="batch")
        it = iter(sA)
        next(it)
        chaos.configure("serve.preempt:fail@1")
        try:
            outB = eng.generate(pB, max_new_tokens=4,
                                priority="interactive", timeout=120)
        finally:
            chaos.configure("")
        assert len(outB) == 4
        with pytest.raises(RequestRejected) as ei:
            sA.result(timeout=120)
        assert ei.value.reason == "kv_blocks"
    assert all_free(eng)


# -- priority --------------------------------------------------------------
def test_priority_dequeue_order(pair):
    """With the one slot busy, batch, interactive and standard requests
    queue; they are admitted interactive, standard, batch."""
    _ref, net = pair
    p = np.arange(1, 6, dtype=np.int32)
    with paged_engine(net, "tpe_order", max_slots=1, aging_s=0.0) as eng:
        blocker = eng.submit(p + 3, max_new_tokens=50)
        next(iter(blocker))
        streams = [(eng.submit(p, max_new_tokens=2, priority="batch"),
                    "batch"),
                   (eng.submit(p + 1, max_new_tokens=2,
                               priority="interactive"), "interactive"),
                   (eng.submit(p + 2, max_new_tokens=2), "standard")]
        assert not blocker.done
        for s, _tag in streams:
            s.result(timeout=120)
    # the order of their first tokens, stamped on the scheduler thread
    order = [tag for s, tag in sorted(streams,
                                      key=lambda st: st[0]._req.t_first)]
    assert order == ["interactive", "standard", "batch"]


def test_priority_aging_order(pair):
    """Dequeue by effective class: a batch request that waited two aging
    periods outranks a fresh interactive one; ties go FIFO; aging 0 is
    strict."""
    _ref, net = pair
    eng = paged_engine(net, "tpe_aging", max_slots=1, aging_s=0.05)
    eng.close()
    now = time.monotonic()

    def req(rank, waited):
        r = _GenRequest(np.ones(2, np.int32), 1, 0.0, 0, 1.0, 0, None, None,
                        0, priority=rank)
        r.t_submit = now - waited
        return r
    old_batch, fresh_inter, standard = req(2, 0.15), req(0, 0.0), req(1, 0.0)
    eng._pending.extend([old_batch, standard, fresh_inter])
    assert eng._pop_pending() is old_batch         # aged to class 0, first
    assert eng._pop_pending() is fresh_inter
    assert eng._pop_pending() is standard
    eng._aging_s = 0.0
    eng._pending.extend([old_batch, standard, fresh_inter])
    assert [eng._pop_pending() for _ in range(3)] == [fresh_inter, standard,
                                                      old_batch]
    with pytest.raises(ValueError):
        eng.submit(np.ones(2, np.int32), priority="vip")


# -- speculative decoding ----------------------------------------------------
def test_speculative_engine_equals_plain(pair):
    _ref, net = pair
    rep = np.tile(np.int32([5, 6, 7]), 6)
    kws = [dict(), dict(do_sample=True, temperature=0.9, seed=3)]
    with paged_engine(net, "tpe_seng0") as base:
        want = [base.generate(rep, max_new_tokens=12, timeout=120, **k)
                for k in kws]
    with paged_engine(net, "tpe_seng", speculative_k=3, spec_ngram=2,
                      warmup=True) as eng:
        got = [eng.generate(rep, max_new_tokens=12, timeout=120, **k)
               for k in kws]
        assert val("tpe_seng.spec.proposed") > 0
        assert ("pverify:4[16x16]", 4, 64,
                eng.session._serial) in eng.session._cache.keys()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert all_free(eng)


def test_speculative_oracle_drafts_all_accepted(pair, monkeypatch):
    """An oracle drafter proposing the true continuation gets every draft
    accepted, and the stream stays the plain one in fewer steps."""
    _ref, net = pair
    from paddle_tpu_torch.generation import speculative
    rep = np.tile(np.int32([5, 6, 7]), 6)
    with paged_engine(net, "tpe_oracle0") as base:
        want = base.generate(rep, max_new_tokens=12, timeout=120)
    truth = want.tolist()

    def oracle(context, k, ngram=2):
        done = int(np.asarray(context).size) - rep.size
        return truth[done:done + int(k)]
    monkeypatch.setattr(speculative, "propose_drafts", oracle)
    with paged_engine(net, "tpe_oracle", speculative_k=3) as eng:
        got = eng.generate(rep, max_new_tokens=12, timeout=120)
        assert val("tpe_oracle.spec.proposed") > 0
        assert val("tpe_oracle.spec.accepted") == \
            val("tpe_oracle.spec.proposed")
        assert metrics.get("tpe_oracle.spec.accept_rate").value == 1.0
        assert eng.session.steps["decode"] < len(want) - 1
    np.testing.assert_array_equal(got, want)
    assert all_free(eng)


# -- prefix-chain export and import -----------------------------------------
def _chain_bytes(eng, blocks):
    return [[f[torch.as_tensor(blocks)].clone() for f in a]
            for a in eng._arenas]


def test_export_import_bit_for_bit(pair):
    _ref, net = pair
    prompt = np.random.RandomState(4).randint(1, V, 37).astype(np.int32)
    with paged_engine(net, "tpe_exp", prefix_cache_blocks=8) as a:
        want = a.generate(prompt, max_new_tokens=6, timeout=120)
        chain, covered = a.prefix_cache.lookup(prompt)
        src = _chain_bytes(a, chain)
        a.pool.decref(chain)
        blob = a.export_prefix_chain(prompt)
        assert a.export_prefix_chain(prompt[::-1].copy()) is None
    assert covered == 37 and all_free(a)
    doc = rwire.deserialize_chain(blob)           # the reference reads it
    assert doc["covered"] == 37
    with paged_engine(net, "tpe_imp", prefix_cache_blocks=8) as b:
        assert b.import_prefix_chain(blob) == 37
        chain, covered = b.prefix_cache.lookup(prompt)
        for x, y in zip(_chain_bytes(b, chain), src):
            for f, g in zip(x, y):
                assert torch.equal(f, g)
        b.pool.decref(chain)
        got = b.generate(prompt, max_new_tokens=6, timeout=120)
        assert val("tpe_imp.prefix_cache.hit") == 2
        with pytest.raises(pgen.KVTransferCorrupt):
            b.import_prefix_chain(blob[:-1])
    np.testing.assert_array_equal(got, want)
    assert all_free(b)


def test_import_of_a_reference_blob(pair):
    """A chain the reference filled and serialized enters the port's pool:
    the arena holds its bytes, and a prompt over it hits and streams as a
    cold run does."""
    ref, net = pair
    prompt = np.random.RandomState(6).randint(1, V, 20).astype(np.int32)
    rs = RefPagedSession(ref, batch_capacity=1, max_length=64,
                         block_size=BS)
    arenas = rs.init_arenas()
    table = rs.identity_table()
    ids = np.zeros((1, 32), np.int32)
    ids[0, :20] = prompt
    zeros = np.zeros(1, np.int32)
    _tok, arenas = rs.prefill(arenas, table, ids, zeros,
                              np.array([20], np.int32),
                              np.zeros((1, 2), np.uint32),
                              np.zeros(1, np.float32), zeros,
                              np.ones(1, np.float32))
    payload = rs.swap_out_blocks(arenas, [0, 1])
    blob = rwire.serialize_chain(prompt, 20, BS, payload)
    with paged_engine(net, "tpe_rimp", prefix_cache_blocks=8) as eng:
        cold = eng.generate(np.concatenate([prompt, [5, 6]]),
                            max_new_tokens=6, timeout=120)
        eng.prefix_cache.clear()
        assert eng.import_prefix_chain(blob) == 20
        chain, covered = eng.prefix_cache.lookup(prompt)
        assert covered == 20
        for a, fields in zip(eng._arenas, payload):
            for f, h in zip(a, fields):
                np.testing.assert_array_equal(
                    f[torch.as_tensor(chain)].numpy().view(np.int32),
                    np.asarray(h).view(np.int32))
        eng.pool.decref(chain)
        hot = eng.generate(np.concatenate([prompt, [5, 6]]),
                           max_new_tokens=6, timeout=120)
    np.testing.assert_array_equal(hot, cold)
    assert all_free(eng)


# -- configuration -----------------------------------------------------------
def test_config_defaults_read_the_flags():
    names = ("FLAGS_serving_queue_depth", "FLAGS_kv_cache_dtype",
             "FLAGS_prefix_cache_blocks", "FLAGS_speculative_k")
    saved = paddle_tpu_torch.get_flags(list(names))
    try:
        paddle_tpu_torch.set_flags({"FLAGS_serving_queue_depth": 3,
                                    "FLAGS_kv_cache_dtype": "int8",
                                    "FLAGS_prefix_cache_blocks": 12,
                                    "FLAGS_speculative_k": 2})
        cfg = GenerationEngineConfig()
        assert (cfg.max_queue, cfg.kv_cache_dtype, cfg.prefix_cache_blocks,
                cfg.speculative_k) == (3, "int8", 12, 2)
        assert GenerationEngineConfig(max_queue=7).max_queue == 7
    finally:
        paddle_tpu_torch.set_flags(saved)
    assert GenerationEngineConfig().max_queue == saved[names[0]]


def test_queue_depth_flag_bounds_admission(pair):
    _ref, net = pair
    saved = paddle_tpu_torch.get_flags(["FLAGS_serving_queue_depth"])
    paddle_tpu_torch.set_flags({"FLAGS_serving_queue_depth": 1})
    try:
        eng = paged_engine(net, "tpe_depth", max_slots=1)
    finally:
        paddle_tpu_torch.set_flags(saved)
    try:
        blocker = eng.submit(np.arange(1, 6, dtype=np.int32),
                             max_new_tokens=50)
        next(iter(blocker))
        queued = eng.submit(np.arange(1, 4, dtype=np.int32),
                            max_new_tokens=2)
        with pytest.raises(RequestRejected) as ei:
            eng.submit(np.arange(1, 4, dtype=np.int32), max_new_tokens=2)
        assert ei.value.reason == "queue_full"
        queued.result(timeout=120)
    finally:
        eng.close()
