"""The port's observability layer against the reference's: request tracing
(profiler/rtrace.py), the host tracer (profiler/tracer.py), the metrics
registry's Prometheus text, and device-memory accounting
(profiler/memscope.py), following the reference's
tests/test_observability.py and tests/test_memscope.py.

The same headers parse to the same trace identities in both packages, the
same observations give the same histogram buckets and Prometheus text,
and tracing and memory accounting cost one predicate when they are off.
On the CPU the allocator reads give nothing, as the reference's device
reads do on its CPU backend; tags, ``tree_nbytes``, the compile ledger,
the OOM dump and goodput still count.
"""
import json
import os

import numpy as np
import pytest

from paddle_tpu.profiler import metrics as rmetrics
from paddle_tpu.profiler import memscope as rmemscope
from paddle_tpu.profiler import rtrace as rrtrace

from paddle_tpu_torch import set_flags
from paddle_tpu_torch.generation import (BlockPool, BlockPoolExhausted,
                                         GenerationSession)
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.profiler import flight, memscope, metrics, rtrace, tracer
from paddle_tpu_torch.serving import (GenerationEngine,
                                      GenerationEngineConfig,
                                      PagedGenerationEngine)

WIDTH = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64)


@pytest.fixture(scope="module")
def net():
    return GPT(GPTConfig(**WIDTH), device="cpu", seed=0)


@pytest.fixture()
def scoped():
    """Memory accounting armed over clean state; disarmed after."""
    memscope.reset()
    memscope.enable()
    yield
    memscope.disable()
    memscope.reset()


def _engine(net, name, **kw):
    kw = dict(dict(max_slots=2, max_new_tokens=4, name=name), **kw)
    return GenerationEngine(net, GenerationEngineConfig(**kw))


# ---------------------------------------------------------------------------
# traceparent: the same identities as the reference's
# ---------------------------------------------------------------------------
TID, SID = "ab" * 16, "12" * 8
HEADERS = [f"00-{TID}-{SID}-01", f"00-{TID.upper()}-{SID}-00",
           f" 00-{TID}-{SID}-01 ", None, "", "garbage",
           f"00-{'0' * 32}-{SID}-01", f"00-{TID}-{'0' * 16}-01",
           f"ff-{TID}-{SID}-01", f"00-{TID[:-2]}-{SID}-01",
           f"01-{'cd' * 16}-{'34' * 8}-03"]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_and_echo_equal_the_reference(header):
    assert rtrace.parse_traceparent(header) == \
        rrtrace.parse_traceparent(header)
    got = rtrace.TraceContext.from_headers(header, request_id="r")
    want = rrtrace.TraceContext.from_headers(header, request_id="r")
    assert len(got.trace_id) == 32 and got.request_id == "r"
    assert got.parent_id == want.parent_id
    if want.parent_id is not None:         # the caller's trace continues
        assert got.trace_id == want.trace_id
        echoed = got.traceparent()
        assert echoed == f"00-{got.trace_id}-{got.root}-01"
        assert rtrace.parse_traceparent(echoed) == (got.trace_id, got.root)


def test_spans_parent_to_the_root_and_batch_spans_link_members():
    tracer.clear()
    rtrace.enable()
    try:
        a = rtrace.TraceContext.from_headers(f"00-{TID}-{SID}-01", "a")
        b = rtrace.TraceContext(request_id="b")
        t0 = tracer.now_ns()
        bid = rtrace.batch_span("batch::decode", t0, t0 + 5, [a, b],
                                occupancy=2)
        a.record("decode", t0, t0 + 5, batch_span=bid)
        a.record("ingress", t0 - 1, t0 + 9, parent=None, span_id=a.root)
    finally:
        rtrace.disable()
    spans = rtrace.request_spans(trace_id=TID)
    assert [s["name"] for s in spans] == ["ingress", "decode"]
    assert spans[0]["parent_id"] == SID and spans[0]["span_id"] == a.root
    assert spans[1]["parent_id"] == a.root and spans[1]["batch_span"] == bid
    batch = [e[5] for e in tracer.events() if e[0] == "batch::decode"][0]
    assert batch["members"] == 2 and batch["span_id"] == bid
    assert {ln["trace_id"] for ln in batch["links"]} == {TID, b.trace_id}
    tracer.clear()


def test_tracer_exports_and_summarizes(tmp_path):
    tracer.clear()
    tracer.record("serve::x.decode", 0, 2000, cat="serving")
    tracer.record("serve::x.decode", 10, 1010, cat="serving")
    s = tracer.summarize()["serve::x.decode"]
    assert s["calls"] == 2 and s["max_ns"] == 2000 and s["avg_ns"] == 1500
    path = tracer.export_chrome_tracing(str(tmp_path / "t.json"))
    doc = json.loads(open(path).read())
    assert [e["dur"] for e in doc["traceEvents"]] == [2.0, 1.0]
    tracer.clear()
    # eager_phase_profile is ported on the eager core's op:: spans
    # (tests/test_torch_dispatch.py holds its phases to the reference's)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import place
    was = place._place
    pt.set_device("cpu")
    try:
        net = pt.nn.Linear(4, 3)
        opt = pt.optimizer.SGD(0.1, parameters=net.parameters())
        model = pt.Model(net).prepare(opt, pt.nn.CrossEntropyLoss(),
                                      jit=False)
        table, shares, wall = tracer.eager_phase_profile(
            model, opt, np.ones((2, 4), np.float32),
            np.zeros((2, 1), np.int64), net.weight)
    finally:
        place._place = was
    assert table["linear"]["phase"] == "matmul" and wall > 0
    assert abs(sum(s["time_frac"] for s in shares.values()) - 1) < 1e-9
    assert not tracer.is_enabled() and not tracer.events()


def test_tracing_and_accounting_off_cost_one_predicate(net):
    """Off, a served request leaves no rtrace span, no serving span, no
    memscope gauge and no ledger entry."""
    assert not rtrace.active and not tracer.active and not memscope.active
    tracer.clear()
    memscope.reset()
    names0 = set(metrics.snapshot())
    with _engine(net, "obs_off") as eng:
        eng.generate([3, 5, 7], max_new_tokens=3, timeout=120,
                     trace_ctx=rtrace.TraceContext(request_id="off"))
    assert tracer.events() == []
    fresh = set(metrics.snapshot()) - names0
    assert [n for n in fresh if n.startswith("mem.")] == []
    assert memscope.compile_count() == 0
    assert memscope.tag_bytes().get("params", 0) == 0


def test_serving_phases_are_host_spans_when_the_tracer_is_on(net):
    tracer.clear()
    tracer.enable()
    try:
        with _engine(net, "obs_span") as eng:
            eng.generate([3, 5, 7], max_new_tokens=3, timeout=120)
    finally:
        tracer.disable()
    names = [e[0] for e in tracer.events() if e[4] == "serving"]
    assert names.count("serve::obs_span.prefill") == 1
    assert names.count("serve::obs_span.decode") == 2
    tracer.clear()


# ---------------------------------------------------------------------------
# the registry: histogram buckets and Prometheus text equal the reference's
# ---------------------------------------------------------------------------
OBS = (0.3, 3.0, 40.0, 99.0, 1e6, 2.0, 80.0, 0.0, 5.0)


def test_histogram_buckets_equal_the_reference():
    got, want = metrics.Histogram("obs_lat_ms"), rmetrics.Histogram("obs_lat_ms")
    for v in OBS:
        got.observe(v)
        want.observe(v)
    assert got.bucket_counts() == want.bucket_counts()
    assert got.bucket_counts()[-1] == ("+Inf", len(OBS))
    assert got.snapshot() == want.snapshot()


def test_prometheus_text_equals_the_reference():
    texts = []
    for mod in (metrics, rmetrics):
        reg = mod.Registry()
        h = reg.histogram("obs_req_ms", "request latency")
        for v in OBS:
            h.observe(v)
        reg.counter("obs.total", "a counter").inc(3)
        reg.gauge("obs-depth").set(2.5)
        texts.append(reg.to_prometheus())
    assert texts[0] == texts[1]
    assert 'obs_req_ms_bucket{le="+Inf"} 9' in texts[0]
    assert "# TYPE obs_total counter" in texts[0]


# ---------------------------------------------------------------------------
# memscope: tags, tree_nbytes, watermarks, the ledger, OOM, goodput
# ---------------------------------------------------------------------------
def test_tags_and_tree_nbytes(scoped):
    import torch
    t = torch.ones(4, 8)
    assert memscope.tree_nbytes({"w": t, "b": [t[0], (t, None)]}) == \
        (32 + 8 + 32) * 4
    assert memscope.tree_nbytes(np.ones((3, 2), np.float16)) == 12
    assert memscope.tree_nbytes([]) == 0
    memscope.set_tag_bytes("params", 1000)
    assert memscope.add_tag_bytes("params", -400) == 600
    assert metrics.get("mem.live_bytes.params").value == 600
    tags = memscope.tag_bytes()
    assert tags["params"] == 600 and tags["activations"] == 0
    # the CPU has no allocator to read: nothing, as the reference's
    # device reads give nothing on its CPU backend
    assert memscope.live_bytes() == 0 and memscope.device_stats() == {}
    c = memscope.census()
    assert c["live_bytes_total"] == 0 and c["tags"]["params"] == 600


def test_phase_watermarks(scoped, monkeypatch):
    samples = iter([300, 1200, 700])
    monkeypatch.setattr(memscope, "live_bytes", lambda: next(samples))
    assert [memscope.on_phase("s.decode") for _ in range(3)] == \
        [300, 1200, 700]
    assert memscope.phase_peaks() == {"s.decode": 1200}
    assert metrics.get("mem.peak_bytes.s.decode").value == 1200
    monkeypatch.setattr(memscope, "live_bytes", lambda: 0)
    assert memscope.peak_bytes() == 1200


def test_is_oom_matching_equals_the_reference():
    import torch
    from paddle_tpu.generation import BlockPoolExhausted as RefExhausted
    cases = [RuntimeError("RESOURCE_EXHAUSTED: ..."),
             RuntimeError("XLA: Out of memory while..."),
             RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
             ValueError("shape mismatch"), RuntimeError("deadline"), None]
    for exc in cases:
        assert memscope.is_oom(exc) == rmemscope.is_oom(exc)
    assert memscope.is_oom(BlockPoolExhausted("need 3, have 1"))
    assert rmemscope.is_oom(RefExhausted("need 3, have 1"))
    assert memscope.is_oom(torch.cuda.OutOfMemoryError("no room"))


def test_oom_dump_artifact_and_latch(scoped, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_RESTART_GENERATION", "0")
    monkeypatch.delenv("PADDLE_OOM_DUMP_EVERY", raising=False)
    flight.clear()
    pool = BlockPool(4, 16, name="memtest")
    pool.block_bytes = 1024
    held = pool.alloc(3)
    memscope.set_tag_bytes("kv_arena", 4 * 1024)
    doc = memscope.oom_dump(BlockPoolExhausted("need 2, have 1"),
                            context="test_seam", pool=pool)
    path = os.path.join(str(tmp_path), "oom.r0.g0.json")
    assert doc["path"] == path and doc["context"] == "test_seam"
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk["census"]["tags"]["kv_arena"] == 4 * 1024
    assert on_disk["pool"] == {"num_blocks": 4, "block_size": 16,
                               "block_bytes": 1024, "used": 3,
                               "available": 1, "arena_bytes": 4096}
    assert any(e["cat"] == "mem" and e["event"] == "oom"
               for e in on_disk["flight"]["events"])
    # one artifact per seam; the flight event still fires
    assert memscope.oom_dump(BlockPoolExhausted("again"),
                             context="test_seam", pool=pool) is None
    assert flight.counts().get("mem.oom", 0) == 2
    pool.decref(held)
    flight.clear()


def test_compile_ledger_causes(scoped):
    memscope.compile_record("site_a", "f32[8,16]", 0.5)
    memscope.compile_record("site_a", "f32[8,32]", 0.4)
    memscope.compile_record("site_a", "f32[8,16]", 0.3)
    entries = memscope.compile_entries()
    assert [e["cause"] for e in entries] == \
        ["new-site", "new-bucket", "retrace"]
    assert entries[1]["nearest"] == "f32[8,16]"
    assert memscope.compile_seconds() == pytest.approx(1.2, abs=1e-6)
    old = memscope._flags.get_flag("FLAGS_check_nan_inf")
    try:
        set_flags({"FLAGS_check_nan_inf": not old})
        memscope.compile_record("site_a", "f32[4]", 0.1)
    finally:
        set_flags({"FLAGS_check_nan_inf": old})
    assert memscope.compile_entries()[-1]["cause"] == "flag-change"


def test_compile_ledger_records_step_graph_captures(net, scoped):
    """Each executable a session makes (a StepGraph: on the card, one
    capture) lands in the ledger with its site, key and wall time."""
    sess = GenerationSession(net, batch_capacity=2, name="ledger")
    sess.generate([[3, 5, 7], [4, 6]], max_new_tokens=3)
    sess.generate([[1] * 12], max_new_tokens=2)
    entries = [e for e in memscope.compile_entries()
               if e["site"] == "ledger"]
    assert [e["cause"] for e in entries] == \
        ["new-site", "new-bucket", "new-bucket"]
    assert "prefill:8" in entries[0]["signature"]
    assert "decode" in entries[1]["signature"]
    assert "prefill:16" in entries[2]["signature"]
    assert all(e["wall_ms"] > 0 for e in entries)
    assert len(entries) == sess._cache.compiles


def test_goodput_fractions_sum_to_one(scoped):
    import time
    gp = memscope.GoodputMeter("t").start()
    time.sleep(0.06)
    gp.add_s("data_wait", 0.005)
    gp.step_ns(int(40e6))
    memscope.compile_record("gp_site", "sig", 0.02)
    doc = gp.finish(export=True)
    fr = doc["fractions"]
    assert abs(sum(fr.values()) - 1.0) <= 0.01
    assert set(fr) >= {"data_wait", "compile", "productive", "other"}
    assert doc["compiles"] == 1
    assert doc["buckets_s"]["compile"] == pytest.approx(0.02, abs=1e-6)
    assert doc["productive_s"] == pytest.approx(0.02, abs=1e-3)
    assert metrics.get("t.goodput.productive").value == fr["productive"]


def test_engine_memory_tags_and_breakdown(net, scoped):
    params = sum(p.numel() for p in net.parameters()) * 4
    with _engine(net, "mem_dense") as eng:
        caches = sum(c.k.numel() + c.v.numel() for c in eng._caches) * 4
        assert caches == 2 * 2 * 2 * 64 * 32 * 4      # L, k/v, S, T, D
        tags = memscope.tag_bytes()
        assert tags["params"] == params and tags["kv_arena"] == caches
        mb = eng.memory_breakdown()
        assert mb["mem_params_bytes"] == params
        assert mb["mem_kv_arena_bytes"] == caches
        assert mb["mem_prefix_cache_bytes"] == 0
    eng = PagedGenerationEngine(net, GenerationEngineConfig(
        max_slots=2, max_length=64, max_new_tokens=2, block_size=16,
        prefix_cache_blocks=4, name="mem_paged"))
    try:
        arenas = sum(f.numel() * f.element_size()
                     for a in eng._arenas for f in a)
        assert memscope.tag_bytes()["kv_arena"] == arenas
        eng.generate([3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29,
                      31, 33, 35], max_new_tokens=2, timeout=120)
        mb = eng.memory_breakdown()
        assert mb["mem_kv_arena_bytes"] == arenas
        assert mb["mem_prefix_cache_bytes"] == \
            len(eng.prefix_cache) * eng.pool.block_bytes > 0
    finally:
        eng.close()


def test_flight_events_carry_the_ambient_request_id():
    flight.clear()
    rtrace.enable()
    try:
        rtrace.set_current(rtrace.TraceContext(request_id="req-mem-1"))
        try:
            flight.note("kv", "exhausted", need=3, free=1)
        finally:
            rtrace.set_current(None)
        flight.note("kv", "exhausted", need=1, free=0)
    finally:
        rtrace.disable()
    evs = [f for _t, cat, ev, f in flight.events()
           if cat == "kv" and ev == "exhausted"]
    assert evs[-2]["request_id"] == "req-mem-1"
    assert "request_id" not in (evs[-1] or {})
    flight.clear()
