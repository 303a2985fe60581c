"""The port's HTTP serving path against the reference's: the registry
metrics of the engines (the reference's tests/test_generation_serving.py
expectations), JSON and SSE streams equal to the reference engine's,
tenant quotas and Retry-After (tests/test_slo_serving.py), pause /
resume, swap_weights, request span chains (tests/test_observability.py)
and /healthz on the paged engine.

The model is the reference tests' (V 97, D 32, L 2, H 2, T 64) with its
weights carried across by ``gpt_state_from_paddle_tpu``; prompts come
from numpy with a seed.  Engines and the server are shared per module
where a test needs no engine of its own.
"""
import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as rserving
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig
from paddle_tpu.serving import admission as radm

from paddle_tpu_torch import set_flags
from paddle_tpu_torch.generation import GenerationSession
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.nn import torch_view
from paddle_tpu_torch.profiler import metrics, rtrace, tracer
from paddle_tpu_torch.serving import (DeadlineExceeded, EngineClosed,
                                      GenerationEngine,
                                      GenerationEngineConfig,
                                      PagedGenerationEngine,
                                      RequestRejected, ServingServer, serve,
                                      seq_buckets)
from paddle_tpu_torch.serving import admission as padm
from paddle_tpu_torch.utils import chaos
from paddle_tpu_torch.utils import concurrency as cc

WIDTH = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64)
V = WIDTH["vocab_size"]


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
    rs = np.random.RandomState(1)
    return [rs.randint(1, V, (n,)).astype(np.int32)
            for n in (3, 5, 7, 4, 6, 9)]


def make_engine(net, name, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_new_tokens", 8)
    return GenerationEngine(net, GenerationEngineConfig(name=name, **kw))


@pytest.fixture(scope="module")
def served(pair):
    """One engine behind one server for the tests that need nothing of
    their own."""
    _ref, net = pair
    eng = make_engine(net, "srv")
    srv = ServingServer(eng).start()
    yield eng, srv
    srv.stop()
    eng.close()


@pytest.fixture(scope="module")
def ref_greedy(pair, prompts):
    """The reference engine's greedy streams, 5 tokens per prompt."""
    ref, _net = pair
    eng = rserving.GenerationEngine(ref, rserving.GenerationEngineConfig(
        max_slots=4, max_new_tokens=8, name="ref_srv"))
    try:
        return [eng.generate(p, max_new_tokens=5, timeout=300).tolist()
                for p in prompts[:3]]
    finally:
        eng.close()


def _conn(srv):
    return http.client.HTTPConnection(srv.host, srv.port, timeout=120)


def _post(srv, body, headers=None, path="/v1/generate"):
    conn = _conn(srv)
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    conn.request("POST", path, body if isinstance(body, str)
                 else json.dumps(body), h)
    r = conn.getresponse()
    data = r.read().decode()
    conn.close()
    return r, data


def _events(data):
    return [json.loads(ln[6:]) for ln in data.split("\n")
            if ln.startswith("data: ")]


# ---------------------------------------------------------------------------
# fault C9: the reference's registry expectations
# ---------------------------------------------------------------------------
def test_completed_and_compiles_over_two_rounds(pair, prompts):
    """Two rounds of 6: 12 ``.request.completed``, compiles bounded by
    the bucket count (test_generation_serving.py:99-116)."""
    _ref, net = pair
    name = "gse_buckets"
    with make_engine(net, name, max_length=64) as eng:
        for _rep in range(2):
            for p in prompts:
                eng.generate(p, max_new_tokens=3, timeout=120)
        bound = len(seq_buckets(64, eng.config.prompt_bucket_min)) + 1
        assert val(f"{name}.compile") <= bound
        assert val(f"{name}.request.completed") == 2 * len(prompts)
        assert val(f"{name}.executable_cache.hit") == \
            eng.session._cache.hits
        stats = eng.stats()
    assert stats[f"{name}.request.completed"] == 12
    assert stats["completed"] == 12 and stats["admitted"] == 12


def test_ttft_and_inter_token_metrics(pair, prompts):
    _ref, net = pair
    name = "gse_metrics"
    with make_engine(net, name) as eng:
        eng.generate(prompts[0], max_new_tokens=5, timeout=120)
        assert eng.occupancy == 0 and eng.parked == 0
    assert metrics.get(f"{name}.ttft_ms").count == 1
    assert metrics.get(f"{name}.inter_token_ms").count == 4
    assert metrics.get(f"{name}.prefill").count == 1
    assert metrics.get(f"{name}.decode").count >= 4
    assert val(f"{name}.tokens_out") >= 5
    assert metrics.get(f"{name}.decode.occupancy").count == 4
    assert val(f"{name}.slots") == 4


# ---------------------------------------------------------------------------
# HTTP streams against the reference engine's
# ---------------------------------------------------------------------------
def test_http_json_and_sse_equal_the_reference_engine(served, prompts,
                                                      ref_greedy):
    eng, srv = served
    for p, want in zip(prompts[:3], ref_greedy):
        r, data = _post(srv, {"prompt_ids": p.tolist(),
                              "max_new_tokens": 5})
        assert r.status == 200 and json.loads(data)["tokens"] == want
        r, data = _post(srv, {"prompt_ids": p.tolist(),
                              "max_new_tokens": 5, "stream": True},
                        {"X-Request-Id": "sse-1"})
        assert r.status == 200
        assert "text/event-stream" in r.getheader("Content-Type")
        assert r.getheader("X-Request-Id") == "sse-1"
        events = _events(data)
        final = [e for e in events if e.get("done")][0]
        assert [e["token"] for e in events if "token" in e] == want
        assert final["tokens"] == want and final["request_id"] == "sse-1"
    # a sampled stream over HTTP equals the engine's own
    body = {"prompt_ids": prompts[0].tolist(), "max_new_tokens": 5,
            "do_sample": True, "temperature": 0.8, "seed": 42,
            "stream": True}
    r, data = _post(srv, body)
    want = eng.session.generate([prompts[0]], max_new_tokens=5,
                                do_sample=True, temperature=0.8,
                                seed=42)[0].tolist()
    assert [e["token"] for e in _events(data) if "token" in e] == want


def test_http_routes_and_errors(served):
    eng, srv = served
    conn = _conn(srv)
    conn.request("GET", "/healthz")
    h = json.loads(conn.getresponse().read())
    assert h["ready"] is True and h["decode_slots"] == eng.slots
    assert h["mem_kv_arena_bytes"] > 0 and "requests_parked" in h
    conn.request("GET", "/metrics")
    r = conn.getresponse()
    text = r.read().decode()
    assert r.getheader("Content-Type") == "text/plain; version=0.0.4"
    assert "srv_ttft_ms_bucket{le=" in text
    conn.close()
    r, data = _post(srv, "{}", {"X-Request-Id": "err-1"})
    assert r.status == 400 and json.loads(data)["request_id"] == "err-1"
    r, data = _post(srv, {"prompt_ids": [1, 2], "priority": "vip"})
    assert r.status == 400
    r, data = _post(srv, {"inputs": {"x": [1]}}, path="/v1/infer")
    assert r.status == 404
    assert json.loads(data)["error"] == (
        "no inference engine bound; this server only serves /v1/generate")
    r, data = _post(srv, {}, path="/admin/swap")
    assert r.status == 404 and "fleet admin" in json.loads(data)["error"]
    r, _ = _post(srv, {}, path="/nowhere")
    assert r.status == 404
    r, data = _post(srv, {"prompt_ids": [1] * 64})
    assert r.status == 429 and json.loads(data)["reason"] == "too_large"
    assert 1 <= int(r.getheader("Retry-After")) <= 30


def test_a_burst_of_connections_is_accepted(served):
    """64 clients connect at once: each connection is taken at once (a
    listen backlog of 5 drops SYNs that the client's kernel resends
    only after 1 s), and each is answered."""
    _eng, srv = served
    out = [None] * 64

    def client(i):
        conn = _conn(srv)
        t0 = time.perf_counter()
        conn.connect()
        connect_s = time.perf_counter() - t0
        conn.request("POST", "/v1/generate", json.dumps(
            {"prompt_ids": [3, 4 + i % 5], "max_new_tokens": 1}),
            {"Content-Type": "application/json"})
        r = conn.getresponse()
        r.read()
        conn.close()
        out[i] = (r.status, connect_s)
    ts = [threading.Thread(target=client, args=(i,)) for i in range(64)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert [o[0] for o in out] == [200] * 64
    assert max(o[1] for o in out) < 0.5


def test_body_over_the_cap_answers_413_unread(pair):
    _ref, net = pair
    with make_engine(net, "srv_cap") as eng:
        with ServingServer(eng, max_body_bytes=64) as srv:
            r, data = _post(srv, {"prompt_ids": list(range(1, 60))})
            assert r.status == 413
            assert json.loads(data)["reason"] == "body_too_large"


def test_deadline_over_http_answers_504(pair):
    _ref, net = pair
    with make_engine(net, "srv_504") as eng:
        eng.pause()
        with ServingServer(eng) as srv:
            out = {}
            t = threading.Thread(target=lambda: out.update(r=_post(
                srv, {"prompt_ids": [3, 4]}, {"X-Deadline-Ms": "1"})))
            t.start()
            while eng._admission.depth < 1:
                time.sleep(0.005)
            time.sleep(0.01)
            eng.resume()
            t.join(timeout=60)
        r, data = out["r"]
        assert r.status == 504 and json.loads(data)["reason"] == "deadline"


# ---------------------------------------------------------------------------
# admission: 429, Retry-After, tenants and priorities
# ---------------------------------------------------------------------------
def test_http_rejection_maps_to_429_with_retry_after(pair, prompts):
    _ref, net = pair
    with make_engine(net, "gse_http429", max_queue=1) as eng:
        eng.pause()
        parked = eng.submit(prompts[0], max_new_tokens=2)
        with ServingServer(eng) as srv:
            r, data = _post(srv, {"prompt_ids": prompts[0].tolist()})
            assert r.status == 429
            assert json.loads(data)["reason"] == "queue_full"
            assert 1 <= int(r.getheader("Retry-After")) <= 30
        eng.resume()
        assert len(parked.result(timeout=120)) == 2


def test_http_tenant_priority_and_retry_after(pair):
    """X-Tenant / X-Priority reach admission; a quota 429 answers
    Retry-After in [1, 30] with reason tenant_quota; another tenant is
    still served (test_slo_serving.py:378-414)."""
    _ref, net = pair
    eng = PagedGenerationEngine(net, GenerationEngineConfig(
        max_slots=4, max_length=64, max_new_tokens=8, block_size=16,
        num_blocks=8, name="tsp_http",
        tenant_quotas={"free": {"rate": 0.0, "burst": 10.0}}))
    srv = ServingServer(eng).start()
    try:
        def post(tenant, priority):
            return _post(srv, {"prompt_ids": [1, 2, 3], "max_new_tokens": 3},
                         {"X-Tenant": tenant, "X-Priority": priority})
        r, data = post("free", "interactive")
        assert r.status == 200 and len(json.loads(data)["tokens"]) == 3
        r, data = post("free", "interactive")
        assert r.status == 429 and json.loads(data)["reason"] == \
            "tenant_quota"
        assert 1 <= int(r.getheader("Retry-After")) <= 30
        assert val("tsp_http.tenant.free.admitted") == 1
        assert val("tsp_http.tenant.free.shed") == 1
        r, _data = post("paid", "batch")
        assert r.status == 200
        r, _data = post("free", "vip")
        assert r.status == 400
        eng.set_quotas({})                  # lifted without a restart
        r, _data = post("free", "standard")
        assert r.status == 200
        assert val("tsp_http.tenant.free.completed") == 2
        assert metrics.get("tsp_http.tenant.free.latency_ms").count == 2
    finally:
        srv.stop()
        eng.close()
    assert eng.pool.available == eng.pool.num_blocks


def _frozen_decisions(adm):
    """A scripted run of the quota table, the drain estimator and a
    quota-bound controller under one frozen clock: every decision."""
    now = [100.0]
    out = []
    t = adm.TenantQuotaTable({"acme": {"rate": 10.0, "burst": 30.0},
                              "*": {"rate": 1.0, "burst": 2.0}},
                             clock=lambda: now[0])
    for step, (who, n) in enumerate([("acme", 30), ("acme", 1), ("x", 2),
                                     ("x", 1), ("acme", 10), ("acme", 1),
                                     ("x", 1), ("acme", 25)]):
        out.append(t.try_acquire(who, n))
        out.append(round(t.level(who), 9))
        now[0] += (0.0, 1.0, 0.5, 0.0, 0.3, 2.0, 100.0, 0.0)[step]
    gen = t.generation
    with pytest.raises(ValueError):
        t.reload({"acme": {"rate": -1}})
    out.append(t.generation == gen)
    t.reload({"acme": {"rate": 5.0, "burst": 1.0}})
    out += [t.level("acme"), t.level("x"), t.try_acquire("x", 10 ** 6)]
    d = adm.DrainRateEstimator(window_s=30.0, clock=lambda: now[0])
    out += [d.retry_after_s(0), d.retry_after_s(5)]
    for _ in range(10):
        d.note()
        now[0] += 0.5
    out += [d.rate(), d.retry_after_s(4), d.retry_after_s(1000),
            d.retry_after_s(1)]
    now[0] += 100.0
    out.append(d.retry_after_s(5))
    ctl = adm.AdmissionController(
        8, name=f"frozen_{adm.__name__.split('.')[0]}",
        quotas=adm.TenantQuotaTable({"free": {"rate": 0.0, "burst": 4.0}},
                                    clock=lambda: now[0]))
    ctl.drain = adm.DrainRateEstimator(clock=lambda: now[0])
    ctl.acquire(tenant="free", priority="standard", quota_tokens=4)
    for _ in range(3):
        ctl.acquire(tenant="paid", priority="batch")
        now[0] += 0.25
        ctl.release()
    try:
        ctl.acquire(tenant="free", priority="standard", quota_tokens=4)
    except adm.RequestRejected as e:
        out += [e.reason, e.retry_after]
    return out


def test_quota_and_retry_after_decide_as_the_reference():
    got, want = _frozen_decisions(padm), _frozen_decisions(radm)
    assert got == want
    assert "tenant_quota" in got and all(
        1 <= x <= 30 for x in got[-1:])


def test_quota_watcher_hot_reload_as_the_reference(tmp_path):
    res = []
    for adm, tag in ((padm, "p"), (radm, "r")):
        ctl = adm.AdmissionController(8, name=f"tsp_watch_{tag}")
        path = tmp_path / f"quotas_{tag}.json"
        path.write_text(json.dumps({"t1": {"rate": 0.0, "burst": 2.0}}))
        w = adm.QuotaWatcher(str(path), ctl, interval=0.05)
        out = [w.poll_once(), ctl.quotas.limit_for("t1")["burst"]]
        path.write_text("{not json")
        with pytest.warns(RuntimeWarning):
            out.append(w.poll_once())
        out.append(ctl.quotas.limit_for("t1")["burst"])
        time.sleep(0.01)                     # a distinct mtime_ns
        path.write_text(json.dumps({"t1": {"rate": 9.0, "burst": 99.0}}))
        out += [w.poll_once(), ctl.quotas.limit_for("t1")["burst"],
                w.poll_once()]
        w.start()
        w.stop()
        res.append(out)
    assert res[0] == res[1] == [True, 2.0, False, 2.0, True, 99.0, False]


def test_serve_request_chaos_site_fails_submit(pair):
    _ref, net = pair
    with make_engine(net, "srv_chaos") as eng:
        chaos.configure("serve.request:fail@1", seed=0)
        try:
            with pytest.raises(chaos.ChaosError):
                eng.submit([3, 4])
        finally:
            chaos.reset()
        assert len(eng.generate([3, 4], max_new_tokens=2, timeout=60)) == 2


# ---------------------------------------------------------------------------
# lifecycle: pause / resume, swap_weights, stop, disconnects
# ---------------------------------------------------------------------------
def test_pause_resume_completes_every_admitted_request(pair, prompts):
    _ref, net = pair
    with make_engine(net, "gse_pause", max_queue=3) as eng:
        want = [eng.generate(p, max_new_tokens=4, timeout=120)
                for p in prompts[:3]]
        eng.pause()
        streams = [eng.submit(p, max_new_tokens=4) for p in prompts[:3]]
        with pytest.raises(RequestRejected) as ei:
            eng.submit(prompts[3], max_new_tokens=4)
        assert ei.value.reason == "queue_full"
        assert 1 <= ei.value.retry_after <= 30
        time.sleep(0.05)
        assert not any(s.done for s in streams)
        eng.resume()
        for s, w in zip(streams, want):
            np.testing.assert_array_equal(s.result(timeout=120), w)


def test_swap_weights_mid_traffic_and_a_bad_tree(prompts):
    net = GPT(GPTConfig(**WIDTH), device="cpu", seed=3)
    other = GPT(GPTConfig(**WIDTH), device="cpu", seed=4)
    # the Layer's own state_dict (Tensors) is a swap tree as it is
    first = {k: v.clone() for k, v in torch_view(net).state_dict().items()}
    second = {k: v.clone() for k, v in other.state_dict().items()}
    want_second = GenerationSession(other, batch_capacity=4).generate(
        [prompts[1]], max_new_tokens=6)[0]
    with make_engine(net, "srv_swap") as eng:
        want_first = eng.generate(prompts[1], max_new_tokens=6, timeout=60)
        long = eng.submit(prompts[0], max_new_tokens=40)
        it = iter(long)
        head = [next(it) for _ in range(3)]
        eng.swap_weights(second)
        tail = list(it)                   # straddles the swap, not dropped
        assert len(head + tail) == 40 and long.finish_reason == \
            "max_new_tokens"
        np.testing.assert_array_equal(
            eng.generate(prompts[1], max_new_tokens=6, timeout=60),
            want_second)
        eng.swap_weights({k: v.numpy() for k, v in first.items()})
        np.testing.assert_array_equal(
            eng.generate(prompts[1], max_new_tokens=6, timeout=60),
            want_first)
        before = {k: v.clone()
                  for k, v in torch_view(net).state_dict().items()}
        bad = dict(second, **{"wte.weight": second["wte.weight"][:, :16]})
        with pytest.raises(ValueError, match="a shape/dtype change"):
            eng.swap_weights(bad)
        missing = {k: v for k, v in second.items() if k != "wte.weight"}
        with pytest.raises(ValueError, match="tree mismatch"):
            eng.swap_weights(missing)
        with pytest.raises(ValueError, match="a shape/dtype change"):
            eng.swap_weights(dict(
                second, **{"wte.weight": first["wte.weight"].double()}))
        assert all(torch.equal(before[k], v)
                   for k, v in torch_view(net).state_dict().items())
        assert eng.session._cache.compiles == len(eng.session._cache)
        assert val("srv_swap.weight_swaps") == 2
    with pytest.raises(EngineClosed):
        eng.swap_weights(first)


def test_client_disconnect_mid_sse_cancels(pair):
    _ref, net = pair
    eng = make_engine(net, "srv_gone", max_slots=2)
    slow = eng.session.decode

    def decode(*a, **kw):
        time.sleep(0.02)
        return slow(*a, **kw)
    eng.session.decode = decode
    srv = ServingServer(eng).start()
    try:
        body = json.dumps({"prompt_ids": [3, 5, 7], "max_new_tokens": 60,
                           "stream": True}).encode()
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        got = b""
        while b"data:" not in got:
            got += s.recv(4096)
        s.close()
        deadline = time.monotonic() + 30
        while val("srv_gone.request.cancelled") == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert val("srv_gone.request.cancelled") == 1
        assert val("srv_gone.request.completed") == 0
    finally:
        srv.stop()
        eng.close()


def test_stop_drains_in_flight_requests(pair):
    _ref, net = pair
    with make_engine(net, "srv_drain") as eng:
        eng.pause()
        srv = ServingServer(eng).start()
        out = {}
        t = threading.Thread(target=lambda: out.update(r=_post(
            srv, {"prompt_ids": [3, 4], "max_new_tokens": 3})))
        t.start()
        while srv.active_requests < 1 or eng._admission.depth < 1:
            time.sleep(0.005)
        threading.Timer(0.1, eng.resume).start()
        srv.stop(drain_s=30)                # returns once it answered
        assert srv.active_requests == 0
        t.join(timeout=30)
        r, data = out["r"]
        assert r.status == 200 and len(json.loads(data)["tokens"]) == 3


def test_serve_binds_only_a_generation_engine(pair):
    _ref, net = pair
    with pytest.raises(NotImplementedError, match="item 10"):
        serve("model/prefix", block=False)
    with pytest.raises(NotImplementedError, match="item 10"):
        ServingServer(object())
    with make_engine(net, "srv_serve") as eng:
        srv = serve(eng, port=0, block=False)
        try:
            r, data = _post(srv, {"prompt_ids": [3, 4],
                                  "max_new_tokens": 2})
            assert r.status == 200 and len(json.loads(data)["tokens"]) == 2
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# request tracing over HTTP
# ---------------------------------------------------------------------------
@pytest.fixture()
def traced():
    tracer.clear()
    rtrace.enable()
    yield
    rtrace.disable()
    tracer.clear()


def test_span_chains_over_http(pair, traced):
    """Two clients admitted at one boundary: each request's chain is
    complete and parented to its root, its traceparent comes back with
    its trace id, and a fused decode span links both
    (test_observability.py:115-250)."""
    _ref, net = pair
    tids = ["%032x" % (0xA0 + i) for i in range(2)]
    results = {}
    with make_engine(net, "obs_stag") as eng:
        eng.pause()
        with ServingServer(eng) as srv:
            def client(i):
                r, data = _post(
                    srv, {"prompt_ids": [3 + i, 5, 7], "max_new_tokens": 6,
                          "seed": i},
                    {"traceparent": f"00-{tids[i]}-{'12' * 8}-01",
                     "X-Request-Id": f"req-{i}"})
                results[i] = (r.status, r.getheader("traceparent"),
                              r.getheader("X-Request-Id"), json.loads(data))
            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(2)]
            for t in ts:
                t.start()
            while eng._admission.depth < 2:
                time.sleep(0.005)
            eng.resume()
            for t in ts:
                t.join(timeout=120)
    evs = tracer.events()
    for i in range(2):
        status, tp, rid, body = results[i]
        assert status == 200 and len(body["tokens"]) == 6
        assert tp.split("-")[1] == tids[i] and rid == f"req-{i}"
        spans = rtrace.request_spans(evs, trace_id=tids[i])
        names = [s["name"] for s in spans]
        for required in ("ingress", "admission", "queue_wait", "prefill",
                         "decode", "egress"):
            assert required in names, (i, names)
        assert names.count("decode") == 5
        by_name = {s["name"]: s for s in spans}
        root = by_name["ingress"]["span_id"]
        assert by_name["ingress"]["parent_id"] == "12" * 8
        assert tp.split("-")[2] == root
        for s in spans:
            if s["name"] != "ingress":
                assert s["parent_id"] == root, s["name"]
            assert s["request_id"] == f"req-{i}"
        assert by_name["admission"]["outcome"] == "admitted"
        assert all("batch_span" in s for s in spans
                   if s["name"] in ("decode", "prefill"))
    batch = [e[5] for e in evs if e[0] == "batch::decode"]
    assert any({ln["trace_id"] for ln in b["links"]} == set(tids)
               for b in batch)


def test_rejected_request_gets_a_terminated_span(pair, traced):
    _ref, net = pair
    with make_engine(net, "obs_shed", max_queue=1) as eng:
        eng.pause()
        parked = eng.submit([3, 5], max_new_tokens=2)
        with ServingServer(eng) as srv:
            tid = "%032x" % 0xBEEF
            r, data = _post(srv, {"prompt_ids": [4, 6]},
                            {"traceparent": f"00-{tid}-{'34' * 8}-01",
                             "X-Request-Id": "shed-me"})
            assert r.status == 429
            assert json.loads(data)["request_id"] == "shed-me"
        eng.resume()
        parked.result(timeout=120)
    spans = rtrace.request_spans(trace_id=tid)
    adm = [s for s in spans if s["name"] == "admission"]
    assert adm[0]["outcome"] == "queue_full" and adm[0]["terminated"]
    assert {"ingress", "egress"} <= {s["name"] for s in spans}


def test_traceparent_echoed_untouched_when_tracing_is_off(served):
    _eng, srv = served
    assert not rtrace.active
    tp = f"00-{'cd' * 16}-{'56' * 8}-01"
    r, _data = _post(srv, {"prompt_ids": [3, 4], "max_new_tokens": 2},
                     {"traceparent": tp})
    assert r.status == 200 and r.getheader("traceparent") == tp
    assert r.getheader("X-Request-Id")


# ---------------------------------------------------------------------------
# the paged engine's /healthz, and the sanitizer across serving
# ---------------------------------------------------------------------------
def test_paged_healthz_reports_block_pool(pair):
    _ref, net = pair
    eng = PagedGenerationEngine(net, GenerationEngineConfig(
        max_slots=2, max_length=64, max_new_tokens=4, block_size=16,
        prefix_cache_blocks=8, name="obs_paged"))
    try:
        with ServingServer(eng) as srv:
            for _ in range(2):          # the second hits the prefix cache
                r, _data = _post(srv, {"prompt_ids": list(range(3, 21)),
                                       "max_new_tokens": 4})
                assert r.status == 200
            conn = _conn(srv)
            conn.request("GET", "/healthz")
            h = json.loads(conn.getresponse().read())
            conn.close()
        assert h["kv_blocks_total"] == eng.pool.num_blocks
        assert h["kv_blocks_in_flight"] + h["kv_blocks_free"] == \
            h["kv_blocks_total"]
        assert h["kv_block_size"] == 16 and h["requests_parked"] == 0
        assert 0.0 < h["prefix_cache_hit_rate"] <= 1.0
        assert h["mem_prefix_cache_bytes"] > 0
    finally:
        eng.close()


def test_serving_under_the_sanitizer_reports_no_inversion(prompts):
    """FLAGS_lock_san 2 (a cycle raises) across concurrent HTTP clients,
    pause / resume, a weight swap and close: no lock-order cycle."""
    prev = {k: cc._flags.get_flag(k)
            for k in ("FLAGS_lock_san", "FLAGS_lock_hold_warn_ms")}
    set_flags({"FLAGS_lock_san": 2})
    cc.reset_graph()
    try:
        net = GPT(GPTConfig(**WIDTH), device="cpu", seed=5)
        eng = PagedGenerationEngine(net, GenerationEngineConfig(
            max_slots=2, max_length=64, max_new_tokens=4, block_size=16,
            prefix_cache_blocks=4, name="san_paged",
            tenant_quotas={"t": {"rate": 1.0, "burst": 1000.0}}))
        assert type(eng._cond).__name__ == "_SanCondition"
        with ServingServer(eng) as srv:
            outs = [None] * 4

            def client(i):
                outs[i] = _post(srv, {"prompt_ids": prompts[i].tolist(),
                                      "max_new_tokens": 4,
                                      "stream": i % 2 == 1},
                                {"X-Tenant": "t"})[0].status
            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(4)]
            for t in ts:
                t.start()
            eng.pause()
            eng.resume()
            eng.swap_weights(net.state_dict())
            for t in ts:
                t.join(timeout=120)
        eng.close()
        assert outs == [200] * 4
        assert cc.san_stats()["cycles"] == 0
        assert cc.san_stats()["acquires"] > 0
    finally:
        set_flags(prev)
        cc.reset_graph()
