"""The port's chaos layer, resilience primitives, metrics registry and
flight recorder against the reference's (``paddle_tpu/utils/chaos.py``,
``utils/resilience.py``, ``profiler/metrics.py``, ``profiler/flight.py``).

The specs of ``tests/test_resilience.py:118-190`` and the fit sites'
(``step.loss``, ``host.slow``, ``ckpt.write``) give, over 50 ``hit``s a
site, the reference's sequence of outcomes for the same seed (the
per-site ``random.Random(seed ^ crc32(site))``); ``retry``, ``Deadline``
and fail points behave alike; a registry's ``snapshot`` and
``prometheus_text`` after the same operations are equal, and so are the
flight recorder's ``counts``.  Delays are not slept: ``time.sleep`` is
replaced for the test.
"""
import json
import time

import pytest

from paddle_tpu.profiler import flight as rflight
from paddle_tpu.profiler import metrics as rmetrics
from paddle_tpu.utils import chaos as rchaos
from paddle_tpu.utils import resilience as rresilience

import paddle_tpu_torch
from paddle_tpu_torch.profiler import flight, metrics
from paddle_tpu_torch.utils import chaos, resilience

BOTH = ((chaos, resilience, metrics, flight),
        (rchaos, rresilience, rmetrics, rflight))


@pytest.fixture(autouse=True)
def _teardown():
    yield
    for c, r, _m, _f in BOTH:
        c.reset()
        r.clear_fail_points()


SPECS = [
    ("ckpt.write:fail@3;store.rpc:delay=0.5@2-4;step.loss:nan;"
     "loader.worker:fail@p=0.25;fs.rename:fail@5-", 0),
    ("s:fail@2", 0),
    ("rpc:fail@1;d:delay=0.05@1", 0),
    ("s:fail@p=0.5", 7),
    ("s:fail@p=0.5", 8),
    ("step.loss:nan@4", 0),
    ("host.slow:delay=0.15@2-3;step.loss:nan@p=0.3;ckpt.write:fail@2-", 3),
    ("a:nan@p=0.1;a:fail@p=0.9;b:delay=1@10-12", 11),
]


def _schedule(mod, spec, seed):
    mod.configure(spec, seed=seed)
    out = {}
    for site in sorted(mod.parse_spec(spec)):
        seq = []
        for _ in range(50):
            try:
                seq.append(mod.hit(site))
            except mod.ChaosError as e:
                seq.append(f"fail: {e}")
        out[site] = (seq, mod.call_count(site))
    return out


@pytest.mark.parametrize("spec,seed", SPECS, ids=[f"{i}" for i in
                                                  range(len(SPECS))])
def test_schedules_are_the_references(monkeypatch, spec, seed):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    port = _schedule(chaos, spec, seed)
    n = len(slept)
    ref = _schedule(rchaos, spec, seed)
    assert port == ref
    assert slept[:n] == slept[n:]
    assert any(v is not None for seq, _ in port.values() for v in seq)


def test_parse_errors_and_flag_arming_are_the_references():
    for bad in ("nosite", "site:explode", "site:fail@p=2.0"):
        msgs = []
        for mod in (chaos, rchaos):
            with pytest.raises(ValueError) as e:
                mod.parse_spec(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert chaos.SITES == rchaos.SITES
    paddle_tpu_torch.set_flags({"FLAGS_chaos_spec": "s:fail@1"})
    try:
        assert chaos.active
        with pytest.raises(chaos.ChaosError):
            chaos.hit("s")
        # an unrelated flag does not reset the schedule
        paddle_tpu_torch.set_flags({"FLAGS_prefetch_to_device": 2})
        assert chaos.call_count("s") == 1
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_chaos_spec": ""})
    assert not chaos.active


def test_injections_count_in_metrics_and_flight():
    for c, _r, m, f in BOTH:
        c.configure("x.site:fail@1-2", seed=0)
        before = m.counter("chaos.injected.x.site").value
        f.clear()
        for _ in range(3):
            try:
                c.hit("x.site")
            except c.ChaosError:
                pass
        assert m.counter("chaos.injected.x.site").value == before + 2
        assert f.counts() == {"chaos.x.site": 2}


def _retry_runs(res, met):
    out = []
    for fail_until, kw in ((3, dict(max_tries=5)), (10, dict(max_tries=3)),
                           (1, dict(max_tries=5, multiplier=3.0))):
        calls, delays = [0], []

        @res.retry(retry_on=(ConnectionRefusedError,), base_delay=0.01,
                   jitter=0.0, sleep=delays.append, **kw)
        def flaky():
            calls[0] += 1
            if calls[0] < fail_until:
                raise ConnectionRefusedError("not yet")
            return "ok"
        before = met.counter("resilience.retry").value
        try:
            result = flaky()
        except ConnectionRefusedError as e:
            result = f"raised {e}"
        out.append((result, calls[0], delays,
                    met.counter("resilience.retry").value - before))
    calls = [0]

    @res.retry(retry_on=(OSError,), classify=lambda e: isinstance(
        e, ConnectionRefusedError), sleep=lambda d: None)
    def permanent():
        calls[0] += 1
        raise FileNotFoundError("gone")
    with pytest.raises(FileNotFoundError):
        permanent()
    out.append(calls[0])
    with pytest.raises(ValueError, match="max_tries"):
        res.retry(max_tries=0)
    return out


def test_retry_deadline_and_fail_points_behave_alike():
    runs = [_retry_runs(r, m) for _c, r, m, _f in BOTH]
    assert runs[0] == runs[1]
    for _c, res, _m, _f in BOTH:
        assert res.Deadline(None).remaining() is None
        assert not res.Deadline(None).expired()
        assert res.Deadline(None).clamp(42.0) == 42.0
        d = res.Deadline(0.05)
        assert d.clamp(1.0) <= 0.05
        assert res.Deadline(0.0).expired()
        res.arm_fail_point("x.y")
        with pytest.raises(res.FailPointError, match="x.y"):
            res.fail_point("x.y")
        res.fail_point("x.y")                # one shot
        res.arm_fail_point("z", exc=KeyError("planted"))
        with pytest.raises(KeyError, match="planted"):
            res.fail_point("z")


def _drive_registry(reg):
    reg.counter("a.count", "things").inc()
    reg.counter("a.count").inc(4)
    g = reg.gauge("q.depth", "queue depth")
    g.set(3.5)
    g.dec(1.0)
    h = reg.histogram("lat.ms", "latency", reservoir=8)
    for v in (0.3, 7.0, 12.5, 3000.0, 0.001, 42.0, 42.0, 9.0, 11.0, 1e6):
        h.observe(v)
    reg.histogram("b.ms", buckets=(1.0, 10.0)).observe(5.0)
    reg.histogram("empty")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("a.count")
    return reg.snapshot(), reg.to_prometheus()


def test_metrics_snapshot_and_prometheus_text_are_the_references(tmp_path):
    port = _drive_registry(metrics.Registry())
    ref = _drive_registry(rmetrics.Registry())
    assert port == ref
    assert "lat_ms_bucket{le=\"+Inf\"} 10" in port[1]
    path = tmp_path / "m.json"
    metrics.counter("dump.probe").inc()
    assert json.loads(metrics.dump_json(str(path))) == json.loads(
        path.read_text())


def test_flight_counts_and_dump_are_the_references(tmp_path):
    docs = []
    for _c, _r, _m, f in BOTH:
        f.clear()
        for i in range(5):
            f.note("ckpt", "commit", step=i)
        f.note("train", "anomaly", value="nan", step=4, action="skip")
        docs.append(f.dump(str(tmp_path / f"{id(f)}.json"), reason="t"))
        assert f.events(2)[-1][1:3] == ("train", "anomaly")
    assert docs[0]["counts"] == docs[1]["counts"] == {
        "ckpt.commit": 5, "train.anomaly": 1}
    assert [e["fields"] for e in docs[0]["events"]] == [
        e["fields"] for e in docs[1]["events"]]
    paddle_tpu_torch.set_flags({"FLAGS_flight_recorder": False})
    try:
        assert not flight.active
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_flight_recorder": True})
    assert flight.active

