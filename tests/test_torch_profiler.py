"""The port's profiler front end (``paddle_tpu_torch/profiler/__init__.py``:
``make_scheduler``, ``Profiler``, ``RecordEvent``, ``export_chrome_tracing``,
the legacy calls), ``ProfilerCallback``, and the trace and memory sites of
``Model.fit`` / ``evaluate`` and the loaders, against the reference's
(``paddle_tpu/profiler/__init__.py``, ``tests/test_profiler.py``,
``tests/test_memscope.py``).

The schedulers give the same states over the same steps; the same
``step()`` calls over the same spans (fed through each package's
``tracer.record`` with the same ns values) give the same states, windows,
``on_trace_ready`` calls and summary tables; the same 4-step ``fit`` in
both packages publishes the same span and metric names with the same
counts (``dispatch.*``, the reference's eager dispatch core, apart).  On
the CPU there is no device trace: asking for one raises ``NoCudaDevice``.
"""
import json
import os
import subprocess
import sys
import time
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as rprof
from paddle_tpu.profiler import metrics as rmetrics
from paddle_tpu.profiler import tracer as rtracer

from paddle_tpu_torch import Model
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.callbacks import ProfilerCallback
from paddle_tpu_torch.device import NoCudaDevice
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.profiler import memscope, metrics, tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_observability():
    """Every test starts and ends with both tracers off and empty and
    both registries fresh."""
    for t, m in ((tracer, metrics), (rtracer, rmetrics)):
        t.disable()
        t.clear()
        m._DEFAULT.clear()
    yield
    for t, m in ((tracer, metrics), (rtracer, rmetrics)):
        t.disable()
        t.clear()
        m._DEFAULT.clear()


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------
GRID = [(1, 1, 2, 1, 2), (0, 0, 2, 0, 0), (1, 1, 3, 0, 1), (2, 0, 1, 3, 0),
        (0, 2, 1, 2, 5), (3, 1, 4, 0, 7), (1, 0, 1, 0, 0)]
BAD = [dict(closed=1, ready=1, record=0), dict(closed=-1, ready=0, record=1),
       dict(closed=0, ready=-2, record=1),
       dict(closed=0, ready=0, record=1, repeat=-1),
       dict(closed=0, ready=0, record=1, skip_first=-1)]


def _states(fn, n=40):
    return [int(fn(i)) for i in range(n)]


@pytest.mark.parametrize("closed, ready, record, repeat, skip_first", GRID)
def test_make_scheduler_equals_reference(closed, ready, record, repeat,
                                         skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
              skip_first=skip_first)
    assert _states(prof.make_scheduler(**kw)) == \
        _states(rprof.make_scheduler(**kw))


@pytest.mark.parametrize("kw", BAD)
def test_make_scheduler_errors_equal_reference(kw):
    with pytest.raises(ValueError) as want:
        rprof.make_scheduler(**kw)
    with pytest.raises(ValueError) as got:
        prof.make_scheduler(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("span", [(2, 4), (0, 3), (1, 2), (5, 9)])
def test_range_scheduler_equals_reference(span):
    assert _states(prof.Profiler(scheduler=span)._scheduler) == \
        _states(rprof.Profiler(scheduler=span)._scheduler)


def test_empty_range_raises_as_reference():
    with pytest.raises(ValueError) as want:
        rprof.Profiler(scheduler=(3, 3))
    with pytest.raises(ValueError) as got:
        prof.Profiler(scheduler=(3, 3))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the Profiler's state machine and windows, step for step
# ---------------------------------------------------------------------------
def _drive(pkg, trc, sched, steps=12, samples=4):
    """States, windows and the summary of ``pkg.Profiler`` over ``steps``
    step() calls, a span fed before each one (``t0 = 1000 i``, 300 + 10 i
    ns long, a second span every third step) while the tracer is on."""
    seen, fired = [], []
    p = pkg.Profiler(scheduler=sched, on_trace_ready=lambda pr: fired.append(
        (pr.step_num, [(e[0], e[1], e[2], e[4]) for e in pr.events])))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p.start()
    for i in range(steps):
        seen.append((int(p.current_state), trc.active))
        if trc.active:
            trc.record(f"s{i}", 1000 * i, 1000 * i + 300 + 10 * i,
                       tid=1, cat="host")
            if i % 3 == 0:
                trc.record("every3", 1000 * i, 1000 * i + 50, tid=1)
        p.step(num_samples=samples)
    p.stop()
    table = p.summary(printout=False).splitlines()
    return dict(seen=seen, fired=fired, after=(int(p.current_state),
                                               trc.active),
                table=table[:-1], info=table[-1], step_num=p.step_num,
                samples=p._samples)


SCHEDS = [None, (2, 5), (1, 2),
          dict(closed=1, ready=1, record=2, repeat=2),
          dict(closed=0, ready=0, record=2),
          dict(closed=1, ready=1, record=3, skip_first=1),
          dict(closed=2, ready=0, record=1, repeat=0, skip_first=3)]


@pytest.mark.parametrize("sched", SCHEDS, ids=str)
def test_profiler_windows_equal_reference(sched):
    def make(pkg):
        return pkg.make_scheduler(**sched) if isinstance(sched, dict) \
            else sched
    got = _drive(prof, tracer, make(prof))
    want = _drive(rprof, rtracer, make(rprof))
    assert got["seen"] == want["seen"]
    assert got["fired"] == want["fired"]
    assert got["after"] == want["after"] == (0, False)
    assert got["table"] == want["table"]
    assert (got["step_num"], got["samples"]) == \
        (want["step_num"], want["samples"]) == (12, 48)
    assert got["info"].startswith("steps: 12, avg step: ")
    assert "ips:" in got["info"]


def test_timer_only_and_on_trace_ready_errors_equal_reference():
    def run(pkg, trc):
        p = pkg.Profiler(timer_only=True)
        p.start()
        p.step(num_samples=3)
        p.stop()
        q = pkg.Profiler(scheduler=(1, 2), on_trace_ready=lambda pr: 1 / 0)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            q.start()
            for _ in range(3):
                q.step()
            q.stop()
        return (p.step_num, p._samples, trc.active, p.events,
                [str(x.message) for x in w if "on_trace_ready" in
                 str(x.message)])
    assert run(prof, tracer) == run(rprof, rtracer)


def test_record_event_costs_one_predicate_when_nothing_traces(monkeypatch):
    """With no device trace and the tracer off, a RecordEvent enters no
    record_function and records nothing."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not prof._device_live and not tracer.active
    with prof.RecordEvent("quiet"):
        pass
    ev = prof.RecordEvent("quiet2")
    ev.begin()
    ev.end()
    assert tracer.events() == []


def test_device_trace_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device trace runs there")
    with pytest.raises(NoCudaDevice):
        prof.Profiler(with_device_trace=True, log_dir=str(tmp_path))
    with pytest.raises(NoCudaDevice):
        ProfilerCallback(with_device_trace=True, log_dir=str(tmp_path))
    with pytest.raises(NoCudaDevice):
        prof.start_profiler(log_dir=str(tmp_path))
    with pytest.raises(NoCudaDevice):
        with prof.profiler(log_dir=str(tmp_path)):
            pass
    assert not prof._device_live and prof._active["trace"] is None
    # timer_only takes no device trace, as in the reference
    prof.Profiler(with_device_trace=True, timer_only=True)


# ---------------------------------------------------------------------------
# port copies of tests/test_profiler.py
# ---------------------------------------------------------------------------
def test_profiler_does_not_own_free_running_tracer():
    prof.enable_host_tracer()
    p = prof.Profiler(timer_only=True)
    p.start()
    p.step()
    p.stop()
    assert tracer.active
    p2 = prof.Profiler(scheduler=prof.make_scheduler(closed=1, ready=0,
                                                     record=1, repeat=1))
    p2.start()
    for _ in range(4):
        p2.step()
    p2.stop()
    assert tracer.active
    prof.disable_host_tracer()
    assert not tracer.active


def test_nested_spans_chrome_export(tmp_path):
    prof.enable_host_tracer()
    with prof.RecordEvent("outer", args={"k": 1}):
        with prof.RecordEvent("inner"):
            time.sleep(0.001)
    prof.disable_host_tracer()
    path = tmp_path / "trace.json"
    prof.export_chrome_tracing(str(path))
    doc = json.load(open(path))
    evs = {e["name"]: e for e in doc["traceEvents"]
           if e["name"] in ("outer", "inner")}
    assert set(evs) == {"outer", "inner"}
    for e in evs.values():
        assert e["ph"] == "X"
        assert isinstance(e["ts"], (int, float))
        assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
        assert "pid" in e and "tid" in e
    o, i = evs["outer"], evs["inner"]
    assert o["tid"] == i["tid"]
    assert o["ts"] <= i["ts"]
    assert o["ts"] + o["dur"] >= i["ts"] + i["dur"]
    assert o["args"] == {"k": 1}


class _FitDS(Dataset):
    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return (rng.rand(4).astype(np.float32),
                np.array([i % 2], np.int64))

    def __len__(self):
        return 16


class _RefFitDS(paddle.io.Dataset):
    __getitem__ = _FitDS.__getitem__
    __len__ = _FitDS.__len__


def _ref_net():
    paddle.seed(0)
    return paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.ReLU(),
                                paddle.nn.Linear(8, 2))


def _port_net(ref=None):
    """Linear(4, 8), ReLU, Linear(8, 2), with the reference net's weights
    when given ((in, out) layouts transposed)."""
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 2))
    if ref is not None:
        with torch.no_grad():
            for i in (0, 2):
                net[i].weight.copy_(torch.from_numpy(
                    np.asarray(ref[i].weight.numpy()).T.copy()))
                net[i].bias.copy_(torch.from_numpy(
                    np.asarray(ref[i].bias.numpy()).copy()))
    return net


def _tiny_model(jit=True, net=None, metric=True):
    net = net or _port_net(_ref_net())
    return Model(net).prepare(Adam(1e-3, parameters=net.parameters()),
                              CrossEntropyLoss(),
                              metrics=Accuracy() if metric else None,
                              jit=jit)


def test_hapi_fit_exports_nested_trace_and_metrics(tmp_path):
    """The reference's test without its dispatch checks, which wait for
    the eager core (ROADMAP.md §A item 5)."""
    model = _tiny_model(jit=False)
    prof.enable_host_tracer()
    model.fit(_FitDS(), batch_size=4, epochs=1, verbose=0)
    prof.disable_host_tracer()
    path = tmp_path / "fit_trace.json"
    prof.export_chrome_tracing(str(path))
    evs = json.load(open(path))["traceEvents"]
    assert {"hapi", "dataloader"} <= {e["cat"] for e in evs}
    steps = [e for e in evs if e["name"] == "hapi::train_step"]
    assert len(steps) == 4
    waits = [e for e in evs if e["name"] == "step::data_wait"]
    assert len(waits) == 4 and all(
        w["ts"] + w["dur"] <= s["ts"] for w, s in zip(waits, steps))
    snap = metrics.snapshot()
    assert snap["hapi.train_step_latency_ms"]["count"] == 4
    assert snap["hapi.train_step_latency_ms"]["p95"] > 0
    assert snap["hapi.train_samples"] == 16
    assert snap["hapi.train_ips"] > 0
    assert snap["dataloader.batch_wait_ms"]["count"] == 4


def test_profiler_callback_and_progbar_ips(capsys):
    model = _tiny_model()
    windows = []
    cb = ProfilerCallback(on_trace_ready=lambda p: windows.append(
        len(p.events)), summary=False)
    model.fit(_FitDS(), batch_size=5, epochs=1, verbose=2, log_freq=1,
              callbacks=[cb])
    assert cb.profiler.step_num == 4
    assert cb.profiler._samples == 16              # not 4 * 5
    assert len(windows) == 1 and windows[0] > 0    # fired at stop()
    assert "ips:" in cb.profiler.step_info()
    out = capsys.readouterr().out
    assert "ips:" in out
    assert "batch_size" not in out
    assert not tracer.active


def test_eval_loop_instrumented():
    model = _tiny_model()
    prof.enable_host_tracer()
    model.evaluate(_FitDS(), batch_size=8, verbose=0)
    prof.disable_host_tracer()
    snap = metrics.snapshot()
    assert snap["hapi.eval_step_latency_ms"]["count"] == 2
    assert any(e[0] == "hapi::eval_step" for e in tracer.events())


def test_trace_summary_cli(tmp_path):
    tracer.enable()
    for _ in range(3):
        t0 = tracer.now_ns()
        tracer.record("op::matmul", t0, t0 + 5_000_000, cat="dispatch")
    t0 = tracer.now_ns()
    tracer.record("io::batch_wait", t0, t0 + 1_000_000, cat="dataloader")
    path = tmp_path / "t.json"
    prof.export_chrome_tracing(str(path))
    tracer.disable()
    script = os.path.join(ROOT, "tools", "trace_summary.py")
    r = subprocess.run([sys.executable, script, str(path), "-n", "5"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "op::matmul" in r.stdout and "io::batch_wait" in r.stdout
    top = [ln for ln in r.stdout.splitlines() if "::" in ln][0]
    assert "op::matmul" in top
    r2 = subprocess.run([sys.executable, script, str(path),
                         "--cat", "dispatch"],
                        capture_output=True, text=True, timeout=120)
    assert "op::matmul" in r2.stdout and "io::batch_wait" not in r2.stdout


# ---------------------------------------------------------------------------
# C12: fit publishes the reference's spans and metrics
# ---------------------------------------------------------------------------
def _fit_trace(fit):
    """Span names and counts, the registry's new names, histogram counts
    and the counters that count (not the ns ones), of one traced run."""
    snap0 = set(fit.registry.snapshot())
    fit.prof.enable_host_tracer()
    try:
        fit.run()
    finally:
        fit.prof.disable_host_tracer()
    spans = Counter(e[0] for e in fit.tracer.events()
                    if not e[0].startswith("op::"))
    snap = {k: v for k, v in fit.registry.snapshot().items()
            if k not in snap0 and not k.startswith("dispatch.")}
    counts = {k: v["count"] if isinstance(v, dict) else v
              for k, v in snap.items()
              if isinstance(v, dict) or k in ("dataloader.batches",
                                              "hapi.train_samples")}
    return spans, sorted(snap), counts


class _Fit:
    def __init__(self, prof_mod, trc, registry, run):
        self.prof, self.tracer, self.registry, self.run = \
            prof_mod, trc, registry, run


def test_fit_publishes_the_reference_spans_and_metrics():
    ref_net = _ref_net()
    net = _port_net(ref_net)
    rmodel = paddle.Model(ref_net)
    rmodel.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                         parameters=ref_net.parameters()),
                   paddle.nn.CrossEntropyLoss())
    model = _tiny_model(net=net, metric=False)
    got = _fit_trace(_Fit(prof, tracer, metrics, lambda: model.fit(
        _FitDS(), batch_size=4, epochs=1, verbose=0, shuffle=False)))
    want = _fit_trace(_Fit(rprof, rtracer, rmetrics, lambda: rmodel.fit(
        _RefFitDS(), batch_size=4, epochs=1, verbose=0, shuffle=False)))
    assert got == want
    assert got[0] == {"io::batch_wait": 4, "step::data_wait": 4,
                      "step::device": 4, "hapi::train_step": 4}
    for i in (0, 2):
        np.testing.assert_allclose(
            net[i].weight.detach().numpy(),
            np.asarray(ref_net[i].weight.numpy()).T, rtol=1e-5, atol=1e-6)


def test_fit_with_tracing_and_accounting_off_adds_nothing():
    assert not tracer.active and not memscope.active
    model = _tiny_model()
    names0 = set(metrics.snapshot())
    model.fit(_FitDS(), batch_size=4, epochs=1, verbose=0)
    assert tracer.events() == []
    fresh = set(metrics.snapshot()) - names0
    assert fresh == set(), fresh


# ---------------------------------------------------------------------------
# port copies of tests/test_memscope.py: accounting off and on
# ---------------------------------------------------------------------------
@pytest.fixture()
def scoped():
    memscope.reset()
    memscope.enable()
    yield
    memscope.disable()
    memscope.reset()


def _fit_model(steps=4):
    torch.manual_seed(7)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 2))
    m = Model(net).prepare(Adam(1e-2, parameters=net.parameters()),
                           torch.nn.MSELoss())
    r = np.random.RandomState(0)
    x = r.rand(steps * 4, 8).astype("float32")
    y = r.rand(steps * 4, 2).astype("float32")
    return m, x, y


def test_zero_cost_when_off():
    assert not memscope.active
    memscope.reset()
    names0 = set(metrics.snapshot())
    ledger0 = memscope.compile_count()
    m, x, y = _fit_model()
    m.fit([(x, y)], epochs=1, verbose=0)
    fresh = set(metrics.snapshot()) - names0
    bad = [n for n in fresh if n.startswith("mem.") or ".goodput." in n]
    assert bad == [], f"memscope metrics appeared while off: {bad}"
    assert memscope.compile_count() == ledger0
    assert getattr(m, "_last_goodput", None) is None
    assert memscope.tag_bytes().get("params", 0) == 0


def test_fit_goodput_and_memory_tags(scoped, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_RESTART_GENERATION", "0")
    m, x, y = _fit_model()
    m.fit([(x, y)], epochs=1, verbose=0)
    doc = m._last_goodput
    assert doc is not None and doc["mode"] == "train"
    assert abs(sum(doc["fractions"].values()) - 1.0) <= 0.01
    assert doc["compiles"] == 1 and doc["steps"] == 1
    assert [e["site"] for e in memscope.compile_entries()] == \
        ["hapi.train_step"]
    tags = memscope.tag_bytes()
    params = list(m.network.parameters())
    assert tags["params"] == sum(p.numel() * p.element_size()
                                 for p in params) == 4 * (8 * 16 + 16 +
                                                          16 * 2 + 2)
    # Adam: two moments a parameter and the two 0-d powers (fp32)
    slots = [t for p in params for t in m._optimizer._state[id(p)].values()]
    assert tags["opt_state"] == sum(t.numel() * t.element_size()
                                    for t in slots) > 2 * tags["params"]
    assert "step" in memscope.phase_peaks()
    assert metrics.get("train.goodput.productive") is not None
    with open(os.path.join(str(tmp_path), "goodput.r0.g0.json")) as f:
        assert json.load(f)["fractions"] == doc["fractions"]


def test_eval_and_predict_captures_are_their_own_sites(scoped):
    model = _tiny_model()
    x = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    y = (np.arange(8) % 2).reshape(8, 1).astype(np.int64)
    model.train_batch([x], [y])
    model.eval_batch([x], [y])
    model.predict_batch([x])
    model.train_batch([x], [y])
    assert [e["site"] for e in memscope.compile_entries()] == \
        ["hapi.train_step", "hapi.eval_step", "hapi.predict_step"]


def test_oom_in_a_step_dumps_then_raises(scoped, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_RESTART_GENERATION", "0")
    model = _tiny_model(metric=False)

    def exhausted(*_):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 2.00 GiB")
    model.network.forward = exhausted
    x = np.ones((4, 4), np.float32)
    with pytest.raises(torch.OutOfMemoryError, match="Tried to allocate"):
        model.train_batch([x], [np.zeros((4, 1), np.int64)])
    with open(os.path.join(str(tmp_path), "oom.r0.g0.json")) as f:
        doc = json.load(f)
    assert doc["context"] == "hapi.train_step"
    assert doc["error"].startswith("OutOfMemoryError: CUDA out of memory")
