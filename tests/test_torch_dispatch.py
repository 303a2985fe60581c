"""The eager core's op dispatch against the reference's
(``paddle_tpu/core/dispatch.py``): the kernel registry and ``defop``,
op-error tagging, ``FLAGS_check_nan_inf`` and ``FLAGS_benchmark``, the
refusals under ``enable_static()`` and under a CUDA-graph capture, the
out-of-memory dump, the ``op::`` spans and ``dispatch.*`` metrics with
``eager_phase_profile``, and AMP's casts by the reference's lists (and
the reference's eager AMP backward, which raises where the port's runs:
``ROADMAP.md`` §C)."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from paddle_tpu.core.dtype import canonical_dtype as rname
from paddle_tpu_torch.core import dispatch as pd
from paddle_tpu_torch.core import errors
from paddle_tpu_torch.core.dtype import canonical_dtype as pname
from paddle_tpu_torch.profiler import memscope, metrics, tracer

A = np.random.RandomState(0).randn(3, 4).astype(np.float32)
W = np.random.RandomState(1).randn(4, 5).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def test_registry_and_defop():
    @pd.defop("scaled_by_two", n_tensor_args=1)
    def scaled(a, *, k=2.0):
        return a * k
    out = scaled(port.to_tensor(A), k=3.0, name="x")
    np.testing.assert_allclose(out.numpy(), 3 * A)
    assert pd.get_kernel("scaled_by_two") is pd.get_kernel(
        "scaled_by_two", "other-backend")
    with pytest.raises(KeyError, match="no kernel"):
        pd.get_kernel("no_such_op")
    with pytest.raises(TypeError, match="positional static"):
        scaled(port.to_tensor(A), 3.0)
    pd.register_kernel("scaled_by_two", "special")(lambda a, k=2.0: a - k)
    assert pd.get_kernel("scaled_by_two", "special")(1.0) == -1.0
    # a torch tensor is an operand as a Tensor is, and its gradient flows
    t = torch.ones(2, requires_grad=True)
    scaled(t).sum().backward()
    assert torch.equal(t.grad, torch.full((2,), 2.0))


@pytest.mark.parametrize("m", [ref, port], ids=["ref", "port"])
def test_op_errors_are_tagged(m):
    with pytest.raises(m.errors.InvalidArgumentError,
                       match=r"\[operator < reshape > error\]"):
        m.reshape(m.to_tensor(A), [5, 5])
    with pytest.raises(m.errors.InvalidArgumentError,
                       match=r"\[operator < matmul > error\]"):
        m.matmul(m.to_tensor(A), m.to_tensor(A))


def test_enforce_taxonomy():
    with pytest.raises(errors.InvalidArgumentError, match="INVALID"):
        errors.enforce(False, "bad")
    with pytest.raises(errors.NotFoundError):
        errors.enforce_eq(1, 2, error_cls=errors.NotFoundError)
    with pytest.raises(errors.OutOfRangeError):
        errors.enforce_gt(1, 2, error_cls=errors.OutOfRangeError)
    with pytest.raises(errors.UnimplementedError,
                       match=r"\[operator < op > error\]"):
        with errors.op_error_context("op"):
            raise errors.UnimplementedError("x")
    assert issubclass(errors.ResourceExhaustedError, MemoryError)
    assert sorted(errors.__all__) == sorted(
        ref.errors.__all__ + ["tag_op_error"])


@pytest.mark.parametrize("m", [ref, port], ids=["ref", "port"])
def test_check_nan_inf_names_the_op(m):
    m.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="op 'log'.*NaN"):
            m.log(m.to_tensor([-1.0, 1.0]))
        with pytest.raises(FloatingPointError, match="op 'divide'.*Inf"):
            m.divide(m.to_tensor([1.0]), m.to_tensor([0.0]))
        assert float(m.exp(m.to_tensor(0.0))) == 1.0
    finally:
        m.set_flags({"FLAGS_check_nan_inf": False})
    assert np.isnan(m.log(m.to_tensor([-1.0])).numpy()).all()


def test_benchmark_flag_and_capture_refusal(monkeypatch):
    port.set_flags({"FLAGS_benchmark": True})
    try:
        out = port.add(port.to_tensor(A), 1.0)
        np.testing.assert_allclose(out.numpy(), A + 1)
        monkeypatch.setattr(pd, "_capturing", lambda: True)
        with pytest.raises(RuntimeError, match="CUDA-graph capture"):
            port.add(port.to_tensor(A), 1.0)
    finally:
        port.set_flags({"FLAGS_benchmark": False})
    assert not pd.debug_ops_active


def test_static_mode_refuses_naming_the_item():
    port.enable_static()
    try:
        assert not port.in_dynamic_mode()
        with pytest.raises(errors.UnimplementedError, match="A7"):
            port.add(port.to_tensor(A), 1.0)
    finally:
        port.disable_static()
    assert port.in_dynamic_mode()


def test_an_oom_in_an_op_dumps_then_raises(monkeypatch):
    seen = []
    monkeypatch.setattr(memscope, "active", True)
    monkeypatch.setattr(memscope, "oom_dump",
                        lambda e, context="": seen.append(context))

    def kernel(a):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    with pytest.raises(torch.OutOfMemoryError):
        pd.dispatch("hungry", kernel, [port.to_tensor(A)], {})
    assert seen == ["dispatch:hungry"]


def test_spans_and_metrics():
    was = tracer.active
    tracer.enable()
    tracer.clear()
    before = metrics.counter("dispatch.count").value
    try:
        x = port.to_tensor(A)
        y = port.matmul(x, port.to_tensor(W))
        port.relu(y).sum()
        evs = tracer.events()
    finally:
        tracer.clear()
        if not was:
            tracer.disable()
    ops = [e for e in evs if e[4] == "dispatch"]
    assert [e[0] for e in ops] == ["op::matmul", "op::relu", "op::reduce_sum"]
    assert all(e[2] >= e[1] for e in ops)
    assert metrics.counter("dispatch.count").value - before == 3
    assert metrics.counter("dispatch.op.matmul").value >= 1
    t0 = metrics.counter("dispatch.time_ns").value
    port.relu(port.to_tensor(A))                 # tracer off: no span
    assert metrics.counter("dispatch.time_ns").value == t0


def _phase_model(m, net):
    opt = m.optimizer.SGD(0.1, parameters=net.parameters())
    model = m.Model(net)
    model.prepare(opt, m.nn.CrossEntropyLoss(), jit=False)
    return model, opt


def test_eager_phase_profile_has_the_references_phases():
    """The same two-layer network in both packages: the port's table has
    the reference's phases, and its shares sum to 1."""
    x = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, (8, 1))
    ref.seed(0)
    rnet = ref.nn.Sequential(ref.nn.Linear(4, 6), ref.nn.LayerNorm(6),
                             ref.nn.ReLU(), ref.nn.Linear(6, 3))
    port.seed(0)
    pnet = port.nn.Sequential(port.nn.Linear(4, 6), port.nn.LayerNorm(6),
                              port.nn.ReLU(), port.nn.Linear(6, 3))
    rmodel, ropt = _phase_model(ref, rnet)
    pmodel, popt = _phase_model(port, pnet)
    rtab, rshares, _ = ref.profiler_mod.tracer.eager_phase_profile(
        rmodel, ropt, x, y, rnet[0].weight)
    ptab, pshares, wall = tracer.eager_phase_profile(
        pmodel, popt, x, y, pnet[0].weight)
    assert set(pshares) == set(rshares) == {
        "matmul", "norm", "elementwise", "loss", "optimizer"}
    assert {"linear", "layer_norm", "relu", "cross_entropy"} <= set(ptab)
    assert ptab["linear"]["calls"] == rtab["linear"]["calls"] == 4
    assert abs(sum(s["time_frac"] for s in pshares.values()) - 1) < 1e-9
    assert wall > 0 and not tracer.events()


# -- AMP at the dispatch -----------------------------------------------------
AMP_OPS = [
    ("matmul", lambda m, x, w: m.matmul(x, w)),
    ("linear", lambda m, x, w: m.nn.functional.linear(x, w)),
    ("exp_black", lambda m, x, w: m.exp(m.matmul(x, w))),
    ("add_grey", lambda m, x, w: m.matmul(x, w) + 1.0),
    ("mixed_grey", lambda m, x, w: m.matmul(x, w) * m.ones([3, 5])),
    ("sum_black", lambda m, x, w: m.sum(m.matmul(x, w))),
    ("softmax_black", lambda m, x, w: m.nn.functional.softmax(
        m.matmul(x, w))),
    ("layer_norm_black", lambda m, x, w: m.nn.functional.layer_norm(
        m.matmul(x, w), 5)),
    ("relu_grey", lambda m, x, w: m.nn.functional.relu(m.matmul(x, w))),
    ("cross_entropy_black", lambda m, x, w: m.nn.functional.cross_entropy(
        m.matmul(x, w), m.to_tensor(np.array([[0], [1], [4]])))),
]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name, f", AMP_OPS, ids=[n for n, _ in AMP_OPS])
def test_auto_cast_follows_the_reference_lists(name, f, level, dtype):
    outs = []
    for m, dname in ((ref, rname), (port, pname)):
        x, w = m.to_tensor(A), m.to_tensor(W)
        with m.amp.auto_cast(level=level, dtype=dtype):
            out = f(m, x, w)
        outs.append((dname(out.dtype), np.asarray(out.numpy(), np.float64)))
    assert outs[0][0] == outs[1][0]
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=tol, atol=tol)


def test_the_references_eager_amp_backward_raises_where_the_ports_runs():
    """The reference's cached VJP takes the low-type product's cotangent
    in fp32 and raises (``paddle_tpu/core/dispatch.py:238-243``,
    ``ROADMAP.md`` §C); the port's backward runs and the fp32 leaves get
    fp32 gradients."""
    grads = []
    for m in (ref, port):
        x = m.to_tensor(A, stop_gradient=False)
        w = m.to_tensor(W, stop_gradient=False)
        with m.amp.auto_cast():
            loss = (m.matmul(x, w) * 2.0).sum()
        if m is ref:
            with pytest.raises(ValueError, match="VJP"):
                loss.backward()
            continue
        loss.backward()
        grads = [x.grad, w.grad]
    assert [pname(g.dtype) for g in grads] == ["float32", "float32"]
    np.testing.assert_allclose(grads[0].numpy(),
                               np.tile(2 * W.sum(1), (3, 1)), rtol=5e-2)
