"""The eager core's tensor functions against the reference, one case per
ported function, method and operator: the same numpy inputs through
``paddle_tpu`` and ``paddle_tpu_torch`` (on the CPU), forward value and
dtype, then the gradient of every differentiable input
(``tests/torch_op_test.py``).  Bounds: elementwise and shape ops rtol
1e-5 / atol 1e-6, products and reductions rtol 1e-4 / atol 1e-5,
integer, bool and shape results exact.  Random ops are held to their
shapes, dtypes and determinism under ``seed``; coverage cases check that
the reference's names exist in the port (the partly ported modules'
missing names are ``ROADMAP.md``'s waiting ones)."""
import os

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.tools.eager_ops import A, CASES, I, S3, W
from torch_op_test import numeric_grad_check, run_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    # the reference's per-op jit cache compiles every new op twice; op by
    # op its eager values are the same, at a fraction of the test's time
    was = ref.get_flags(["FLAGS_eager_jit_cache"])
    ref.set_flags({"FLAGS_eager_jit_cache": False})
    yield
    ref.set_flags(was)
    port_place._place = place


FUNCTIONS = [c for c in CASES if c.kind != "method"]
METHOD_CASES = [c for c in CASES if c.kind == "method"]


@pytest.mark.parametrize("case", FUNCTIONS, ids=[c.id for c in FUNCTIONS])
def test_op_matches_the_reference(case):
    run_both(case.fn(ref), case.fn(port), case.args, case.kw,
             grad=case.grad, tol=case.tol, what=case.id)


def _port_run(f, args, kw, grad):
    ts = [port.to_tensor(a, stop_gradient=i not in grad)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    out = f(*ts, **kw)
    outs = [o for o in (out if isinstance(out, (tuple, list)) else [out])
            if hasattr(o, "numpy")]
    if grad:
        loss = None
        for o in outs:
            if not o.stop_gradient:
                term = (o * 1.5).sum()
                loss = term if loss is None else loss + term
        loss.backward()
    return [o.numpy() for o in outs], [ts[i].grad.numpy() for i in grad]


@pytest.mark.parametrize("case", METHOD_CASES,
                         ids=[c.id for c in METHOD_CASES])
def test_method_is_its_function(case):
    """A method of the surface the reference attaches (``_attach``,
    ``ops/__init__.py:39-129``) gives its function's values and
    gradients bit for bit (the functions are held to the reference
    above); the methods the reference adds beyond them are held to the
    function they stand for."""
    name = {"astype": "cast"}.get(case.name, case.name)
    method = _port_run(lambda x, *r, **k: getattr(x, case.name)(*r, **k),
                       case.args, case.kw, case.grad)
    if name == "clone":
        function = _port_run(lambda x: port.assign(x), case.args, {},
                             case.grad)
    elif name == "reshape_":
        function = _port_run(port.reshape, case.args, case.kw, case.grad)
    else:
        function = _port_run(getattr(port, name), case.args, case.kw,
                             case.grad)
    for got, want in zip(method[0] + method[1], function[0] + function[1]):
        np.testing.assert_array_equal(got, want)
    assert len(method[0]) == len(function[0])


def test_tolist():
    assert port.to_tensor(A).tolist_op() == ref.to_tensor(A).tolist_op()
    assert port.tolist(port.to_tensor(I)) == ref.tolist(ref.to_tensor(I))


def _dtype(t):
    return port.core.dtype.canonical_dtype(t.dtype)


@pytest.mark.parametrize("name, call, dtype", [
    ("rand", lambda m: m.rand([400, 50]), "float32"),
    ("randn", lambda m: m.randn([400, 50]), "float32"),
    ("randint", lambda m: m.randint(0, 10, [400, 50]), "int32"),
    ("randperm", lambda m: m.randperm(20000), "int32"),
    ("uniform", lambda m: m.uniform([400, 50], min=-2.0, max=2.0),
     "float32"),
    ("normal", lambda m: m.normal(1.0, 2.0, [400, 50]), "float32"),
    ("bernoulli", lambda m: m.bernoulli(m.full([400, 50], 0.3)), "float32"),
    ("multinomial", lambda m: m.multinomial(
        m.to_tensor(np.full((4, 8), 1 / 8, np.float32)), 3), "int32"),
    ("gumbel_softmax", lambda m: m.nn.functional.gumbel_softmax(
        m.zeros([200, 5])), "float32"),
    ("dropout", lambda m: m.nn.functional.dropout(m.ones([400, 50]), 0.3),
     "float32"),
])
def test_random_ops_statistics_and_determinism(name, call, dtype):
    """A random op gives the reference's shape and dtype, moments near the
    distribution's, and the same draws after the same ``seed``."""
    ref.seed(0)
    r = call(ref)
    port.seed(0)
    a = call(port)
    port.seed(0)
    b = call(port)
    assert r.shape == a.shape and _dtype(a) == dtype == \
        ref.core.dtype.canonical_dtype(r.dtype)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    x = a.numpy().astype(np.float64)
    want = {"rand": (0.5, 0.2887), "randn": (0.0, 1.0),
            "randint": (4.5, 2.8723), "randperm": (9999.5, 5773.5),
            "uniform": (0.0, 1.1547), "normal": (1.0, 2.0),
            "bernoulli": (0.3, 0.4583), "gumbel_softmax": (0.2, None),
            "dropout": (1.0, 0.6547)}.get(name)
    if want is not None:
        assert abs(x.mean() - want[0]) < 0.05 * max(1.0, abs(want[1] or 1))
        if want[1] is not None:
            assert abs(x.std() - want[1]) < 0.05 * want[1]
    if name == "randperm":
        np.testing.assert_array_equal(np.sort(x), np.arange(20000))
    if name == "multinomial":
        assert all(len(set(row)) == 3 for row in a.numpy())


def test_logcumsumexp_is_right_where_the_reference_is_not():
    """A fault of the reference (``ROADMAP.md`` §C): its logcumsumexp
    subtracts the running maximum of each position from every earlier
    term (``paddle_tpu/ops/reduction.py:120-131``), so it is off by up to
    0.72 here; the port's is ``torch.logcumsumexp``, held to numpy's
    ``logaddexp.accumulate``, with its gradient checked numerically."""
    truth = np.logaddexp.accumulate(A.astype(np.float64), axis=1)
    got = port.logcumsumexp(port.to_tensor(A), axis=1).numpy()
    np.testing.assert_allclose(got, truth, rtol=1e-5, atol=1e-6)
    bad = ref.logcumsumexp(ref.to_tensor(A), axis=1).numpy()
    assert np.abs(bad - truth).max() > 0.1
    numeric_grad_check(lambda x: port.logcumsumexp(x, axis=1), [A])


@pytest.mark.parametrize("op, arrays", [
    (lambda x: port.tanh(x) * x, [A]),
    (lambda x, y: port.matmul(x, y).sum(axis=1), [A, W]),
    (lambda x: port.nn.functional.layer_norm(x, 4), [S3[:1]]),
    (lambda x: port.logsumexp(x, axis=0), [A]),
    (lambda x: port.median(x, axis=1), [A]),
])
def test_numeric_gradients(op, arrays):
    numeric_grad_check(op, arrays)


# -- coverage ----------------------------------------------------------------
WHOLE = ["creation", "math", "reduction", "logic", "manipulation",
         "activation", "norm_ops", "loss", "extras", "linalg", "sequence"]


@pytest.mark.parametrize("mod", WHOLE)
def test_every_name_of_the_modules_taken_whole(mod):
    names = getattr(ref.ops, mod).__all__
    missing = [n for n in names
               if not hasattr(getattr(port.ops, mod), n)
               or not hasattr(port, n)]
    assert not missing, f"ops/{mod}.py: {missing}"


def _waiting_names():
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    start = text.index("<!-- 5a-rest -->")
    end = text.index("<!-- /5a-rest -->")
    return text[start:end]


@pytest.mark.parametrize("mod, where", [
    ("nn_misc", "F"), ("loss", "F"), ("linalg", "fn")])
def test_the_partly_taken_modules_miss_only_waiting_names(mod, where):
    space = port.nn.functional if where == "F" else port
    waiting = _waiting_names()
    missing = [n for n in getattr(ref.ops, mod).__all__
               if not hasattr(space, n)]
    # a module with nothing missing is taken whole (WHOLE checks it)
    assert missing or mod in WHOLE, mod
    unlisted = [n for n in missing if f"`{n}`" not in waiting]
    assert not unlisted, f"ops/{mod}.py names neither ported nor listed " \
                         f"as waiting in ROADMAP.md: {unlisted}"


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
@pytest.mark.parametrize("shapes", [((3, 4), (3, 4)), ((), (3, 4)),
                                    ((3, 4), ())], ids=["same", "0d_left",
                                                        "0d_right"])
def test_mixed_float_arithmetic_promotes_as_jax(op, shapes):
    # fp32 beside bf16 (AMP O1's residual adds): the port lets torch
    # promote inside the kernel where torch's common type is JAX's, and
    # casts first where it is not (a 0-d fp32 beside a bf16 tensor)
    rs = np.random.RandomState(0)
    a = np.asarray(rs.rand(*shapes[0]) + 0.5, np.float32)
    b = np.asarray(rs.rand(*shapes[1]) + 0.5, np.float32)

    def run(pkg):
        x = pkg.to_tensor(a, stop_gradient=False)
        y = pkg.to_tensor(b).astype("bfloat16")
        y.stop_gradient = False
        out = getattr(pkg, op)(x, y)
        out.sum().backward()
        return out, x.grad, y.grad
    want, got = run(ref), run(port)
    assert str(got[0].dtype).replace("torch.", "") == str(want[0].dtype)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g.numpy(), np.float32),
                                   np.asarray(w.numpy(), np.float32),
                                   rtol=1e-2 if g is got[2] else 1e-6)
