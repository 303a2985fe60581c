"""The functional transforms of the port (``autograd_functional.py``,
exported from ``paddle_tpu_torch.autograd``) against the reference's on
functions written on each package's Tensors: ``vjp``, ``jvp``,
``jacobian``, ``hessian`` and ``vhp``, their defaults for ``v`` and their
layouts for one and several inputs, at the products' tolerance (rtol
1e-4 / atol 1e-5, ``tests/torch_op_test.py`` ``"red"``)."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu import autograd_functional as raf
from paddle_tpu_torch import autograd_functional as paf
from paddle_tpu_torch.core import place as port_place
from torch_op_test import TOL, leaves

RED = TOL["red"]
rs = np.random.RandomState(0)
X = rs.randn(3, 4).astype(np.float32)
Y = rs.randn(4, 2).astype(np.float32)
VEC = rs.randn(5).astype(np.float32)
VEC2 = rs.randn(5).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def _same(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert list(y.shape) == list(x.shape)
        assert y.stop_gradient
        np.testing.assert_allclose(y.numpy(), np.asarray(x.numpy()), **RED)


def _both(call):
    return call(ref, raf), call(port, paf)


CASES = {
    "vjp": lambda m, f: f.vjp(lambda a: m.tanh(a) * a, m.to_tensor(X)),
    "vjp_v": lambda m, f: f.vjp(lambda a: m.exp(a), m.to_tensor(X),
                                m.to_tensor(X[::-1].copy())),
    "vjp_two": lambda m, f: f.vjp(lambda a, b: m.matmul(a, b),
                                  [m.to_tensor(X), m.to_tensor(Y)]),
    "jvp": lambda m, f: f.jvp(lambda a: m.sin(a) * a, m.to_tensor(X)),
    "jvp_v": lambda m, f: f.jvp(lambda a, b: m.matmul(a, b),
                                [m.to_tensor(X), m.to_tensor(Y)],
                                [m.to_tensor(X * 2), m.to_tensor(Y * 3)]),
    "jacobian": lambda m, f: f.jacobian(lambda a: m.tanh(a) * 2.0,
                                        m.to_tensor(VEC)),
    "jacobian_matrix": lambda m, f: f.jacobian(
        lambda a: m.matmul(a, m.to_tensor(Y)), m.to_tensor(X)),
    "jacobian_two": lambda m, f: f.jacobian(
        lambda a, b: a * b + m.sin(a), [m.to_tensor(VEC),
                                        m.to_tensor(VEC2)]),
    "hessian": lambda m, f: f.hessian(lambda a: (a * a * a).sum(),
                                      m.to_tensor(VEC)),
    "hessian_two": lambda m, f: f.hessian(
        lambda a, b: (m.exp(a) * b * b).sum(), [m.to_tensor(VEC),
                                                m.to_tensor(VEC2)]),
    "vhp": lambda m, f: f.vhp(lambda a: (a ** 3).sum(), m.to_tensor(VEC)),
    "vhp_v_two": lambda m, f: f.vhp(
        lambda a, b: m.sin(a) * b, [m.to_tensor(VEC), m.to_tensor(VEC2)],
        [m.to_tensor(VEC2), m.to_tensor(VEC)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_the_reference(name):
    want, got = _both(CASES[name])
    _same(want, got)


def test_layouts_for_several_inputs():
    _, jac = _both(CASES["jacobian_two"])
    assert isinstance(jac, tuple) and len(jac) == 2
    assert jac[0].shape == [5, 5]
    _, hes = _both(CASES["hessian_two"])
    assert isinstance(hes, tuple) and all(isinstance(r, tuple) and
                                          len(r) == 2 for r in hes)
    out, grads = CASES["vjp_two"](port, paf)
    assert isinstance(grads, list) and [g.shape for g in grads] == \
        [[3, 4], [4, 2]]


def test_the_autograd_namespace_exports_the_references():
    import paddle_tpu.autograd as rautograd
    for name in ("vjp", "jvp", "jacobian", "hessian"):
        assert getattr(port.autograd, name) is getattr(paf, name)
        assert hasattr(rautograd, name)
    assert set(paf.__all__) == set(raf.__all__)


def test_transforms_work_under_no_grad():
    with port.no_grad():
        jac = paf.jacobian(lambda a: a * a, port.to_tensor(VEC))
    np.testing.assert_allclose(jac.numpy(), np.diag(2 * VEC), **RED)
