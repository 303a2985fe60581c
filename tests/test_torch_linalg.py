"""``paddle_tpu_torch.linalg`` and the rest of ``ops/linalg.py`` against
the reference, beyond the op table (``tools/eager_ops.py``, held in
``tests/test_torch_ops_parity.py``): the namespace's names and aliases,
the results the reference builds off its tape (no gradient in either
package), ``lstsq``'s residuals, rank and singular values, the data range
of ``histogram``, the method surface, and each ``cond`` norm against
numpy.  Decompositions and solves are held at the reference's rtol 1e-3
(``tests/test_linalg_fft_signal.py:23-41``)."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.tools.eager_ops import EIGM, REC, RHS5, SPD, SQW
from torch_op_test import TOL

DEC = TOL["dec"]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def test_the_namespace_is_the_references():
    import paddle_tpu.linalg as rlinalg
    assert rlinalg.__all__ == port.linalg.__all__
    for name in rlinalg.__all__:
        assert callable(getattr(port.linalg, name)), name
    assert port.linalg.inv is port.linalg.inverse is port.ops.linalg.inverse
    assert port.cond is port.linalg.cond
    for name in ref.ops.linalg.__all__:
        assert callable(getattr(port, name)), name


# (name, call) of every result the reference builds outside its dispatch
NO_GRAD = [
    ("svd", lambda m, x: m.svd(x)),
    ("qr", lambda m, x: m.qr(x)),
    ("lu", lambda m, x: m.lu(x)),
    ("eig", lambda m, x: m.eig(x)),
    ("eigh", lambda m, x: m.eigh(x)),
    ("eigvals", lambda m, x: m.eigvals(x)),
    ("eigvalsh", lambda m, x: m.eigvalsh(x)),
    ("slogdet", lambda m, x: m.slogdet(x)),
    ("matrix_rank", lambda m, x: m.matrix_rank(x)),
    ("histogram", lambda m, x: m.histogram(x, bins=4)),
    ("lstsq", lambda m, x: m.lstsq(x, x)),
    ("cov", lambda m, x: m.cov(x)),
    ("corrcoef", lambda m, x: m.corrcoef(x)),
]


@pytest.mark.parametrize("m", [ref, port], ids=["reference", "port"])
@pytest.mark.parametrize("name, call", NO_GRAD, ids=[n for n, _ in NO_GRAD])
def test_results_built_off_the_tape_carry_no_gradient(m, name, call):
    """``ops/linalg.py:168-266`` of the reference: these results come back
    with ``stop_gradient`` from an input that records one, in both."""
    x = m.to_tensor(SPD, stop_gradient=False)
    out = call(m, x)
    for o in out if isinstance(out, (tuple, list)) else (out,):
        assert o.stop_gradient, name


@pytest.mark.parametrize("name, call", [
    ("cholesky", lambda m, x: m.cholesky(x)),
    ("inverse", lambda m, x: m.inverse(x)),
    ("det", lambda m, x: m.det(x)),
    ("pinv", lambda m, x: m.pinv(x)),
    ("matrix_power", lambda m, x: m.matrix_power(x, 2)),
    ("cond", lambda m, x: m.linalg.cond(x)),
])
def test_results_through_the_dispatch_carry_a_gradient(name, call):
    for m in (ref, port):
        x = m.to_tensor(SPD, stop_gradient=False)
        assert not call(m, x).stop_gradient, name


def test_lstsq_returns_residuals_rank_and_singular_values():
    """As ``jnp.linalg.lstsq`` (the reference's): residuals computed for
    every column, rank int32, the singular values of ``x``."""
    want = ref.lstsq(ref.to_tensor(REC), ref.to_tensor(RHS5))
    got = port.lstsq(port.to_tensor(REC), port.to_tensor(RHS5))
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()), **DEC)
    assert str(got[2].dtype) == "torch.int32" and int(got[2]) == 3
    sol, res, _, sv = np.linalg.lstsq(REC, RHS5, rcond=None)
    np.testing.assert_allclose(got[1].numpy(), res, rtol=1e-3)
    np.testing.assert_allclose(got[3].numpy(), sv, rtol=1e-3)


def test_lstsq_of_a_wide_system_keeps_its_residuals():
    wide = REC.T.copy()
    rhs = RHS5[:3]
    want = ref.lstsq(ref.to_tensor(wide), ref.to_tensor(rhs))
    got = port.lstsq(port.to_tensor(wide), port.to_tensor(rhs))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(bins=7), dict(bins=3, min=-0.5,
                                                           max=0.5)])
def test_histogram_takes_the_data_range_at_zero_bounds(kw):
    x = np.random.RandomState(0).randn(50).astype(np.float32)
    want = np.asarray(ref.histogram(ref.to_tensor(x), **kw).numpy())
    got = port.histogram(port.to_tensor(x), **kw)
    assert str(got.dtype) == "torch.int32"
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().sum() == (50 if not kw.get("min") else
                                 np.sum(np.abs(x) <= 0.5))


@pytest.mark.parametrize("p", [None, "fro", "nuc", 1, -1, 2, -2, np.inf,
                               -np.inf])
def test_cond_against_numpy(p):
    a = (np.random.RandomState(1).rand(5, 5) + 5 * np.eye(5)).astype(
        np.float32)
    got = port.linalg.cond(port.to_tensor(a), p=p).numpy()
    np.testing.assert_allclose(got, np.linalg.cond(a.astype(np.float64),
                                                   p=p), rtol=1e-3)


def test_methods_bound_as_the_reference_binds_them():
    x = port.to_tensor(SPD)
    np.testing.assert_array_equal(x.cholesky().numpy(),
                                  port.cholesky(x).numpy())
    np.testing.assert_array_equal(x.inverse().numpy(),
                                  port.inverse(x).numpy())
    np.testing.assert_allclose(x.inverse().numpy(),
                               np.asarray(ref.to_tensor(SPD).inverse()
                                          .numpy()), **DEC)


def test_eig_is_complex_on_the_inputs_device():
    w, v = port.eig(port.to_tensor(EIGM))
    assert str(w.dtype) == str(v.dtype) == "torch.complex64"
    assert w.place == v.place == port.CPUPlace()
    a = EIGM.astype(np.complex128)
    np.testing.assert_allclose(a @ v.numpy(), v.numpy() * w.numpy(),
                               atol=1e-4)


def test_solves_agree_with_numpy():
    got = port.linalg.solve(port.to_tensor(SQW), port.to_tensor(SQW[:, :2]))
    np.testing.assert_allclose(got.numpy(), np.eye(4)[:, :2], atol=1e-5)
    lu_, piv = port.linalg.lu(port.to_tensor(SQW))
    assert str(piv.dtype) == "torch.int32" and piv.numpy().min() >= 1
