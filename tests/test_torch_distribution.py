"""``paddle_tpu_torch.distribution`` against the reference: densities,
probabilities, entropies and divergences at ``"ew"`` (rtol 1e-5 / atol
1e-6, ``tests/torch_op_test.py``), with their gradients; samples, which
torch draws with other bits than JAX, are held to their statistics (mean
and variance within 5 standard errors at 200,000 draws, Categorical
frequencies the same), to determinism under a seed, and to the
reparameterisation that lets a gradient reach the parameters."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_op_test import TOL, run_both

EW = TOL["ew"]
N = 200_000
rs = np.random.RandomState(0)
LOC, SCALE = rs.randn(3).astype(np.float32), (rs.rand(3) + 0.5).astype(
    np.float32)
LOW, HIGH = (rs.rand(3) - 1).astype(np.float32), (rs.rand(3) + 0.5).astype(
    np.float32)
LOGITS = rs.randn(2, 4).astype(np.float32)
VALUE = rs.uniform(-1.2, 1.6, (5, 3)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


D = {
    "normal": lambda m, lo, sc: m.distribution.Normal(lo, sc),
    "uniform": lambda m, lo, hi: m.distribution.Uniform(lo, hi),
}
PARAMS = {"normal": (LOC, SCALE), "uniform": (LOW, HIGH)}


@pytest.mark.parametrize("kind", ["normal", "uniform"])
@pytest.mark.parametrize("what", ["log_prob", "probs", "entropy"])
def test_densities_match_the_reference(kind, what):
    def fn(m):
        def f(a, b, v):
            dist = D[kind](m, a, b)
            return dist.entropy() if what == "entropy" else \
                getattr(dist, what)(v)
        return f
    run_both(fn(ref), fn(port), [*PARAMS[kind], VALUE], grad=(0, 1),
             tol="ew", what=f"{kind}.{what}")


def test_normal_kl_matches_the_reference():
    def fn(m):
        return lambda a, b, c, d: m.distribution.Normal(a, b).kl_divergence(
            m.distribution.Normal(c, d))
    run_both(fn(ref), fn(port), [LOC, SCALE, LOC[::-1].copy(),
                                 SCALE[::-1].copy()], grad=(0, 1, 2, 3),
             tol="ew", what="kl")


@pytest.mark.parametrize("what", ["entropy", "probs", "log_prob", "kl"])
def test_categorical_matches_the_reference(what):
    idx = np.array([[1], [3]], np.int64)[:, 0]

    def fn(m):
        def f(x, y):
            c = m.distribution.Categorical(x)
            if what == "entropy":
                return c.entropy()
            if what == "kl":
                return c.kl_divergence(m.distribution.Categorical(y))
            return getattr(c, what)(m.to_tensor(idx))
        return f
    run_both(fn(ref), fn(port), [LOGITS, LOGITS[::-1].copy()], grad=(0, 1)
             if what == "kl" else (0,), tol="ew", what=what)


def test_normal_samples_have_its_moments():
    port.seed(0)
    x = port.distribution.Normal(LOC, SCALE).sample([N]).numpy()
    assert x.shape == (N, 3) and x.dtype == np.float32
    se_mean = SCALE / np.sqrt(N)
    se_var = SCALE ** 2 * np.sqrt(2.0 / (N - 1))
    assert np.all(np.abs(x.mean(0) - LOC) < 5 * se_mean)
    assert np.all(np.abs(x.var(0) - SCALE ** 2) < 5 * se_var)


def test_uniform_samples_have_its_moments():
    port.seed(0)
    x = port.distribution.Uniform(LOW, HIGH).sample([N]).numpy()
    w = (HIGH - LOW).astype(np.float64)
    var = w ** 2 / 12
    se_var = np.sqrt((w ** 4 / 80 - var ** 2) / N)
    assert np.all(x >= LOW) and np.all(x < HIGH)
    assert np.all(np.abs(x.mean(0) - (LOW + HIGH) / 2) <
                  5 * np.sqrt(var / N))
    assert np.all(np.abs(x.var(0) - var) < 5 * se_var)


def test_categorical_frequencies():
    port.seed(0)
    draws = port.distribution.Categorical(LOGITS).sample([N])
    assert draws.shape == [N, 2] and str(draws.dtype) == "torch.int32"
    got = draws.numpy()
    p = np.exp(LOGITS) / np.exp(LOGITS).sum(-1, keepdims=True)
    for row in range(2):
        freq = np.bincount(got[:, row], minlength=4) / N
        assert np.all(np.abs(freq - p[row]) < 5 * np.sqrt(
            p[row] * (1 - p[row]) / N))


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_draws_repeat_under_a_seed(kind):
    dist = D[kind](port, *PARAMS[kind])
    port.seed(3)
    a = dist.sample([4]).numpy()
    port.seed(3)
    b = dist.sample([4]).numpy()
    np.testing.assert_array_equal(a, b)
    c, d = dist.sample([4], seed=7).numpy(), dist.sample([4], seed=7).numpy()
    np.testing.assert_array_equal(c, d)
    assert np.abs(a - dist.sample([4]).numpy()).max() > 0
    port.seed(3)
    a2 = port.distribution.Categorical(LOGITS).sample([6]).numpy()
    port.seed(3)
    np.testing.assert_array_equal(
        a2, port.distribution.Categorical(LOGITS).sample([6]).numpy())


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_samples_are_reparameterised(kind):
    """A gradient reaches the parameters through a sample, as the
    reference's (``distribution.py:78-84, 114-120``)."""
    for m in (ref, port):
        a = m.to_tensor(PARAMS[kind][0], stop_gradient=False)
        b = m.to_tensor(PARAMS[kind][1], stop_gradient=False)
        D[kind](m, a, b).sample([8]).sum().backward()
        # d/d loc of loc + eps scale is 1 a draw; low + u (high - low)
        # moves low by 1 - u and high by u
        total = np.asarray(a.grad.numpy()) + (
            0 if kind == "normal" else np.asarray(b.grad.numpy()))
        np.testing.assert_allclose(total, np.full(3, 8.0), **EW)
        assert np.abs(np.asarray(b.grad.numpy())).max() > 0


def test_the_names_are_the_references():
    assert port.distribution.__all__ == ref.distribution.__all__
    for name in ref.distribution.__all__:
        assert isinstance(getattr(port.distribution, name), type)
