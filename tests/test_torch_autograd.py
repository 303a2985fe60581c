"""Eager autograd on torch autograd against the reference's tape
(``paddle_tpu/core/autograd.py``): every point of its ``backward``
(:130), ``grad`` (:216) and ``PyLayer`` (:286) semantics on both
packages, the hooks (linear hooks agree; a non-linear hook on a tensor
used twice is the one difference, ``ROADMAP.md`` §C), and the grad-mode
switches as decorators and contexts."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place

A = np.random.RandomState(0).randn(3, 4).astype(np.float32)
B = np.random.RandomState(1).randn(3, 4).astype(np.float32)
PACKAGES = [ref, port]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def _leaf(m, a=A):
    return m.to_tensor(a, stop_gradient=False)


@pytest.mark.parametrize("m", PACKAGES, ids=["ref", "port"])
def test_backward_refuses_what_the_reference_refuses(m):
    with pytest.raises(RuntimeError, match="does not require grad"):
        (m.to_tensor(A) * 2.0).sum().backward()
    with pytest.raises(RuntimeError, match="grad_tensor"):
        (_leaf(m) * 2.0).backward()
    y = (_leaf(m) * _leaf(m, B)).sum()
    y.backward()
    with pytest.raises(RuntimeError, match="retain_graph"):
        y.backward()


def _grads(m, fn, *arrays, stop=()):
    xs = [m.to_tensor(a, stop_gradient=i in stop)
          for i, a in enumerate(arrays)]
    fn(m, *xs)
    return [None if x.grad is None else np.asarray(x.grad.numpy())
            for x in xs]


def _same(fn, *arrays, stop=()):
    r = _grads(ref, fn, *arrays, stop=stop)
    p = _grads(port, fn, *arrays, stop=stop)
    for a, b in zip(r, p):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    return p


def test_non_scalar_backward_with_a_seed():
    seed = np.random.RandomState(2).randn(3, 4).astype(np.float32)

    def fn(m, x):
        (x * x).backward(m.to_tensor(seed))
    _same(fn, A)


def test_retain_graph_accumulates():
    def fn(m, x, y):
        z = (x * y).sum()
        z.backward(retain_graph=True)
        z.backward()
    g = _same(fn, A, B)
    np.testing.assert_allclose(g[0], 2 * B, rtol=1e-6)


def test_gradients_accumulate_across_calls():
    def fn(m, x):
        (x * 3.0).sum().backward()
        (x * x).sum().backward()
    g = _same(fn, A)
    np.testing.assert_allclose(g[0], 3 + 2 * A, rtol=1e-6)


def test_no_gradient_reaches_a_stop_gradient_input():
    def fn(m, x, y):
        (m.tanh(x) * y).sum().backward()
    g = _same(fn, A, B, stop=(1,))
    assert g[1] is None


def test_a_leaf_backward_is_its_seed():
    def fn(m, x):
        x.backward(m.to_tensor(B))
    g = _same(fn, A)
    np.testing.assert_array_equal(g[0], B)


def test_a_linear_hook_agrees_on_a_tensor_used_twice():
    def fn(m, x):
        y = x * 2.0
        y.register_hook(lambda g: g * 3.0)
        (y * y + m.sin(y)).sum().backward()
    _same(fn, A)


def test_a_hook_returning_none_keeps_the_gradient_and_can_be_removed():
    seen = {}

    def fn(m, x):
        y = x * 2.0
        h = y.register_hook(
            lambda g: seen.setdefault(m.__name__, []).append(list(g.shape)))
        (y * y).sum().backward(retain_graph=True)
        h.remove()
        (y * y).sum().backward()
    _same(fn, A)
    # once per incoming edge in the reference, once on their sum in the
    # port; after remove(), never
    assert seen == {"paddle_tpu": [[3, 4]] * 2, "paddle_tpu_torch": [[3, 4]]}


def test_a_non_linear_hook_on_a_tensor_used_twice_differs():
    """The reference fires the hook once per incoming edge and sums the
    results (:199-203); torch fires it once, on the sum.  With
    ``g -> g * g`` on a tensor used twice the reference gets
    ``g1^2 + g2^2`` and the port ``(g1 + g2)^2`` (``ROADMAP.md`` §C: the
    port keeps torch's, which is paddle's own order: accumulate, then
    hook)."""
    def fn(m, x):
        y = x * 1.0
        y.register_hook(lambda g: g * g)
        (y * 2.0 + y * 3.0).sum().backward()
    r = _grads(ref, fn, A)[0]
    p = _grads(port, fn, A)[0]
    np.testing.assert_allclose(r, np.full_like(A, 13.0))
    np.testing.assert_allclose(p, np.full_like(A, 25.0))


def test_grad_leaves_dot_grad_alone():
    for m in PACKAGES:
        x, y = _leaf(m), _leaf(m, B)
        z = (x * x * y).sum()
        gx, gy = m.grad(z, [x, y])
        np.testing.assert_allclose(np.asarray(gx.numpy()), 2 * A * B,
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(gy.numpy()), A * A,
                                   rtol=1e-5)
        assert x.grad is None and y.grad is None and gx.stop_gradient


def test_grad_with_grad_outputs_and_unused_inputs():
    seed = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    outs = []
    for m in PACKAGES:
        x, u = _leaf(m), _leaf(m, B)
        y = m.exp(x)
        (g,) = m.grad([y], [x], grad_outputs=[m.to_tensor(seed)],
                      retain_graph=True)
        gx, gu = m.grad(y.sum(), [x, u], allow_unused=True)
        assert gu is None
        with pytest.raises(RuntimeError):
            m.grad(m.exp(x).sum(), [x, u])
        outs.append((np.asarray(g.numpy()), np.asarray(gx.numpy())))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-5)


def test_grad_create_graph_gives_second_order():
    x = _leaf(port)
    (g,) = port.grad((x ** 3).sum(), [x], create_graph=True)
    (gg,) = port.grad(g.sum(), [x])
    np.testing.assert_allclose(gg.numpy(), 6 * A, rtol=1e-5)


def _cube(m):
    class Cube(m.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor
            return g * 3.0 * x * x * ctx.k
    return Cube


def _split(m):
    class Split(m.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            return x + y, x * y

        @staticmethod
        def backward(ctx, ga, gb):
            return ga + gb * 2.0, ga - gb
    return Split


def test_pylayer_matches_the_reference():
    def fn(m, x):
        out = _cube(m).apply(x, 2.0)
        assert not out.stop_gradient
        out.sum().backward()
    g = _same(fn, A)
    np.testing.assert_allclose(g[0], 6 * A * A, rtol=1e-5)

    def fn2(m, x, y):
        a, b = _split(m).apply(x, y)
        (a * 2.0 + b).sum().backward()
    _same(fn2, A, B)
    with port.no_grad():
        out = _cube(port).apply(port.to_tensor(A, stop_gradient=False), 1.0)
    assert out.stop_gradient
    assert port.autograd.PyLayerContext().saved_tensors == ()


@pytest.mark.parametrize("m", PACKAGES, ids=["ref", "port"])
def test_grad_mode_contexts_and_decorators(m):
    x = _leaf(m)
    with m.no_grad():
        assert not m.is_grad_enabled()
        assert (x * 2.0).stop_gradient
        with m.enable_grad():
            assert not (x * 2.0).stop_gradient

    @m.no_grad
    def bare():
        return x * 2.0

    @m.no_grad()
    def called():
        return x * 2.0
    assert bare().stop_gradient and called().stop_gradient
    assert m.is_grad_enabled()
    m.set_grad_enabled(False)
    try:
        assert (x * 2.0).stop_gradient
    finally:
        m.set_grad_enabled(True)
    assert not (x * 2.0).stop_gradient
    assert m.autograd.no_grad is m.no_grad
