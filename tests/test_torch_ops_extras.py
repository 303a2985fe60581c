"""The port's ``ops/extras.py``, ``nn.utils`` and the rest of
``nn_misc`` against the reference's: the same numpy inputs through
``paddle_tpu`` and ``paddle_tpu_torch`` (on the CPU), values, dtypes and
gradients at ``tests/torch_op_test.py``'s bounds; the in-place variants'
identity and guard; the random ones held to statistics and determinism;
spectral and weight norm held to the reference's weights and buffers
after three forwards (the twins of ``tests/test_ops_extras.py`` and of
``tests/test_nn_extras.py``'s norm test)."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_op_test import TOL, assert_same, run_both

rs = np.random.RandomState(5)
f32 = np.float32
A = rs.randn(3, 4).astype(f32)
P = (rs.rand(3, 4) + 0.5).astype(f32)
SQ = rs.randn(4, 4).astype(f32)
V3 = rs.randn(3).astype(f32)
X4 = rs.randn(4, 6, 3, 2).astype(f32)       # (N·T, C, H, W), T = 2
QKV = [rs.randn(1, 2, 6, 4).astype(f32) for _ in range(3)]
CSR_OFF = np.array([0, 1, 3, 4, 6, 8, 10], np.int32)
CSR_COL = np.array([0, 0, 1, 2, 2, 3, 3, 4, 4, 5], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    was = ref.get_flags(["FLAGS_eager_jit_cache"])
    ref.set_flags({"FLAGS_eager_jit_cache": False})
    yield
    ref.set_flags(was)
    port_place._place = place


def test_every_name_of_extras():
    """The reference's ``ops/extras.py`` whole, at the top level too
    (``cond`` is ``linalg.cond``: §A item 5b)."""
    missing = [n for n in ref.ops.extras.__all__
               if not hasattr(port.ops.extras, n) or not hasattr(port, n)]
    assert not missing, missing


# (id, callable of a package, args, kwargs, grad inputs)
CASES = [
    ("add_n", lambda m: lambda a, b, c: m.add_n([a, b, c]), (A, P, A), {},
     (0, 1, 2)),
    ("add_n_one", lambda m: lambda a: m.add_n(a), (A,), {}, (0,)),
    ("broadcast_tensors", lambda m: lambda a, b: m.broadcast_tensors([a, b]),
     (A[:, :1], V3[None, :1]), {}, (0, 1)),
    ("diagflat", lambda m: m.diagflat, (V3,), dict(offset=1), (0,)),
    ("diagonal", lambda m: m.diagonal, (SQ,), dict(offset=-1), (0,)),
    ("diagonal_axes", lambda m: m.diagonal, (X4,), dict(axis1=1, axis2=3),
     (0,)),
    ("floor_mod", lambda m: m.floor_mod, (A, P), {}, ()),
    ("multiplex", lambda m: lambda a, b, i: m.multiplex([a, b], i),
     (A, P, np.array([[1], [0], [1]], np.int32)), {}, (0, 1)),
    ("scatter_nd", lambda m: lambda i, u: m.scatter_nd(i, u, [5, 4]),
     (np.array([[1], [3], [1]], np.int32), A), {}, (1,)),
    ("rank", lambda m: m.rank, (X4,), {}, ()),
    ("shape", lambda m: m.shape, (X4,), {}, ()),
    # the rest of nn_misc
    ("sequence_mask", lambda m: m.nn.functional.sequence_mask,
     (np.array([1, 3, 0], np.int32),), {}, ()),
    ("sequence_mask_maxlen", lambda m: m.nn.functional.sequence_mask,
     (np.array([[1, 3], [2, 5]], np.int32),),
     dict(maxlen=6, dtype="float32"), ()),
    ("diag_embed", lambda m: m.nn.functional.diag_embed, (A,), {}, (0,)),
    ("diag_embed_offset", lambda m: m.nn.functional.diag_embed, (A,),
     dict(offset=-2, dim1=0, dim2=2), (0,)),
    ("affine_channel", lambda m: m.nn.functional.affine_channel,
     (X4, V3.repeat(2), rs.randn(6).astype(f32)), {}, (0, 1, 2)),
    ("affine_channel_nhwc", lambda m: m.nn.functional.affine_channel,
     (X4, V3[:2], V3[1:]), dict(data_layout="NHWC"), (0, 1, 2)),
    ("npair_loss", lambda m: m.nn.functional.npair_loss,
     (A, P, np.array([0, 1, 0], np.int64)), {}, (0, 1)),
    ("temporal_shift", lambda m: m.nn.functional.temporal_shift, (X4,),
     dict(seg_num=2, shift_ratio=0.34), (0,)),
    ("temporal_shift_nhwc", lambda m: m.nn.functional.temporal_shift,
     (X4.transpose(0, 2, 3, 1).copy(),),
     dict(seg_num=2, data_format="NHWC"), (0,)),
    ("sparse_attention", lambda m: lambda q, k, v, o, c:
     m.nn.functional.sparse_attention(q, k, v, o, c),
     (*QKV, CSR_OFF, CSR_COL), {}, (0, 1, 2)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_the_reference(case):
    name, fn, args, kw, grad = case
    run_both(fn(ref), fn(port), args, kw, grad=grad, tol="red", what=name)


def test_broadcast_shape_rank_shape_is_tensor():
    assert port.broadcast_shape([2, 1, 3], [4, 3]) == \
        ref.broadcast_shape([2, 1, 3], [4, 3]) == [2, 4, 3]
    x = port.to_tensor(np.zeros((2, 5), f32))
    assert int(port.rank(x).numpy()) == 2
    np.testing.assert_array_equal(port.shape(x).numpy(), [2, 5])
    assert port.is_tensor(x) and not port.is_tensor(np.zeros(3))


def test_tensor_arrays():
    arr = port.create_array()
    port.array_write(port.to_tensor(np.float32(1.0)), 0, arr)
    port.array_write(port.to_tensor(np.float32(2.0)), 2, arr)
    assert int(port.array_length(arr).numpy()) == 3 and arr[1] is None
    assert float(port.array_read(arr, port.to_tensor(2)).numpy()) == 2.0
    with pytest.raises(ValueError, match=">= 0"):
        port.array_write(port.to_tensor(np.float32(2.0)), -1, arr)
    assert port.create_array(initialized_list=[1, 2]) == [1, 2]


INPLACE = [("exp_", A, {}), ("ceil_", A, {}), ("floor_", A, {}),
           ("round_", A * 3, {}), ("reciprocal_", P, {}), ("rsqrt_", P, {}),
           ("sqrt_", P, {}), ("tanh_", A, {}),
           ("squeeze_", A[:, None], dict(axis=1)),
           ("unsqueeze_", A, dict(axis=0)),
           ("flatten_", X4, dict(start_axis=1)),
           ("scale_", A, dict(scale=2.0, bias=0.5)),
           ("increment", A, dict(value=2.5))]


@pytest.mark.parametrize("name, x, kw", INPLACE, ids=[c[0] for c in INPLACE])
def test_inplace_variant(name, x, kw):
    """Returns its input, holding the reference's values."""
    outs = []
    for m in (ref, port):
        t = m.to_tensor(x)
        y = getattr(m, name)(t, **kw)
        assert y is t
        outs.append(t)
    assert_same(outs[0], outs[1], "ew", name)


def test_scatter_inplace():
    upd = rs.randn(2, 4).astype(f32)
    outs = []
    for m in (ref, port):
        t = m.to_tensor(A)
        assert m.scatter_(t, m.to_tensor(np.array([2, 0], np.int32)),
                          m.to_tensor(upd)) is t
        outs.append(t)
    assert_same(outs[0], outs[1], "ew", "scatter_")


def test_inplace_on_a_tensor_that_needs_grad_raises():
    x = port.to_tensor(np.array([1.0, 4.0], f32), stop_gradient=False)
    y = x * 2
    with pytest.raises(RuntimeError, match="in-place"):
        port.sqrt_(y)
    with port.no_grad():
        port.sqrt_(y)
    np.testing.assert_allclose(y.numpy(), np.sqrt([2.0, 8.0]), rtol=1e-6)
    with pytest.raises(RuntimeError, match="in-place"):
        port.uniform_(x)


def test_add_n_never_aliases():
    x = port.to_tensor(np.ones(3, f32))
    out = port.add_n(x)
    assert out is not x
    port.exp_(out)
    np.testing.assert_allclose(x.numpy(), 1.0)


def test_random_extras_statistics_and_determinism():
    """``standard_normal`` and ``uniform_`` draw from the port's generators:
    moments near the distribution's, the same draws after the same seed
    (``uniform_``'s own ``seed`` too); torch's bits are not JAX's."""
    port.seed(0)
    a = port.standard_normal([4000]).numpy()
    port.seed(0)
    b = port.standard_normal([4000]).numpy()
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and abs(a.mean()) < 0.05 and \
        abs(a.std() - 1) < 0.05
    x, y = port.zeros([4000]), port.zeros([4000])
    port.uniform_(x, min=0.5, max=1.0, seed=7)
    port.uniform_(y, min=0.5, max=1.0, seed=7)
    np.testing.assert_array_equal(x.numpy(), y.numpy())
    u = x.numpy()
    assert (u >= 0.5).all() and (u < 1.0).all() and abs(u.mean() - 0.75) \
        < 0.01
    port.seed(1)
    port.uniform_(x)
    port.seed(1)
    port.uniform_(y)
    np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_check_shape_and_printoptions():
    assert port.check_shape([2, -1, 3]) and port.check_shape(
        port.to_tensor(np.array([1, 2], np.int32)))
    with pytest.raises(ValueError, match="invalid dim"):
        port.check_shape([2, -3])
    was = np.get_printoptions()
    try:
        port.set_printoptions(precision=2)
        assert "1.23" in repr(port.to_tensor(np.float32(1.23456)))
    finally:
        np.set_printoptions(**was)


def test_class_center_sample_raises_as_the_reference():
    for m in (ref, port):
        with pytest.raises(NotImplementedError, match="class_center_sample"):
            m.nn.functional.class_center_sample(None, 10, 4)


# -- nn.utils ----------------------------------------------------------------
def _linear_pair(n_in, n_out):
    ref.seed(0)
    r = ref.nn.Linear(n_in, n_out)
    p = port.nn.Linear(n_in, n_out)
    p.set_state_dict({k: v.numpy() for k, v in r.state_dict().items()})
    return r, p


@pytest.mark.parametrize("iters, dim", [(1, None), (3, 1)])
def test_spectral_norm_after_three_forwards(iters, dim):
    """Weights and ``weight_u`` equal the reference's after each of three
    forwards (the hook divides the weight it left last time)."""
    r, p = _linear_pair(6, 5)
    ref.nn.spectral_norm(r, n_power_iterations=iters, dim=dim)
    port.nn.spectral_norm(p, n_power_iterations=iters, dim=dim)
    x = rs.randn(2, 6).astype(f32)
    for _ in range(3):
        assert_same(r(ref.to_tensor(x)), p(port.to_tensor(x)), "red", "out")
        np.testing.assert_allclose(p.weight.numpy(), r.weight.numpy(),
                                   **TOL["red"])
        np.testing.assert_allclose(p.weight_u.numpy(), r.weight_u.numpy(),
                                   **TOL["red"])


def test_spectral_norm_bounds_the_top_singular_value():
    port.seed(0)
    lin = port.nn.Linear(6, 6)
    port.nn.utils.spectral_norm(lin, n_power_iterations=3)
    lin(port.to_tensor(np.eye(6, dtype=f32)))
    s = np.linalg.svd(lin.weight.numpy(), compute_uv=False)
    np.testing.assert_allclose(s[0], 1.0, rtol=0.05)


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_after_three_forwards_and_remove(dim):
    r, p = _linear_pair(4, 3)
    w0 = p.weight.numpy().copy()
    ref.nn.weight_norm(r, dim=dim)
    port.nn.weight_norm(p, dim=dim)
    np.testing.assert_allclose(p.weight_g.numpy(), r.weight_g.numpy(),
                               **TOL["red"])
    x = rs.randn(2, 4).astype(f32)
    for _ in range(3):
        assert_same(r(ref.to_tensor(x)), p(port.to_tensor(x)), "red", "out")
    np.testing.assert_allclose(p.weight.numpy(), r.weight.numpy(),
                               **TOL["red"])
    np.testing.assert_allclose(p.weight.numpy(), w0, rtol=1e-5)
    for m, lyr in ((ref, r), (port, p)):
        m.nn.utils.remove_weight_norm(lyr)
        lyr.weight.set_value(np.full((4, 3), 2.0, f32))
        lyr(m.to_tensor(x))
        np.testing.assert_array_equal(lyr.weight.numpy(), 2.0)


def test_parameters_vector_round_trip():
    r, p = _linear_pair(3, 2)
    vr = ref.nn.utils.parameters_to_vector(r.parameters())
    vp = port.nn.utils.parameters_to_vector(p.parameters())
    assert_same(vr, vp, "ew", "vector")
    new = np.arange(8, dtype=f32)
    ref.nn.utils.vector_to_parameters(ref.to_tensor(new), r.parameters())
    port.nn.utils.vector_to_parameters(port.to_tensor(new), p.parameters())
    for a, b in zip(r.parameters(), p.parameters()):
        np.testing.assert_array_equal(b.numpy(), a.numpy())


def test_spectral_norm_layer_matches_the_reference():
    np.random.seed(0)
    r = ref.nn.SpectralNorm([4, 6], dim=1, power_iters=2)
    np.random.seed(0)
    p = port.nn.SpectralNorm([4, 6], dim=1, power_iters=2)
    w = rs.randn(4, 6).astype(f32)
    for _ in range(2):
        assert_same(r(ref.to_tensor(w)), p(port.to_tensor(w)), "red", "sn")
    np.testing.assert_allclose(p.weight_v.numpy(), r.weight_v.numpy(),
                               **TOL["red"])
