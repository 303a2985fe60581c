"""The eager core's ``Tensor``, ``Parameter`` and ``to_tensor`` against the
reference's (``paddle_tpu/core/tensor.py``): metadata, dtypes as the
reference runs them (x64 off), host interop, mutation, movement,
``__repr__``, the dtype and keyword probes that once caught real bugs,
and the place: the card unless ``set_device("cpu")``, raising
``NoCudaDevice`` without one."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.dtype import canonical_dtype as rname
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.core.dtype import canonical_dtype as pname
from paddle_tpu_torch.core.tensor import Parameter

A = np.random.RandomState(0).randn(3, 4).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


@pytest.mark.parametrize("data, dtype", [
    (1, None), (1.5, None), (True, None), ([1, 2, 3], None),
    ([[1.0, 2.0]], None), (np.arange(4), None),
    (np.arange(4, dtype=np.float64), None), (A, None), (A, "float16"),
    ([1, 2], "int64"), ([1, 2], "float64"), (np.ones(3, bool), None),
    ([1, 2], "bfloat16"), (np.arange(3, dtype=np.int8), None),
])
def test_to_tensor_types_follow_the_reference(data, dtype):
    r = ref.to_tensor(data, dtype=dtype)
    p = port.to_tensor(data, dtype=dtype)
    assert rname(r.dtype) == pname(p.dtype)
    np.testing.assert_array_equal(np.asarray(p.numpy(), np.float64),
                                  np.asarray(r.numpy(), np.float64))
    assert r.shape == p.shape and p.stop_gradient


def test_metadata_matches_the_reference():
    r, p = ref.to_tensor(A), port.to_tensor(A)
    for attr in ("shape", "ndim", "dim", "size", "is_leaf", "persistable"):
        assert getattr(r, attr) == getattr(p, attr), attr
    assert p.numel() == r.numel() and p.element_size() == r.element_size()
    assert p.place == port.CPUPlace(0) and p.place.is_cpu_place()
    assert p.T.shape == r.T.shape == [4, 3]
    assert isinstance(p.name, str) and p.trainable is False
    p.name = "x"
    assert p.name == "x"
    q = port.to_tensor(A, stop_gradient=False)
    assert not q.stop_gradient and q.is_leaf and q.trainable


def test_host_interop():
    p = port.to_tensor(A)
    a = p.numpy()
    a[0, 0] = 99.0
    assert p.numpy()[0, 0] == A[0, 0]           # numpy() copies
    np.testing.assert_array_equal(np.asarray(p), A)
    assert np.asarray(p, dtype=np.float64).dtype == np.float64
    s = port.to_tensor(2.5)
    assert s.item() == 2.5 and float(s) == 2.5 and int(s) == 2
    assert bool(port.to_tensor(1)) and p.tolist() == A.tolist()
    assert p.item(1) == A.ravel()[1]
    assert len(p) == 3 and [list(r.shape) for r in p] == [[4]] * 3
    with pytest.raises(TypeError):
        len(s)
    # bf16 comes back as a float32 array (no ml_dtypes on the card's
    # machine), its values exact
    b = port.to_tensor(A).astype("bfloat16")
    rb = ref.to_tensor(A).astype("bfloat16")
    assert b.numpy().dtype == np.float32
    np.testing.assert_array_equal(b.numpy(),
                                  np.asarray(rb.numpy(), np.float32))


def test_repr_is_the_references():
    r, p = ref.to_tensor(A[:2, :2]), port.to_tensor(A[:2, :2])
    assert repr(r).splitlines() == repr(p).splitlines()
    q = port.to_tensor([1.0], stop_gradient=False)
    assert "stop_gradient=False" in repr(q)
    w = Parameter(np.ones(2, np.float32))
    assert repr(w).startswith("Parameter containing:\nTensor(shape=[2]")


def test_setitem_rebinds_and_keeps_the_gradient():
    x = port.to_tensor(A, stop_gradient=False)
    y = x * 2.0
    before = y._data
    y[0] = 0.0
    assert y._data is not before               # an out-of-place update
    y.sum().backward()
    want = np.full_like(A, 2.0)
    want[0] = 0.0
    np.testing.assert_array_equal(x.grad.numpy(), want)
    r = ref.to_tensor(A)
    r[1, 1:3] = 5.0
    p = port.to_tensor(A)
    p[1, 1:3] = 5.0
    np.testing.assert_array_equal(p.numpy(), r.numpy())
    # a parameter is written in place: the torch parameter stays the one a
    # Layer or an optimizer holds
    w = Parameter(A.copy())
    tp = w._data
    w[0, 0] = 7.0
    assert w._data is tp and float(tp[0, 0]) == 7.0


def test_mutation_and_movement():
    p = port.to_tensor(A.copy())
    d = p._data
    p.set_value(np.zeros((3, 4), np.float32))
    assert p._data is d and not p.numpy().any()
    p.fill_(2.0)
    p.scale_(0.5)
    np.testing.assert_array_equal(p.numpy(), np.ones((3, 4)))
    p.copy_(port.to_tensor(A))
    np.testing.assert_array_equal(p.numpy(), A)
    p.zero_()
    assert not p.numpy().any()
    q = port.to_tensor(A, stop_gradient=False)
    c, det = q.clone(), q.detach()
    assert not c.stop_gradient and det.stop_gradient
    assert det._data.data_ptr() == q._data.data_ptr()
    assert pname(q.astype("float16").dtype) == "float16"
    assert pname(q.cast("int32").dtype) == "int32"
    m = q.to("cpu", "float16")
    assert pname(m.dtype) == "float16" and m.place.is_cpu_place()
    assert q.cpu().place.is_cpu_place()
    # gradients accumulate into .grad, clear_gradient drops or zeroes it
    (q * q).sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), 2 * A)
    q.clear_gradient(set_to_zero=True)
    assert not q.grad.numpy().any()
    q.clear_grad()
    assert q.grad is None
    # stop_gradient on a non-leaf cuts the graph below it
    z = q * 3.0
    z.stop_gradient = True
    assert z.stop_gradient and not q.stop_gradient


def test_one_parameter_wrapper_per_torch_parameter():
    w = Parameter(A.copy(), name="w0")
    assert Parameter.of(w._data) is w
    tp = torch.nn.Parameter(torch.ones(2))
    assert Parameter.of(tp) is Parameter.of(tp)
    w.optimize_attr["learning_rate"] = 0.5
    w.need_clip = False
    # the paddle attributes live on the torch parameter, where the port's
    # optimizers and clips read them
    assert w._data.optimize_attr == {"learning_rate": 0.5}
    assert w._data.need_clip is False and w._data.__dict__["name"] == "w0"
    r = ref.core.tensor.Parameter(ref.to_tensor(A)._data)
    for attr in ("persistable", "need_clip", "is_distributed", "trainable",
                 "stop_gradient"):
        assert getattr(Parameter(A), attr) == getattr(r, attr), attr
    w.trainable = False
    assert w.stop_gradient and not w._data.requires_grad
    import copy
    w2 = copy.deepcopy(w)
    assert w2._data is not w._data and w2.name == "w0"
    assert w2.optimize_attr == {"learning_rate": 0.5}


# -- the dtype and keyword probes ---------------------------------------------
def test_name_keywords_on_op_factories():
    x = port.to_tensor(A)
    for f, args in ((port.add, (x, x)), (port.zeros, ([2],)),
                    (port.relu, (x,)), (port.sum, (x,)),
                    (port.reshape, (x, [12])), (port.matmul, (x, x.T)),
                    (port.nn.functional.linear,
                     (x, port.to_tensor(np.ones((4, 2), np.float32))))):
        f(*args, name="op")


def test_scalar_promotion_on_int_tensors():
    for r, p in ((ref.to_tensor([1, 2]), port.to_tensor([1, 2])),):
        for f in (lambda t: t + 2, lambda t: t * 2, lambda t: t * 0.5,
                  lambda t: t / 2, lambda t: 2 - t, lambda t: t // 2,
                  lambda t: t ** 2, lambda t: t + True, lambda t: 1.5 * t):
            assert rname(f(r).dtype) == pname(f(p).dtype)
            np.testing.assert_array_equal(np.asarray(f(p).numpy()),
                                          np.asarray(f(r).numpy()))


def test_index_dtypes_of_randint_and_topk():
    ref.seed(0)
    port.seed(0)
    assert rname(ref.randint(0, 5, [3]).dtype) == \
        pname(port.randint(0, 5, [3]).dtype) == "int32"
    r = ref.topk(ref.to_tensor(A), 2)[1]
    p = port.topk(port.to_tensor(A), 2)[1]
    assert rname(r.dtype) == pname(p.dtype) == "int32"
    np.testing.assert_array_equal(p.numpy(), r.numpy())
    assert pname(port.argmax(port.to_tensor(A)).dtype) == "int32"


def test_no_dtype_truncation_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        port.to_tensor(np.arange(4, dtype=np.int64))
        port.to_tensor(np.arange(4, dtype=np.float64))
        port.to_tensor([1, 2], dtype="int64")
        port.arange(5, dtype="int64")
        port.zeros([2], dtype="float64")
        port.to_tensor(A).astype("int64")


def test_default_dtype_flag():
    was = port.get_flags(["FLAGS_default_dtype"])
    port.set_flags({"FLAGS_default_dtype": "float16"})
    try:
        assert pname(port.to_tensor(1.5).dtype) == "float16"
        assert pname(port.zeros([2]).dtype) == "float16"
        assert pname(port.to_tensor(np.ones(2)).dtype) == "float16"
        assert pname(port.to_tensor(A).dtype) == "float32"
    finally:
        port.set_flags(was)
    assert pname(port.ones([2]).dtype) == "float32"


# -- the place ---------------------------------------------------------------
def test_no_card_means_no_tensor_without_an_explicit_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(port_place, "_place", None)
    assert port.get_device() == "gpu:0"
    for make in (lambda: port.to_tensor([1.0]), lambda: port.zeros([2]),
                 lambda: port.randn([2]), lambda: port.nn.Linear(2, 2)):
        with pytest.raises(port.NoCudaDevice):
            make()
    with pytest.raises(port.NoCudaDevice):
        port.set_device("gpu")
    assert port.set_device("cpu") == port.CPUPlace(0)
    assert port.get_device() == "cpu:0"
    with pytest.raises(ValueError):
        port.set_device("tpu")


def test_device_namespace():
    assert port.device.get_all_device_type()[0] == "cpu"
    assert port.device.get_available_device()[-1] == "cpu"
    assert port.device.is_compiled_with_cuda() == torch.cuda.is_available()
    assert not port.device.is_compiled_with_xpu()
    assert port.device_count() == torch.cuda.device_count()
    port.device.synchronize()
    with pytest.raises(RuntimeError):
        port.device.XPUPlace(0)
