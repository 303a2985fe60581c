"""``paddle_tpu_torch.fft`` and ``paddle_tpu_torch.signal`` against the
reference, beyond the op table (``tools/eager_ops.py``): complex tensors
through the eager core (``fft`` -> ``ifft`` and ``stft`` -> ``istft``
round trips, ``numpy()`` of a conjugate view), the gradient through
``rfft`` of a real input, the names, and the reference's errors.
Tolerances are the reference's: fft rtol / atol 2e-4
(``tests/test_linalg_fft_signal.py:54-82``), ``istft`` rtol 1e-3 / atol
1e-4 (:145)."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_op_test import TOL

FFT = TOL["fft"]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def test_the_names_are_the_references():
    assert port.fft.__all__ == ref.fft.__all__
    assert port.signal.__all__ == ref.signal.__all__
    for mod in ("fft", "signal"):
        for name in getattr(ref, mod).__all__:
            assert callable(getattr(getattr(port, mod), name)), name


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward", None])
def test_fft_ifft_round_trip_of_a_complex_tensor(norm):
    rs = np.random.RandomState(0)
    z = (rs.rand(4, 16) + 1j * rs.rand(4, 16)).astype(np.complex64)
    got = port.fft.fft(port.to_tensor(z), norm=norm)
    assert str(got.dtype) == "torch.complex64"
    np.testing.assert_allclose(got.numpy(), np.fft.fft(z, norm=norm), **FFT)
    want = ref.fft.fft(ref.to_tensor(z), norm=norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **FFT)
    back = port.fft.ifft(got, norm=norm)
    np.testing.assert_allclose(back.numpy(), z, **FFT)


def test_a_bad_norm_raises_as_the_reference():
    x = np.ones(4, np.float32)
    for m in (ref, port):
        with pytest.raises(ValueError, match="norm should be one of"):
            m.fft.fft(m.to_tensor(x), norm="sideways")


def test_gradient_through_rfft_of_a_real_input():
    x = np.random.RandomState(1).rand(4, 16).astype(np.float32)
    grads = []
    for m in (ref, port):
        t = m.to_tensor(x, stop_gradient=False)
        (m.fft.rfft(t).abs() ** 2).sum().backward()
        grads.append(np.asarray(t.grad.numpy()))
    np.testing.assert_allclose(grads[1], grads[0], **FFT)
    assert grads[1].shape == x.shape and np.abs(grads[1]).max() > 1


def test_conjugate_views_read_back():
    """torch keeps a conjugate or a negation as a bit on a view, which
    ``numpy()`` resolves."""
    z = (np.arange(4) + 1j * np.arange(4)).astype(np.complex64)
    got = port.conj(port.to_tensor(z))
    np.testing.assert_array_equal(got.numpy(), np.conj(z))
    inv = port.fft.ifft(port.to_tensor(z), norm="forward")
    np.testing.assert_allclose(inv.numpy(), np.fft.ifft(z, norm="forward"),
                               **FFT)


def test_stft_shape_and_istft_round_trip():
    """The reference's ``stft(x, 64, 16)`` on 200 samples is complex64 of
    [33, 13]; the inverse of a Hann-windowed transform gives x back."""
    rs = np.random.RandomState(3)
    x = rs.rand(200).astype(np.float32)
    spec = port.signal.stft(port.to_tensor(x), 64, 16)
    assert spec.shape == [33, 13] and str(spec.dtype) == "torch.complex64"
    want = ref.signal.stft(ref.to_tensor(x), 64, 16)
    np.testing.assert_allclose(spec.numpy(), np.asarray(want.numpy()), **FFT)
    x2 = rs.rand(2, 256).astype(np.float32)
    w = np.hanning(64).astype(np.float32)
    s2 = port.signal.stft(port.to_tensor(x2), 64, 16,
                          window=port.to_tensor(w))
    back = port.signal.istft(s2, 64, 16, window=port.to_tensor(w),
                             length=256)
    np.testing.assert_allclose(back.numpy(), x2, rtol=1e-3, atol=1e-4)


def test_stft_of_a_complex_input_two_sided():
    rs = np.random.RandomState(4)
    z = (rs.rand(80) + 1j * rs.rand(80)).astype(np.complex64)
    kw = dict(n_fft=16, hop_length=4, onesided=False)
    got = port.signal.stft(port.to_tensor(z), **kw)
    want = ref.signal.stft(ref.to_tensor(z), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **FFT)
    back = port.signal.istft(got, 16, 4, onesided=False,
                             return_complex=True)
    np.testing.assert_allclose(back.numpy(), np.asarray(ref.signal.istft(
        want, 16, 4, onesided=False, return_complex=True).numpy()), **FFT)


@pytest.mark.parametrize("call, match", [
    (lambda m, x: m.signal.frame(x, 8, 0), "hop_length"),
    (lambda m, x: m.signal.frame(x, 8, 4, axis=1), "axis"),
    (lambda m, x: m.signal.frame(x, 80, 4), "frame_length"),
    (lambda m, x: m.signal.overlap_add(x[None], -1), "hop_length"),
    (lambda m, x: m.signal.stft(x, 16, win_length=32), "win_length"),
    (lambda m, x: m.signal.stft(x, 16, window=m.to_tensor(
        np.ones(8, np.float32))), "window length"),
    (lambda m, x: m.signal.stft(x.astype("complex64"), 16), "onesided"),
    (lambda m, x: m.signal.istft(m.signal.stft(x, 16, 4), 16, 4,
                                 return_complex=True), "incompatible"),
    (lambda m, x: m.signal.istft(m.signal.stft(x, 16, 4), 16, 4,
                                 window=m.to_tensor(np.zeros(
                                     16, np.float32))), "NOLA"),
], ids=["hop", "axis", "short", "overlap_hop", "win_length", "window",
        "complex_onesided", "istft_complex", "nola"])
def test_signal_errors_are_the_references(call, match):
    x = np.random.RandomState(5).rand(40).astype(np.float32)
    for m in (ref, port):
        with pytest.raises(ValueError, match=match):
            call(m, m.to_tensor(x))
