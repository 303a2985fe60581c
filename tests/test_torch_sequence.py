"""The ragged sequence ops of the port (``ops/sequence.py``) against the
reference on ragged batches held as ``(x, seq_lens)``: every one of the
17 ops, with a scrap tail (``sum(seq_lens) < total``, whose tokens every
result masks out), empty sequences, integer payloads and
``edit_distance`` normalised and not, forward and gradients at
``"ew"`` / ``"red"`` (``tests/torch_op_test.py``).  The op table
(``tools/eager_ops.py``) holds one case of each too, which
``chip_smoke.py`` phase 20d runs on the card."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.ops import sequence as rseq
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.tools.eager_ops import CASES
from torch_op_test import run_both

rs = np.random.RandomState(7)
LENS = np.array([3, 0, 4, 1, 2], np.int64)          # sum 10 of 13
X = rs.randn(13, 4).astype(np.float32)
IDS = rs.randint(0, 5, (13,)).astype(np.int64)
XI = rs.randint(-9, 9, (13, 2)).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def test_every_op_has_an_op_table_case():
    ids = {c.id for c in CASES}
    for name in rseq.__all__:
        assert any(i.split(":")[1] == name or i.startswith(f"op:{name}")
                   for i in ids), name
        assert callable(getattr(port, name)) and \
            callable(getattr(port.ops.sequence, name)), name


def _f(name, **kw):
    return lambda m: (lambda *a: getattr(m, name)(*a, **kw))


CASES_HERE = [
    ("pool_" + p, _f("sequence_pool", pool_type=p), [X, LENS], (0,), "red")
    for p in ("sum", "average", "sqrt", "max", "min", "first", "last")
] + [
    ("pool_int_max", _f("sequence_pool", pool_type="max"), [XI, LENS], (),
     "ew"),
    ("pool_int_sum", _f("sequence_pool", pool_type="sum"), [XI, LENS], (),
     "ew"),
    ("pool_all_empty", _f("sequence_pool", pool_type="average",
                          pad_value=3.0), [X, np.zeros(3, np.int64)], (0,),
     "red"),
    ("softmax", _f("sequence_softmax"), [X[:, 0].copy(), LENS], (0,), "red"),
    ("pad", _f("sequence_pad", pad_value=0.5), [X, LENS], (0,), "ew"),
    ("pad_maxlen", _f("sequence_pad", maxlen=2), [X, LENS], (0,), "ew"),
    ("unpad", _f("sequence_unpad"), [rs.randn(5, 4, 2).astype(np.float32),
                                     np.array([1, 4, 0, 2, 3], np.int64)],
     (0,), "ew"),
    ("reverse", _f("sequence_reverse"), [X, LENS], (0,), "ew"),
    ("conv", _f("sequence_conv", context_length=3),
     [X, LENS, rs.randn(12, 3).astype(np.float32)], (0, 2), "red"),
    ("conv_start", _f("sequence_conv", context_length=2, context_start=-2),
     [X, LENS, rs.randn(8, 3).astype(np.float32)], (0, 2), "red"),
    ("expand", _f("sequence_expand"), [X[:10], LENS,
                                      np.array([1, 2, 0, 3, 1], np.int64)],
     (0,), "ew"),
    ("expand_as", _f("sequence_expand_as"), [X[:5], LENS], (0,), "ew"),
    ("slice", _f("sequence_slice"), [X, LENS, np.array([1, 0, 2, 0, 1],
                                                       np.int64),
                                     np.array([2, 0, 2, 1, 1], np.int64)],
     (0,), "ew"),
    ("enumerate", _f("sequence_enumerate", win_size=4), [IDS, LENS], (),
     "ew"),
    ("reshape", _f("sequence_reshape", new_dim=2), [X[:10], LENS], (0,),
     "ew"),
    ("erase", _f("sequence_erase", tokens=[0, 4]), [IDS, LENS], (), "ew"),
    ("scatter", _f("sequence_scatter"), [rs.randn(5, 6).astype(np.float32),
                                         rs.randint(0, 6, 13).astype(
                                             np.int64),
                                         rs.randn(13).astype(np.float32),
                                         LENS], (0, 2), "ew"),
]


@pytest.mark.parametrize("label, fn, args, grad, tol", CASES_HERE,
                         ids=[c[0] for c in CASES_HERE])
def test_op_matches_the_reference_with_a_scrap_tail(label, fn, args, grad,
                                                    tol):
    run_both(fn(ref), fn(port), args, grad=grad, tol=tol, what=label)


def test_concat_matches_the_reference():
    lens_b = np.array([1, 2, 0, 2, 3], np.int64)

    def fn(m):
        return lambda x, y: m.sequence_concat(
            [x, y], [m.to_tensor(LENS), m.to_tensor(lens_b)])
    run_both(fn(ref), fn(port), [X[:10], X[3:11]], grad=(0, 1), what="cat")


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance_matches_the_reference(normalized):
    h = rs.randint(0, 4, (6, 7)).astype(np.int64)
    r = rs.randint(0, 4, (6, 5)).astype(np.int64)
    hl = np.array([7, 0, 3, 5, 1, 6], np.int64)
    rl = np.array([5, 2, 0, 4, 5, 1], np.int64)

    def fn(m):
        return lambda a, b, c, d: m.edit_distance(a, b, c, d,
                                                  normalized=normalized)
    run_both(fn(ref), fn(port), [h, r, hl, rl], what="edit_distance")


def test_edit_distance_of_known_strings():
    h = np.array([[1, 2, 3, 0]], np.int64)             # "kit" vs "sitting"
    r = np.array([[4, 2, 3, 3, 2, 5, 6]], np.int64)
    dist, n = port.edit_distance(port.to_tensor(h), port.to_tensor(r),
                                 port.to_tensor(np.array([3])),
                                 port.to_tensor(np.array([7])),
                                 normalized=False)
    assert float(dist.numpy()[0]) == 5.0 and int(n) == 1


def test_pad_then_unpad_gives_the_tokens_back():
    padded, lens = port.sequence_pad(port.to_tensor(X), port.to_tensor(LENS))
    assert padded.shape == [5, 4, 4]
    back = port.sequence_unpad(padded, lens)
    np.testing.assert_array_equal(back.numpy(), X[:10])
