"""The sparse embedding and the row-sparse (``SelectedRows``) update
against the reference's: every case of ``tests/test_sparse_grads.py``,
the port beside the reference on the same weights (carried across) and
numpy ids, on the CPU, where the update runs its plain version
(``multi_tensor_update_rows_ref`` for SGD, Adam and AdamW; the dense
update on the scattered gradient for the others).  Bounds:
``torch_op_test.TOL["ew"]``, and the reference's 2e-5 where a sparse run
is held to a dense one."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.selected_rows import SelectedRows as RefRows
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.core.selected_rows import SelectedRows
from torch_op_test import TOL

EW = TOL["ew"]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def _pair(V, D, sparse=True, seed=0, padding_idx=None, dtype=None):
    """The reference's embedding from ``seed`` and the port's with its
    weights."""
    ref.seed(seed)
    r = ref.nn.Embedding(V, D, padding_idx=padding_idx, sparse=sparse)
    p = port.nn.Embedding(V, D, padding_idx=padding_idx, sparse=sparse)
    w = np.asarray(r.weight._data)
    if dtype is not None:
        import jax.numpy as jnp
        r.weight._data = r.weight._data.astype(jnp.bfloat16)
        p.to(dtype=torch.bfloat16)
        w = np.asarray(r.weight._data.astype(jnp.float32))
    p.weight.set_value(w)
    return r, p


def _ids(seed, shape, V):
    return np.random.RandomState(seed).randint(0, V, shape)


def _backward(m, emb, ids, kind="square"):
    out = emb(m.to_tensor(ids))
    loss = {"square": lambda: m.sum(out * out), "sum": lambda: m.sum(out),
            "mean2": lambda: m.mean(out * out),
            "mean": lambda: m.mean(out)}[kind]()
    loss.backward()


def _rows_values(g):
    return np.asarray(g.rows), np.asarray(g.values, np.float64)


def test_sparse_embedding_grad_is_selected_rows():
    r, p = _pair(1000, 8)
    ids = _ids(0, (4, 6), 1000)
    for m, e in ((ref, r), (port, p)):
        _backward(m, e, ids)
    g, rg = p.weight.grad, r.weight.grad
    assert isinstance(g, SelectedRows) and isinstance(rg, RefRows)
    assert tuple(g.values.shape) == (24, 8) and g.dense_shape == (1000, 8)
    assert p.weight._data.grad.is_sparse         # no dense (V, D) array
    for a, b in zip(_rows_values(g), _rows_values(rg)):
        np.testing.assert_allclose(a, b, **EW)


def test_sparse_matches_dense_grad():
    r, p = _pair(1000, 8, seed=1)
    _, pd = _pair(1000, 8, sparse=False, seed=1)
    ids = _ids(1, (4, 6), 1000)
    for m, e in ((ref, r), (port, p), (port, pd)):
        _backward(m, e, ids)
    dense = p.weight.grad.to_dense().numpy()
    np.testing.assert_allclose(dense, pd.weight.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(dense, np.asarray(r.weight.grad.to_dense()),
                               **EW)


def test_grad_accumulation_merges():
    r, p = _pair(1000, 8, seed=2)
    ids = _ids(2, (4, 6), 1000)
    for _ in range(2):
        for m, e in ((ref, r), (port, p)):
            _backward(m, e, ids, "sum")
    g = p.weight.grad
    assert tuple(g.values.shape) == (48, 8)     # two backwards concatenated
    merged, rmerged = g.merged(), r.weight.grad.merged()
    assert merged.values.shape[0] == len(np.unique(np.asarray(g.rows)))
    for a, b in zip(_rows_values(merged), _rows_values(rmerged)):
        np.testing.assert_allclose(a, b, **EW)
    np.testing.assert_allclose(merged.to_dense().numpy(),
                               g.to_dense().numpy(), atol=1e-5)


def test_padding_idx_rows_get_zero_grad():
    r, p = _pair(50, 4, padding_idx=0)
    ids = np.array([[0, 1, 2, 0]])
    for m, e in ((ref, r), (port, p)):
        _backward(m, e, ids, "sum")
    g = p.weight.grad
    # one row per id, the padding ids' values zero, as the reference's
    assert tuple(g.values.shape) == (4, 4)
    for a, b in zip(_rows_values(g), _rows_values(r.weight.grad)):
        np.testing.assert_allclose(a, b, **EW)
    dense = g.merged().to_dense().numpy()
    assert np.all(dense[0] == 0.0) and np.any(dense[1] != 0.0)


def _train(m, emb, opt, ids_seq, loss="mean2"):
    for ids in ids_seq:
        _backward(m, emb, ids, loss)
        opt.step()
        opt.clear_grad()
    return np.asarray(emb.weight.numpy(), np.float64)


@pytest.mark.parametrize("opt_name, kw", [
    ("SGD", dict(learning_rate=0.1)),
    ("Adam", dict(learning_rate=0.1)),
    ("AdamW", dict(learning_rate=0.1, weight_decay=0.1)),
    ("Momentum", dict(learning_rate=0.1, weight_decay=0.05)),
    ("Adagrad", dict(learning_rate=0.1, weight_decay=0.05)),
    ("SGD", dict(learning_rate=0.1, weight_decay=0.05)),
])
def test_train_matches_the_reference(opt_name, kw):
    """Five steps of each: the port equals the reference; without decay
    SGD and the densified optimizers also equal their dense twins within
    2e-5.
    Momentum and Adagrad with L2 decay densify the gradient with the
    decay added on the touched rows only."""
    V, D = 100, 4
    rs = np.random.RandomState(3)
    ids_seq = [rs.randint(0, V, (2, 5)) for _ in range(5)]
    out = {}
    for sparse in (True, False):
        r, p = _pair(V, D, sparse=sparse, seed=7)
        out[sparse] = [_train(m, e, getattr(m.optimizer, opt_name)(
            parameters=e.parameters(), **kw), ids_seq)
            for m, e in ((ref, r), (port, p))]
        np.testing.assert_allclose(out[sparse][1], out[sparse][0], **EW)
    if opt_name not in ("Adam", "AdamW") and "weight_decay" not in kw:
        np.testing.assert_allclose(out[True][1], out[False][1], atol=2e-5)
    else:   # lazy rows, or decay on touched rows: the dense twin moves all
        assert not np.allclose(out[True][1], out[False][1], atol=2e-5)


def test_adam_sparse_touches_only_looked_up_rows():
    r, p = _pair(100, 4, seed=7)
    w0 = p.weight.numpy().copy()
    ids = np.array([[1, 5, 9]])
    ws = [_train(m, e, m.optimizer.Adam(learning_rate=0.1,
                                        parameters=e.parameters()),
                 [ids] * 3) for m, e in ((ref, r), (port, p))]
    np.testing.assert_allclose(ws[1], ws[0], **EW)
    touched = np.zeros(100, bool)
    touched[[1, 5, 9]] = True
    np.testing.assert_array_equal(ws[1][~touched], w0[~touched])
    assert not np.allclose(ws[1][touched], w0[touched])


def test_adamw_sparse_decays_touched_rows_only():
    r, p = _pair(60, 4, seed=1)
    w0 = p.weight.numpy().copy()
    ids = np.array([[2, 4]])
    ws = [_train(m, e, m.optimizer.AdamW(
        learning_rate=0.1, weight_decay=0.1, parameters=e.parameters()),
        [ids], "mean") for m, e in ((ref, r), (port, p))]
    np.testing.assert_allclose(ws[1], ws[0], **EW)
    untouched = np.ones(60, bool)
    untouched[[2, 4]] = False
    np.testing.assert_array_equal(ws[1][untouched], w0[untouched])


def test_global_norm_clip_handles_selected_rows():
    r, p = _pair(40, 4)
    w0 = p.weight.numpy().copy()
    ids = np.array([[1, 2, 3]])
    ws = [_train(m, e, m.optimizer.SGD(
        learning_rate=1.0, parameters=e.parameters(),
        grad_clip=m.nn.ClipGradByGlobalNorm(1e-4)), [ids], "square")
        for m, e in ((ref, r), (port, p))]
    np.testing.assert_allclose(ws[1], ws[0], **EW)
    assert 0 < np.abs(ws[1] - w0).sum() < 1e-3


def test_large_vocab_never_materializes_dense():
    V, D = 200_000, 16
    r, p = _pair(V, D)
    ids = _ids(0, (8, 32), V)
    for m, e in ((ref, r), (port, p)):
        _backward(m, e, ids, "sum")
    g = p.weight.grad
    assert isinstance(g, SelectedRows)
    assert g.values.size == 8 * 32 * D and g.values.size * 50 < V * D
    for m, e in ((ref, r), (port, p)):
        m.optimizer.SGD(learning_rate=0.1, parameters=e.parameters()).step()
    np.testing.assert_allclose(p.weight.numpy(), np.asarray(r.weight._data),
                               **EW)


@pytest.mark.parametrize("sparse", [True, False])
def test_global_norm_clip_merges_repeated_rows(sparse):
    """Row 3 looked up 4 times: the global norm is the merged row's, so
    the sparse step equals the dense one (2e-5) and the reference's."""
    moved = []
    for m in (ref, port):
        r, p = _pair(10, 4, sparse=sparse)
        e = r if m is ref else p
        w0 = np.asarray(e.weight.numpy(), np.float64)
        moved.append(_train(m, e, m.optimizer.SGD(
            learning_rate=1.0, parameters=e.parameters(),
            grad_clip=m.nn.ClipGradByGlobalNorm(0.5)),
            [np.array([[3, 3, 3, 3, 1]])], "square") - w0)
    np.testing.assert_allclose(moved[1], moved[0], atol=1e-6)
    if not sparse:
        return
    _, pd = _pair(10, 4, sparse=False)
    w0 = pd.weight.numpy().copy()
    dense = _train(port, pd, port.optimizer.SGD(
        learning_rate=1.0, parameters=pd.parameters(),
        grad_clip=port.nn.ClipGradByGlobalNorm(0.5)),
        [np.array([[3, 3, 3, 3, 1]])], "square") - w0
    np.testing.assert_allclose(moved[1], dense, atol=2e-5)


def test_bf16_parameters_over_fp32_masters():
    """A bf16 table with ``multi_precision``: the rows update its fp32
    master, the bf16 rows are the master's cast, untouched rows keep
    their bits; against the reference's master within bf16's step."""
    r, p = _pair(40, 8, seed=4, dtype="bfloat16")
    w0 = p.weight._data.detach().clone()
    rs = np.random.RandomState(4)
    seq = [rs.randint(0, 20, (2, 3)) for _ in range(3)]
    ropt = ref.optimizer.Adam(0.05, parameters=r.parameters(),
                              multi_precision=True)
    popt = port.optimizer.Adam(0.05, parameters=p.parameters(),
                               multi_precision=True)
    for ids in seq:
        for m, e, opt in ((ref, r, ropt), (port, p, popt)):
            _backward(m, e, ids, "mean2")
            opt.step()
            opt.clear_grad()
    master = popt._master_weights[id(p.weight._data)]
    w = p.weight._data.detach()
    assert w.dtype == torch.bfloat16 and master.dtype == torch.float32
    assert torch.equal(w, master.to(torch.bfloat16))
    rmaster = np.asarray(ropt._master_weights[id(r.weight)])
    np.testing.assert_allclose(master.numpy(), rmaster, rtol=1e-2,
                               atol=1e-2)
    touched = np.zeros(40, bool)
    touched[np.unique(np.concatenate([s.ravel() for s in seq]))] = True
    assert torch.equal(w[~torch.as_tensor(touched)],
                       w0[~torch.as_tensor(touched)])


def test_clear_grad_set_to_zero_leaves_a_dense_gradient():
    """``clear_grad(set_to_zero=True)`` on a sparse gradient leaves dense
    zeros, as the reference's: the next gradient accumulates densely and
    the next Adam step moves every row's moments (a dense update)."""
    r, p = _pair(30, 4, seed=5)
    ids = np.array([[1, 2, 2]])
    opts = [m.optimizer.Adam(0.1, parameters=e.parameters())
            for m, e in ((ref, r), (port, p))]
    for (m, e), opt in zip(((ref, r), (port, p)), opts):
        _backward(m, e, ids, "mean2")
        opt.step()
        e.weight.clear_gradient(set_to_zero=True)
        assert not isinstance(e.weight.grad, (SelectedRows, RefRows))
        np.testing.assert_array_equal(np.asarray(e.weight.grad.numpy()), 0)
        _backward(m, e, ids, "mean2")
        assert not isinstance(e.weight.grad, (SelectedRows, RefRows))
    before = p.weight.numpy().copy()
    for opt in opts:
        opt.step()
    np.testing.assert_allclose(p.weight.numpy(), np.asarray(r.weight._data),
                               **EW)
    # a dense Adam step moves the rows the first step touched, untouched
    # by this one's ids only through their moments (row 1 and 2 here)
    assert not np.array_equal(p.weight.numpy()[[1, 2]], before[[1, 2]])
    popt = opts[1]
    popt.clear_grad(set_to_zero=True)
    assert not p.weight._data.grad.is_sparse


def _model_net(m, sparse, seed=0):
    ref.seed(seed)

    class Net(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = m.nn.Embedding(50, 8, sparse=sparse)
            self.head = m.nn.Linear(8, 3)

        def forward(self, ids):
            return self.head(m.mean(self.emb(ids), axis=1))
    return Net()


def _carry(rnet, pnet):
    pnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in rnet.state_dict().items()})


@pytest.mark.parametrize("jit", [False, True])
def test_model_jit_dense_and_eager_lazy(jit):
    """``Model(jit=True)`` takes the dense gradient on every step (the
    reference traces its step): the sparse net equals the dense net; with
    ``jit=False`` Adam is lazy.  Both equal the reference's ``Model``."""
    rs = np.random.RandomState(6)
    batches = [(rs.randint(0, 20, (4, 3)), rs.randint(0, 3, (4, 1)))
               for _ in range(3)]
    weights = {}
    for sparse in (True, False):
        outs = []
        rnet, pnet = _model_net(ref, sparse), _model_net(port, sparse)
        _carry(rnet, pnet)
        for m, net in ((ref, rnet), (port, pnet)):
            model = m.Model(net)
            model.prepare(m.optimizer.Adam(0.05,
                                           parameters=net.parameters()),
                          m.nn.CrossEntropyLoss(), jit=jit)
            for ids, y in batches:
                model.train_batch([ids], [y])
            outs.append(np.asarray(net.emb.weight.numpy(), np.float64))
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)
        weights[sparse] = outs[1]
    if jit:
        np.testing.assert_array_equal(weights[True], weights[False])
    else:
        assert not np.allclose(weights[True], weights[False], atol=1e-6)


@pytest.mark.parametrize("opt_name", ["SGD", "Adam", "Momentum"])
def test_the_per_leaf_path_equals_the_fused_one(opt_name):
    """``FLAGS_fused_optimizer=0`` takes the per-leaf ``_update`` path: a
    sparse gradient moves the same rows to the same values (L2 decay on
    the touched rows)."""
    rs = np.random.RandomState(8)
    seq = [rs.randint(0, 30, (2, 4)) for _ in range(3)]
    out = []
    for flag in (True, False):
        port.set_flags({"FLAGS_fused_optimizer": flag})
        try:
            _, p = _pair(30, 4, seed=9)
            out.append(_train(port, p, getattr(port.optimizer, opt_name)(
                learning_rate=0.1, weight_decay=0.01,
                parameters=p.parameters()), seq))
        finally:
            port.set_flags({"FLAGS_fused_optimizer": True})
    np.testing.assert_allclose(out[1], out[0], **EW)


def test_fp16_loss_scaling_unscales_a_sparse_gradient():
    """``Model(jit=False)`` under fp16 O1: the merged sparse gradient's
    values are unscaled with the rest, and Adam moves only the rows the
    batches touched."""
    port.seed(0)

    class Net(port.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = port.nn.Embedding(50, 8, sparse=True)
            self.head = port.nn.Linear(8, 3)

        def forward(self, ids):
            return self.head(port.mean(self.emb(ids), axis=1))
    net = Net()
    w0 = net.emb.weight.numpy().copy()
    model = port.Model(net)
    model.prepare(port.optimizer.Adam(0.05, parameters=net.parameters()),
                  port.nn.CrossEntropyLoss(), jit=False,
                  amp_configs={"level": "O1", "dtype": "float16"})
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 20, (4, 3))
    losses = [float(model.train_batch([ids], [rs.randint(0, 3, (4, 1))])[
        "loss"]) for _ in range(2)]
    assert np.isfinite(losses).all()
    moved = np.nonzero((net.emb.weight.numpy() != w0).any(1))[0]
    np.testing.assert_array_equal(moved, np.unique(ids))
