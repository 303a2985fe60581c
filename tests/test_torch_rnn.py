"""The recurrent layers and beam search of the port against the reference
(``paddle_tpu/nn/layer/rnn.py``), and the slice as a whole: a small LSTM
language model built in both packages, the reference's ``state_dict()``
carried into the port through ``set_state_dict`` (no converter), then
three ``Model.train_batch`` steps of SGD under ``ClipGradByGlobalNorm``.

Tolerances: the recurrent layers, like products and reductions, rtol
1e-4 / atol 1e-5 (``tests/torch_op_test.py`` ``"red"``); beam ids exact,
log-probabilities ``"ew"``.  The reference's gaps the port copies are
pinned here on both packages (``ROADMAP.md`` §C).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_op_test import TOL

V, E, H, T, B = 50, 16, 16, 6, 3
RED, EW = TOL["red"], TOL["ew"]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def _carry(rnet, net):
    """The reference's ``state_dict()`` into the port's layer as it is: the
    same names and shapes, no converter."""
    state = {k: np.array(v.numpy()) for k, v in rnet.state_dict().items()}
    assert set(state) == set(net.state_dict())
    missing, unexpected = net.set_state_dict(state)
    assert not missing and not unexpected
    return state


def _lm(m):
    nn = m.nn

    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, E)
            self.lstm = nn.LSTM(E, H, num_layers=2, direction="bidirect")
            self.head = nn.Linear(2 * H, V)

        def forward(self, ids):
            out, _ = self.lstm(self.emb(ids))
            return self.head(out)
    return LM()


def _sgd(m, net):
    return m.optimizer.SGD(learning_rate=1.0, parameters=net.parameters(),
                           grad_clip=m.nn.ClipGradByGlobalNorm(10.0))


@pytest.fixture(scope="module")
def trained():
    """Three SGD steps of the LSTM language model in both packages."""
    ref.seed(0)
    rnet, net = _lm(ref), _lm(port)
    _carry(rnet, net)
    rmodel = ref.Model(rnet)
    rmodel.prepare(_sgd(ref, rnet), ref.nn.CrossEntropyLoss())
    model = port.Model(net).prepare(_sgd(port, net),
                                    port.nn.CrossEntropyLoss(), jit=False)
    rs = np.random.RandomState(0)
    out = dict(ref=[], port=[])
    for _ in range(3):
        ids = rs.randint(0, V, (B, T)).astype(np.int64)
        labels = np.roll(ids, -1, 1)[..., None]
        out["ref"].append(float(np.asarray(rmodel.train_batch(
            [ids], [labels])["loss"])))
        out["port"].append(float(model.train_batch([ids], [labels])["loss"]))
    out["ref_state"] = {k: np.asarray(v.numpy())
                        for k, v in rnet.state_dict().items()}
    out["state"] = {k: v.numpy() for k, v in net.state_dict().items()}
    return out


def test_lstm_lm_losses_track_the_reference(trained):
    np.testing.assert_allclose(trained["port"], trained["ref"], **RED)
    assert trained["port"][-1] != trained["port"][0]


def test_lstm_lm_parameters_after_three_steps_match(trained):
    for k, want in trained["ref_state"].items():
        np.testing.assert_allclose(trained["state"][k], want, err_msg=k,
                                   **RED)


def test_parameter_names_and_shapes_are_the_references():
    ref.seed(0)
    for cls, gates in (("LSTM", 4), ("GRU", 3), ("SimpleRNN", 1)):
        rl = getattr(ref.nn, cls)(E, H, num_layers=2, direction="bidirect")
        pl = getattr(port.nn, cls)(E, H, num_layers=2, direction="bidirect")
        rshapes = {k: tuple(v.shape) for k, v in rl.state_dict().items()}
        pshapes = {k: tuple(v.shape) for k, v in pl.state_dict().items()}
        assert pshapes == rshapes
        assert pshapes["rnns.1.rnn_bw.cell.weight_ih"] == (gates * H, 2 * H)
        # Uniform(+-1/sqrt(hidden)), as the reference draws them
        w = pl.state_dict()["rnns.0.rnn_fw.cell.weight_hh"].numpy()
        assert np.abs(w).max() <= 1 / np.sqrt(H) and w.std() > 0.1


def _layer_case(m, cls, kw):
    return getattr(m.nn, cls)(E, H, **kw)


@pytest.mark.parametrize("cls, kw", [
    ("GRU", dict(num_layers=2)),
    ("GRU", dict(direction="bidirect", time_major=True)),
    ("SimpleRNN", dict(num_layers=2, activation="tanh")),
    ("SimpleRNN", dict(direction="backward", activation="relu")),
    ("LSTM", dict(num_layers=1, direction="backward")),
], ids=["gru2", "gru_bi_time_major", "rnn_tanh", "rnn_relu_backward",
        "lstm_backward"])
def test_layer_forward_and_gradients_match(cls, kw):
    ref.seed(1)
    rl, pl = _layer_case(ref, cls, kw), _layer_case(port, cls, kw)
    _carry(rl, pl)
    rs = np.random.RandomState(1)
    shape = (T, B, E) if kw.get("time_major") else (B, T, E)
    x = rs.randn(*shape).astype(np.float32)
    rx = ref.to_tensor(x, stop_gradient=False)
    px = port.to_tensor(x, stop_gradient=False)
    rout, rst = rl(rx)
    pout, pst = pl(px)
    np.testing.assert_allclose(pout.numpy(), rout.numpy(), **RED)
    rstates = rst if isinstance(rst, tuple) else (rst,)
    pstates = pst if isinstance(pst, tuple) else (pst,)
    for a, b in zip(rstates, pstates):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **RED)
    cot = rs.randn(*rout.shape).astype(np.float32)
    (rout * ref.to_tensor(cot)).sum().backward()
    (pout * port.to_tensor(cot)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), rx.grad.numpy(), **RED)
    rgrads = {k: p.grad for k, p in rl.named_parameters()}
    for k, p in pl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), rgrads[k].numpy(),
                                   err_msg=k, **RED)


@pytest.mark.parametrize("cls", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_cells_with_given_states_match(cls):
    ref.seed(2)
    rc, pc = getattr(ref.nn, cls)(E, H), getattr(port.nn, cls)(E, H)
    _carry(rc, pc)
    rs = np.random.RandomState(2)
    x = rs.randn(B, E).astype(np.float32)
    h = rs.randn(B, H).astype(np.float32)
    c = rs.randn(B, H).astype(np.float32)

    def run(m, cell):
        st = (m.to_tensor(h), m.to_tensor(c)) if cls == "LSTMCell" \
            else m.to_tensor(h)
        out, new = cell(m.to_tensor(x), st)
        return [out] + list(new if isinstance(new, tuple) else (new,))
    for a, b in zip(run(ref, rc), run(port, pc)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **RED)


def _decoder(m, beam=3, Vd=12, D=8):
    emb = m.nn.Embedding(Vd, D)
    cell = m.nn.GRUCell(D, D)
    proj = m.nn.Linear(D, Vd)
    dec = m.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                 beam_size=beam, embedding_fn=emb,
                                 output_fn=proj)
    return dec, (emb, cell, proj)


def test_beam_decode_matches_the_reference():
    """``tests/test_nn_extras.py:109-125``'s decode in both packages with
    the same weights: the same ids, log-probabilities at ``"ew"``."""
    ref.seed(0)
    rdec, rparts = _decoder(ref)
    pdec, pparts = _decoder(port)
    for a, b in zip(rparts, pparts):
        _carry(a, b)
    zeros = np.zeros((2, 8), np.float32)
    rids, rlp = ref.nn.dynamic_decode(
        rdec, rparts[1].get_initial_states(ref.to_tensor(zeros)),
        max_step_num=6)
    pids, plp = port.nn.dynamic_decode(
        pdec, pparts[1].get_initial_states(port.to_tensor(zeros)),
        max_step_num=6)
    assert pids.shape == rids.shape and str(pids.dtype) == "torch.int32"
    np.testing.assert_array_equal(pids.numpy(), rids.numpy())
    np.testing.assert_allclose(plp.numpy(), rlp.numpy(), **EW)
    assert (np.diff(plp.numpy(), axis=1) <= 1e-5).all()


@pytest.mark.parametrize("m", [ref, port], ids=["reference", "port"])
def test_gap_rnn_never_reads_sequence_length(m):
    m.seed(3)
    rnn = m.nn.LSTM(E, H)
    x = m.to_tensor(np.random.RandomState(3).randn(B, T, E)
                    .astype(np.float32))
    full, _ = rnn(x)
    cut, _ = rnn(x, sequence_length=m.to_tensor(np.array([1, 2, 3],
                                                         np.int64)))
    np.testing.assert_array_equal(cut.numpy(), full.numpy())


@pytest.mark.parametrize("m", [ref, port], ids=["reference", "port"])
def test_gap_initial_states_are_float32_whatever_dtype(m):
    cell = m.nn.LSTMCell(E, H)
    h, c = cell.get_initial_states(m.to_tensor(np.zeros((B, E), np.float32)),
                                   dtype="float16", init_value=0.5)
    for s in (h, c):
        assert "float32" in str(s.dtype) and s.shape == [B, H]
        assert float(s.numpy().max()) == 0.5


@pytest.mark.parametrize("m", [ref, port], ids=["reference", "port"])
def test_gap_dropout_only_between_layers(m):
    """One layer with dropout 0.5 in train mode drops nothing (the stack
    drops out between layers only); two layers do."""
    m.seed(4)
    x = m.to_tensor(np.random.RandomState(4).randn(B, T, E)
                    .astype(np.float32))
    one = m.nn.GRU(E, H, num_layers=1, dropout=0.5)
    one.train()
    a, _ = one(x)
    one.eval()
    b, _ = one(x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    two = m.nn.GRU(E, H, num_layers=2, dropout=0.5)
    two.train()
    a, _ = two(x)
    two.eval()
    b, _ = two(x)
    assert np.abs(a.numpy() - b.numpy()).max() > 1e-3


@pytest.mark.parametrize("m", [ref, port], ids=["reference", "port"])
def test_gap_beam_start_and_finished_beams(m):
    """Beam 0 starts alone at log-prob 0, the others at -1e9; a finished
    beam extends with ``end_token`` at no cost."""
    m.seed(5)
    dec, parts = _decoder(m, beam=3)
    init = parts[1].get_initial_states(m.to_tensor(np.zeros((2, 8),
                                                            np.float32)))
    ids, states, lp, finished = dec.initialize(init)
    np.testing.assert_array_equal(np.asarray(lp), np.tile(
        np.array([0.0, -1e9, -1e9], np.float32), 2))
    assert np.asarray(ids.numpy()).tolist() == [0] * 6
    done = np.ones(6, bool)
    fin = m.to_tensor(done)._data
    start = m.to_tensor(np.arange(6, dtype=np.float32) * -1.0)._data
    tokens, parent, _, new_lp, _ = dec.step(ids, states, start, fin)
    assert np.asarray(tokens.numpy()).tolist() == [1] * 6
    np.testing.assert_array_equal(np.asarray(new_lp),
                                  -np.arange(6, dtype=np.float32))


@pytest.mark.parametrize("m", [ref, port], ids=["reference", "port"])
def test_gap_dynamic_decode_needs_initial_states(m):
    dec, _ = _decoder(m)
    with pytest.raises(ValueError, match="initial cell states"):
        m.nn.dynamic_decode(dec, None)


def test_gather_tree_backtraces_as_the_reference():
    ids = np.array([[[2, 5]], [[6, 1]], [[3, 9]]], np.int32)
    parents = np.array([[[0, 0]], [[1, 0]], [[0, 1]]], np.int32)
    out = port.nn.functional.gather_tree(port.to_tensor(ids),
                                         port.to_tensor(parents)).numpy()
    assert out[:, 0, 0].tolist() == [5, 6, 3]
    want = ref.nn.functional.gather_tree(ref.to_tensor(ids),
                                         ref.to_tensor(parents)).numpy()
    np.testing.assert_array_equal(out, want)


def test_every_name_of_the_reference_is_exported():
    from paddle_tpu.nn.layer import rnn as rrnn
    for name in rrnn.__all__:
        assert hasattr(port.nn, name) and hasattr(port.nn.layer, name), name
