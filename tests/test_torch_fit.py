"""``Model.fit``, ``evaluate`` and ``predict`` of the port against the JAX
package's.

The flagship recipe at the SMALL GPT of ``tests/test_models.py:18``
(weights carried across with ``gpt_state_from_paddle_tpu``): AdamW under
``LinearWarmup(PolynomialDecay(...))`` with ``ClipGradByGlobalNorm(1.0)``
and ``Accuracy``, two shuffled epochs over ten sequences in batches of 4
(a partial last batch of 2), evaluated after each epoch on six more.
Both packages draw the batch order from ``np.random``.  Held to the
tolerances of ``tests/test_torch_hapi.py``: per-step losses (recorded by
a callback) rtol 1e-5, parameters atol 5e-4, ``evaluate``'s loss rtol
1e-5, ``predict(stack_outputs=True)`` atol 1e-4.  Then
``accumulate_grad_batches`` and ``num_iters``, ``EarlyStopping``, the
progress bar's lines, ``VisualDL``'s jsonl, ``ModelCheckpoint`` files the
reference's ``framework_io.load`` reads, ``save`` / ``load``, and how
often ``fit`` reads the loss.
"""
import json
import numbers
import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import framework_io as rfio
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

import paddle_tpu_torch
from paddle_tpu_torch import Model, framework_io
from paddle_tpu_torch.callbacks import Callback, EarlyStopping, VisualDL
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.models.convert import LINEAR_WEIGHTS
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, CrossEntropyLoss
from paddle_tpu_torch.optimizer import SGD, AdamW, lr

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=32, ffn_mult=2)            # tests/test_models.py:18
T, BATCH = 16, 4


def _data(n, seed):
    """ids from ``np.random.RandomState(seed)``, labels = ids rolled by one
    (``tests/test_torch_hapi.py:45-48``)."""
    ids = np.random.RandomState(seed).randint(0, SMALL["vocab_size"], (n, T))
    return [ids, np.roll(ids, -1, 1).reshape(n, T, 1)]


TRAIN, EVAL = _data(10, 0), _data(6, 1)


def _ref_state(net):
    return {k: np.array(v) for k, v in net.functional_state()[0].items()}


def _as_reference(state):
    return {k: (v.T if k.endswith(LINEAR_WEIGHTS) else v)
            for k, v in ((k, v.detach().numpy()) for k, v in state.items())}


def _pair():
    paddle.seed(0)
    ref = RefGPT(RefConfig(**SMALL))
    net = GPT(GPTConfig(**SMALL), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(_ref_state(ref),
                                                  device="cpu"))
    return ref, net


def _ref_model(ref, metrics=True, amp=None):
    sched = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.PolynomialDecay(5e-3, 8), 3, 0.0, 5e-3)
    model = paddle.Model(ref)
    model.prepare(paddle.optimizer.AdamW(
        sched, parameters=ref.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)),
        paddle.nn.CrossEntropyLoss(),
        metrics=paddle.metric.Accuracy() if metrics else None,
        amp_configs=amp)
    return model


def _port_model(net, metrics=True, jit=True, amp=None):
    sched = lr.LinearWarmup(lr.PolynomialDecay(5e-3, 8), 3, 0.0, 5e-3)
    return Model(net).prepare(
        AdamW(sched, parameters=net.parameters(), weight_decay=0.01,
              grad_clip=ClipGradByGlobalNorm(1.0)), CrossEntropyLoss(),
        metrics=Accuracy() if metrics else None, jit=jit, amp_configs=amp)


class _Record(Callback):
    """Per-step losses (read after fit) and batch sizes, and the step
    cache's compiles at each epoch's start."""

    def __init__(self):
        super().__init__()
        self.losses, self.sizes, self.compiles = [], [], []

    def on_epoch_begin(self, epoch, logs=None):
        self.compiles.append(self.model._steps.compiles)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])
        self.sizes.append(logs["batch_size"])


def _ref_recorder(losses):
    class Rec(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))
    return Rec()


@pytest.fixture(scope="module")
def fitted():
    ref, net = _pair()
    rmodel = _ref_model(ref)
    ref_losses = []
    np.random.seed(3)
    rmodel.fit(paddle.io.TensorDataset(TRAIN),
               eval_data=paddle.io.TensorDataset(EVAL), batch_size=BATCH,
               epochs=2, verbose=0, callbacks=[_ref_recorder(ref_losses)])
    model = _port_model(net)
    rec = _Record()
    np.random.seed(3)
    model.fit(TensorDataset(TRAIN), eval_data=TensorDataset(EVAL),
              batch_size=BATCH, epochs=2, verbose=0, callbacks=[rec])
    rec.compiles.append(model._steps.compiles)
    return dict(ref=ref, net=net, rmodel=rmodel, model=model, rec=rec,
                ref_losses=ref_losses)


def test_fit_losses_track_the_reference(fitted):
    rec = fitted["rec"]
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in rec.losses)
    np.testing.assert_allclose([float(v) for v in rec.losses],
                               fitted["ref_losses"], rtol=1e-5)
    assert rec.sizes == [4, 4, 2, 4, 4, 2]


def test_fit_parameters_match_the_reference(fitted):
    want = _ref_state(fitted["ref"])
    got = _as_reference(fitted["net"].state_dict())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=5e-4, err_msg=name)
    moved = max(np.abs(w - v).max() for w, v in zip(
        want.values(), _ref_state(_pair()[0]).values()))
    assert moved > 5e-3


def test_evaluate_and_predict_match_the_reference(fitted):
    want = fitted["rmodel"].evaluate(paddle.io.TensorDataset(EVAL),
                                     batch_size=BATCH, verbose=0)
    got = fitted["model"].evaluate(TensorDataset(EVAL), batch_size=BATCH,
                                   verbose=0)
    assert set(got) == set(want) == {"loss", "acc"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert abs(got["acc"] - want["acc"]) <= 1.0 / EVAL[0].size
    r_out = fitted["rmodel"].predict(paddle.io.TensorDataset(EVAL[:1]),
                                     batch_size=BATCH, stack_outputs=True)
    out = fitted["model"].predict(TensorDataset(EVAL[:1]), batch_size=BATCH,
                                  stack_outputs=True)
    assert len(out) == 1 and out[0].shape == (6, T, SMALL["vocab_size"])
    np.testing.assert_allclose(out[0], r_out[0], atol=1e-4)
    per_batch = fitted["model"].predict(TensorDataset(EVAL[:1]),
                                        batch_size=BATCH)
    assert [p[0].shape[0] for p in per_batch] == [4, 2]


def test_evaluate_equals_an_eval_batch_loop(fitted):
    model = fitted["model"]
    got = model.evaluate(TensorDataset(EVAL), batch_size=BATCH, verbose=0)
    metric = model._metrics[0]
    metric.reset()
    losses = [model.eval_batch([EVAL[0][i:i + BATCH]],
                               [EVAL[1][i:i + BATCH]])["loss"]
              for i in range(0, 6, BATCH)]
    assert got == {"loss": float(np.mean(losses)),
                   "acc": metric.accumulate()}


def test_the_partial_batch_captures_once(fitted):
    # train B 4 and B 2, eval B 4 and B 2: all made in epoch 1
    assert fitted["rec"].compiles == [0, 4, 4]
    kinds = sorted((k[0], k[1][0][0][0]) for k in fitted["model"]._steps.keys()
                   if k[0] in ("train", "eval"))
    assert kinds == [("eval", 2), ("eval", 4), ("train", 2), ("train", 4)]
    assert fitted["model"]._steps.hits > 0


def _port_fit(**kw):
    _, net = _pair()
    model = _port_model(net, metrics=kw.pop("metrics", False),
                        jit=kw.pop("jit", True))
    rec = _Record()
    np.random.seed(3)
    model.fit(TensorDataset(TRAIN), batch_size=BATCH, epochs=2, verbose=0,
              callbacks=[rec], **kw)
    return model, torch.stack(rec.losses), {
        k: v.clone() for k, v in net.state_dict().items()}


def test_prefetch_metrics_and_capture_change_no_bit():
    base_model, base, state = _port_fit(prefetch_to_device=0)
    assert base_model._last_prefetcher is None
    runs = {"flag default (2)": _port_fit(),
            "depth 1": _port_fit(prefetch_to_device=1),
            "metrics": _port_fit(metrics=True),
            "jit=False": _port_fit(jit=False)}
    assert runs["flag default (2)"][0]._last_prefetcher.depth == 2
    was = paddle_tpu_torch.get_flags(["FLAGS_prefetch_to_device"])
    paddle_tpu_torch.set_flags({"FLAGS_prefetch_to_device": 0})
    try:
        runs["flag 0"] = _port_fit()
    finally:
        paddle_tpu_torch.set_flags(was)
    assert runs["flag 0"][0]._last_prefetcher is None
    for name, (_, losses, st) in runs.items():
        assert torch.equal(losses, base), name
        assert all(torch.equal(v, st[k]) for k, v in state.items()), name


def test_a_loader_with_its_own_stage_lands_on_the_models_device():
    _, net = _pair()
    model = _port_model(net, metrics=False)
    loader = DataLoader(TensorDataset(TRAIN), batch_size=BATCH,
                        prefetch_to_device=2, places="cuda")
    model.fit(loader, epochs=1, verbose=0)
    assert loader._device == torch.device("cpu")
    assert loader._last_prefetcher.stats["produced"] == 3


@pytest.mark.parametrize("kw", [dict(accumulate_grad_batches=2),
                                dict(num_iters=4)],
                         ids=["accumulate", "num_iters"])
def test_accumulation_and_num_iters_track_the_reference(kw):
    ref, net = _pair()
    rmodel = _ref_model(ref, metrics=False)
    ref_losses = []
    np.random.seed(3)
    rmodel.fit(paddle.io.TensorDataset(TRAIN), batch_size=BATCH, epochs=2,
               verbose=0, callbacks=[_ref_recorder(ref_losses)], **kw)
    model = _port_model(net, metrics=False)
    rec = _Record()
    np.random.seed(3)
    model.fit(TensorDataset(TRAIN), batch_size=BATCH, epochs=2, verbose=0,
              callbacks=[rec], **kw)
    assert len(rec.losses) == len(ref_losses) == kw.get("num_iters", 6)
    np.testing.assert_allclose([float(v) for v in rec.losses], ref_losses,
                               rtol=1e-5)
    want = _ref_state(ref)
    for name, g in _as_reference(net.state_dict()).items():
        np.testing.assert_allclose(g, want[name], atol=5e-4, err_msg=name)
    if "accumulate_grad_batches" in kw:
        # the boundary counts batches within an epoch: batch 1 of each
        # epoch steps, batch 2's gradients carry into the next epoch
        assert model._optimizer._global_step == 2


# fit under AMP O1 in fp16 with accumulate_grad_batches 2.  The
# reference's own run cannot be the truth: its accumulation rides the eager
# tape (paddle_tpu/hapi/model.py:1176-1182), whose AMP backward raises (an
# fp16 cotangent into an fp32 output's vjp), so the port's fp16 run is held
# against the reference's fp32 run of the same recipe and batches, at fp16
# O1's rounding: losses rtol 2^-11 (one fp16 rounding; measured 1.5e-5),
# and the parameters as tests/test_torch_fp16_model.py holds them after
# AdamW steps (the error's L2 norm at most FP16_PARAM_REL_L2 of the
# reference's move, at most FP16_PARAM_SHARE of the elements further than
# 1e-4, none further than 6e-3, the sum of the two updates' rates, 1.67e-3
# and 4.38e-3: AdamW moves a weight whose gradient is rounding noise by
# the rate either way; measured 0.028, 0.34%, 5.1e-3).
FP16_LOSS_RTOL = 2.0 ** -11
FP16_PARAM_REL_L2, FP16_PARAM_SHARE, FP16_PARAM_CLOSE, FP16_PARAM_ATOL = \
    5e-2, 1e-2, 1e-4, 6e-3


def test_fp16_accumulation_tracks_the_reference():
    ref, net = _pair()
    amp = {"level": "O1", "dtype": "float16"}
    rmodel = _ref_model(ref, metrics=False)
    ref_losses = []
    np.random.seed(3)
    rmodel.fit(paddle.io.TensorDataset(TRAIN), batch_size=BATCH, epochs=2,
               verbose=0, callbacks=[_ref_recorder(ref_losses)],
               accumulate_grad_batches=2)
    model = _port_model(net, metrics=False, amp=amp)
    rec = _Record()
    np.random.seed(3)
    model.fit(TensorDataset(TRAIN), batch_size=BATCH, epochs=2, verbose=0,
              callbacks=[rec], accumulate_grad_batches=2)
    # two updates (batch 2 of each epoch), both finite at the default
    # scale 2^15, and every micro-batch's loss
    assert model._optimizer._global_step == 2
    assert not bool(model._amp_found_inf)
    assert float(model._scaler["scale"]) == 2.0 ** 15
    np.testing.assert_allclose([float(v) for v in rec.losses], ref_losses,
                               rtol=FP16_LOSS_RTOL)
    want = _ref_state(ref)
    start = _ref_state(_pair()[0])
    got = _as_reference(net.state_dict())
    err = np.concatenate([(got[k] - w).ravel() for k, w in want.items()])
    move = np.concatenate([(w - start[k]).ravel() for k, w in want.items()])
    rel = np.linalg.norm(err) / np.linalg.norm(move)
    share = float((np.abs(err) > FP16_PARAM_CLOSE).mean())
    print(f"fp16 fit, accumulate 2: relative L2 {rel:.3g}, {share:.2%} past "
          f"{FP16_PARAM_CLOSE}, worst {np.abs(err).max():.3g}")
    assert rel <= FP16_PARAM_REL_L2
    assert share <= FP16_PARAM_SHARE
    assert np.abs(err).max() <= FP16_PARAM_ATOL


def test_the_references_fp16_accumulation_raises():
    # the reason the test above holds the port against the reference's
    # fp32 run: the reference's eager AMP backward fails
    ref, _ = _pair()
    rmodel = _ref_model(ref, metrics=False,
                        amp={"level": "O1", "dtype": "float16"})
    with pytest.raises(ValueError, match="VJP"):
        rmodel.fit(paddle.io.TensorDataset(TRAIN), batch_size=BATCH,
                   epochs=1, verbose=0, accumulate_grad_batches=2)


# -- the callbacks, on a Linear(4, 2) regression in both packages -----------
def _linear_pair():
    paddle.seed(0)
    ref = paddle.nn.Linear(4, 2)
    net = torch.nn.Linear(4, 2)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(np.array(ref.weight._data).T))
        net.bias.copy_(torch.from_numpy(np.array(ref.bias._data)))
    rs = np.random.RandomState(0)
    x = rs.rand(16, 4).astype(np.float32)
    y = (x[:, :2] * 0.5 + 0.1 * rs.randn(16, 2)).astype(np.float32)
    rmodel = paddle.Model(ref)
    rmodel.prepare(paddle.optimizer.SGD(learning_rate=0.3,
                                        parameters=ref.parameters()),
                   paddle.nn.MSELoss())
    model = Model(net).prepare(SGD(0.3, parameters=net.parameters()),
                               lambda out, t: ((out - t) ** 2).mean())
    return (rmodel, paddle.io.TensorDataset([x, y])), \
        (model, TensorDataset([x, y]))


def test_early_stopping_stops_where_the_reference_stops():
    (rmodel, rds), (model, ds) = _linear_pair()
    epochs = {}
    for key, m, d, cb, base in (
            ("ref", rmodel, rds, paddle.callbacks.EarlyStopping,
             paddle.callbacks.Callback),
            ("port", model, ds, EarlyStopping, Callback)):
        seen = epochs[key] = []

        class Count(base):
            def on_epoch_end(self, epoch, logs=None):
                seen.append(epoch)

        np.random.seed(1)
        m.fit(d, eval_data=d, batch_size=4, epochs=30, verbose=0,
              callbacks=[cb(monitor="loss", patience=1, min_delta=2e-3,
                            verbose=0), Count()])
    assert epochs["port"] == epochs["ref"]
    assert 1 < len(epochs["port"]) < 30


_TIMINGS = re.compile(r" - ips: [0-9.]+ samples/s| done in [0-9.]+s")


def test_progress_bar_lines_equal_the_reference(capsys):
    (rmodel, rds), (model, ds) = _linear_pair()
    out = {}
    for key, m, d in (("ref", rmodel, rds), ("port", model, ds)):
        np.random.seed(2)
        m.fit(d, eval_data=d, batch_size=4, epochs=2, verbose=2,
              log_freq=2)
        out[key] = _TIMINGS.sub("", capsys.readouterr().out).splitlines()
    assert out["port"] == out["ref"]
    assert len(out["port"]) == 2 * (2 + 1 + 1)     # 2 log lines, epoch, eval
    assert out["port"][0].startswith("Epoch 1/2 step 0/4 - loss: ")


def test_visualdl_writes_each_steps_scalars(tmp_path):
    _, (model, ds) = _linear_pair()
    rec = _Record()
    model.fit(ds, batch_size=4, epochs=2, verbose=0, shuffle=False,
              callbacks=[rec, VisualDL(log_dir=str(tmp_path), flush_every=3)])
    lines = [json.loads(line)
             for line in open(tmp_path / "scalars.jsonl")]
    assert [r["step"] for r in lines] == [0, 1, 2, 3] * 2
    np.testing.assert_array_equal([r["loss"] for r in lines],
                                  [float(v) for v in rec.losses])


def test_checkpoints_are_read_by_the_reference(tmp_path):
    _, net = _pair()
    model = _port_model(net, metrics=False)
    model.fit(TensorDataset(TRAIN), batch_size=BATCH, epochs=2, verbose=0,
              save_dir=str(tmp_path), save_freq=1)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"{n}.{s}" for n in ("0", "1", "final")
                           for s in ("pdparams", "pdopt"))
    params = rfio.load(str(tmp_path / "final.pdparams"))
    state = net.state_dict()
    assert set(params) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(params[k]._data),
                                      v.numpy())
    opt = rfio.load(str(tmp_path / "final.pdopt"))
    assert opt["global_step"] == 6
    assert opt["LR_Scheduler"]["last_epoch"] == 6
    # and the port reads what the reference writes
    rfio.save({"w": params["wte.weight"], "n": 3}, str(tmp_path / "r.pd"))
    back = framework_io.load(str(tmp_path / "r.pd"))
    assert back["n"] == 3 and torch.equal(back["w"], state["wte.weight"])


def test_save_and_load_round_trip(tmp_path):
    _, net = _pair()
    model = _port_model(net, metrics=False)
    model.fit(TensorDataset(TRAIN), batch_size=BATCH, epochs=1, verbose=0)
    model.save(str(tmp_path / "ckpt"))
    _, other = _pair()
    restored = _port_model(other, metrics=False)
    restored.load(str(tmp_path / "ckpt"))
    for k, v in net.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    a, b = model._optimizer, restored._optimizer
    assert b._lr_scheduler.last_epoch == a._lr_scheduler.last_epoch == 3
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k, v in sa.items():
        assert torch.equal(sb[k], v) if isinstance(v, torch.Tensor) \
            else sb[k] == v, k
    # both continue alike
    batch = ([TRAIN[0][:4]], [TRAIN[1][:4]])
    assert torch.equal(model.train_batch(*batch)["loss"],
                       restored.train_batch(*batch)["loss"])


class _CountingLoss:
    """A loss whose every read is counted."""

    reads = 0

    def __init__(self, v):
        self.v = v

    def __float__(self):
        type(self).reads += 1
        return float(self.v)


numbers.Number.register(_CountingLoss)


@pytest.mark.parametrize("verbose,most", [(0, 0), (2, 20 // 5 + 2)])
def test_fit_reads_the_loss_at_most_once_per_log_window(monkeypatch, verbose,
                                                        most):
    _, (model, _) = _linear_pair()
    rs = np.random.RandomState(4)
    x = rs.rand(80, 4).astype(np.float32)
    ds = TensorDataset([x, x[:, :2]])
    real = model.train_batch

    def counted(*a, **kw):
        logs = real(*a, **kw)
        logs["loss"] = _CountingLoss(logs["loss"])
        return logs
    monkeypatch.setattr(model, "train_batch", counted)
    _CountingLoss.reads = 0
    model.fit(ds, batch_size=4, epochs=1, verbose=verbose, log_freq=5,
              shuffle=False)
    assert _CountingLoss.reads <= most
    if verbose:
        assert _CountingLoss.reads > 0
