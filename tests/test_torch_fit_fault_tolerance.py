"""``Model.fit``'s checkpointer and nan/inf loss guard against the
reference's (``paddle_tpu/hapi/model.py:697-934, 1017-1281``).

Resume: a run that saved to an ``AsyncCheckpointer`` and stopped, then a
fresh model (re-initialised from another seed) resumed from it through
``fit(checkpointer=...)``, equals one uninterrupted run bit for bit in
its last losses, parameters, optimizer slots and step count: on the SMALL
GPT of ``tests/test_models.py:18`` (with dropout, which draws from the
random state the tree carries) in fp32 and under O1 bf16, captured and
eager, and on the reference's ``_FitDS`` linear model
(``tests/test_resilience.py:531-555``) with its weights carried across,
whose resumed losses also track the reference's own resumed run.

The guard: ``FLAGS_anomaly_action`` ``raise``, ``skip`` and ``rollback``
with ``FLAGS_chaos_spec`` ``step.loss:nan@k`` give the reference's
exception text, warnings and ``train.anomaly`` count, and losses that
track the reference's at ``tests/test_torch_fit.py``'s tolerance (rtol
1e-5; parameters atol 5e-4).  ``skip`` equals, bit for bit, a hand loop
that copies the state before the poisoned step and back after it.

The gaps the port copies: the tree holds neither the LR scheduler (a
resumed run's scheduler starts fresh, and the replayed batches fire no
callback) nor the fp16 loss scaler's state.
"""
import re
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as rckpt
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig
from paddle_tpu.profiler import metrics as rmetrics
from paddle_tpu.utils import chaos as rchaos

import paddle_tpu_torch
from paddle_tpu_torch import Model
from paddle_tpu_torch.callbacks import Callback
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Adam, AdamW, lr
from paddle_tpu_torch.profiler import metrics
from paddle_tpu_torch.utils import chaos

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=32, ffn_mult=2)            # tests/test_models.py:18
T, BATCH, N_STEPS, SAVE_AT = 16, 4, 12, 6


@pytest.fixture(autouse=True)
def _teardown():
    yield
    for c in (chaos, rchaos):
        c.reset()
    for f in (paddle_tpu_torch.set_flags, paddle.set_flags):
        f({"FLAGS_anomaly_action": ""})


def _gpt_data(n):
    ids = np.random.RandomState(0).randint(0, SMALL["vocab_size"], (n, T))
    return [ids, np.roll(ids, -1, 1).reshape(n, T, 1)]


class _Losses(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))


def _reseed():
    paddle_tpu_torch.seed(0)
    torch.manual_seed(0)


def _gpt_model(seed, jit, amp):
    net = GPT(GPTConfig(**SMALL, dropout=0.1), device="cpu", seed=seed)
    _reseed()
    return Model(net).prepare(
        AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01),
        CrossEntropyLoss(), jit=jit, amp_configs=amp)


def _fit(model, data, steps, checkpointer=None, **kw):
    rec = _Losses()
    model.fit(TensorDataset([a[:steps * BATCH] for a in data]),
              batch_size=BATCH, shuffle=False, verbose=0,
              checkpointer=checkpointer, callbacks=[rec], **kw)
    return rec.losses


def _state(model):
    fs = model._optimizer.functional_state()
    return dict(params={k: v.clone() for k, v in
                        model.network.state_dict().items()},
                slots={f"{n}.{k}": v.clone() for n, s in fs["slots"].items()
                       for k, v in s.items()},
                master={n: v.clone() for n, v in fs["master"].items()},
                step=fs["step"])


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for part in ("params", "slots", "master"):
        assert a[part].keys() == b[part].keys(), part
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)


def _resume_run(make, data, tmp_path):
    """(uninterrupted model, its losses, resumed model, its losses): U
    over N_STEPS batches; S over SAVE_AT with a checkpointer saving every
    5th step (steps 1 and 6); R, a fresh model from another seed, over
    the same N_STEPS batches resuming from S's directory."""
    U = make(0)
    lu = _fit(U, data, N_STEPS)
    d = str(tmp_path / "ckpt")
    ckptr = ckpt.AsyncCheckpointer(d, max_to_keep=2, save_interval_steps=5)
    _fit(make(0), data, SAVE_AT, ckptr)
    ckptr.close()
    assert ckptr.all_steps() == [1, SAVE_AT]
    R = make(1)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        lr_ = _fit(R, data, N_STEPS, ckpt.AsyncCheckpointer(d))
    assert any(f"resumed from checkpoint at step {SAVE_AT}" in str(w.message)
               for w in rec)
    return U, lu, R, lr_, d


@pytest.mark.parametrize("jit", [True, False], ids=["captured", "eager"])
@pytest.mark.parametrize("amp", [None, "O1"], ids=["fp32", "o1_bf16"])
def test_resume_equals_an_uninterrupted_run(tmp_path, jit, amp):
    data = _gpt_data(N_STEPS * BATCH)
    U, lu, R, lr_, d = _resume_run(lambda s: _gpt_model(s, jit, amp), data,
                                   tmp_path)
    assert len(lr_) == N_STEPS - SAVE_AT       # the replayed batches fire
    assert lr_ == lu[SAVE_AT:]                 # no callback
    _assert_same_state(_state(U), _state(R))
    rckpt.verify_checkpoint(f"{d}/{N_STEPS}")
    assert ckpt.AsyncCheckpointer(d).all_steps() == [10, 11, 12]


# ---------------------------------------------------------------------------
# the reference's _FitDS linear model, weights carried across
# ---------------------------------------------------------------------------
def _lin_xy(n=8):
    xs, ys = [], []
    for i in range(n):            # tests/test_resilience.py:544-552
        rng = np.random.RandomState(i)
        xs.append(rng.rand(4).astype(np.float32))
        ys.append(rng.rand(2).astype(np.float32))
    return np.stack(xs), np.stack(ys)


class _RefDS(paddle.io.Dataset):
    def __init__(self, n=8):
        self.x, self.y = _lin_xy(n)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _lin_pair(jit=True):
    """The reference's ``_fit_model`` (:531-538) and the port's twin."""
    paddle.seed(0)
    rnet = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.ReLU(),
                                paddle.nn.Linear(8, 2))
    rmodel = paddle.Model(rnet)
    rmodel.prepare(paddle.optimizer.Adam(1e-3, parameters=rnet.parameters()),
                   paddle.nn.MSELoss())
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 2))
    ref = rnet.functional_state()[0]
    net.load_state_dict({k: torch.from_numpy(np.array(v).T.copy()
                                             if v.ndim == 2 else np.array(v))
                         for k, v in ref.items()})
    model = Model(net).prepare(Adam(1e-3, parameters=net.parameters()), _mse,
                               jit=jit)
    return rmodel, model


def _ref_params(rmodel):
    return {k: np.array(v).T if v.ndim == 2 else np.array(v)
            for k, v in rmodel.network.functional_state()[0].items()}


def _assert_tracks(rmodel, model, rlosses, losses):
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    for k, v in _ref_params(rmodel).items():
        np.testing.assert_allclose(model.network.state_dict()[k].numpy(), v,
                                   atol=5e-4, err_msg=k)


def _ref_fit(rmodel, epochs, checkpointer=None, callbacks=()):
    losses = []

    class Rec(paddle.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))
    rmodel.fit(_RefDS(), batch_size=4, epochs=epochs, verbose=0,
               shuffle=False, checkpointer=checkpointer,
               callbacks=[Rec(), *callbacks])
    return losses


def _port_fit(model, epochs, checkpointer=None, callbacks=()):
    rec = _Losses()
    model.fit(TensorDataset(list(_lin_xy())), batch_size=4, epochs=epochs,
              verbose=0, shuffle=False, checkpointer=checkpointer,
              callbacks=[rec, *callbacks])
    return rec.losses


def test_linear_resume_is_bit_exact_and_tracks_the_references(tmp_path):
    U = _lin_pair()[1]
    lu = _port_fit(U, 6)
    out = {}
    for pkg, mod in (("port", ckpt), ("ref", rckpt)):
        d = str(tmp_path / pkg)
        rmodel, model = _lin_pair()
        c = mod.AsyncCheckpointer(d, max_to_keep=2)
        (_port_fit(model, 3, c) if pkg == "port" else
         _ref_fit(rmodel, 3, c))
        c.close()
        rmodel, model = _lin_pair()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            c = mod.AsyncCheckpointer(d, max_to_keep=2)
            out[pkg] = (_port_fit(model, 6, c) if pkg == "port" else
                        _ref_fit(rmodel, 6, c)), (model, rmodel)
            c.close()
    losses, (model, _) = out["port"]
    rlosses, (_, rmodel) = out["ref"]
    assert losses == lu[6:] and len(losses) == 6
    _assert_same_state(_state(U), _state(model))
    _assert_tracks(rmodel, model, rlosses, losses)


# ---------------------------------------------------------------------------
# the anomaly guard
# ---------------------------------------------------------------------------
def _guarded(pkg, action, spec, tmp_path, with_ckpt, epochs=4):
    """One guarded fit of the linear model in ``pkg``: (losses, warnings
    about the guard and the restore, train.anomaly's rise, the error's
    text or None, the model)."""
    rmodel, model = _lin_pair()
    port = pkg == "port"
    flags, chaos_mod = ((paddle_tpu_torch.set_flags, chaos) if port else
                        (paddle.set_flags, rchaos))
    met = metrics if port else rmetrics
    ckptr, cbs = None, ()
    if with_ckpt:
        d = str(tmp_path / pkg)
        ckptr = (ckpt if port else rckpt).AsyncCheckpointer(d)
        # each save lands before the next step, so that the restored step
        # does not depend on the writer thread's timing
        wait = (Callback if port else paddle.hapi.callbacks.Callback)
        cbs = (type("Wait", (wait,), {
            "on_train_batch_end": lambda self, s, logs=None:
                ckptr.wait_until_finished()})(),)
    flags({"FLAGS_anomaly_action": action})
    chaos_mod.configure(spec, seed=0)
    before = met.counter("train.anomaly").value
    error, losses = None, []
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            losses = (_port_fit(model, epochs, ckptr, cbs) if port else
                      _ref_fit(rmodel, epochs, ckptr, cbs))
        except FloatingPointError as e:
            error = str(e)
    if ckptr is not None:
        ckptr.close()
    said = [re.sub(r"from \S+ \(", "from <dir> (", str(w.message))
            for w in rec if re.search("anomal|roll|revert|resumed|restore",
                                      str(w.message))]
    return losses, said, met.counter("train.anomaly").value - before, \
        error, (model if port else rmodel)


CASES = {"raise": ("raise", "step.loss:nan@2", False),
         "skip": ("skip", "step.loss:nan@3", False),
         "skip_seeded": ("skip", "step.loss:nan@p=0.4", False),
         "rollback": ("rollback", "step.loss:nan@5", True),
         "rollback_without_checkpointer": ("rollback", "step.loss:nan@3",
                                           False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_guard_matches_the_reference(tmp_path, case):
    action, spec, with_ckpt = CASES[case]
    got = {pkg: _guarded(pkg, action, spec, tmp_path, with_ckpt)
           for pkg in ("port", "ref")}
    losses, said, rise, error, model = got["port"]
    rlosses, rsaid, rrise, rerror, rmodel = got["ref"]
    assert error == rerror
    assert said == rsaid
    assert rise == rrise >= 1
    if action == "raise":
        assert "train step 2" in error and losses == rlosses == []
        return
    nan = [i for i, v in enumerate(losses) if not np.isfinite(v)]
    assert nan == [i for i, v in enumerate(rlosses) if not np.isfinite(v)]
    finite = [i for i in range(len(losses)) if i not in nan]
    np.testing.assert_allclose(np.array(losses)[finite],
                               np.array(rlosses)[finite], rtol=1e-5)
    for k, v in _ref_params(rmodel).items():
        np.testing.assert_allclose(model.network.state_dict()[k].numpy(), v,
                                   atol=5e-4, err_msg=k)


def test_skip_equals_a_hand_reverted_loop():
    """``skip`` reverts the whole step: the same bits as a hand loop of
    captured ``train_batch`` that clones the state before batch 3 and
    copies it back after it."""
    jit = True
    _, model = _lin_pair(jit)
    paddle_tpu_torch.set_flags({"FLAGS_anomaly_action": "skip"})
    chaos.configure("step.loss:nan@3", seed=0)
    with pytest.warns(UserWarning, match="step reverted"):
        losses = _port_fit(model, 2)
    chaos.reset()
    paddle_tpu_torch.set_flags({"FLAGS_anomaly_action": ""})
    _, hand = _lin_pair(jit)
    x, y = _lin_xy()
    hand_losses = []
    for step in range(4):
        i = (step % 2) * 4
        if step == 2:
            keep = _state(hand)
        hand_losses.append(float(hand.train_batch([x[i:i + 4]],
                                                  [y[i:i + 4]])["loss"]))
        if step == 2:
            with torch.no_grad():
                for k, v in hand.network.state_dict().items():
                    v.copy_(keep["params"][k])
                fs = hand._optimizer.functional_state()
                for n, s in fs["slots"].items():
                    for k, v in s.items():
                        v.copy_(keep["slots"][f"{n}.{k}"])
                hand._optimizer._global_step = keep["step"]
    assert np.isnan(losses[2])
    assert [v for i, v in enumerate(losses) if i != 2] == \
        [v for i, v in enumerate(hand_losses) if i != 2]
    _assert_same_state(_state(model), _state(hand))


def test_check_nan_inf_raises_at_the_step():
    _, model = _lin_pair()
    x, y = _lin_xy()
    paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf": True})
    chaos.configure("step.loss:nan@2", seed=0)
    try:
        model.train_batch([x[:4]], [y[:4]])
        with pytest.raises(FloatingPointError,
                           match="nan at train step 2 .FLAGS_check_nan_inf"):
            model.train_batch([x[:4]], [y[:4]])
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf": False})


def test_step_loss_is_a_site_of_the_captured_step_only():
    """As in the reference (:463-468, 601-604), the uncaptured step
    (``jit=False``, ``update=False``) visits no ``step.loss`` site."""
    _, model = _lin_pair(jit=False)
    x, y = _lin_xy()
    chaos.configure("step.loss:nan", seed=0)
    assert np.isfinite(float(model.train_batch([x[:4]], [y[:4]])["loss"]))
    assert chaos.call_count("step.loss") == 0


def test_host_slow_visits_every_fit_step(monkeypatch):
    import time
    _, model = _lin_pair()
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    chaos.configure("host.slow:delay=0.15@2-3", seed=0)
    _port_fit(model, 2)
    assert chaos.call_count("host.slow") == 4 and slept == [0.15, 0.15]


# ---------------------------------------------------------------------------
# the reference's gaps, copied
# ---------------------------------------------------------------------------
def test_the_lr_scheduler_is_not_in_the_tree_and_restarts(tmp_path):
    """A resumed run's scheduler starts fresh and the replayed batches
    step it not: after resuming at step 3 of 6, it has taken 3 steps, in
    both packages."""
    stepped = {}
    for pkg in ("port", "ref"):
        for stage, epochs in (("save", 3), ("resume", 6)):
            rmodel, model = _lin_pair()
            if pkg == "port":
                sched = lr.StepDecay(0.01, step_size=2, gamma=0.5)
                model.prepare(Adam(sched,
                                   parameters=model.network.parameters()),
                              _mse)
                c = ckpt.AsyncCheckpointer(str(tmp_path / pkg))
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    _port_fit(model, epochs, c)
                tree = model._ckpt_tree(0)
            else:
                sched = paddle.optimizer.lr.StepDecay(0.01, step_size=2,
                                                      gamma=0.5)
                rmodel.prepare(paddle.optimizer.Adam(
                    sched, parameters=rmodel.network.parameters()),
                    paddle.nn.MSELoss())
                c = rckpt.AsyncCheckpointer(str(tmp_path / pkg))
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    _ref_fit(rmodel, epochs, c)
                tree = rmodel._ckpt_tree(0)
            c.close()
            assert sorted(tree) == ["buffers", "meta", "opt", "params"]
            stepped[(pkg, stage)] = (sched.last_epoch, sched())
    assert stepped[("port", "resume")] == stepped[("ref", "resume")]
    assert stepped[("port", "resume")][0] == stepped[("port", "save")][0]


def test_the_loss_scaler_is_not_in_the_tree(tmp_path):
    """The fp16 scaler's state (``_amp_scaler_state``) is not saved: a
    resumed fp16 model starts from ``init_loss_scaling`` again."""
    net = GPT(GPTConfig(**SMALL), device="cpu", seed=0)
    amp = {"level": "O1", "dtype": "float16", "init_loss_scaling": 2.0 ** 10,
           "incr_every_n_steps": 1}
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss(), amp_configs=amp)
    data = _gpt_data(3 * BATCH)
    c = ckpt.AsyncCheckpointer(str(tmp_path / "c"))
    _fit(model, data, 3, c)
    c.close()
    assert float(model._scaler["scale"]) == 2.0 ** 13
    keys = [".".join(map(str, p)) for p, _ in
            ckpt._flatten(model._ckpt_tree(3))]
    assert not any("scale" in k or "found_inf" in k for k in keys)
    paddle.seed(0)
    rnet = RefGPT(RefConfig(**SMALL))
    rmodel = paddle.Model(rnet)
    rmodel.prepare(paddle.optimizer.AdamW(1e-3,
                                          parameters=rnet.parameters()),
                   paddle.nn.CrossEntropyLoss())
    assert sorted(rmodel._ckpt_tree(0)) == sorted(model._ckpt_tree(0))
    twin = GPT(GPTConfig(**SMALL), device="cpu", seed=1)
    fresh = Model(twin).prepare(AdamW(1e-3, parameters=twin.parameters()),
                                CrossEntropyLoss(), amp_configs=amp)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh._fit_resume(ckpt.AsyncCheckpointer(str(tmp_path / "c")))
    assert fresh._scaler["scale"] is None     # made anew at the next step
    assert torch.equal(fresh.network.wte.weight, net.wte.weight)


def test_resume_raises_on_a_tree_of_another_model(tmp_path):
    # only a corrupt tree is passed over; a tree this model cannot hold (a
    # parameter of another shape) raises, and the live state is untouched
    _, model = _lin_pair()
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = model._ckpt_tree(3)
    tree["params"] = dict(tree["params"], **{"0.weight": torch.zeros(5, 4)})
    c.save(3, tree)
    c.close()
    before = {k: v.clone() for k, v in model.network.state_dict().items()}
    with pytest.raises(ValueError, match="0.weight"):
        model._fit_resume(ckpt.AsyncCheckpointer(str(tmp_path)))
    for k, v in model.network.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_cross_world_resume_derives_the_rank_seed(tmp_path, monkeypatch):
    """A tree saved at data-parallel world 2 and resumed at world 1 on rank
    3 reseeds the random state with ``derive_rank_seed`` of the saved seed
    and the new rank, keeping the draw count, in both packages (the
    reference's :784-793)."""
    from paddle_tpu.core.random import default_generator as rgen
    from paddle_tpu_torch.random import default_generator as gen
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    seeds = {}
    for pkg, mod in (("port", ckpt), ("ref", rckpt)):
        rmodel, model = _lin_pair()
        m = model if pkg == "port" else rmodel
        paddle_tpu_torch.seed(11)
        paddle.seed(11)
        gen.draw_seeds(5)
        draws = gen.draws
        m._fit_data_world = 2
        c = mod.AsyncCheckpointer(str(tmp_path / pkg))
        c.save(4, m._ckpt_tree(4))
        c.close()
        paddle_tpu_torch.seed(0)
        paddle.seed(0)
        with pytest.warns(UserWarning, match="saved at data-parallel world 2"):
            info = m._fit_resume(mod.AsyncCheckpointer(str(tmp_path / pkg)),
                                 data_world=1)
        assert (info["step"], info["world"]) == (4, 2)
        seeds[pkg] = gen._seed if pkg == "port" else rgen._seed
        if pkg == "port":
            assert gen.draws == draws
    assert seeds["port"] == seeds["ref"] == ckpt.derive_rank_seed(11, 3)


# the reference's cross-world fit scenarios (tests/test_reshard.py:262-408):
# (dataset size, batch, world saved at, its num_iters and epochs, world
# resumed at)
CROSS_WORLD = {"shrink": (48, 2, 4, 3, 1, 2),
               "multi_epoch_padding": (10, 1, 4, 5, 2, 2),
               "grow": (48, 2, 2, 4, 1, 4)}


def _idx_xy(n):
    xs = [np.random.RandomState(i).rand(4).astype(np.float32)
          for i in range(n)]
    return np.stack(xs), np.stack([(x.sum(keepdims=True) * 0.5)
                                   .astype(np.float32) for x in xs])


def _cross_world_fit(pkg, tmp_path, monkeypatch, case):
    n, batch, w0, iters, epochs, w1 = CROSS_WORLD[case]
    x, y = _idx_xy(n)
    port = pkg == "port"
    mod = ckpt if port else rckpt

    def make():
        paddle.seed(0)
        if not port:
            net = paddle.nn.Sequential(paddle.nn.Linear(4, 8),
                                       paddle.nn.Tanh(),
                                       paddle.nn.Linear(8, 1))
            m = paddle.Model(net)
            m.prepare(paddle.optimizer.Adam(1e-2,
                                            parameters=net.parameters()),
                      paddle.nn.MSELoss())
            return m
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                  torch.nn.Linear(8, 1))
        return Model(net).prepare(Adam(1e-2, parameters=net.parameters()),
                                  _mse)

    def loader(world):
        if port:
            from paddle_tpu_torch.io import DataLoader, DistributedBatchSampler
            ds = TensorDataset([x, y])
            return DataLoader(ds, batch_sampler=DistributedBatchSampler(
                ds, batch_size=batch, num_replicas=world, rank=0))
        ds = paddle.io.TensorDataset([x, y])
        return paddle.io.DataLoader(ds, batch_sampler=(
            paddle.io.DistributedBatchSampler(
                ds, batch_size=batch, num_replicas=world, rank=0)))

    trained = []
    base = Callback if port else paddle.hapi.callbacks.Callback

    class Rec(base):
        def on_train_batch_end(self, step, logs=None):
            trained.append((self.model._fit_epoch, step))

    d = str(tmp_path / pkg)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(w0))
    m = make()
    c = mod.AsyncCheckpointer(d, max_to_keep=8)
    m.fit(loader(w0), epochs=epochs, verbose=0, num_iters=iters,
          checkpointer=c, prefetch_to_device=0)
    c.close()
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(w1))
    m2 = make()
    c2 = mod.AsyncCheckpointer(d, max_to_keep=8)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m2.fit(loader(w1), epochs=epochs, verbose=0, checkpointer=c2,
               callbacks=[Rec()], prefetch_to_device=0)
    c2.close()
    said = sorted({re.sub(r"from \S+ \(", "(", str(w.message))
                   for w in rec if "resum" in str(w.message)})
    return dict(trained=trained, samples=m2._fit_samples_seen,
                steps=c2.all_steps(), said=said)


@pytest.mark.parametrize("case", sorted(CROSS_WORLD))
def test_cross_world_fit_resume_matches_the_reference(tmp_path, monkeypatch,
                                                      case):
    port = _cross_world_fit("port", tmp_path, monkeypatch, case)
    ref = _cross_world_fit("ref", tmp_path, monkeypatch, case)
    assert port == ref
    assert any("resharded resume" in m for m in port["said"])
