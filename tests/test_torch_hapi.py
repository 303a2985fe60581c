"""The eager-GPT train path of paddle_tpu_torch against the JAX reference.

``Model(GPT).prepare(AdamW, CrossEntropyLoss).train_batch`` runs in both
packages from the same weights (the reference's SMALL GPT of
``tests/test_models.py:18``, carried across with
``gpt_state_from_paddle_tpu``) on the same ids and labels (labels = ids
rolled by one, ``tests/test_models.py:57-58``).  On the CPU the port's
attention runs its autograd function with the kernels' plain versions.
Also held against the reference: ``eval_batch``, ``predict_batch``,
``cross_entropy`` and the optimizers' eager ``step()``.

Tolerances, fp32 (``tests/test_torch_train_step.py``): losses rtol 1e-5;
parameters after three steps atol 5e-4, because AdamW maps a gradient
near eps (1e-8) to an update of order lr, so a last-digit difference in
such a gradient moves the parameter by a fraction of lr; logits 1e-4
(``tests/test_torch_gpt.py``); cross entropy 1e-6; an eager optimizer
step on a Linear(4, 2) 1e-6.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig
from paddle_tpu.ops import loss as rloss

import paddle_tpu_torch
from paddle_tpu_torch import Model
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.nn import torch_view
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.ops.loss import cross_entropy
from paddle_tpu_torch.callbacks import ProfilerCallback
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=32, ffn_mult=2)            # tests/test_models.py:18
B, T, STEPS = 4, 16, 3


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMALL["vocab_size"], (B, T)).astype(np.int32)
    labels = np.roll(ids, -1, 1).reshape(B, T, 1).astype(np.int64)
    return ids, labels


def _state(net):
    """The reference's parameters as numpy copies (its step donates)."""
    return {k: np.array(v) for k, v in net.functional_state()[0].items()}


def _as_reference(state):
    return {k: v.detach().numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def trained():
    paddle.seed(0)
    ref = RefGPT(RefConfig(**SMALL))
    net = GPT(GPTConfig(**SMALL), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(_state(ref), device="cpu"),
                        strict=True)
    rmodel = paddle.Model(ref)
    rmodel.prepare(paddle.optimizer.AdamW(1e-3, parameters=ref.parameters(),
                                          weight_decay=0.01),
                   paddle.nn.CrossEntropyLoss())
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters(),
                                     weight_decay=0.01), CrossEntropyLoss())
    ids, labels = _batch()
    out = {"ref_loss": [], "loss": []}
    for _ in range(STEPS):
        out["ref_loss"].append(float(rmodel.train_batch([ids], [labels])
                                     ["loss"]))
        logs = model.train_batch([ids], [labels])
        assert logs["loss"].dim() == 0
        out["loss"].append(float(logs["loss"]))
    out.update(ref=ref, net=net, rmodel=rmodel, model=model)
    return out


def test_train_batch_losses_track_the_reference(trained):
    np.testing.assert_allclose(trained["loss"][0], trained["ref_loss"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(trained["loss"], trained["ref_loss"],
                               rtol=1e-5)
    assert trained["loss"][-1] < trained["loss"][0]


def test_parameters_after_three_steps_match(trained):
    want = _state(trained["ref"])
    got = _as_reference(torch_view(trained["net"]).state_dict())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=5e-4, err_msg=name)


def test_eval_and_predict_batch_match(trained):
    ids, labels = _batch()
    want = trained["rmodel"].eval_batch([ids], [labels])["loss"]
    got = trained["model"].eval_batch([ids], [labels])["loss"]
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    r_logits = trained["rmodel"].predict_batch([ids])
    logits = trained["model"].predict_batch([ids])
    assert len(logits) == 1 and logits[0].shape == (B, T, SMALL["vocab_size"])
    np.testing.assert_allclose(logits[0], r_logits[0], atol=1e-4)
    assert trained["model"].eval_batch([ids]) == {}


def _ce_inputs():
    rs = np.random.RandomState(1)
    logits = rs.randn(3, 5, 7).astype(np.float32)
    labels = rs.randint(0, 7, (3, 5, 1)).astype(np.int64)
    labels[0, 1, 0] = labels[2, 4, 0] = -100
    weight = rs.rand(7).astype(np.float32) + 0.5
    soft = rs.rand(3, 5, 7).astype(np.float32)
    return logits, labels, weight, soft / soft.sum(-1, keepdims=True)


@pytest.mark.parametrize("kw", [
    dict(), dict(reduction="sum"), dict(reduction="none"),
    dict(weight=True), dict(weight=True, reduction="none"),
    dict(label_smoothing=0.1), dict(label_smoothing=0.1, weight=True),
    dict(squeeze=True), dict(ignore_index=3), dict(soft_label=True),
    dict(soft_label=True, label_smoothing=0.2, reduction="sum"),
    dict(use_softmax=False), dict(axis=1)])
def test_cross_entropy_matches_reference(kw):
    logits, labels, weight, soft = _ce_inputs()
    kw = dict(kw)
    lab = soft if kw.get("soft_label") else labels
    if kw.pop("squeeze", False):
        lab = lab[..., 0]
    w = weight if kw.pop("weight", False) else None
    if not kw.get("use_softmax", True):       # probabilities, some zero
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        logits[0, 0, 0] = 0.0
    if kw.get("axis") == 1:                   # classes on axis 1 (5 of them)
        lab = np.random.RandomState(2).randint(0, 5, (3, 1, 7))
        lab[1, 0, 2] = -100
    want = np.asarray(rloss.cross_entropy(
        Tensor(jnp.asarray(logits)), Tensor(jnp.asarray(lab)),
        weight=None if w is None else Tensor(jnp.asarray(w)), **kw)._data)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab),
                        weight=None if w is None else torch.from_numpy(w),
                        **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_layer_and_bad_reduction():
    logits, labels, _, _ = _ce_inputs()
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    torch.testing.assert_close(CrossEntropyLoss(reduction="sum")(x, y),
                               cross_entropy(x, y, reduction="sum"))
    with pytest.raises(ValueError, match="reduction"):
        cross_entropy(x, y, reduction="max")


def _linear_pair(seed):
    paddle.seed(seed)
    ref = paddle.nn.Linear(4, 2)
    net = torch.nn.Linear(4, 2)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(np.array(ref.weight._data).T))
        net.bias.copy_(torch.from_numpy(np.array(ref.bias._data)))
    return ref, net


def _eager_steps(ref_opt, ref, opt, net, steps=3):
    rs = np.random.RandomState(7)
    x = rs.randn(6, 4).astype(np.float32)
    y = rs.randn(6, 2).astype(np.float32)
    for _ in range(steps):
        loss = ((ref(Tensor(jnp.asarray(x))) - Tensor(jnp.asarray(y)))
                ** 2).mean()
        loss.backward()
        ref_opt.step()
        ref_opt.clear_grad()
        ((net(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean() \
            .backward()
        opt.step()
        opt.clear_grad()
    return (np.array(ref.weight._data).T, np.array(ref.bias._data),
            net.weight.detach().numpy(), net.bias.detach().numpy())


@pytest.mark.parametrize("kind", ["sgd", "adam", "adamw", "adamw_fun"])
def test_eager_step_matches_reference(kind):
    ref, net = _linear_pair(0)
    common = dict(learning_rate=0.1)
    if kind == "sgd":
        ref_opt = paddle.optimizer.SGD(parameters=ref.parameters(),
                                       weight_decay=0.5, **common)
        opt = SGD(parameters=net.parameters(), weight_decay=0.5, **common)
    elif kind == "adam":
        ref_opt = paddle.optimizer.Adam(parameters=ref.parameters(),
                                        weight_decay=0.5, **common)
        opt = Adam(parameters=net.parameters(), weight_decay=0.5, **common)
    else:
        ref_fun = fun = None
        if kind == "adamw_fun":           # decay the weight only
            ref_fun = (lambda n, w=ref.weight.name: n == w)
            fun = (lambda n: n == "weight")
        ref_opt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                         weight_decay=0.5,
                                         apply_decay_param_fun=ref_fun,
                                         **common)
        opt = AdamW(parameters=net.named_parameters(), weight_decay=0.5,
                    apply_decay_param_fun=fun, **common)
    rw, rb, w, b = _eager_steps(ref_opt, ref, opt, net)
    np.testing.assert_allclose(w, rw, atol=1e-6)
    np.testing.assert_allclose(b, rb, atol=1e-6)


def test_adamw_decay_moves_the_weights_as_the_reference_does():
    # lr 0.1, three steps: weight_decay 0.5 against 0 (the reference
    # differs by ~0.1 on this Linear(4, 2))
    out = {}
    for wd in (0.5, 0.0):
        ref, net = _linear_pair(0)
        ref_opt = paddle.optimizer.AdamW(0.1, parameters=ref.parameters(),
                                         weight_decay=wd)
        opt = AdamW(0.1, parameters=net.parameters(), weight_decay=wd)
        out[wd] = _eager_steps(ref_opt, ref, opt, net)
    ref_gap = np.abs(out[0.5][0] - out[0.0][0]).max()
    gap = np.abs(out[0.5][2] - out[0.0][2]).max()
    assert ref_gap > 0.05
    np.testing.assert_allclose(gap, ref_gap, atol=1e-6)


def test_optimizer_state_dict_round_trip():
    _, net = _linear_pair(1)
    opt = AdamW(0.1, parameters=net.named_parameters())
    net(torch.ones(3, 4)).sum().backward()
    opt.step()
    sd = opt.state_dict()
    assert sd["global_step"] == 1
    assert set(sd) == {"global_step"} | {
        f"{n}_{k}" for n in ("weight", "bias")
        for k in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
    assert sd["weight_beta1_pow"].item() == pytest.approx(0.9)
    _, other = _linear_pair(1)
    fresh = AdamW(0.1, parameters=other.named_parameters())
    fresh.set_state_dict(sd)
    assert fresh.state_dict()["global_step"] == 1
    torch.testing.assert_close(fresh.state_dict()["weight_moment1"],
                               sd["weight_moment1"])
    assert opt.get_lr() == 0.1
    opt.clear_grad(set_to_zero=True)
    assert not net.weight.grad.any()


def test_model_names_the_parameters_for_the_decay_rule():
    _, net = _linear_pair(2)
    seen = []
    opt = AdamW(0.1, parameters=net.parameters(),
                apply_decay_param_fun=lambda n: seen.append(n) or True)
    model = Model(net).prepare(opt, lambda out, y: ((out - y) ** 2).mean())
    model.train_batch([np.ones((2, 4), np.float32)],
                      [np.zeros((2, 2), np.float32)])
    assert sorted(seen) == ["bias", "weight"]
    logs = model.train_batch([np.ones((2, 4), np.float32)],
                             [np.zeros((2, 2), np.float32)], update=False)
    assert net.weight.grad is not None and float(logs["loss"]) >= 0


# the knobs that still wait, each with the ROADMAP.md item its error
# names; a knob ported since keeps its case, which checks what it does now
# (None): multi_precision, regularizers, decorate with optimizers,
# summary, offload, the budget remat, fit's checkpointer and its anomaly
# guard, ProfilerCallback and lazy_mode (a sparse gradient's rows-only
# update) are ported; the supervisor's heartbeat waits for the
# distributed launch (A5)
KNOBS = {"multi_precision": None, "lazy_mode": None, "regularizer": None,
         "amp": None, "offload": None, "remat": None, "checkpointer": None,
         "anomaly_action": None, "supervise_store": "A5",
         "profiler_callback": None, "save_export": "A6", "summary": None}


@contextlib.contextmanager
def _port_flags(flags):
    """The port's flags set for the block, then restored."""
    was = paddle_tpu_torch.get_flags(list(flags))
    paddle_tpu_torch.set_flags(flags)
    try:
        yield
    finally:
        paddle_tpu_torch.set_flags(was)


def _ported_knob(knob, net, params, tmp_path):
    """What a ported knob does on the Linear(4, 2) ``net``."""
    if knob == "multi_precision":
        net.to(torch.bfloat16)
        opt = AdamW(parameters=params, multi_precision=True)
        net(torch.ones(2, 4, dtype=torch.bfloat16)).float().sum().backward()
        opt.step()
        for p in params:
            master = opt._master_weights[id(p)]
            assert master.dtype == torch.float32
            assert torch.equal(p.detach(), master.to(torch.bfloat16))
    elif knob == "lazy_mode":
        # taken and read nowhere, as in the reference: a sparse gradient
        # moves the touched rows only, with lazy_mode set or not
        moved = []
        for lazy in (True, False):
            torch.manual_seed(0)
            emb = torch.nn.Embedding(6, 2, sparse=True)
            before = emb.weight.detach().clone()
            opt = Adam(parameters=emb.parameters(), lazy_mode=lazy)
            emb(torch.tensor([0, 3])).sum().backward()
            opt.step()
            moved.append((emb.weight.detach() != before).any(1).tolist())
        assert moved[0] == moved[1] == [True, False, False, True, False,
                                        False]
    elif knob == "regularizer":
        from paddle_tpu_torch.regularizer import L2Decay
        _, twin = _linear_pair(3)
        for n, opt in ((net, SGD(parameters=params,
                                 weight_decay=L2Decay(0.1))),
                       (twin, SGD(parameters=twin.parameters(),
                                  weight_decay=0.1))):
            n(torch.ones(2, 4)).sum().backward()
            opt.step()
        assert torch.equal(net.weight, twin.weight)
    elif knob == "amp":
        from paddle_tpu_torch.amp import decorate
        opt = SGD(parameters=params)
        assert decorate(net, optimizers=opt) == (net, opt)
        assert net.weight.dtype == torch.bfloat16 and opt._multi_precision
    elif knob in ("offload", "remat"):
        # on the CPU offload warns and trains un-offloaded, as the
        # reference does without a pinned_host memory space; the remat
        # engages with the reference's warning and changes no bit
        _, twin = _linear_pair(3)
        x, y = np.ones((2, 4), np.float32), np.zeros((2, 2), np.float32)
        models = []
        for n in (net, twin):
            opt = Adam(parameters=n.parameters())
            models.append(Model(n).prepare(
                opt, lambda out, lab: ((out - lab) ** 2).mean(),
                offload=knob == "offload" and n is net))
        flags = {"FLAGS_program_remat": knob == "remat",
                 "FLAGS_remat_budget_mb": 64 if knob == "remat" else 0}
        with _port_flags(flags):
            match = ("no pinned_host memory space" if knob == "offload"
                     else "planner peak unknown")
            with pytest.warns(UserWarning, match=match):
                models[0].train_batch([x], [y])
            models[1].train_batch([x], [y])
        assert models[0]._optimizer._offload is False
        assert models[0]._remat_active is (knob == "remat")
        assert torch.equal(net.weight, twin.weight)
        assert torch.equal(net.bias, twin.bias)
    elif knob == "checkpointer":
        # fit saves into the checkpointer and a fresh model resumes from it
        from paddle_tpu_torch.distributed.checkpoint import AsyncCheckpointer
        _, twin = _linear_pair(3)
        data = TensorDataset([np.ones((4, 4), np.float32),
                              np.zeros((4, 2), np.float32)])
        d = str(tmp_path / "ckpt")
        models = [Model(n).prepare(SGD(0.1, parameters=n.parameters()),
                                   lambda out, y: ((out - y) ** 2).mean())
                  for n in (net, twin)]
        ckptr = AsyncCheckpointer(d)
        models[0].fit(data, batch_size=2, verbose=0, shuffle=False,
                      checkpointer=ckptr)
        ckptr.close()
        assert ckptr.all_steps() == [1, 2]
        with pytest.warns(UserWarning, match="resumed from checkpoint at "
                                             "step 2"):
            models[1].fit(data, batch_size=2, verbose=0, shuffle=False,
                          checkpointer=AsyncCheckpointer(d))
        assert torch.equal(net.weight, twin.weight)
        assert torch.equal(net.bias, twin.bias)
    elif knob == "anomaly_action":
        # the guard reads the loss and raises on a nan one
        model = Model(net).prepare(SGD(parameters=params),
                                   lambda out, y: out.sum() * np.nan)
        data = TensorDataset([np.ones((2, 4), np.float32),
                              np.zeros((2, 2), np.float32)])
        with _port_flags({"FLAGS_anomaly_action": "raise"}), pytest.raises(
                FloatingPointError, match="at train step 1"):
            model.fit(data, batch_size=2, verbose=0)
    elif knob == "profiler_callback":
        # the callback drives a Profiler across fit: one window of steps
        # 1 and 2 of three, each with its hapi::train_step span
        from paddle_tpu_torch.profiler import tracer
        model = Model(net).prepare(SGD(parameters=params),
                                   lambda out, y: ((out - y) ** 2).mean())
        data = TensorDataset([np.ones((6, 4), np.float32),
                              np.zeros((6, 2), np.float32)])
        windows = []
        cb = ProfilerCallback(scheduler=(1, 3), summary=False,
                              on_trace_ready=lambda p: windows.append(
                                  (p.step_num, [e[0] for e in p.events])))
        model.fit(data, batch_size=2, verbose=0, callbacks=[cb])
        assert cb.profiler.step_num == 3 and cb.profiler._samples == 6
        assert [(n, names.count("hapi::train_step"))
                for n, names in windows] == [(3, 2)]
        assert not tracer.active
    else:
        assert Model(net).summary((2, 4)) == {"total_params": 10,
                                              "trainable_params": 10}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knobs_not_ported_raise(monkeypatch, tmp_path, knob):
    _, net = _linear_pair(3)
    params = list(net.parameters())
    if KNOBS[knob] is None:
        _ported_knob(knob, net, params, tmp_path)
        return
    match = f"ROADMAP.md {KNOBS[knob]}"
    model = Model(net)
    opt = SGD(parameters=params)
    model.prepare(opt, lambda out, y: out.sum())
    data = TensorDataset([np.ones((2, 4), np.float32),
                          np.zeros((2, 2), np.float32)])
    fit = lambda **kw: model.fit(data, batch_size=2, verbose=0, **kw)  # noqa: E731
    if knob == "supervise_store":
        monkeypatch.setenv("PADDLE_SUPERVISE_STORE", "file:///nowhere")
        call = fit
    else:
        call = lambda: model.save(str(tmp_path / "m"), training=False)  # noqa: E731
    with pytest.raises(NotImplementedError, match=match):
        call()
