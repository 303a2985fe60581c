"""The port's learning-rate schedulers and the optimizer's use of them,
against the JAX package's.

Every scheduler class of ``paddle_tpu/optimizer/lr.py`` is built in both
packages with the same arguments and stepped 60 times; the values agree
to rtol 1e-12 (the same float arithmetic on the host).  ``ReduceOnPlateau``
is fed the same losses.  A scheduler's ``state_dict`` restores a fresh
one mid-schedule, and an optimizer under a scheduler refreshes the
device scalar its step reads only when the value changed.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as rlr

from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer import lr

STEPS = 60

# (class name, positional args, keyword args)
CASES = [
    ("NoamDecay", (64, 10), dict(learning_rate=1.0)),
    ("PiecewiseDecay", ([10, 30], [0.1, 0.05, 0.01]), {}),
    ("NaturalExpDecay", (0.5, 0.1), {}),
    ("InverseTimeDecay", (0.5, 0.1), {}),
    ("PolynomialDecay", (0.5, 20), dict(end_lr=0.01, power=2.0)),
    ("PolynomialDecay", (0.5, 20), dict(end_lr=0.01, cycle=True)),
    ("LinearWarmup", (0.5, 10, 0.0, 0.5), {}),
    ("LinearWarmup", ("poly", 4, 0, 1e-4), {}),
    ("ExponentialDecay", (0.5, 0.9), {}),
    ("MultiStepDecay", (0.5, [10, 20, 40]), dict(gamma=0.5)),
    ("StepDecay", (0.5, 7), dict(gamma=0.5)),
    ("LambdaDecay", (0.5, lambda e: 0.95 ** e), {}),
    ("MultiplicativeDecay", (0.5, lambda e: 0.97), {}),
    ("CosineAnnealingDecay", (0.5, 25), dict(eta_min=0.01)),
    ("OneCycleLR", (0.5, 50), {}),
    ("OneCycleLR", (0.5, 50), dict(anneal_strategy="linear",
                                   phase_pct=0.4)),
    ("CyclicLR", (0.1, 0.5), dict(step_size_up=7)),
    ("CyclicLR", (0.1, 0.5), dict(step_size_up=5, step_size_down=9,
                                  mode="triangular2")),
    ("CyclicLR", (0.1, 0.5), dict(step_size_up=6, mode="exp_range",
                                  exp_gamma=0.98)),
]


def _make(mod, name, args, kw):
    if args and args[0] == "poly":       # the flagship recipe's schedule
        args = (mod.PolynomialDecay(1e-4, 40),) + args[1:]
    return getattr(mod, name)(*args, **kw)


def _values(sched, steps=STEPS):
    out = [sched()]
    for _ in range(steps):
        sched.step()
        out.append(sched())
    return out


def test_every_reference_class_is_ported():
    assert set(rlr.__all__) == set(lr.__all__)
    assert len(lr.__all__) == 16        # the base class and 15 schedules
    named = {name for name, _, _ in CASES} | {"ReduceOnPlateau"}
    assert named == set(lr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_schedule_values_match_the_reference(name, args, kw):
    want = _values(_make(rlr, name, args, kw))
    got = _values(_make(lr, name, args, kw))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(got)) > 1


@pytest.mark.parametrize("kw", [
    dict(), dict(mode="max", threshold_mode="abs", threshold=0.05,
                 cooldown=2, patience=2, factor=0.5, min_lr=0.01)])
def test_reduce_on_plateau_follows_the_same_losses(kw):
    rs = np.random.RandomState(0)
    losses = np.concatenate([np.linspace(3.0, 1.0, 15),
                             1.0 + 0.01 * rs.rand(45)])
    ref = rlr.ReduceOnPlateau(0.5, **kw)
    port = lr.ReduceOnPlateau(0.5, **kw)
    want, got = [], []
    for loss in losses:
        ref.step(loss)
        port.step(torch.tensor(loss, dtype=torch.float64))  # 0-d tensors too
        want.append(ref())
        got.append(port())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert min(got) < 0.5
    port.step()                              # no metric: no step
    assert port() == got[-1]


@pytest.mark.parametrize("name,args,kw", [CASES[4], CASES[7], CASES[14]],
                         ids=["poly", "warmup", "onecycle"])
def test_state_dict_round_trip(name, args, kw):
    a = _make(lr, name, args, kw)
    for _ in range(13):
        a.step()
    sd = a.state_dict()
    ref = _make(rlr, name, args, kw)
    for _ in range(13):
        ref.step()
    assert sd == ref.state_dict()
    b = _make(lr, name, args, kw)
    b.set_state_dict(sd)
    assert _values(a, 20) == _values(b, 20)


def test_optimizer_reads_the_scheduler():
    net = torch.nn.Linear(4, 2)
    sched = lr.StepDecay(0.5, 2, gamma=0.5)
    opt = AdamW(sched, parameters=net.parameters())
    assert opt._lr_scheduler is sched and opt.get_lr() == 0.5
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    net(torch.ones(1, 4)).sum().backward()
    opt.step()
    scalar = opt._lr(torch.device("cpu"))
    assert scalar.item() == 0.5
    sched.step()
    sched.step()
    assert scalar.item() == 0.5        # refreshed by the next step only
    opt.step()
    assert scalar.item() == 0.25 and opt._lr(torch.device("cpu")) is scalar
    sd = opt.state_dict()
    assert sd["LR_Scheduler"] == sched.state_dict()
    fresh_sched = lr.StepDecay(0.5, 2, gamma=0.5)
    fresh = AdamW(fresh_sched, parameters=net.parameters())
    fresh.set_state_dict(sd)
    assert fresh_sched.last_epoch == 2 and fresh.get_lr() == 0.25
    with pytest.raises(TypeError, match="learning_rate"):
        SGD("0.1", parameters=net.parameters())


def test_refresh_fills_only_when_the_value_changes(monkeypatch):
    net = torch.nn.Linear(4, 2)
    sched = lr.PiecewiseDecay([2], [0.1, 0.01])
    opt = SGD(sched, parameters=net.parameters())
    opt._lr(torch.device("cpu"))
    fills = []
    orig = torch.Tensor.fill_
    monkeypatch.setattr(torch.Tensor, "fill_",
                        lambda t, v: fills.append(v) or orig(t, v))
    for _ in range(4):
        opt._refresh_lr()
        sched.step()
    assert fills == [0.01]
