"""The port's flag registry (``paddle_tpu_torch/utils/flags.py``) against
the reference's (``paddle_tpu/utils/flags.py``): the same names, defaults
and types, the same errors, the environment read once when a flag is
defined, and ``set_flags`` reaching every place the port reads a flag.

Both registries are compared as fresh copies of their files, loaded by
path, so that flags another test set in this process do not count.
"""
import contextlib
import importlib.util

import numpy as np
import pytest
import torch

import paddle_tpu.utils.flags as rflags_mod

import paddle_tpu_torch
import paddle_tpu_torch.utils.flags as pflags_mod
from paddle_tpu_torch import Model
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.optimizer import SGD, fused_update


def _fresh(module, name):
    """A new instance of ``module``'s file: its flags as defined now."""
    spec = importlib.util.spec_from_file_location(name, module.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _set(flags):
    was = paddle_tpu_torch.get_flags(list(flags))
    paddle_tpu_torch.set_flags(flags)
    try:
        yield
    finally:
        paddle_tpu_torch.set_flags(was)


def test_names_defaults_and_types_are_the_references(monkeypatch):
    for k in rflags_mod.all_flags():
        monkeypatch.delenv(k, raising=False)
    ref = _fresh(rflags_mod, "_ref_flags").all_flags()
    port = _fresh(pflags_mod, "_port_flags").all_flags()
    assert len(ref) == 41
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert port[k] == v and type(port[k]) is type(v), k


def test_exported_as_the_reference_exports_them():
    import paddle_tpu
    assert paddle_tpu_torch.set_flags is pflags_mod.set_flags
    assert paddle_tpu_torch.get_flags is pflags_mod.get_flags
    assert paddle_tpu_torch.utils.all_flags is pflags_mod.all_flags
    assert callable(paddle_tpu.set_flags) and callable(paddle_tpu.get_flags)
    got = paddle_tpu_torch.get_flags("FLAGS_fused_optimizer")
    assert list(got) == ["FLAGS_fused_optimizer"]


@pytest.mark.parametrize("call", ["get_flag", "get_flags", "set_flags"])
def test_unknown_flag_raises_keyerror_in_both(call):
    args = {"get_flag": "FLAGS_nope", "get_flags": ["FLAGS_nope"],
            "set_flags": {"FLAGS_nope": 1}}[call]
    for mod in (rflags_mod, pflags_mod):
        with pytest.raises(KeyError, match="unknown flag 'FLAGS_nope'"):
            getattr(mod, call)(args)


@pytest.mark.parametrize("name,raw,want", [
    ("FLAGS_remat_budget_mb", "512", 512),
    ("FLAGS_program_remat", "yes", True),
    ("FLAGS_fused_optimizer", "0", False),
    ("FLAGS_watchdog_timeout", "2.5", 2.5),
    ("FLAGS_anomaly_action", "raise", "raise")])
def test_environment_is_read_when_the_flag_is_defined(monkeypatch, name, raw,
                                                      want):
    monkeypatch.setenv(name, raw)
    port = _fresh(pflags_mod, "_port_flags_env")
    ref = _fresh(rflags_mod, "_ref_flags_env")
    assert port.get_flag(name) == want == ref.get_flag(name)
    monkeypatch.setenv(name, "7" if raw != "7" else "8")
    assert port.get_flag(name) == want         # read once, at definition


def test_on_change_runs_after_set_flags():
    seen = []
    mod = _fresh(pflags_mod, "_port_flags_obs")
    mod.on_change(lambda: seen.append(mod.get_flag("FLAGS_speculative_k")))
    mod.set_flags({"FLAGS_speculative_k": 3})
    assert seen == [3]


def _linear():
    torch.manual_seed(0)
    net = torch.nn.Linear(4, 2)
    return Model(net).prepare(SGD(0.1, parameters=net.parameters()),
                              lambda out, y: ((out - y) ** 2).mean())


def _xy():
    return np.ones((2, 4), np.float32), np.zeros((2, 2), np.float32)


def test_set_flags_reaches_the_fused_update():
    model = _linear()
    x, y = _xy()
    before = dict(fused_update.ROUTES)
    with _set({"FLAGS_fused_optimizer": False}):
        model.train_batch([x], [y])
    assert fused_update.ROUTES["per_leaf_flag"] == \
        before["per_leaf_flag"] + 1
    model.train_batch([x], [y])
    assert fused_update.ROUTES["fused"] == before["fused"] + 1


def test_set_flags_reaches_the_prefetch_depth():
    model = _linear()
    data = TensorDataset(list(_xy()))
    with _set({"FLAGS_prefetch_to_device": 0}):
        model.fit(data, batch_size=2, verbose=0)
    assert model._last_prefetcher is None
    with _set({"FLAGS_prefetch_to_device": 3}):
        model.fit(data, batch_size=2, verbose=0)
    assert model._last_prefetcher.depth == 3


def test_set_flags_reaches_the_remat_decision():
    model = _linear()
    x, y = _xy()
    assert model._remat_decision(2) is False
    with _set({"FLAGS_program_remat": True}):
        assert model._remat_decision(2) is False      # no budget: off
        with _set({"FLAGS_remat_budget_mb": 1}), \
                pytest.warns(UserWarning, match="planner peak unknown"):
            model.train_batch([x], [y])
    assert model._remat_active is True
    assert model._remat_cache == ((1, 2), True)
    keys = list(model._steps.keys())
    assert [k[-2] for k in keys] == [True]


def test_set_flags_reaches_the_anomaly_guard():
    # set_flags arms the guard and, through the chaos layer's observer,
    # the step.loss site that poisons the step's loss: the step is reverted
    model = _linear()
    before = {k: v.clone() for k, v in model.network.state_dict().items()}
    with _set({"FLAGS_anomaly_action": "skip"}), \
            _set({"FLAGS_chaos_spec": "step.loss:nan@1"}), \
            pytest.warns(UserWarning, match="step reverted"):
        model.fit(TensorDataset(list(_xy())), batch_size=2, verbose=0)
    for k, v in model.network.state_dict().items():
        assert torch.equal(v, before[k]), k
