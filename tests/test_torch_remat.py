"""``Model``'s budget remat (``hapi/remat.py``) on the CPU: with
``FLAGS_program_remat`` and ``FLAGS_remat_budget_mb`` set through
``set_flags``, the captured update step keeps the products and recomputes
the rest in the backward.

- On the SMALL GPT (``tests/test_models.py:18``) three AdamW steps are bit
  for bit the port's steps without the remat, in fp32, O1 and O2, and
  they track the reference's own remat run (``paddle_tpu`` with its
  ``set_flags``; ``jax.checkpoint(dots_saveable)``) within
  ``tests/test_torch_hapi.py``'s fp32 limits: losses rtol 1e-5,
  parameters atol 5e-4.  Both warn with the reference's text.
- On a two-layer fused encoder with dropout 0.1 (hash dropout in the
  epilogue, mask dropout in the FFN), three steps are bit for bit the
  steps without the remat and draw as many host seeds: the recompute
  replays its forward's draws.  Without the replay the recompute draws
  anew and the gradients go wrong silently; this test catches that.
- The recompute really runs: the epilogue's forward runs twice a layer a
  step under the remat.
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

import paddle_tpu_torch
from paddle_tpu_torch import Model
from paddle_tpu_torch.hapi import remat
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.models.convert import LINEAR_WEIGHTS
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.ops import fused_ln
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.random import default_generator
from paddle_tpu_torch.tools.profile_train import build_encoder

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=32, ffn_mult=2)            # tests/test_models.py:18
ENC = dict(vocab_size=128, d_model=32, nhead=2, dim_feedforward=64,
           num_layers=2, max_len=16, dropout_rate=0.1)
B, T, STEPS = 4, 16, 3
REMAT = {"FLAGS_program_remat": True, "FLAGS_remat_budget_mb": 64}
WARNING = "planner peak unknown"


@contextlib.contextmanager
def _flags(set_flags, get_flags, flags):
    was = get_flags(list(flags))
    set_flags(flags)
    try:
        yield
    finally:
        set_flags(was)


def _port_flags(on):
    return _flags(paddle_tpu_torch.set_flags, paddle_tpu_torch.get_flags,
                  REMAT if on else {})


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMALL["vocab_size"], (B, T)).astype(np.int32)
    labels = np.roll(ids, -1, 1).reshape(B, T, 1).astype(np.int64)
    return ids, labels


def _ref_state(net):
    return {k: np.array(v) for k, v in net.functional_state()[0].items()}


def _train(net, remat_on, amp=None, jit=True, steps=STEPS):
    """Three captured AdamW steps on ``net``: losses, state, host seeds
    drawn, the warnings' texts."""
    model = Model(net).prepare(
        AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01),
        CrossEntropyLoss(), amp_configs=amp, jit=jit)
    ids, labels = _batch()
    drawn = default_generator.draws
    with _port_flags(remat_on), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        losses = [model.train_batch([ids], [labels])["loss"]
                  for _ in range(steps)]
    return (torch.stack(losses), {k: v.clone() for k, v in
                                  net.state_dict().items()},
            default_generator.draws - drawn, [str(x.message) for x in w],
            model)


def _gpt():
    return GPT(GPTConfig(**SMALL), device="cpu")


def _encoder():
    return build_encoder(ENC, device="cpu", seed_val=3)


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    assert set(a[1]) == set(b[1])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


@pytest.fixture(scope="module")
def reference_remat():
    """The reference's Model on the SMALL GPT, three jitted steps with its
    own remat flags, and its initial weights."""
    from paddle_tpu.utils import flags as rflags
    paddle.seed(0)
    ref = RefGPT(RefConfig(**SMALL))
    init = _ref_state(ref)
    rmodel = paddle.Model(ref)
    rmodel.prepare(paddle.optimizer.AdamW(1e-3, parameters=ref.parameters(),
                                          weight_decay=0.01),
                   paddle.nn.CrossEntropyLoss())
    ids, labels = _batch()
    with _flags(rflags.set_flags, rflags.get_flags, REMAT), \
            warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        losses = [float(rmodel.train_batch([ids], [labels])["loss"])
                  for _ in range(STEPS)]
    assert rmodel._remat_active is True
    return dict(init=init, losses=losses, state=_ref_state(ref),
                warnings=[str(x.message) for x in w])


def _gpt_from(init):
    net = GPT(GPTConfig(**SMALL), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(init, device="cpu"))
    return net


@pytest.mark.parametrize("amp", [None, "O1", "O2"])
def test_gpt_remat_is_bit_for_bit_the_step_without(amp):
    plain = _train(_gpt(), False, amp)
    got = _train(_gpt(), True, amp)
    _assert_same(plain, got)
    assert any(WARNING in m for m in got[3])
    assert got[4]._remat_active is True
    assert not any(WARNING in m for m in plain[3])


def test_gpt_remat_tracks_the_references_remat_run(reference_remat):
    got = _train(_gpt_from(reference_remat["init"]), True)
    np.testing.assert_allclose(got[0].numpy(), reference_remat["losses"],
                               rtol=1e-5)
    state = {k: (v.T if k.endswith(LINEAR_WEIGHTS) else v)
             for k, v in ((k, v.numpy()) for k, v in got[1].items())}
    for name, w in reference_remat["state"].items():
        np.testing.assert_allclose(state[name], w, atol=5e-4, err_msg=name)
    want = [m for m in reference_remat["warnings"] if WARNING in m]
    assert want and [m for m in got[3] if WARNING in m][0] == want[0]


@pytest.mark.parametrize("amp", [None, "O1", "O2"])
def test_dropout_encoder_remat_replays_its_draws(amp):
    calls = []
    orig = fused_ln.fused_ln

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    runs = []
    fused_ln.fused_ln = counted
    try:
        for on in (False, True):
            calls.clear()
            paddle_tpu_torch.seed(5)
            runs.append(_train(_encoder(), on, amp) + (len(calls),))
    finally:
        fused_ln.fused_ln = orig
    plain, got = runs
    n_plain = plain[-1]
    _assert_same(plain, got)
    layers = ENC["num_layers"]
    assert plain[2] == got[2] == 2 * layers * STEPS   # host seeds a step
    assert n_plain == 2 * layers * STEPS
    assert got[-1] == 2 * n_plain                     # forward + recompute


def test_the_draw_replay_is_what_keeps_the_bits(monkeypatch):
    """A recompute that draws anew (the replay taken out) changes the
    gradients without any error: the equality above is the replay's."""
    from paddle_tpu_torch import random as prandom
    paddle_tpu_torch.seed(5)
    plain = _train(_encoder(), False)
    monkeypatch.setattr(prandom.DrawLog, "replaying",
                        prandom.DrawLog.recording)
    paddle_tpu_torch.seed(5)
    got = _train(_encoder(), True)
    assert got[2] == 2 * plain[2]
    assert not all(torch.equal(plain[1][k], got[1][k]) for k in plain[1])


@pytest.mark.parametrize("path", ["jit=False", "update=False"])
def test_the_eager_steps_ignore_the_flags(path):
    net = _gpt()
    model = Model(net).prepare(
        AdamW(1e-3, parameters=net.parameters()), CrossEntropyLoss(),
        jit=path != "jit=False")
    ids, labels = _batch()
    with _port_flags(True), warnings.catch_warnings():
        warnings.simplefilter("error")
        model.train_batch([ids], [labels], update=path != "update=False")
    assert model._remat_active is False and model._remat_cache is None


def test_the_decision_keys_the_step_and_is_cached_per_budget_and_batch():
    net = _gpt()
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss())
    ids, labels = _batch()
    model.train_batch([ids], [labels])
    with _port_flags(True):
        with pytest.warns(UserWarning, match=WARNING):
            model.train_batch([ids], [labels])
        with warnings.catch_warnings():
            warnings.simplefilter("error")         # cached: no new warning
            model.train_batch([ids], [labels])
        with pytest.warns(UserWarning, match=WARNING):
            model.train_batch([ids[:2]], [labels[:2]])
    assert [k[-2] for k in model._steps.keys()] == [False, True, True]
    assert model._remat_cache == ((64, 2), True)


def test_blocks_are_the_outermost_lists_items():
    gpt = _gpt()
    assert remat.blocks(gpt) == list(gpt.blocks)
    enc = _encoder()
    assert remat.blocks(enc) == list(enc.layers)
    lin = torch.nn.Linear(2, 2)
    assert remat.blocks(lin) == [lin]
    with remat.segments(gpt):
        assert all("forward" in vars(b) for b in gpt.blocks)
    assert not any("forward" in vars(b) for b in gpt.blocks)


def test_policy_keeps_the_products_and_torch_seeded_ops():
    aten = torch.ops.aten
    keep = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default,
               aten.baddbmm.default):
        assert remat.policy(None, op) == keep
    assert remat.policy(None, aten.native_dropout.default) == keep
    assert remat.policy(None, aten.add.Tensor) != keep
    assert remat.policy(None, aten.gelu.default) != keep
