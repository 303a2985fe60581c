"""``Model.prepare(jit=True)``'s captured steps, on the CPU (where an entry
is the plain step function): N steps equal ``jit=False``'s, the gradients
and the optimizer state stay where the graph reads them, the seed vector
draws the eager path's seeds in its order, the learning rate is read from
the device scalar, and the launch counters' capture bookkeeping."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import Model, graphs
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.nn import CrossEntropyLoss, torch_view
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ln as fl
from paddle_tpu_torch.ops import fused_ops as fo
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.random import SeedSlots, default_generator
from paddle_tpu_torch.tools.profile_train import build_encoder

ENCODER = dict(vocab_size=53, d_model=32, num_layers=2, nhead=2,
               dim_feedforward=64, max_len=16, dropout_rate=0.1)
GPT_WIDTH = dict(vocab_size=53, hidden_size=32, num_layers=2, num_heads=2,
                 max_seq_len=16)
STEPS = 3


def _batch(seed=0, B=4, T=16, V=53):
    ids = np.random.RandomState(seed).randint(0, V, (B, T))
    return ids, np.roll(ids, -1, 1).reshape(B, T, 1)


def _run(make_net, jit, amp=None, steps=STEPS):
    net = make_net()
    model = Model(net).prepare(
        AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01),
        CrossEntropyLoss(), amp_configs=amp, jit=jit)
    paddle_tpu_torch.seed(2)
    losses = [model.train_batch([ids], [labels])["loss"].clone()
              for ids, labels in (_batch(s) for s in range(steps))]
    return torch.stack(losses), {k: v.clone() for k, v in
                                 torch_view(net).state_dict().items()}, model


@pytest.mark.parametrize("path,amp", [("encoder", None), ("encoder", "O2"),
                                      ("gpt", None)])
def test_captured_steps_equal_eager_steps(path, amp):
    def make():
        if path == "encoder":
            return build_encoder(ENCODER, device="cpu", seed_val=1)
        return GPT(GPTConfig(**GPT_WIDTH), device="cpu", seed=1)
    l_e, s_e, m_e = _run(make, jit=False, amp=amp)
    l_j, s_j, m_j = _run(make, jit=True, amp=amp)
    assert torch.equal(l_e, l_j), (l_e, l_j)
    assert s_e.keys() == s_j.keys()
    for k in s_e:
        assert torch.equal(s_e[k], s_j[k]), k
    assert m_j._steps.compiles == 1 and m_j._steps.hits == STEPS - 1
    assert m_e._steps.compiles == 0
    assert m_j._optimizer._global_step == m_e._optimizer._global_step \
        == STEPS
    key = m_j._steps.keys()[0]
    assert key[0] == "train" and key[-1] == (
        None if amp is None else (amp, torch.bfloat16))


def test_grads_and_optimizer_state_stay_in_place():
    net = build_encoder(ENCODER, device="cpu", seed_val=1)
    opt = AdamW(1e-3, parameters=net.parameters())
    model = Model(net).prepare(opt, CrossEntropyLoss())
    ptrs = []
    for s in range(STEPS):
        model.train_batch(*[[a] for a in _batch(s)])
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        ptrs.append(([g.data_ptr() for g in grads],
                     [t.data_ptr() for t in opt.bound_tensors()],
                     [p.data_ptr() for p in net.parameters()]))
        assert len(grads) > 10 and all(not g.any() for g in grads)
    assert ptrs[0] == ptrs[1] == ptrs[2]
    assert len(ptrs[0][1]) == 4 * len(ptrs[0][0]) + 1    # slots + lr
    # the gradients dropped (rather than zeroed): the entry is made again
    opt.clear_grad()
    model.train_batch(*[[a] for a in _batch(5)])
    assert model._steps.compiles == 2


def test_seed_vector_draws_the_eager_seeds_in_order():
    paddle_tpu_torch.seed(5)
    eager = [fo._next_seed() for _ in range(9)]
    paddle_tpu_torch.seed(5)
    slots = SeedSlots(3, "cpu")
    n0 = default_generator.draws
    with slots.recording():
        views = [fo._next_seed() for _ in range(3)]
        with pytest.raises(RuntimeError, match="more than the 3"):
            fo._next_seed()
    assert default_generator.draws == n0          # the capture drew none
    assert all(v.shape == (1,) and v.dtype == torch.int64 for v in views)
    for i in range(3):
        assert slots.refill() == eager[3 * i:3 * i + 3]
        assert [int(v) for v in views] == eager[3 * i:3 * i + 3]
    # outside a capture next_seed draws again, after the refills
    assert fo._next_seed() != eager[0]
    # a slot is a seed: the plain epilogue's mask from it is the int's
    x, r = torch.randn(6, 8), torch.randn(6, 8)
    v = torch.zeros(8)
    g = torch.ones(8)
    assert torch.equal(fl.fused_ln(x, r, v, g, v, views[0], p=0.5, eps=1e-5),
                       fl.fused_ln(x, r, v, g, v, eager[6], p=0.5, eps=1e-5))


def test_the_step_reads_the_learning_rate_scalar():
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 4)
    opt = SGD(0.5, parameters=net.parameters())
    model = Model(net).prepare(opt, torch.nn.MSELoss())
    x, y = np.ones((2, 3), np.float32), np.zeros((2, 4), np.float32)
    model.train_batch([x], [y])
    opt.set_lr(0.0)
    before = net.weight.detach().clone()
    model.train_batch([x], [y])
    assert torch.equal(net.weight, before)
    assert opt.get_lr() == 0.0 and model._steps.compiles == 1
    opt.set_lr(0.25)
    model.train_batch([x], [y])
    assert not torch.equal(net.weight, before)


def test_eval_and_predict_are_cached_per_signature():
    net = GPT(GPTConfig(**GPT_WIDTH), device="cpu", seed=1)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss())
    eager = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss(), jit=False)
    for s in range(2):
        ids, labels = _batch(s)
        assert model.eval_batch([ids], [labels]) == \
            eager.eval_batch([ids], [labels])
        np.testing.assert_array_equal(model.predict_batch([ids])[0],
                                      eager.predict_batch([ids])[0])
    model.predict_batch([_batch(0, B=2)[0]])
    assert sorted(k[0] for k in model._steps.keys()) == ["eval", "predict",
                                                         "predict"]
    assert model._steps.compiles == 3 and model._steps.hits == 2


def test_capture_bookkeeping_of_the_launch_counters():
    fa.FWD_LAUNCHES, fl.LAUNCHES = 5, 0
    fa.MODE_LAUNCHES.clear()
    fa.MODE_LAUNCHES["fwd small"] = 2
    before = graphs.launch_counts()
    # what a capture's wrappers do
    fa.FWD_LAUNCHES += 2
    fl.LAUNCHES += 4
    fa.MODE_LAUNCHES["fwd small"] += 1
    fa.MODE_LAUNCHES["bwd small"] = 1
    rise = graphs._restore_counts(before)
    assert (fa.FWD_LAUNCHES, fl.LAUNCHES) == (5, 0)
    assert fa.MODE_LAUNCHES == {"fwd small": 2}
    assert rise == {("flash_attention", "FWD_LAUNCHES", None): 2,
                    ("fused_ln", "LAUNCHES", None): 4,
                    ("flash_attention", "MODE_LAUNCHES", "fwd small"): 1,
                    ("flash_attention", "MODE_LAUNCHES", "bwd small"): 1}
    for _ in range(3):                         # three replays
        graphs._set_counts(rise, add=True)
    assert (fa.FWD_LAUNCHES, fl.LAUNCHES) == (11, 12)
    assert fa.MODE_LAUNCHES == {"fwd small": 5, "bwd small": 3}
    fa.FWD_LAUNCHES = fl.LAUNCHES = 0
    fa.MODE_LAUNCHES.clear()
