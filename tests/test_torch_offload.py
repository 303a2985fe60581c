"""``Model.prepare(offload=True)`` on the CPU.  The reference keeps the
optimizer state in pinned host memory where its backend has a
``pinned_host`` memory space and otherwise warns and trains un-offloaded
(``paddle_tpu/hapi/model.py:377-409``); the port offloads on a card and on
the CPU does as the reference does there: the same warning, and steps bit
for bit those of ``offload=False``.  ``jit=False`` does not offload and
does not warn, as in the reference.  The card's side (pinned slots read
in place by the update kernel) is in ``tests/test_torch_cuda.py``.
"""
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch import Model
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import AdamW, Lamb

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=32, ffn_mult=2)            # tests/test_models.py:18
WARNING = "no pinned_host memory space"


def _run(offload, jit=True, make_opt=AdamW, steps=3):
    net = GPT(GPTConfig(**SMALL), device="cpu", seed=1)
    opt = make_opt(1e-3, parameters=net.parameters())
    model = Model(net).prepare(opt, CrossEntropyLoss(), offload=offload,
                               jit=jit)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMALL["vocab_size"], (4, 16))
    labels = np.roll(ids, -1, 1).reshape(4, 16, 1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        losses = torch.stack([model.train_batch([ids], [labels])["loss"]
                              for _ in range(steps)])
    return losses, net.state_dict(), opt, [str(x.message) for x in w]


@pytest.mark.parametrize("make_opt", [AdamW, Lamb])
def test_offload_on_the_cpu_warns_and_trains_unoffloaded(make_opt):
    base = _run(False, make_opt=make_opt)
    got = _run(True, make_opt=make_opt)
    assert torch.equal(base[0], got[0])
    for k, v in base[1].items():
        assert torch.equal(v, got[1][k]), k
    assert sum(WARNING in m for m in got[3]) == 1      # once, at the first
    assert not any(WARNING in m for m in base[3])
    assert got[2]._offload is False
    assert all(t.device.type == "cpu" for s in got[2]._state.values()
               for t in s.values())
    for k, v in base[2].state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, got[2].state_dict()[k]), k


def test_offload_with_jit_false_neither_offloads_nor_warns():
    base = _run(False, jit=False)
    got = _run(True, jit=False)
    assert torch.equal(base[0], got[0])
    assert not any(WARNING in m for m in got[3])
    assert got[2]._offload is False


def test_prepare_without_offload_takes_the_slots_off_the_host(monkeypatch):
    # an optimizer offloaded by an earlier prepare: prepare(offload=False)
    # moves its slots back (new tensors, the same values) and makes no
    # later slot on the host (the pinned copy counted; the CPU has none)
    from paddle_tpu_torch.optimizer import optimizers
    made = []

    def pinned(t):
        made.append(t)
        return t.clone()
    monkeypatch.setattr(optimizers, "_pinned", pinned)
    _, _, opt, _ = _run(False, steps=1)
    before = {k: dict(v) for k, v in opt._state.items()}
    opt._offload_state()
    assert opt._offload and len(made) == sum(map(len, before.values()))
    net = GPT(GPTConfig(**SMALL), device="cpu", seed=1)
    held = {id(p): p for _, p in opt._params}
    Model(net).prepare(opt, CrossEntropyLoss(), offload=False)
    assert opt._offload is False
    for key, state in opt._state.items():
        assert state.keys() == before[key].keys()
        for k, v in state.items():
            assert v is not before[key][k] and torch.equal(
                v, before[key][k]), k
            assert v.device == held[key].device
    made.clear()
    opt._state.clear()
    opt._slot(next(iter(held.values())))
    assert not made


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::mt_update_kernel<1, 0>(Launch)",
    "mt_norms_kernel<10, 0>", "mt_fold_kernel", "mt_pows_kernel",
    "mt_unscale_kernel<float>"])
def test_profile_train_files_the_update_kernels_as_the_update(kernel):
    # profile_train --offload reads the offloaded update's device time
    # under this kind
    from paddle_tpu_torch.tools import profile_train
    assert profile_train._kind(kernel) == \
        "optimizer update (multi_tensor_update.cu)"


@pytest.mark.parametrize("sizes,elements", [
    ([100], 64), ([8, 8, 8], 16), ([3, 5, 7, 1, 64, 1000, 9], 32),
    ([1 << 12, 17, 1 << 13], 1 << 10), ([0, 5, 0], 8)])
def test_stage_cuts_cover_every_element_once_aligned(sizes, elements):
    """The staged offload route's cut of a group into stages: every element
    of every tensor in exactly one range, in order; no stage past its
    capacity; every range at a multiple of 8 in its stage and tensor."""
    from paddle_tpu_torch.ops.multi_tensor_update import stage_cuts
    cuts = stage_cuts(sizes, elements)
    seen = [[] for _ in sizes]
    for cut in cuts:
        assert cut
        end = 0
        for i, start, n, pos in cut:
            assert n > 0 and pos % 8 == 0 and start % 8 == 0
            assert pos >= end and pos + n <= elements
            end = pos + n
            seen[i].append((start, n))
    for i, n in enumerate(sizes):
        got = sorted(seen[i])
        assert sum(k for _, k in got) == n
        assert all(a[0] + a[1] == b[0] for a, b in zip(got, got[1:]))


def test_profile_train_busy_time_is_the_union_over_streams():
    # an offloaded update's copies overlap kernels on other streams: the
    # idle share reads the union of the intervals, not their sum
    from types import SimpleNamespace as NS
    from paddle_tpu_torch.tools import profile_train

    def ev(start, end):
        return NS(time_range=NS(start=start, end=end))
    events = [ev(0, 10), ev(5, 15), ev(20, 30), ev(22, 25), ev(30, 31)]
    assert profile_train._busy_us(events) == 26.0
    assert profile_train._busy_us([]) == 0.0
