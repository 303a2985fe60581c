"""``paddle_tpu_torch.summary`` / ``flops`` and ``Model.summary`` against
the reference's (``paddle_tpu/hapi/summary_mod.py``).

On the GPT of ``tests/test_torch_train_step.py`` (V 1024, D 128, L 4,
H 4) fed int64 ids of shape (2, 16): the printed table equals the
reference's line for line and the totals are equal.  ``flops`` counts the
same products as the reference's on a small MLP and a small conv net,
and on that GPT (the reference feeds fp32 zeros, which its embedding
refuses, so its zeros are made integer for the comparison).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as rops
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

import paddle_tpu_torch
from paddle_tpu_torch import Model
from paddle_tpu_torch.models import GPT, GPTConfig

WIDTH = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
             max_seq_len=128, ffn_mult=2)     # test_torch_train_step.py
IDS = (2, 16)


def _gpts():
    paddle.seed(0)
    return RefGPT(RefConfig(**WIDTH)), GPT(GPTConfig(**WIDTH), device="cpu")


def test_summary_table_and_totals_equal_the_reference(capsys):
    ref, net = _gpts()
    want = paddle.summary(ref, IDS, dtypes="int64")
    want_text = capsys.readouterr().out
    net.train()
    got = paddle_tpu_torch.summary(net, IDS, dtypes="int64")
    got_text = capsys.readouterr().out
    assert got == want == {"total_params": 808704,
                           "trainable_params": 808704}
    assert got_text.splitlines() == want_text.splitlines()
    assert net.training                   # the mode is restored


def test_model_summary_and_input_forms(capsys):
    ref, net = _gpts()
    want = paddle.Model(ref).summary(IDS, "int64")
    want_text = capsys.readouterr().out
    assert Model(net).summary(IDS, "int64") == want
    assert capsys.readouterr().out == want_text
    ids = torch.zeros(IDS, dtype=torch.long)
    assert paddle_tpu_torch.summary(net, input=ids) == want
    capsys.readouterr()
    net.head.weight.stop_gradient = True
    totals = paddle_tpu_torch.summary(net, [IDS], dtypes=["int64"])
    assert totals["trainable_params"] == 808704 - 128 * 1024
    assert "Non-trainable params: 131,072" in capsys.readouterr().out
    with pytest.raises(ValueError, match="input_size or input"):
        paddle_tpu_torch.summary(net)


def _mlps():
    paddle.seed(0)
    ref = paddle.nn.Sequential(paddle.nn.Linear(12, 32), paddle.nn.ReLU(),
                               paddle.nn.Linear(32, 5))
    net = torch.nn.Sequential(torch.nn.Linear(12, 32), torch.nn.ReLU(),
                              torch.nn.Linear(32, 5))
    return ref, net, (3, 12)


def _convs():
    paddle.seed(0)
    ref = paddle.nn.Sequential(
        paddle.nn.Conv2D(2, 6, 3, padding=1), paddle.nn.ReLU(),
        paddle.nn.Conv2D(6, 4, 3, groups=2), paddle.nn.Flatten(),
        paddle.nn.Linear(4 * 6 * 6, 10))
    net = torch.nn.Sequential(
        torch.nn.Conv2d(2, 6, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(6, 4, 3, groups=2), torch.nn.Flatten(),
        torch.nn.Linear(4 * 6 * 6, 10))
    return ref, net, (2, 2, 8, 8)


@pytest.mark.parametrize("make", [_mlps, _convs], ids=["mlp", "conv"])
def test_flops_and_totals_equal_the_reference(make, capsys):
    ref, net, size = make()
    want = paddle.flops(ref, size, print_detail=True)
    want_text = capsys.readouterr().out
    assert paddle_tpu_torch.flops(net, size, print_detail=True) == want > 0
    assert capsys.readouterr().out == want_text
    assert paddle_tpu_torch.summary(net, size) == paddle.summary(ref, size)


def test_flops_on_the_gpt_equal_the_reference(monkeypatch):
    ref, net = _gpts()
    zeros = rops.creation.zeros
    monkeypatch.setattr(rops.creation, "zeros",
                        lambda shape, dtype=None: zeros(shape, "int64"))
    want = paddle.flops(ref, IDS)
    L, D, V, N = 4, 128, 1024, int(np.prod(IDS))
    # qkv, out, up, down per layer and the head: 2·in·out per token
    assert want == 2 * N * (L * (D * 3 * D + D * D + 2 * (D * 2 * D))
                            + D * V)
    assert paddle_tpu_torch.flops(net, IDS) == want
