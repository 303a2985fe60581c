"""The single-chip entry point of the reference (``__graft_entry__.entry``)
written against the port, on the CPU.

``entry()`` builds the flagship GPT at V 8192, D 256, L 4, H 4,
max_seq_len 256 and drives it through ``functional_state`` /
``load_functional_state``, ``Tensor`` and ``autograd.no_grad`` on ids of
shape (4, 128).  The port's GPT is built the same way after
``set_device("cpu")`` and ``seed(0)``, takes the reference net's
``state_dict()`` as numpy arrays through ``set_state_dict`` (no renaming,
no transposes) and runs the same forward.  The logits (4, 128, 8192)
agree within 1e-5 (measured 8e-7 at max |logit| 1.4: XLA and PyTorch sum
in other orders).  Beside it: the names and shapes are the reference's key
for key, ``parameters()`` are the port's ``Parameter``\\ s, and
``summary`` and ``flops`` count what the reference's count.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import creation as rcreation

import paddle_tpu_torch
from paddle_tpu_torch.core import autograd
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.core.tensor import Parameter
from paddle_tpu_torch.models import GPT, GPTConfig

LOGIT_ATOL = 1e-5
ENTRY = dict(vocab_size=8192, hidden_size=256, num_layers=4, num_heads=4,
             max_seq_len=256)


@pytest.fixture(scope="module")
def reference():
    """The reference's entry(): its net, example ids and logits."""
    import __graft_entry__
    forward, (ids,) = __graft_entry__.entry()
    net = inspect.getclosurevars(forward).nonlocals["net"]
    return net, np.asarray(ids), np.asarray(forward(ids))


@pytest.fixture(scope="module")
def port(reference):
    """The port's GPT as entry() builds it, carrying the reference net's
    state_dict() as it is, and its entry()-shaped forward."""
    ref_net, _, _ = reference
    was = port_place._place
    paddle_tpu_torch.set_device("cpu")
    try:
        paddle_tpu_torch.seed(0)
        net = GPT(GPTConfig(**ENTRY))
        missing, unexpected = net.set_state_dict(
            {k: np.asarray(v._data) for k, v in ref_net.state_dict().items()})
        assert missing == [] and unexpected == []
        net.eval()
        params, buffers = net.functional_state()

        def forward(ids):
            with autograd.no_grad():
                net.load_functional_state(params, buffers)
                out = net(paddle_tpu_torch.Tensor(ids))
            return out._data
        yield net, forward
    finally:
        port_place._place = was


def test_entry_forward_matches_the_reference(reference, port):
    _, ids, want = reference
    _, forward = port
    got = forward(ids)
    assert isinstance(got, torch.Tensor) and not got.requires_grad
    assert tuple(got.shape) == want.shape == (4, 128, ENTRY["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_state_dict_is_the_references_key_for_key(reference, port):
    ref_net, _, _ = reference
    net, _ = port
    want, got = ref_net.state_dict(), net.state_dict()
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].shape == list(w.shape), name
        assert got[name].dtype == torch.float32, name
    assert got["blocks.0.attn.qkv.weight"].shape == [256, 768]   # [in, out]


def test_parameters_are_the_ports_parameters(reference, port):
    ref_net, _, _ = reference
    net, _ = port
    params = net.parameters()
    assert len(params) == len(ref_net.parameters())
    assert all(isinstance(p, Parameter) for p in params)
    assert [n for n, _ in net.named_parameters()] == \
        [n for n, _ in ref_net.named_parameters()]


def test_summary_counts_what_the_reference_counts(reference, port, capsys):
    ref_net, ids, _ = reference
    net, _ = port
    want = paddle.summary(ref_net, list(ids.shape), dtypes="int64")
    want_text = capsys.readouterr().out
    got = paddle_tpu_torch.summary(net, list(ids.shape), dtypes="int64")
    assert got == want
    assert capsys.readouterr().out.splitlines() == want_text.splitlines()
    assert not net.training                  # the mode is restored


def test_flops_count_what_the_reference_counts(reference, port,
                                               monkeypatch):
    ref_net, ids, _ = reference
    net, _ = port
    zeros = rcreation.zeros
    # the reference feeds fp32 zeros, which its embedding cannot take
    monkeypatch.setattr(rcreation, "zeros",
                        lambda shape, dtype=None: zeros(shape, "int64"))
    want = paddle.flops(ref_net, list(ids.shape))
    assert paddle_tpu_torch.flops(net, list(ids.shape)) == want > 0
