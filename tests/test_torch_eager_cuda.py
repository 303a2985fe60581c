"""The eager core on the card: the default place is the card, and one
dygraph step of a small ``nn.TransformerEncoder`` runs the hand-written
kernels (row 1 forward, row 6 backward, the fused update).

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_eager_cuda.py -q
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import multi_tensor_update as mtu

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the default place is the card and "
                    "the CUDA kernels have no CPU mode")
    monkeypatch.setattr(port_place, "_place", None)


def test_creation_without_a_place_is_on_the_card(card):
    assert paddle.get_device() == "gpu:0"
    for t in (paddle.zeros([2]), paddle.to_tensor([1.0]), paddle.rand([2]),
              paddle.arange(3), paddle.nn.Linear(2, 2).weight):
        assert t._data.is_cuda and t.place == paddle.CUDAPlace(0)


def _encoder():
    class Net(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            # head dim 64: bf16 takes flash_attn_sm90.cu
            self.enc = paddle.nn.TransformerEncoder(
                paddle.nn.TransformerEncoderLayer(128, 2, 256, dropout=0.1,
                                                  activation="gelu",
                                                  attn_dropout=0.0), 2)
            self.head = paddle.nn.Linear(128, 8)

        def forward(self, x):
            return self.head(self.enc(x))
    return Net()


def test_a_dygraph_encoder_step_runs_the_kernels(card):
    paddle.seed(0)
    net = _encoder()
    opt = paddle.optimizer.AdamW(1e-3, parameters=net.parameters())
    rs = np.random.RandomState(0)
    x = paddle.to_tensor(rs.randn(2, 32, 128).astype(np.float32))
    y = paddle.to_tensor(rs.randint(0, 8, (2, 32, 1)))
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
    fa.SM90_FWD_LAUNCHES = fa.SM90_BWD_LAUNCHES = 0
    mtu.LAUNCHES.clear()
    loss = paddle.nn.functional.cross_entropy(net(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    assert (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) == (2, 2)
    assert (fa.SM90_FWD_LAUNCHES, fa.SM90_BWD_LAUNCHES) == (0, 0)
    assert mtu.LAUNCHES == {"adamw": 1}
    assert np.isfinite(float(loss))
    with paddle.amp.auto_cast():
        out = net(x)
    assert out.dtype == torch.bfloat16
    assert (fa.SM90_FWD_LAUNCHES, fa.FWD_LAUNCHES) == (2, 4)


def test_the_op_dispatch_refuses_a_sync_inside_a_capture(card):
    x = paddle.ones([4])
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            with pytest.raises(RuntimeError, match="CUDA-graph capture"):
                with torch.cuda.graph(g):
                    paddle.exp(x)
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})


@pytest.mark.parametrize("build", [
    lambda inc: inc.FusedMultiHeadAttention(32, 4),
    lambda inc: inc.FusedFeedForward(32, 64),
    lambda inc: inc.FusedTransformerEncoderLayer(16, 2, 32, dropout_rate=0.0),
    lambda inc: inc.FusedBiasDropoutResidualLayerNorm(32),
], ids=["mha", "ffn", "encoder_layer", "bias_dropout_ln"])
def test_fused_layers_build_on_the_card_after_set_device_gpu(card, build):
    """C15 (``ROADMAP.md`` §C) on the card: with no ``device=``, a fused
    layer lands on the place ``set_device`` set; ``device="cpu"`` still
    wins."""
    from paddle_tpu_torch.incubate import nn as inc
    paddle.set_device("gpu")
    assert all(p.is_cuda for p in build(inc).parameters())
    ffn = inc.FusedFeedForward(32, 64, device="cpu")
    assert all(p.device.type == "cpu" for p in ffn.parameters())
    paddle.set_device("cpu")
    assert all(p.device.type == "cpu" for p in build(inc).parameters())
