"""The port's gradient clips against the JAX package's.

The three clips of ``paddle_tpu/nn/clip.py`` run on the same gradients
(numpy seeds) in both packages, one parameter marked ``need_clip =
False``; the clipped values agree to atol 1e-7.  Then three
``Model.train_batch`` steps of the SMALL GPT under
``AdamW(grad_clip=ClipGradByGlobalNorm(0.01))`` (a norm the gradients
exceed, so every step clips) against the reference's ``Model`` from the
same weights: losses rtol 1e-5, parameters atol 5e-4, the tolerances of
``tests/test_torch_hapi.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

from paddle_tpu_torch import Model
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.models.convert import LINEAR_WEIGHTS
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByValue,
                                 CrossEntropyLoss)
from paddle_tpu_torch.optimizer import SGD, AdamW

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=32, ffn_mult=2)            # tests/test_models.py:18
SHAPES = ((4, 3), (5,), (2, 2, 2), (7,))


class _P:
    """A parameter stand-in: the clips read only ``need_clip``."""

    def __init__(self, need_clip=True):
        self.need_clip = need_clip


def _grads(scale):
    rs = np.random.RandomState(4)
    return [(rs.randn(*s) * scale).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("kind,scale", [
    ("value", 1.0), ("norm", 1.0), ("norm", 0.01), ("global", 1.0),
    ("global", 0.01)])
def test_clips_match_the_reference(kind, scale):
    grads = _grads(scale)
    params = [_P(), _P(), _P(need_clip=False), _P()]
    make = {"value": lambda m: m.ClipGradByValue(0.5),
            "norm": lambda m: m.ClipGradByNorm(1.0),
            "global": lambda m: m.ClipGradByGlobalNorm(1.0)}[kind]
    import paddle_tpu.nn as rnn
    import paddle_tpu_torch.nn as pnn
    want = make(rnn)([(p, Tensor(jnp.asarray(g)))
                      for p, g in zip(params, grads)])
    given = [torch.from_numpy(g.copy()) for g in grads]
    got = make(pnn)(list(zip(params, given)))
    for (_, w), (_, g), orig, src in zip(want, got, given, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(orig.numpy(), src)   # not in place
    np.testing.assert_array_equal(got[2][1].numpy(), grads[2])
    if scale == 1.0:            # these gradients exceed every bound
        assert any(not np.array_equal(g.numpy(), s)
                   for (_, g), s in zip(got, grads))


def test_global_norm_of_bf16_gradients_is_summed_in_fp32():
    grads = [torch.from_numpy(g).to(torch.bfloat16) for g in _grads(1.0)]
    clip = ClipGradByGlobalNorm(1.0)
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    got = clip([(_P(), g) for g in grads])
    for (_, c), g in zip(got, grads):
        assert c.dtype == torch.bfloat16
        torch.testing.assert_close(c.float(), (g.float() / total).to(
            torch.bfloat16).float(), rtol=2 ** -8, atol=0)


def test_optimizer_clips_in_place_before_the_update():
    net = torch.nn.Linear(4, 2, bias=False)
    with torch.no_grad():
        net.weight.fill_(0.0)
    opt = SGD(1.0, parameters=net.parameters(),
              grad_clip=ClipGradByValue(0.25))
    (net(torch.ones(1, 4)) * 10).sum().backward()
    opt.step()
    assert torch.equal(net.weight, torch.full((2, 4), -0.25))
    with pytest.raises(TypeError, match="grad_clip"):
        SGD(parameters=net.parameters(), grad_clip=object())
    net.weight.need_clip = False
    opt.clear_grad()
    (net(torch.ones(1, 4)) * 10).sum().backward()
    opt.step()
    assert torch.equal(net.weight, torch.full((2, 4), -10.25))


def _state(net):
    return {k: np.array(v) for k, v in net.functional_state()[0].items()}


@pytest.mark.parametrize("jit", [True, False])
def test_clipped_train_batch_tracks_the_reference(jit):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMALL["vocab_size"], (4, 16)).astype(np.int32)
    labels = np.roll(ids, -1, 1).reshape(4, 16, 1).astype(np.int64)
    paddle.seed(0)
    ref = RefGPT(RefConfig(**SMALL))
    net = GPT(GPTConfig(**SMALL), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(_state(ref), device="cpu"))
    rmodel = paddle.Model(ref)
    rmodel.prepare(paddle.optimizer.AdamW(
        1e-3, parameters=ref.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.01)),
        paddle.nn.CrossEntropyLoss())
    model = Model(net).prepare(
        AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01,
              grad_clip=ClipGradByGlobalNorm(0.01)), CrossEntropyLoss(),
        jit=jit)
    want, got = [], []
    for _ in range(3):
        want.append(float(rmodel.train_batch([ids], [labels])["loss"]))
        got.append(float(model.train_batch([ids], [labels])["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref_state = _state(ref)
    for k, v in net.state_dict().items():
        v = v.detach().numpy()
        np.testing.assert_allclose(v.T if k.endswith(LINEAR_WEIGHTS) else v,
                                   ref_state[k], atol=5e-4, err_msg=k)
    # the norm the gradients had before the clip is far above 0.01
    model.train_batch([ids], [labels], update=False)
    norm = torch.sqrt(sum((p.grad ** 2).sum() for p in net.parameters()
                          if p.grad is not None))
    assert norm > 0.1
