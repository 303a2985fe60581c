"""The fused transformer layers of paddle_tpu_torch against the JAX
reference (``paddle_tpu.incubate.nn``).

Each layer of the port is built on the CPU and takes the reference
layer's weights through ``fused_transformer_state_from_paddle_tpu``.  In
train mode only the fused epilogue drops (``dropout_rate`` 0.3, attention
and activation dropout 0): the test records the seeds the reference draws
for it (by wrapping its generator) and hands them to the port, so both
sides drop the same elements.  The plain dropout of attention and of the
activation draws torch's bits, not JAX's; it is held to its statistics
here.  Last, a 2-layer encoder with embeddings and an untied head takes
three ``Model.train_batch`` steps in both packages (the reference's eager
engine, whose seeds are concrete).

Tolerances, fp32 on the CPU: layer outputs and gradients atol 1e-5 (the
two sides' products and sums differ in their last bits, carried through a
LayerNorm); losses rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.incubate import nn as rinc
from paddle_tpu.ops import fused_ops as rfo

import paddle_tpu_torch
from paddle_tpu_torch import Model
from paddle_tpu_torch.incubate import nn as inc
from paddle_tpu_torch.incubate.nn import functional as F
from paddle_tpu_torch.models import fused_transformer_state_from_paddle_tpu
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.ops import fused_ops as fo
from paddle_tpu_torch.ops.nn_misc import dropout
from paddle_tpu_torch.optimizer import AdamW

B, T, D, H, FF = 2, 8, 32, 4, 64
ATOL, LOSS_RTOL = 1e-5, 1e-4


class _Recorder:
    """Stands in for the reference's generator in ``ops/fused_ops.py`` and
    keeps the seed each draw becomes (``fused_ops.py:201``)."""

    def __init__(self, gen):
        self.gen, self.seeds = gen, []

    def next_key(self):
        key = self.gen.next_key()
        self.seeds.append(int(jax.random.randint(key, (), 0, 2**31 - 1)))
        return key


@pytest.fixture
def shared_seeds(monkeypatch):
    """The reference's epilogue seeds, replayed in order by the port."""
    rec = _Recorder(rfo.default_generator)
    monkeypatch.setattr(rfo, "default_generator", rec)
    replay = []

    def next_seed():
        replay.append(rec.seeds[len(replay)])
        return replay[-1]

    monkeypatch.setattr(fo, "_next_seed", next_seed)
    return rec.seeds, replay


def _state(layer):
    return {k: np.array(v) for k, v in layer.functional_state()[0].items()}


def _pair(kind, dropout_rate=0.3, normalize_before=False):
    """(reference layer, port layer with the reference's weights)."""
    paddle.seed(0)
    if kind == "ln":
        args, kw = (D,), dict(dropout_rate=dropout_rate)
        ref, port = rinc.FusedBiasDropoutResidualLayerNorm, \
            inc.FusedBiasDropoutResidualLayerNorm
    elif kind == "mha":
        args = (D, H)
        kw = dict(dropout_rate=dropout_rate, attn_dropout_rate=0.0,
                  normalize_before=normalize_before)
        ref, port = rinc.FusedMultiHeadAttention, inc.FusedMultiHeadAttention
    elif kind == "ffn":
        args = (D, FF)
        kw = dict(dropout_rate=dropout_rate, act_dropout_rate=0.0,
                  activation="gelu", normalize_before=normalize_before)
        ref, port = rinc.FusedFeedForward, inc.FusedFeedForward
    else:
        args = (D, H, FF)
        kw = dict(dropout_rate=dropout_rate, attn_dropout_rate=0.0,
                  act_dropout_rate=0.0, activation="gelu",
                  normalize_before=normalize_before)
        ref, port = rinc.FusedTransformerEncoderLayer, \
            inc.FusedTransformerEncoderLayer
    rlayer = ref(*args, **kw)
    layer = port(*args, **kw, device="cpu")
    state = _state(rlayer)
    # the reference's layers carry their qkv_bias etc. under the same names
    layer.load_state_dict(fused_transformer_state_from_paddle_tpu(
        state, device="cpu"), strict=True)
    # ... and the two layers randomly initialise the same shapes alike
    paddle_tpu_torch.seed(0)
    fresh = port(*args, **kw, device="cpu")
    for name, p in fresh.named_parameters():
        assert p.shape == state[name].shape, name
    return rlayer, layer


def _inputs(kind):
    rs = np.random.RandomState(1)
    x = rs.randn(B, T, D).astype(np.float32)
    return (x, rs.randn(B, T, D).astype(np.float32)) if kind == "ln" else (x,)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["ln", "mha", "ffn", "encoder"])
def test_layer_matches_the_reference(kind, train, shared_seeds):
    rlayer, layer = _pair(kind)
    rlayer.train() if train else rlayer.eval()
    layer.train(train)
    arrays = _inputs(kind)
    want = rlayer(*(paddle.to_tensor(a) for a in arrays)).numpy()
    got = layer(*(torch.from_numpy(a) for a in arrays))
    seeds, replay = shared_seeds
    assert replay == seeds and len(seeds) == {"ln": 1, "mha": 1, "ffn": 1,
                                              "encoder": 2}[kind]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=0)
    if train:
        # a dropout of 0.3 moved the outputs: the masks were applied
        rlayer.eval()
        still = rlayer(*(paddle.to_tensor(a) for a in arrays)).numpy()
        assert np.abs(still - want).max() > 1e-2


def test_encoder_layer_gradients_match_the_reference(shared_seeds):
    rlayer, layer = _pair("encoder")
    rlayer.train()
    layer.train()
    (x,) = _inputs("encoder")
    cot = np.random.RandomState(2).randn(B, T, D).astype(np.float32)
    rx = paddle.to_tensor(x, stop_gradient=False)
    paddle.sum(rlayer(rx) * paddle.to_tensor(cot)).backward()
    tx = torch.from_numpy(x).requires_grad_()
    (layer(tx) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(), atol=ATOL,
                               rtol=0)
    rparams = dict(rlayer.named_parameters())
    for name, p in layer.named_parameters():
        if "pre_ln" in name or name.startswith("ffn.ln1"):
            continue                      # unused in the post-LN layer
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(rparams[name].grad.numpy()),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", ["mha", "ffn", "encoder"])
def test_pre_ln_variant_matches_the_reference(kind):
    rlayer, layer = _pair(kind, normalize_before=True)
    rlayer.eval()
    layer.eval()
    (x,) = _inputs(kind)
    want = rlayer(paddle.to_tensor(x)).numpy()
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=0)


def test_layers_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError, match="need_weights"):
        inc.FusedMultiHeadAttention(D, H, need_weights=True, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        inc.FusedMultiHeadAttention(D, 5, device="cpu")
    mha = inc.FusedMultiHeadAttention(D, H, device="cpu")
    x = torch.rand(B, T, D)
    with pytest.raises(NotImplementedError, match="self-attention"):
        mha(x, torch.rand(B, T, D))
    with pytest.raises(NotImplementedError, match="cache"):
        mha(x, cache=object())
    # ParamAttr is ported: the attribute's initializer and settings land
    # on the parameters; what is no attribute still raises, naming it
    from paddle_tpu_torch.nn import ParamAttr, initializer
    ffn = inc.FusedFeedForward(
        D, FF, weight_attr=ParamAttr(initializer=initializer.Constant(0.5),
                                     learning_rate=2.0),
        bias_attr=ParamAttr(trainable=False), device="cpu")
    assert torch.all(ffn.linear1_weight == 0.5)
    assert ffn.linear2_weight.optimize_attr["learning_rate"] == 2.0
    assert not ffn.linear1_bias.requires_grad
    assert torch.all(ffn.ln1_scale == 1.0) and ffn.ln1_scale.requires_grad
    with pytest.raises(TypeError, match="ParamAttr"):
        inc.FusedFeedForward(D, FF, weight_attr=object(), device="cpu")
    # an activation the reference's ops lack raises as its getattr does
    # (C16: any of its activations builds)
    with pytest.raises(AttributeError, match="no_such_activation"):
        inc.FusedFeedForward(D, FF, activation="no_such_activation",
                             device="cpu")


FUSED_BUILDS = {
    "FusedMultiHeadAttention": lambda: inc.FusedMultiHeadAttention(D, H),
    "FusedFeedForward": lambda: inc.FusedFeedForward(D, FF),
    "FusedTransformerEncoderLayer": lambda: inc.FusedTransformerEncoderLayer(
        16, 2, 32, dropout_rate=0.0),
    "FusedBiasDropoutResidualLayerNorm":
        lambda: inc.FusedBiasDropoutResidualLayerNorm(D)}


@pytest.fixture
def restore_place():
    from paddle_tpu_torch.core import place as port_place
    place = port_place._place
    yield
    port_place._place = place


@pytest.mark.parametrize("name", sorted(FUSED_BUILDS))
def test_fused_layers_build_on_the_place_set_device_sets(name,
                                                         restore_place):
    """C15 (``ROADMAP.md`` §C): with no ``device=``, a fused layer builds
    on the current place, as every other layer; an explicit ``device=``
    still wins."""
    paddle_tpu_torch.set_device("cpu")
    layer = FUSED_BUILDS[name]()
    assert all(p.device.type == "cpu" for p in layer.parameters())
    assert paddle_tpu_torch.nn.Linear(4, 4).weight.place == \
        paddle_tpu_torch.CPUPlace()


@pytest.mark.parametrize("activation", ["silu", "tanh", "sigmoid",
                                        "leaky_relu"])
def test_feedforward_takes_the_references_activations(activation):
    """C16 (``ROADMAP.md`` §C): the reference takes any of its ops by name
    (``getattr(P, activation)``); the port's forward and gradients under
    these four match it at the products' tolerance, with the weights
    carried by the fused layers' converter."""
    kw = dict(dropout_rate=0.0, act_dropout_rate=0.0, activation=activation)
    paddle.seed(0)
    rlayer = rinc.FusedFeedForward(D, FF, **kw)
    layer = inc.FusedFeedForward(D, FF, **kw, device="cpu")
    layer.load_state_dict(fused_transformer_state_from_paddle_tpu(
        _state(rlayer), device="cpu"), strict=True)
    rlayer.eval()
    layer.eval()
    (x,) = _inputs("ffn")
    cot = np.random.RandomState(3).randn(B, T, D).astype(np.float32)
    rx = paddle.to_tensor(x, stop_gradient=False)
    out = rlayer(rx)
    paddle.sum(out * paddle.to_tensor(cot)).backward()
    tx = torch.from_numpy(x).requires_grad_()
    got = layer(tx)
    (got * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), out.numpy(), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(), **tol)
    rparams = dict(rlayer.named_parameters())
    for name, p in layer.named_parameters():
        if name.startswith("ln1"):
            continue                      # unused in the post-LN layer
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(rparams[name].grad.numpy()),
                                   err_msg=name, **tol)


def test_plain_dropout_statistics_and_determinism():
    x = torch.ones(4000, 50)
    paddle_tpu_torch.seed(3)
    a = dropout(x, p=0.3)
    paddle_tpu_torch.seed(3)
    b = dropout(x, p=0.3)
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert dropout(x, p=0.3, training=False) is x
    assert dropout(x, p=0.0) is x
    # attention dropout goes to the plain math and drops probabilities
    q = torch.rand(2, 16, 2, 8)
    from paddle_tpu_torch.ops.nn_misc import scaled_dot_product_attention
    full = scaled_dot_product_attention(q, q, q)
    dropped = scaled_dot_product_attention(q, q, q, dropout_p=0.5)
    assert not torch.allclose(full, dropped)
    torch.testing.assert_close(
        scaled_dot_product_attention(q, q, q, dropout_p=0.5, training=False),
        full)


def test_functional_forms_take_the_reference_layouts():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(B, T, D).astype(np.float32))
    qkv_w = torch.from_numpy(rs.randn(3, H, D // H, D).astype(np.float32))
    lin_w = torch.from_numpy(rs.randn(D, D).astype(np.float32) * 0.1)
    out = F.fused_multi_head_attention(x, qkv_w, lin_w, dropout_rate=0.0,
                                       attn_dropout_rate=0.0, training=False)
    w = qkv_w.permute(3, 0, 1, 2).reshape(D, 3 * D)
    q, k, v = (x @ w).reshape(B, T, 3, H, D // H).unbind(2)
    att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                        / np.sqrt(D // H), -1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, D)
    want = torch.nn.functional.layer_norm(x + ctx @ lin_w, (D,))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)


# -- a 2-layer encoder with embeddings and a head, three train_batch steps ----
V, L = 50, 2


class RefEncoder(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.wte = paddle.nn.Embedding(V, D)
        self.wpe = paddle.nn.Embedding(T, D)
        self.layers = paddle.nn.LayerList([
            rinc.FusedTransformerEncoderLayer(
                D, H, FF, dropout_rate=0.1, activation="gelu",
                attn_dropout_rate=0.0, act_dropout_rate=0.0)
            for _ in range(L)])
        self.head = paddle.nn.Linear(D, V)

    def forward(self, ids):
        x = self.wte(ids) + self.wpe(paddle.arange(ids.shape[1]))
        for layer in self.layers:
            x = layer(x)
        return self.head(x)


class Encoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.wte = torch.nn.Embedding(V, D)
        self.wpe = torch.nn.Embedding(T, D)
        self.layers = torch.nn.ModuleList([
            inc.FusedTransformerEncoderLayer(
                D, H, FF, dropout_rate=0.1, activation="gelu",
                attn_dropout_rate=0.0, act_dropout_rate=0.0, device="cpu")
            for _ in range(L)])
        self.head = torch.nn.Linear(D, V)

    def forward(self, ids):
        x = self.wte(ids) + self.wpe(torch.arange(ids.shape[1]))
        for layer in self.layers:
            x = layer(x)
        return self.head(x)


def test_encoder_train_batch_tracks_the_reference(shared_seeds):
    paddle.seed(0)
    ref = RefEncoder()
    state = _state(ref)
    net = Encoder()
    weights = fused_transformer_state_from_paddle_tpu(
        {k: v for k, v in state.items() if k != "head.weight"},
        device="cpu")
    weights["head.weight"] = torch.from_numpy(state["head.weight"].T.copy())
    net.load_state_dict(weights, strict=True)
    rmodel = paddle.Model(ref)
    rmodel.prepare(paddle.optimizer.AdamW(1e-3, parameters=ref.parameters(),
                                          weight_decay=0.01),
                   paddle.nn.CrossEntropyLoss(), jit=False)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters(),
                                     weight_decay=0.01), CrossEntropyLoss())
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, (B, T)).astype(np.int64)
    labels = np.roll(ids, -1, 1).reshape(B, T, 1)
    want, got = [], []
    for _ in range(3):
        want.append(float(rmodel.train_batch([ids], [labels])["loss"]))
        got.append(float(model.train_batch([ids], [labels])["loss"]))
    seeds, replay = shared_seeds
    assert len(seeds) == 3 * 2 * L and replay == seeds
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_build_encoder_is_seeded_and_runs_on_the_cpu():
    from paddle_tpu_torch.tools.profile_train import build_encoder
    cfg = dict(vocab_size=V, d_model=D, num_layers=L, nhead=H,
               dim_feedforward=FF, max_len=T, dropout_rate=0.1)
    a, b = (build_encoder(cfg, device="cpu", seed_val=4) for _ in range(2))
    assert len(a.layers) == L and a.wpe.weight.shape == (T, D)
    assert not a.layers[0].fused_attn.normalize_before
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    a.eval()
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, V, (B, T)))
    out = a(ids.int())
    assert out.shape == (B, T, V) and torch.isfinite(out).all()
