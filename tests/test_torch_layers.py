"""The eager core's ``nn.Layer`` and its layers against the reference's
(``paddle_tpu/nn/``): every ported layer with the reference's weights
carried across by ``set_state_dict`` (no renaming, no transposes), its
forward and gradients; ``state_dict`` keys; the initializers by their
statistics and by determinism under ``seed``; hooks, ``train`` /
``eval``, ``to``, ``functional_state``, the containers; the encoder at
L 2, d 64 (post-LN and pre-LN) forward, gradients and three AdamW steps;
and the same ``Layer`` through the port's ``Model`` (captured and not,
AMP, the budget remat), equal to the dygraph loop bit for bit."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.dtype import canonical_dtype as rname
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.core.dtype import canonical_dtype as pname
from paddle_tpu_torch.nn import torch_view
from torch_op_test import assert_same

rs = np.random.RandomState(0)
f32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    yield
    port_place._place = place


def carry(rlayer, player):
    """The reference layer's state dict, as numpy, into the port layer."""
    sd = {k: np.asarray(v.numpy()) for k, v in rlayer.state_dict().items()}
    missing, unexpected = player.set_state_dict(sd)
    assert not missing and not unexpected
    assert set(player.state_dict()) == set(rlayer.state_dict())


def run_layer(m, layer, inputs, grad_in=True, seed=0, train=False):
    layer.train() if train else layer.eval()
    xs = [m.to_tensor(a, stop_gradient=not (grad_in and
                                            a.dtype.kind == "f"))
          if isinstance(a, np.ndarray) else a for a in inputs]
    out = layer(*xs)
    leaves = [o for o in (out if isinstance(out, (tuple, list)) else [out])
              if o is not None and not isinstance(o, tuple)]
    loss = None
    r = np.random.RandomState(seed)
    for o in leaves:
        if o.stop_gradient:
            continue
        cot = m.to_tensor(r.randn(*o.shape).astype(f32))
        term = (o * cot).sum()
        loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    grads = {n: None if p.grad is None else np.asarray(p.grad.numpy())
             for n, p in layer.named_parameters()}
    xg = [None if not hasattr(x, "grad") or x.grad is None
          else np.asarray(x.grad.numpy()) for x in xs]
    return out, grads, xg


def check_layer(make, inputs, tol=1e-5, grad_tol=5e-5, train=False,
                grad_in=True):
    ref.seed(0)
    rl = make(ref)
    port.seed(1)
    pl = make(port)
    carry(rl, pl)
    rout, rg, rx = run_layer(ref, rl, inputs, grad_in, train=train)
    pout, pg, px = run_layer(port, pl, inputs, grad_in, train=train)
    assert_same(rout, pout, "red" if tol > 1e-6 else "ew")
    assert rg.keys() == pg.keys()
    for n in rg:
        assert (rg[n] is None) == (pg[n] is None), n
        if rg[n] is not None:
            np.testing.assert_allclose(pg[n], rg[n], atol=grad_tol,
                                       rtol=1e-4, err_msg=n)
    for a, b in zip(rx, px):
        if a is not None:
            np.testing.assert_allclose(b, a, atol=grad_tol, rtol=1e-4)
    return rl, pl


X = rs.randn(2, 5, 8).astype(f32)
X4 = rs.randn(2, 4, 3, 3).astype(f32)
X3 = rs.randn(2, 4, 6).astype(f32)
IDS = rs.randint(0, 10, (2, 5)).astype(np.int64)
Q16 = rs.randn(2, 6, 16).astype(f32)
MEM = rs.randn(2, 4, 16).astype(f32)
BOOL_MASK = rs.rand(2, 1, 6, 6) > 0.2

ACTIVATIONS = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish",
               "Hardswish", "Softsign", "LogSigmoid", "Tanhshrink", "GELU",
               "Softmax", "LogSoftmax", "LeakyReLU", "ELU", "CELU", "SELU",
               "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
               "Softplus", "ThresholdedReLU", "RReLU"]

LAYERS = [(f"act:{n}", (lambda n: lambda m: getattr(m.nn, n)())(n), [X])
          for n in ACTIVATIONS]
LAYERS += [
    ("act:PReLU", lambda m: m.nn.PReLU(4), [X4]),
    ("act:GLU", lambda m: m.nn.GLU(), [X]),
    ("act:Maxout", lambda m: m.nn.Maxout(2), [X4]),
    ("Linear", lambda m: m.nn.Linear(8, 3), [X]),
    ("Linear:nobias", lambda m: m.nn.Linear(8, 3, bias_attr=False), [X]),
    ("Embedding", lambda m: m.nn.Embedding(10, 4), [IDS]),
    ("Embedding:pad", lambda m: m.nn.Embedding(10, 4, padding_idx=3),
     [IDS]),
    ("Dropout:eval", lambda m: m.nn.Dropout(0.5), [X]),
    ("Dropout2D:eval", lambda m: m.nn.Dropout2D(0.5), [X4]),
    ("Dropout3D:eval", lambda m: m.nn.Dropout3D(0.5), [X4[None]]),
    ("AlphaDropout:eval", lambda m: m.nn.AlphaDropout(0.5), [X]),
    ("Flatten", lambda m: m.nn.Flatten(), [X4]),
    ("Identity", lambda m: m.nn.Identity(), [X]),
    ("Pad1D", lambda m: m.nn.Pad1D([1, 2], mode="reflect"), [X3]),
    ("Pad2D", lambda m: m.nn.Pad2D([1, 0, 2, 1]), [X4]),
    ("Pad3D", lambda m: m.nn.Pad3D([1, 0, 0, 1, 1, 1], mode="replicate"),
     [X4[None]]),
    ("ZeroPad2D", lambda m: m.nn.ZeroPad2D([1, 1, 1, 1]), [X4]),
    ("Bilinear", lambda m: m.nn.Bilinear(8, 8, 3), [X[0], X[1]]),
    ("CosineSimilarity", lambda m: m.nn.CosineSimilarity(axis=2),
     [X, X[::-1].copy()]),
    ("PairwiseDistance", lambda m: m.nn.PairwiseDistance(), [X[0], X[1]]),
    ("BatchNorm:eval", lambda m: m.nn.BatchNorm(4), [X4]),
    ("BatchNorm1D", lambda m: m.nn.BatchNorm1D(4), [X3]),
    ("BatchNorm2D", lambda m: m.nn.BatchNorm2D(4), [X4]),
    ("BatchNorm3D", lambda m: m.nn.BatchNorm3D(4), [X4[:, :, None]]),
    ("SyncBatchNorm", lambda m: m.nn.SyncBatchNorm(4), [X4]),
    ("LayerNorm", lambda m: m.nn.LayerNorm(8), [X]),
    ("LayerNorm:2d", lambda m: m.nn.LayerNorm([5, 8]), [X]),
    ("GroupNorm", lambda m: m.nn.GroupNorm(2, 4), [X4]),
    ("InstanceNorm1D", lambda m: m.nn.InstanceNorm1D(4), [X3]),
    ("InstanceNorm2D", lambda m: m.nn.InstanceNorm2D(4), [X4]),
    ("InstanceNorm3D", lambda m: m.nn.InstanceNorm3D(4), [X4[:, :, None]]),
    ("LocalResponseNorm", lambda m: m.nn.LocalResponseNorm(3), [X4]),
    ("RMSNorm", lambda m: m.nn.RMSNorm(8), [X]),
    ("Sequential", lambda m: m.nn.Sequential(m.nn.Linear(8, 6),
                                             m.nn.ReLU(),
                                             m.nn.Linear(6, 2)), [X]),
    ("MultiHeadAttention", lambda m: m.nn.MultiHeadAttention(16, 2),
     [Q16]),
    ("MultiHeadAttention:cross", lambda m: m.nn.MultiHeadAttention(
        16, 2, kdim=16, vdim=16), [Q16, MEM, MEM]),
    ("TransformerEncoderLayer:relu", lambda m: m.nn.TransformerEncoderLayer(
        16, 2, 32, dropout=0.0), [Q16]),
    ("TransformerDecoderLayer", lambda m: m.nn.TransformerDecoderLayer(
        16, 2, 32, dropout=0.0, activation="gelu"), [Q16, MEM]),
    ("TransformerDecoder:pre", lambda m: m.nn.TransformerDecoder(
        m.nn.TransformerDecoderLayer(16, 2, 32, dropout=0.0,
                                     normalize_before=True), 2,
        m.nn.LayerNorm(16)), [Q16, MEM]),
    ("Transformer", lambda m: m.nn.Transformer(
        16, 2, 1, 1, 32, dropout=0.0), [MEM, Q16]),
]


@pytest.mark.parametrize("name, make, inputs", LAYERS,
                         ids=[n for n, _, _ in LAYERS])
def test_layer_matches_the_reference(name, make, inputs):
    tol = 1e-5 if name.startswith(("act:", "Dropout", "Flatten", "Identity",
                                   "Pad", "Zero", "Alpha")) else 1e-4
    check_layer(make, inputs, tol=tol)


@pytest.mark.parametrize("kind", ["BatchNorm2D", "BatchNorm1D"])
def test_batch_norm_training_updates_the_running_statistics(kind):
    x = X4 if kind == "BatchNorm2D" else X3
    rl, pl = check_layer(lambda m: getattr(m.nn, kind)(4, momentum=0.8),
                         [x], train=True, tol=1e-4)
    for n in ("_mean", "_variance"):
        np.testing.assert_allclose(
            np.asarray(getattr(pl, n).numpy()),
            np.asarray(getattr(rl, n).numpy()), rtol=1e-5, atol=1e-6)
    assert "_mean" in pl.state_dict() and pl._mean is pl._mean


@pytest.mark.parametrize("mask", ["bool", "additive"])
def test_attention_masks(mask):
    m_arr = BOOL_MASK if mask == "bool" else \
        np.where(BOOL_MASK, 0.0, -1e9).astype(f32)

    def make(m):
        layer = m.nn.MultiHeadAttention(16, 2)
        return _Masked(m, layer, m_arr)
    check_layer(make, [Q16], tol=1e-4)


def _Masked(m, layer, mask):
    class Masked(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.attn = layer

        def forward(self, q):
            return self.attn(q, attn_mask=m.to_tensor(mask))
    return Masked()


@pytest.mark.parametrize("kind", ["Cache", "StaticCache", "FixedCache"])
def test_attention_caches(kind):
    def step(m, layer):
        layer.eval()
        q = m.to_tensor(Q16[:, :2])
        if kind == "Cache":
            cache = layer.gen_cache(q)
            out, cache = layer(q, cache=cache)
            out2, cache = layer(m.to_tensor(Q16[:, 2:3]), cache=cache)
            return out, out2, cache.k, cache.v
        if kind == "StaticCache":
            mem = m.to_tensor(MEM)
            cache = layer.gen_cache(mem, mem, type=layer.StaticCache)
            return layer(q, mem, mem, cache=cache)
        cache = layer.gen_cache(q, type=layer.FixedCache, max_length=6)
        out, cache = layer(q, cache=cache)
        out2, cache = layer(m.to_tensor(Q16[:, 2:3]), cache=cache)
        return out, out2, cache.k, cache.lengths
    ref.seed(0)
    rl = ref.nn.MultiHeadAttention(16, 2)
    pl = port.nn.MultiHeadAttention(16, 2)
    carry(rl, pl)
    with ref.no_grad():
        r = step(ref, rl)
    with port.no_grad():
        p = step(port, pl)
    assert_same(r, p, "red")


def test_encoder_state_dict_loads_from_the_reference_as_it_is():
    ref.seed(0)
    rl = ref.nn.TransformerEncoder(ref.nn.TransformerEncoderLayer(
        64, 4, 128, dropout=0.1, activation="gelu"), 2)
    pl = port.nn.TransformerEncoder(port.nn.TransformerEncoderLayer(
        64, 4, 128, dropout=0.1, activation="gelu"), 2)
    assert list(pl.state_dict()) == [k for k in pl.state_dict()]
    assert set(pl.state_dict()) == set(rl.state_dict())
    for k, v in rl.state_dict().items():
        assert list(v.shape) == pl.state_dict()[k].shape, k
    carry(rl, pl)
    for k, v in pl.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(rl.state_dict()[k].numpy()))
    # the stacked layers are copies: equal values, distinct parameters
    a, b = pl.layers[0].linear1.weight, pl.layers[1].linear1.weight
    assert a._data is not b._data


# -- the encoder at L 2, d 64 ------------------------------------------------
B, T, D, H, FF, C = 2, 32, 64, 4, 128, 8
ENC_X = np.random.RandomState(1).randn(B, T, D).astype(f32)
ENC_Y = np.random.RandomState(2).randint(0, C, (B, T, 1)).astype(np.int64)


def _net(m, pre_ln):
    class Net(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.enc = m.nn.TransformerEncoder(m.nn.TransformerEncoderLayer(
                D, H, FF, dropout=0.0, activation="gelu",
                normalize_before=pre_ln), 2,
                m.nn.LayerNorm(D) if pre_ln else None)
            self.head = m.nn.Linear(D, C)

        def forward(self, x):
            return self.head(self.enc(x))
    return Net()


@pytest.fixture(scope="module", params=[False, True], ids=["post", "pre"])
def encoders(request):
    ref.seed(0)
    rnet = _net(ref, request.param)
    state = {k: np.asarray(v.numpy()) for k, v in rnet.state_dict().items()}
    return request.param, rnet, state


def _port_net(pre_ln, state):
    net = _net(port, pre_ln)
    net.set_state_dict(state)
    return net


def test_encoder_forward_and_gradients(encoders):
    pre_ln, rnet, state = encoders
    pnet = _port_net(pre_ln, state)
    outs = []
    for m, net in ((ref, rnet), (port, pnet)):
        x = m.to_tensor(ENC_X, stop_gradient=False)
        out = net(x)
        m.nn.functional.cross_entropy(out, m.to_tensor(ENC_Y)).backward()
        outs.append((np.asarray(out.numpy()), np.asarray(x.grad.numpy()),
                     {n: np.asarray(p.grad.numpy())
                      for n, p in net.named_parameters()}))
        net.clear_gradients()
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=5e-5, rtol=0)
    assert outs[0][2].keys() == outs[1][2].keys()
    for n in outs[0][2]:
        np.testing.assert_allclose(outs[1][2][n], outs[0][2][n], atol=5e-5,
                                   rtol=0, err_msg=n)


def _dygraph(m, net, steps=3):
    opt = m.optimizer.AdamW(1e-3, parameters=net.parameters(),
                            weight_decay=0.01)
    losses = []
    for i in range(steps):
        x = m.to_tensor(np.roll(ENC_X, i, 1))
        y = m.to_tensor(np.roll(ENC_Y, i, 1))
        loss = m.nn.functional.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _params(net):
    return {n: p.numpy().copy() for n, p in net.named_parameters()}


def test_three_adamw_steps_track_the_reference(encoders):
    pre_ln, rnet0, state = encoders
    rnet = _net(ref, pre_ln)
    rnet.set_state_dict(state)
    pnet = _port_net(pre_ln, state)
    rl, pl = _dygraph(ref, rnet), _dygraph(port, pnet)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    want = {n: np.asarray(p.numpy()) for n, p in rnet.named_parameters()}
    got = _params(pnet)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=5e-4, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "captured"])
def test_model_train_batch_equals_the_dygraph_loop(encoders, jit):
    pre_ln, _, state = encoders
    loop = _port_net(pre_ln, state)
    losses = _dygraph(port, loop)
    net = _port_net(pre_ln, state)
    model = port.Model(net).prepare(
        port.optimizer.AdamW(1e-3, parameters=net.parameters(),
                             weight_decay=0.01),
        port.nn.CrossEntropyLoss(), jit=jit)
    got = []
    for i in range(3):
        logs = model.train_batch([port.to_tensor(np.roll(ENC_X, i, 1))],
                                 [port.to_tensor(np.roll(ENC_Y, i, 1))])
        got.append(float(logs["loss"]))
    assert got == losses
    want = _params(loop)
    for n, v in _params(net).items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)
    out = model.predict_batch([ENC_X])[0]
    assert out.shape == (B, T, C) and np.isfinite(out).all()
    assert isinstance(model.eval_batch([ENC_X], [ENC_Y])["loss"], float)


def test_model_on_a_layer_with_amp_remat_and_clip(encoders):
    pre_ln, _, state = encoders
    results = {}
    for key, amp, remat in (("plain", None, False), ("remat", None, True),
                            ("o1", "O1", False), ("o2", "O2", False)):
        net = _port_net(pre_ln, state)
        opt = port.optimizer.AdamW(
            1e-3, parameters=net.parameters(),
            grad_clip=port.nn.ClipGradByGlobalNorm(1.0))
        model = port.Model(net).prepare(opt, port.nn.CrossEntropyLoss(),
                                        amp_configs=amp)
        flags = {"FLAGS_program_remat": remat,
                 "FLAGS_remat_budget_mb": 1 if remat else 0}
        was = port.get_flags(list(flags))
        port.set_flags(flags)
        try:
            with pytest.warns(UserWarning) if remat else _nothing():
                loss = [float(model.train_batch([ENC_X], [ENC_Y])["loss"])
                        for _ in range(2)]
        finally:
            port.set_flags(was)
        results[key] = (loss, _params(net))
    plain = results["plain"]
    assert results["remat"][0] == plain[0]
    for n, v in results["remat"][1].items():
        np.testing.assert_array_equal(v, plain[1][n], err_msg=n)
    for key in ("o1", "o2"):
        np.testing.assert_allclose(results[key][0], plain[0], rtol=2e-2)
        assert all(np.isfinite(v).all() for v in results[key][1].values())
        assert all(v.dtype == np.float32 for v in results[key][1].values())


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_torch_view_and_functional_call():
    port.seed(0)
    net = port.nn.Sequential(port.nn.Linear(4, 3), port.nn.LayerNorm(3))
    view = torch_view(net)
    assert [type(p) for p in view.parameters()] == [torch.nn.Parameter] * 4
    assert [type(p).__name__ for p in net.parameters()] == ["Parameter"] * 4
    params, buffers = net.functional_state()
    assert set(params) == {"0.weight", "0.bias", "1.weight", "1.bias"}
    doubled = {k: v * 2 for k, v in params.items()}
    x = torch.randn(2, 4)
    got = torch.func.functional_call(net, doubled, (x,))
    net.load_functional_state(doubled)
    assert torch.equal(got, net(x)) and isinstance(net(x), torch.Tensor)
    # the wrappers stay the parameters' after the call
    assert net[0].weight._data is params["0.weight"]
    torch_sd = view.state_dict()
    assert all(isinstance(v, torch.Tensor) for v in torch_sd.values())


def test_layer_registration_and_traversal():
    for m in (ref, port):
        class Net(m.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = m.nn.Linear(3, 2)
                self.w = self.create_parameter(
                    [2], attr=m.ParamAttr(
                        name="w_attr", learning_rate=0.5,
                        initializer=m.nn.initializer.Constant(2.0)))
                self.add_parameter("extra", self.create_parameter([1],
                                                                  is_bias=True))
                self.register_buffer("kept", m.to_tensor([1.0]))
                self.register_buffer("scratch", m.to_tensor([2.0]),
                                     persistable=False)
                self.add_sublayer("act", m.nn.ReLU())
        net = Net()
        names = [n for n, _ in net.named_parameters()]
        assert set(names) == {"fc.weight", "fc.bias", "w", "extra"}
        assert set(net.state_dict()) == set(names) | {"kept"}
        assert [n for n, _ in net.named_buffers()] == ["kept", "scratch"]
        assert len(net.sublayers()) == 2 and len(
            net.sublayers(include_self=True)) == 3
        assert net.w.name == "w_attr" and \
            net.w.optimize_attr["learning_rate"] == 0.5
        np.testing.assert_array_equal(np.asarray(net.w.numpy()), [2.0, 2.0])
        assert net.full_name() == "net"
        named = dict(net.named_parameters(prefix="top"))
        assert "top.fc.weight" in named
    frozen = port.nn.Linear(2, 2, weight_attr=port.ParamAttr(
        trainable=False))
    assert frozen.weight.stop_gradient and not frozen.bias.stop_gradient


def test_hooks_modes_and_movement():
    outs = []
    for m in (ref, port):
        m.seed(0)
        layer = m.nn.Linear(3, 2)
        layer.set_state_dict({"weight": np.eye(3, 2, dtype=f32),
                              "bias": np.ones(2, f32)})
        pre = layer.register_forward_pre_hook(
            lambda lyr, inp: (inp[0] * 2.0,))
        post = layer.register_forward_post_hook(
            lambda lyr, inp, out: out + 10.0)
        x = m.to_tensor(np.ones((1, 3), f32))
        outs.append(np.asarray(layer(x).numpy()))
        pre.remove()
        post.remove()
        outs.append(np.asarray(layer(x).numpy()))
        seq = m.nn.Sequential(m.nn.Dropout(0.5), m.nn.Linear(3, 3))
        seq.eval()
        assert not seq.training and not seq[0].training
        seq.train()
        assert seq[0].training
        layer.to(dtype="float16")
        assert rname(layer.weight.dtype) == "float16" if m is ref else \
            pname(layer.weight.dtype) == "float16"
        layer.float()
    np.testing.assert_array_equal(outs[2], outs[0])
    np.testing.assert_array_equal(outs[3], outs[1])
    np.testing.assert_array_equal(outs[0], [[13.0, 13.0]])
    port.seed(0)
    lin = port.nn.Linear(3, 2)
    lin.astype("bfloat16")
    assert pname(lin.weight.dtype) == "bfloat16" and lin._dtype == "bfloat16"
    lin.to("cpu")
    lin.bfloat16().half()
    assert pname(lin.bias.dtype) == "float16"
    lin.clear_gradients()


def test_containers():
    port.seed(0)
    ll = port.nn.LayerList([port.nn.Linear(2, 2)])
    ll.append(port.nn.ReLU())
    ll.insert(0, port.nn.Tanh())
    ll.extend([port.nn.Sigmoid()])
    assert [type(x).__name__ for x in ll] == ["Tanh", "Linear", "ReLU",
                                              "Sigmoid"]
    assert isinstance(ll[-1], port.nn.Sigmoid) and len(ll[1:3]) == 2
    assert "1.weight" in ll.state_dict()
    pl = port.nn.ParameterList([port.nn.Linear(2, 2).weight])
    pl.append(port.nn.Linear(2, 3).weight)
    assert len(pl) == 2 and pl[1].shape == [2, 3]
    assert [n for n, _ in pl.named_parameters()] == ["0", "1"]
    ld = port.nn.LayerDict({"a": port.nn.ReLU()})
    ld["b"] = port.nn.Tanh()
    assert list(ld.keys()) == ["a", "b"] and "b" in ld
    assert isinstance(ld.pop("a"), port.nn.ReLU) and len(ld) == 1
    seq = port.nn.Sequential(("first", port.nn.Linear(2, 2)),
                             ("second", port.nn.ReLU()))
    assert isinstance(seq[0:1], port.nn.Sequential)
    assert list(dict(seq.named_children())) == ["first", "second"]


# -- initializers --------------------------------------------------------------
INITS = [
    ("Constant", lambda I: I.Constant(0.5), (0.5, 0.0)),
    ("Normal", lambda I: I.Normal(1.0, 2.0), (1.0, 2.0)),
    ("TruncatedNormal", lambda I: I.TruncatedNormal(0.0, 1.0),
     (0.0, 0.8796)),
    ("Uniform", lambda I: I.Uniform(-1.0, 3.0), (1.0, 1.1547)),
    ("XavierNormal", lambda I: I.XavierNormal(),
     (0.0, np.sqrt(2 / (200 + 300)))),
    ("XavierUniform", lambda I: I.XavierUniform(),
     (0.0, np.sqrt(6 / 500) / np.sqrt(3))),
    ("KaimingNormal", lambda I: I.KaimingNormal(), (0.0, np.sqrt(2 / 200))),
    ("KaimingUniform", lambda I: I.KaimingUniform(),
     (0.0, np.sqrt(2) * np.sqrt(3 / 200) / np.sqrt(3))),
]


@pytest.mark.parametrize("name, make, moments", INITS,
                         ids=[n for n, _, _ in INITS])
def test_initializer_statistics_and_determinism(name, make, moments):
    shape = [200, 300]
    ref.seed(0)
    r = np.asarray(make(ref.nn.initializer)(shape, "float32"))
    port.seed(0)
    a = make(port.nn.initializer)(shape, "float32")
    port.seed(0)
    b = make(port.nn.initializer)(shape, "float32")
    assert torch.equal(a, b) and a.dtype == torch.float32
    x = a.numpy().astype(np.float64)
    for v in (x, r.astype(np.float64)):
        assert abs(v.mean() - moments[0]) < 0.02 * max(1.0, moments[1] * 10)
        assert abs(v.std() - moments[1]) <= 0.02 * moments[1] + 1e-9
    if name == "TruncatedNormal":
        assert np.abs(x).max() <= 2.0


def test_deterministic_initializers_equal_the_references():
    I, J = ref.nn.initializer, port.nn.initializer
    for shape, make in (([3, 2, 4, 4], lambda m: m.Bilinear()),
                        ([4, 3, 3], lambda m: m.Dirac()),
                        ([2, 3], lambda m: m.Assign(np.arange(6.0)))):
        np.testing.assert_array_equal(
            make(J)(shape, "float32").numpy(),
            np.asarray(make(I)(shape, "float32")))
    port.seed(0)
    q = J.Orthogonal(gain=2.0)([4, 6], "float32").numpy()
    np.testing.assert_allclose(q @ q.T, 4 * np.eye(4), atol=1e-5)
    for nl in ("relu", "tanh", "leaky_relu", "selu", "sigmoid"):
        assert J.calculate_gain(nl) == I.calculate_gain(nl)


def test_layer_parameters_are_seeded():
    def make():
        port.seed(7)
        return port.nn.TransformerEncoderLayer(16, 2, 32)
    a, b = make(), make()
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=n)
    port.seed(8)
    c = port.nn.TransformerEncoderLayer(16, 2, 32)
    assert not np.array_equal(c.linear1.weight.numpy(),
                              a.linear1.weight.numpy())


def test_dropout_statistics_and_determinism_in_a_layer():
    layer = port.nn.Dropout(0.25)
    x = port.ones([400, 50])
    port.seed(3)
    a = layer(x).numpy()
    port.seed(3)
    b = layer(x).numpy()
    np.testing.assert_array_equal(a, b)
    kept = a != 0
    assert abs(kept.mean() - 0.75) < 0.01
    np.testing.assert_allclose(a[kept], 1 / 0.75, rtol=1e-6)
    d2 = port.nn.Dropout2D(0.5)(port.ones([8, 6, 4, 4])).numpy()
    assert all(len(np.unique(d2[i, j])) == 1 for i in range(8)
               for j in range(6))


def test_a_layer_needs_the_card_or_an_explicit_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(port_place, "_place", None)
    with pytest.raises(port.NoCudaDevice):
        port.nn.TransformerEncoderLayer(16, 2, 32)


def test_deepcopy_keeps_the_paddle_attributes():
    lin = port.nn.Linear(2, 2, weight_attr=port.ParamAttr(
        learning_rate=0.1, need_clip=False))
    dup = copy.deepcopy(lin)
    assert dup.weight._data is not lin.weight._data
    assert dup.weight.optimize_attr["learning_rate"] == 0.1
    assert dup.weight.need_clip is False
    np.testing.assert_array_equal(dup.weight.numpy(), lin.weight.numpy())


def test_the_ports_consumers_take_a_layer_and_tensors(tmp_path, capsys):
    """summary / flops, framework_io, the checkpoint, the metrics and the
    clip, each on a Layer and Tensors."""
    from paddle_tpu_torch import framework_io
    from paddle_tpu_torch.distributed import checkpoint
    port.seed(0)
    net = port.nn.Sequential(port.nn.Linear(4, 6), port.nn.ReLU(),
                             port.nn.Linear(6, 3))
    assert port.summary(net, (2, 4)) == {"total_params": 51,
                                         "trainable_params": 51}
    assert "[2, 6]" in capsys.readouterr().out
    assert port.flops(net, [2, 4]) == 2 * (4 * 6 * 2 + 6 * 3 * 2)
    path = str(tmp_path / "net.pdparams")
    framework_io.save(net.state_dict(), path)
    port.seed(1)
    other = port.nn.Sequential(port.nn.Linear(4, 6), port.nn.ReLU(),
                               port.nn.Linear(6, 3))
    assert other.set_state_dict(framework_io.load(path)) == ([], [])
    np.testing.assert_array_equal(other[0].weight.numpy(),
                                  net[0].weight.numpy())
    checkpoint.save_layer(str(tmp_path / "ckpt"), net, step=1)
    port.seed(2)
    third = port.nn.Sequential(port.nn.Linear(4, 6), port.nn.ReLU(),
                               port.nn.Linear(6, 3))
    checkpoint.load_layer(str(tmp_path / "ckpt"), third)
    np.testing.assert_array_equal(third[2].bias.numpy(), net[2].bias.numpy())
    acc = port.metric.Accuracy()
    pred = port.to_tensor(np.eye(3, dtype=f32))
    label = port.to_tensor(np.array([[0], [1], [0]]))
    acc.update(acc.compute(pred, label))
    assert abs(acc.accumulate() - 2 / 3) < 1e-6
    x = port.to_tensor(np.ones((2, 4), f32))
    net(x).sum().backward()
    clip = port.nn.ClipGradByGlobalNorm(1e-3)
    pairs = clip([(p, p.grad) for p in net.parameters()])
    total = np.sqrt(sum((g.numpy() ** 2).sum() for _, g in pairs))
    assert abs(total - 1e-3) < 1e-7 and type(pairs[0][1]).__name__ == \
        "Tensor"
