"""AMP in paddle_tpu_torch against the JAX reference (``paddle_tpu.amp``,
``Model.prepare(amp_configs=...)``).

- The op lists and ``classify_op`` (custom lists included) equal the
  reference's.
- The casting hook: for O1 and O2, the floating types each value-changing
  op of a small GPT (L 2, D 64, H 4) and a small fused encoder sees under
  ``auto_cast`` equal what the reference's ``amp_cast_inputs`` gives the
  same op of the same model, op by op (the port records its hook's casts
  in ``amp.RECORD``; the reference's are recorded by wrapping
  ``amp_cast_inputs``).  Ops that only move data (reshape, split,
  squeeze, transpose, slice) are left out: the port does not name them.
- ``Model.prepare(amp_configs="O1")`` and ``{"level": "O2"}``:
  ``train_batch`` tracks the reference's ``Model`` over three steps from
  the same weights (``gpt_state_from_paddle_tpu``) and batch; losses at
  rtol 2e-2, since both round to bf16 values summed in other orders.  O2
  keeps fp32 masters.
- ``GradScaler``: bf16 passes through with one warning; fp16's scale
  state follows ``update_loss_scaling`` step for step.
- What is refused: levels other than O1 and O2, dtypes other than bf16
  and fp16; float16 prepares on the card (since the fp16 kernels).
  ``decorate`` with optimizers turns on their fp32 masters
  (``multi_precision``; held to the reference in
  ``tests/test_torch_optimizers.py``).
"""
import threading
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.amp as ramp
from paddle_tpu.incubate import nn as rinc
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig
from paddle_tpu.ops import amp_ops as ramp_ops

from paddle_tpu_torch import Model, amp
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.nn import CrossEntropyLoss, torch_view
from paddle_tpu_torch.ops import amp_ops
from paddle_tpu_torch.optimizer import AdamW

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=32, ffn_mult=2)
B, T, STEPS, LOSS_RTOL = 4, 16, 3, 2e-2
V, D, H, FF = 50, 64, 4, 128
# the ops that change values; the reference also dispatches the data
# movers (reshape, split, squeeze, transpose, slice), which the port does
# not name
VALUE_OPS = {"embedding", "add", "layer_norm", "linear", "matmul", "gelu",
             "scaled_dot_product_attention",
             "fused_bias_dropout_residual_layer_norm", "cross_entropy"}
_FLOAT_NAMES = ("float32", "bfloat16", "float16")


def test_lists_and_classify_op_equal_the_reference():
    assert amp.WHITE_LIST == ramp.WHITE_LIST
    assert amp.BLACK_LIST == ramp.BLACK_LIST
    names = sorted(ramp.WHITE_LIST | ramp.BLACK_LIST | {"gelu", "add"})
    for white, black in [(None, None), (["gelu", "softmax"], None),
                         (None, ["matmul", "add"]),
                         (["layer_norm", "add"], ["add", "linear"])]:
        for name in names:
            assert amp.classify_op(name, white, black) == \
                ramp.classify_op(name, white, black), (name, white, black)


def _ref_record(monkeypatch):
    seen = []
    real = ramp.amp_cast_inputs

    def wrap(op, arrays):
        out = real(op, arrays)
        floats = [(a, o) for a, o in zip(arrays, out)
                  if str(getattr(a, "dtype", None)) in _FLOAT_NAMES]
        seen.append((op, tuple(str(a.dtype) for a, _ in floats),
                     tuple(str(o.dtype) for _, o in floats)))
        return out

    monkeypatch.setattr(ramp, "amp_cast_inputs", wrap)
    return seen


def _port_record(monkeypatch):
    seen = []
    monkeypatch.setattr(amp, "RECORD", seen)
    return seen


def _value_ops(record):
    """(op, the floating types it computes on) for each value-changing op:
    the types after the cast.  The types before it may differ where they
    change nothing: the reference's O2 casts the qkv weight and bias when
    it transposes and reshapes them, the port at the product; and on the
    CPU the reference's attention math returns fp32 for bf16 inputs (its
    scale is a numpy float64), which the next product casts back."""
    return [(op, tuple(str(d).replace("torch.", "") for d in after))
            for op, _, after in record if op in VALUE_OPS]


class RefEncoder(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.wte = paddle.nn.Embedding(V, D)
        self.wpe = paddle.nn.Embedding(T, D)
        self.layers = paddle.nn.LayerList([
            rinc.FusedTransformerEncoderLayer(
                D, H, FF, dropout_rate=0.1, activation="gelu",
                attn_dropout_rate=0.0, act_dropout_rate=0.0)
            for _ in range(2)])
        self.head = paddle.nn.Linear(D, V)

    def forward(self, ids):
        x = self.wte(ids) + self.wpe(paddle.arange(ids.shape[1]))
        for layer in self.layers:
            x = layer(x)
        return self.head(x)


def _models(kind):
    """(reference model, port model, ids) in train mode."""
    paddle.seed(0)
    rs = np.random.RandomState(0)
    if kind == "gpt":
        ref, net = RefGPT(RefConfig(**SMALL)), GPT(GPTConfig(**SMALL),
                                                   device="cpu")
        ids = rs.randint(0, SMALL["vocab_size"], (B, T)).astype(np.int64)
    else:
        from paddle_tpu_torch.tools.profile_train import build_encoder
        ref = RefEncoder()
        net = build_encoder(dict(vocab_size=V, d_model=D, num_layers=2,
                                 nhead=H, dim_feedforward=FF, max_len=T,
                                 dropout_rate=0.1), device="cpu")
        ids = rs.randint(0, V, (B, T)).astype(np.int64)
    ref.train()
    net.train()
    return ref, net, ids


@pytest.mark.parametrize("kind", ["gpt", "encoder"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_each_op_is_cast_as_the_reference_casts_it(monkeypatch, level,
                                                   kind):
    ref, net, ids = _models(kind)
    want, got = _ref_record(monkeypatch), _port_record(monkeypatch)
    with ramp.auto_cast(level=level):
        r_out = ref(paddle.to_tensor(ids))
    with amp.auto_cast(level=level):
        out = net(torch.from_numpy(ids))
    want, got = _value_ops(want), _value_ops(got)
    assert len(want) > 10
    assert got == want
    assert str(out.dtype).replace("torch.", "") == str(r_out._data.dtype)


def _train(level, amp_configs):
    paddle.seed(0)
    ref = RefGPT(RefConfig(**SMALL))
    state = {k: np.array(v) for k, v in ref.functional_state()[0].items()}
    net = GPT(GPTConfig(**SMALL), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(state, device="cpu"))
    rmodel = paddle.Model(ref)
    rmodel.prepare(paddle.optimizer.AdamW(1e-3, parameters=ref.parameters(),
                                          weight_decay=0.01),
                   paddle.nn.CrossEntropyLoss(), amp_configs=amp_configs)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters(),
                                     weight_decay=0.01), CrossEntropyLoss(),
                               amp_configs=amp_configs)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, SMALL["vocab_size"], (B, T)).astype(np.int32)
    labels = np.roll(ids, -1, 1).reshape(B, T, 1).astype(np.int64)
    want = [float(rmodel.train_batch([ids], [labels])["loss"])
            for _ in range(STEPS)]
    got = [float(model.train_batch([ids], [labels])["loss"])
           for _ in range(STEPS)]
    return want, got, net


@pytest.mark.parametrize("level,amp_configs", [
    ("O1", "O1"), ("O2", {"level": "O2"})])
def test_model_train_batch_tracks_the_reference(level, amp_configs):
    want, got, net = _train(level, amp_configs)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    # the masters stay fp32 through AdamW
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_train_batch_under_amp_repeats_and_leaves_fp32_grads():
    ids = np.random.RandomState(1).randint(0, SMALL["vocab_size"], (B, T))
    labels = np.roll(ids, -1, 1).reshape(B, T, 1)
    runs = []
    for _ in range(2):
        net = GPT(GPTConfig(**SMALL), device="cpu", seed=3)
        model = Model(net).prepare(
            AdamW(1e-3, parameters=net.parameters()), CrossEntropyLoss(),
            amp_configs={"level": "O2", "custom_black_list": ["gelu"]})
        loss = model.train_batch([ids], [labels], update=False)["loss"]
        assert loss.dtype == torch.float32
        grads = [p.grad for p in torch_view(net).parameters()]
        assert all(g is not None and g.dtype == torch.float32
                   for g in grads)
        runs.append((loss, grads))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_grad_scaler_passes_bf16_through_with_one_warning():
    scaler = amp.GradScaler()
    loss = torch.tensor(2.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with amp.auto_cast():
            assert scaler.scale(loss) is loss
            assert scaler.scale(loss) is loss
    assert len(caught) == 1 and "bfloat16" in str(caught[0].message)
    net = torch.nn.Linear(2, 1)
    opt = AdamW(0.1, parameters=net.parameters())
    net(torch.ones(1, 2)).sum().backward()
    before = [p.grad.clone() for p in net.parameters()]
    scaler.unscale_(opt)                       # skipped for a bf16 step
    assert all(torch.equal(p.grad, b) for p, b in
               zip(net.parameters(), before))
    scaler.update()
    assert scaler.state_dict()["scale"] == 2.0 ** 15


def test_fp16_scale_state_follows_update_loss_scaling():
    kw = dict(incr_every_n_steps=3, decr_every_n_nan_or_inf=2,
              incr_ratio=2.0, decr_ratio=0.5)
    state = (torch.tensor(8.0), torch.zeros((), dtype=torch.int32),
             torch.zeros((), dtype=torch.int32))
    rstate = (jnp.float32(8.0), jnp.int32(0), jnp.int32(0))
    for found in (False, False, True, True, False, False, False, True,
                  True, True, False):
        state = amp_ops.update_loss_scaling(torch.tensor(found), *state,
                                            kw["incr_every_n_steps"],
                                            kw["decr_every_n_nan_or_inf"],
                                            kw["incr_ratio"],
                                            kw["decr_ratio"])
        rstate = tuple(t._data for t in ramp_ops.update_loss_scaling(
            jnp.asarray(found), *rstate, kw["incr_every_n_steps"],
            kw["decr_every_n_nan_or_inf"], kw["incr_ratio"],
            kw["decr_ratio"]))
        assert [float(t) for t in state] == [float(t) for t in rstate]
    # the scaler drives the same machine: a non-finite gradient skips the
    # step and, twice in a row, halves the scale
    net = torch.nn.Linear(2, 1)
    opt = AdamW(0.1, parameters=net.parameters())
    scaler = amp.GradScaler(init_loss_scaling=8.0, **kw)
    w0 = net.weight.detach().clone()
    for _ in range(2):
        scaler.scale(net(torch.full((1, 2), float("inf"))).sum()).backward()
        scaler.step(opt)
        opt.clear_grad()
    assert torch.equal(net.weight, w0)
    assert scaler.state_dict()["scale"] == 4.0
    scaler.scale(net(torch.ones(1, 2)).sum()).backward()
    scaler.step(opt)
    assert not torch.equal(net.weight, w0)
    assert scaler.state_dict()["good_steps"] == 1


def test_fp16_train_batch_on_the_cpu_scales_the_loss():
    net = GPT(GPTConfig(**SMALL), device="cpu", seed=1)
    model = Model(net).prepare(
        AdamW(1e-3, parameters=net.parameters()), CrossEntropyLoss(),
        amp_configs={"level": "O1", "dtype": "float16",
                     "init_loss_scaling": 1024.0, "incr_every_n_steps": 2})
    ids = np.random.RandomState(2).randint(0, SMALL["vocab_size"], (B, T))
    labels = np.roll(ids, -1, 1).reshape(B, T, 1)
    losses = [float(model.train_batch([ids], [labels])["loss"])
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert float(model._scaler["scale"]) == 2048.0


def test_decorate_and_auto_cast_forms():
    net = torch.nn.Linear(3, 2)
    assert amp.decorate(net) is net
    assert net.weight.dtype == torch.bfloat16
    x = torch.rand(4, 3)

    @amp.auto_cast(level="O1")
    def decorated(a, b):
        return a @ b

    assert decorated(x, x.T).dtype == torch.bfloat16
    assert (x @ x.T).dtype == torch.float32
    seen = []
    with amp.auto_cast():
        with amp.auto_cast(enable=False):
            assert (x @ x.T).dtype == torch.float32
        thread = threading.Thread(target=lambda: seen.append(
            amp._amp_state()))
        thread.start()
        thread.join()
        assert (x @ x.T).dtype == torch.bfloat16
    assert seen == [None]


def test_what_amp_refuses(monkeypatch):
    net = GPT(GPTConfig(**SMALL), device="cpu")
    opt = AdamW(parameters=net.parameters())
    other = GPT(GPTConfig(**SMALL), device="cpu")
    other_opt = AdamW(parameters=other.parameters())
    assert amp.decorate([other], optimizers=[other_opt], master_weight=False
                        ) == ([other], [other_opt])
    assert other_opt._multi_precision is False
    assert all(p.dtype == torch.bfloat16 for p in other.parameters())
    model = Model(net)
    with pytest.raises(ValueError, match="'O1' or 'O2'"):
        model.prepare(opt, CrossEntropyLoss(), amp_configs="O3")
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        model.prepare(opt, CrossEntropyLoss(),
                      amp_configs={"level": "O1", "dtype": "float32"})
    # fp16 on the card prepares: the scaler's device state is made at the
    # first step, on the model's device
    monkeypatch.setattr(Model, "_device", lambda self: torch.device("cuda"))
    model.prepare(opt, CrossEntropyLoss(),
                  amp_configs={"dtype": "float16", "init_loss_scaling": 8.0})
    assert model._amp["dtype"] == torch.float16
    assert model._scaler["init_loss_scaling"] == 8.0
    assert model._scaler["scale"] is None
    model.prepare(opt, CrossEntropyLoss(), amp_configs={"level": "O2"})


def test_the_hook_leaves_the_inside_of_a_port_op_alone():
    # attention is one white op: its plain math on the CPU runs in the
    # type the op was cast to, with no cast of its own softmax (black)
    from paddle_tpu_torch.ops.nn_misc import scaled_dot_product_attention
    q = torch.rand(1, 8, 2, 16)
    record = []
    amp.RECORD = record
    try:
        with amp.auto_cast():
            out = scaled_dot_product_attention(q, q, q, is_causal=True)
    finally:
        amp.RECORD = None
    assert out.dtype == torch.bfloat16
    assert [r[0] for r in record] == ["scaled_dot_product_attention"]
