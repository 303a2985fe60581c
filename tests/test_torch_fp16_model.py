"""AMP in fp16 through ``Model``, the slice as a whole: the port's
``Model(GPT).prepare(AdamW, CrossEntropyLoss, amp_configs={"level": "O1",
"dtype": "float16", ...})`` against the reference's ``paddle.Model`` with
the same configuration over four steps, from the same weights
(``gpt_state_from_paddle_tpu``) and batch.

The reference scales the loss only in its jitted step
(``paddle_tpu/hapi/model.py:296-331``), so the port's eager engine
(``jit=False``) and its captured one (``jit=True``, on the CPU the step
function itself, the code path a CUDA graph captures) are each held
against the reference's jitted step.  The first step overflows in both:
``init_loss_scaling`` 2^40 sends the fp16 gradients past 65504, and with
``decr_every_n_nan_or_inf`` 1 and ``decr_ratio`` 2^-30 the scale falls to
2^10, far inside the range, where the next steps update
(``incr_every_n_steps`` 2 doubles it after the third).  The two must
agree on ``found_inf`` per step and on the scale, good and bad counts
exactly; on the losses at rtol 2e-2 (``tests/test_torch_amp.py``'s O1
tolerance: both round to fp16 values summed in other orders); and on the
fp32 parameters as PARAM_* states.  The overflow step moves no parameter,
slot or power in the port, bit for bit, and the optimizer's step count
advances on it, as the reference's does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

from paddle_tpu_torch import Model, amp
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.nn import CrossEntropyLoss, torch_view
from paddle_tpu_torch.optimizer import SGD, AdamW

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=32, ffn_mult=2)
B, T, STEPS, LOSS_RTOL = 4, 16, 4, 2e-2
# The parameters after three updates of AdamW (1e-3): the error's L2 norm
# at most PARAM_REL_L2 of the reference's move's, at most PARAM_SHARE of
# the elements further than PARAM_CLOSE, and none further than
# PARAM_ATOL, two runs of three AdamW steps of at most the rate each in
# opposite directions.  AdamW divides each gradient by its own magnitude,
# so a gradient that is rounding noise on both sides (the key projection's
# bias: the softmax does not change when every score of a row shifts)
# moves its weight by the rate either way.  Measured: relative L2 0.024,
# 0.22% of the elements past 1e-4, the worst 3.9e-3 (qkv bias).
PARAM_REL_L2, PARAM_SHARE, PARAM_CLOSE, PARAM_ATOL = 5e-2, 1e-2, 1e-4, 6e-3
CONFIG = {"level": "O1", "dtype": "float16", "init_loss_scaling": 2.0 ** 40,
          "decr_every_n_nan_or_inf": 1, "decr_ratio": 2.0 ** -30,
          "incr_every_n_steps": 2}
FOUND = [True, False, False, False]
SCALES = [2.0 ** 10, 2.0 ** 10, 2.0 ** 11, 2.0 ** 11]
GOOD = [0, 1, 0, 1]


def _reference(ids, labels):
    paddle.seed(0)
    ref = RefGPT(RefConfig(**SMALL))
    state = {k: np.array(v) for k, v in ref.functional_state()[0].items()}
    rmodel = paddle.Model(ref)
    rmodel.prepare(paddle.optimizer.AdamW(1e-3, parameters=ref.parameters(),
                                          weight_decay=0.01),
                   paddle.nn.CrossEntropyLoss(), amp_configs=dict(CONFIG))
    rows = []
    for _ in range(STEPS):
        loss = float(rmodel.train_batch([ids], [labels])["loss"])
        sc = rmodel._amp_scaler_state
        rows.append((loss, bool(rmodel._amp_found_inf), float(sc["scale"]),
                     int(sc["good"]), int(sc["bad"])))
    params = {k: np.array(v) for k, v in ref.functional_state()[0].items()}
    return state, rows, params


def _named(net):
    """The network's (name, torch parameter) pairs."""
    return torch_view(net).named_parameters()


def _snapshot(net, opt):
    out = {n: p.detach().clone() for n, p in _named(net)}
    for n, p in _named(net):
        for k, v in opt._state.get(id(p), {}).items():
            out[f"{n}_{k}"] = v.clone()
    return out


@pytest.mark.parametrize("jit", [False, True])
def test_fp16_model_steps_track_the_reference_through_an_overflow(jit):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, SMALL["vocab_size"], (B, T)).astype(np.int32)
    labels = np.roll(ids, -1, 1).reshape(B, T, 1).astype(np.int64)
    state, want, ref_params = _reference(ids, labels)
    assert [r[1] for r in want] == FOUND
    assert [r[2] for r in want] == SCALES and [r[3] for r in want] == GOOD

    net = GPT(GPTConfig(**SMALL), device="cpu")
    net.load_state_dict(gpt_state_from_paddle_tpu(state, device="cpu"))
    opt = AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01)
    model = Model(net).prepare(opt, CrossEntropyLoss(),
                               amp_configs=dict(CONFIG), jit=jit)
    got = []
    for step in range(STEPS):
        loss = float(model.train_batch([ids], [labels])["loss"])
        sc = model._scaler
        got.append((loss, bool(model._amp_found_inf), float(sc["scale"]),
                    int(sc["good"]), int(sc["bad"])))
        assert opt._global_step == step + 1
    assert [g[1:] for g in got] == [w[1:] for w in want]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=LOSS_RTOL)
    assert got[-1][0] < got[0][0]
    port = gpt_state_from_paddle_tpu(ref_params, device="cpu")
    init = gpt_state_from_paddle_tpu(state, device="cpu")
    errs, moves = [], []
    for n, p in torch_view(net).state_dict().items():
        assert p.dtype == torch.float32, n
        errs.append((p - port[n]).flatten())
        moves.append((port[n] - init[n]).flatten())
    err, move = torch.cat(errs), torch.cat(moves)
    rel = float(err.norm() / move.norm())
    share = float((err.abs() > PARAM_CLOSE).float().mean())
    worst = float(err.abs().max())
    print(f"fp16 Model jit={jit}: losses {[g[0] for g in got]} against "
          f"{[w[0] for w in want]}; parameters relative L2 {rel:.3g}, "
          f"{share:.3g} past {PARAM_CLOSE}, worst {worst:.3g}")
    assert rel <= PARAM_REL_L2 and share <= PARAM_SHARE
    assert worst <= PARAM_ATOL


def test_the_overflow_step_moves_nothing_but_the_scale_state():
    net = GPT(GPTConfig(**SMALL), device="cpu", seed=2)
    opt = AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01)
    model = Model(net).prepare(opt, CrossEntropyLoss(),
                               amp_configs=dict(CONFIG), jit=True)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, SMALL["vocab_size"], (B, T))
    labels = np.roll(ids, -1, 1).reshape(B, T, 1)
    params = {n: p.detach().clone() for n, p in _named(net)}
    model.train_batch([ids], [labels])
    assert bool(model._amp_found_inf)
    assert model._amp_found_inf.dtype == torch.bool
    for n, p in _named(net):
        assert torch.equal(p, params[n]), n
    slots = _snapshot(net, opt)
    # every slot as AdamW makes it: moments zero, powers one
    for k, v in slots.items():
        if k.endswith(("moment1", "moment2")):
            assert not v.any(), k
        if k.endswith("_pow"):
            assert float(v) == 1.0, k
    assert float(model._scaler["scale"]) == 2.0 ** 10
    model.train_batch([ids], [labels])
    assert not bool(model._amp_found_inf)
    assert any(not torch.equal(p, params[n])
               for n, p in _named(net))


def test_eager_grad_scaler_loop_on_the_gpt():
    # the eager API of the reference's GradScaler: scale, backward, step
    # (one host read of the flag; it moves the scale state itself)
    net = GPT(GPTConfig(**SMALL), device="cpu", seed=4)
    opt = AdamW(1e-3, parameters=net.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 40, decr_ratio=2.0 ** -30,
                            decr_every_n_nan_or_inf=1, incr_every_n_steps=2)
    rs = np.random.RandomState(2)
    ids = torch.from_numpy(rs.randint(0, SMALL["vocab_size"], (B, T)))
    labels = torch.roll(ids, -1, 1).reshape(B, T, 1)
    loss_fn = CrossEntropyLoss()
    w0 = {n: p.detach().clone() for n, p in _named(net)}
    for step in range(3):
        with amp.auto_cast(level="O1", dtype="float16"):
            out = net(ids)
        loss = loss_fn(out, labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        if step == 0:           # the overflow: nothing moved
            assert all(torch.equal(p, w0[n])
                       for n, p in _named(net))
            assert scaler.state_dict()["scale"] == 2.0 ** 10
    assert scaler.state_dict()["scale"] == 2.0 ** 11
    assert any(not torch.equal(p, w0[n]) for n, p in _named(net))


@pytest.mark.parametrize("jit", [False, True])
def test_fp16_gradient_accumulation_sums_the_micro_batches(jit):
    # train_batch(update=False) leaves its gradients scaled; the step that
    # updates unscales and checks the sum of both micro-batches once.
    # Held against the fp32 gradients of the two batches summed by plain
    # autograd (SGD at rate 1: the move is the gradient): relative L2 at
    # most ACCUM_REL_L2 (fp16 O1 rounding).  Unscaling each micro-batch on
    # its own would leave g1 / scale + g2, off by g1's whole share.
    ACCUM_REL_L2 = 2e-2
    net = GPT(GPTConfig(**SMALL), device="cpu", seed=5)
    plain = GPT(GPTConfig(**SMALL), device="cpu", seed=5)
    rs = np.random.RandomState(3)
    batches = []
    for _ in range(2):
        ids = rs.randint(0, SMALL["vocab_size"], (B, T))
        batches.append((ids, np.roll(ids, -1, 1).reshape(B, T, 1)))
    loss_fn = CrossEntropyLoss()
    for ids, labels in batches:
        loss_fn(plain(torch.from_numpy(ids)),
                torch.from_numpy(labels)).backward()
    w0 = {n: p.detach().clone() for n, p in _named(net)}
    want = torch.cat([-p.grad.flatten() for _, p in _named(plain)])
    model = Model(net).prepare(
        SGD(1.0, parameters=net.parameters()), CrossEntropyLoss(),
        amp_configs={"level": "O1", "dtype": "float16",
                     "init_loss_scaling": 2.0 ** 10}, jit=jit)
    model.train_batch(*map(lambda a: [a], batches[0]), update=False)
    model.train_batch(*map(lambda a: [a], batches[1]))
    assert not bool(model._amp_found_inf)
    assert int(model._scaler["good"]) == 1     # one update of the state
    got = torch.cat([(p.detach() - w0[n]).flatten()
                     for n, p in _named(net)])
    rel = float((got - want).norm() / want.norm())
    print(f"fp16 accumulation jit={jit}: relative L2 {rel:.3g} "
          f"(limit {ACCUM_REL_L2})")
    assert rel <= ACCUM_REL_L2
