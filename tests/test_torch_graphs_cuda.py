"""Captured CUDA graphs on the card: each serving bucket's replay against a
direct call of its step, weights copied in place against a parameter
replaced, the launch counters through replays, ``Model.prepare(jit=True)``
against ``jit=False`` on the encoder with dropout, the seeds and masks a
replay draws, and a capture that fails.

Every test needs an NVIDIA card and skips without one.  The file imports
no JAX, so it runs on the card's machine (``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py -q
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import Model
from paddle_tpu_torch.generation import GenerationSession
from paddle_tpu_torch.generation import session as psession
from paddle_tpu_torch.graphs import CaptureError, StepGraph
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.nn import torch_view
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.ops import flash_attention as pfa
from paddle_tpu_torch.ops import fused_ln as fl
from paddle_tpu_torch.ops import fused_ops as fo
from paddle_tpu_torch.ops import nn_misc
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import seq_buckets

pytestmark = pytest.mark.cuda

WIDTH = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128)                    # head dim 64
ENCODER = dict(vocab_size=97, d_model=128, num_layers=2, nhead=2,
               dim_feedforward=256, max_len=128, dropout_rate=0.1)
B = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")


def _prefill_values(rs, P, mask):
    V = WIDTH["vocab_size"]
    plens = rs.randint(1, P + 1, B).astype(np.int32)
    return (rs.randint(1, V, (B, P)).astype(np.int32), plens, mask,
            rs.randint(0, 2**31, B).astype(np.int64),
            np.array([0.0, 0.9, 0.0, 1.2], np.float32),
            np.array([0, 5, 0, 0], np.int32),
            np.array([1.0, 0.9, 1.0, 0.8], np.float32))


def _direct(sess, fn, types, values):
    """The step function called on the same values, uncaptured."""
    net = sess.model
    net.eval()
    with torch.inference_mode():
        tok = fn(*[torch.as_tensor(np.asarray(v)).to("cuda", t)
                   for v, t in zip(values, types)])
    return tok.cpu().numpy().astype(np.int32)


def _snapshot(caches):
    return [(c.k.clone(), c.v.clone()) for c in caches]


def _restore(caches, snap):
    for c, (k, v) in zip(caches, snap):
        c.k.copy_(k)
        c.v.copy_(v)


def _same(caches, snap):
    return all(torch.equal(c.k, k) and torch.equal(c.v, v)
               for c, (k, v) in zip(caches, snap))


def test_each_bucket_replays_as_a_direct_call(card):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    sess = GenerationSession(net, batch_capacity=B, max_length=128)
    caches = sess.init_caches()
    rs = np.random.RandomState(0)
    buckets = seq_buckets(128, 8)
    for P in buckets:                         # captured in this order
        sess.prefill(caches, *_prefill_values(rs, P, np.ones(B, bool)))
    assert sess._cache.compiles == len(buckets)
    partial = np.array([True, False, True, True])
    for P in (32, 128, 8, 64, 16):            # replayed out of it
        values = _prefill_values(rs, P, partial)
        before = _snapshot(caches)
        tok, _ = sess.prefill(caches, *values)
        replayed = _snapshot(caches)
        _restore(caches, before)
        want = _direct(sess, sess._make_prefill(P), psession._PREFILL_TYPES,
                       values)
        np.testing.assert_array_equal(tok, want, err_msg=f"bucket {P}")
        assert _same(caches, replayed), f"bucket {P}: caches differ"
    positions = np.array([5, 9, 17, 30], np.int32)
    for i in range(3):
        values = (rs.randint(1, 97, B).astype(np.int32), positions + i,
                  *_prefill_values(rs, 8, partial)[3:])
        before = _snapshot(caches)
        tok, _ = sess.decode(caches, *values)
        replayed = _snapshot(caches)
        _restore(caches, before)
        want = _direct(sess, sess._make_decode(), psession._DECODE_TYPES,
                       values)
        np.testing.assert_array_equal(tok, want, err_msg=f"decode {i}")
        assert _same(caches, replayed), f"decode {i}: caches differ"
    assert sess._cache.compiles == len(buckets) + 1
    assert sess._cache.hits == 5 + 2
    entry = sess._cache.entries()[("decode", B, 128, sess._serial)]
    assert entry.graph is not None and entry.pool_bytes > 0


def test_copied_weights_are_read_and_a_replaced_parameter_recaptures(card):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=1)
    sess = GenerationSession(net, batch_capacity=B)
    prompt = [np.arange(1, 20, dtype=np.int32)]
    first = sess.generate(prompt, max_new_tokens=6)[0]
    other = GPT(GPTConfig(**WIDTH), device="cuda", seed=2)
    net.set_state_dict(other.state_dict())           # copied in place
    copied = sess.generate(prompt, max_new_tokens=6)[0]
    assert sess._cache.compiles == 2
    np.testing.assert_array_equal(copied, GenerationSession(
        other, batch_capacity=B).generate(prompt, max_new_tokens=6)[0])
    assert not np.array_equal(first, copied)
    net.head.weight = torch.nn.Parameter(
        torch_view(net.head).state_dict()["weight"].clone())
    again = sess.generate(prompt, max_new_tokens=6)[0]
    assert sess._cache.compiles == 4
    np.testing.assert_array_equal(again, copied)


def _encoder(seed_val=1):
    from paddle_tpu_torch.tools.profile_train import build_encoder
    return build_encoder(ENCODER, device="cuda", seed_val=seed_val)


def _batch(seed, V=97, T=128):
    ids = np.random.RandomState(seed).randint(0, V, (B, T))
    return (torch.from_numpy(ids).cuda(),
            torch.from_numpy(np.roll(ids, -1, 1).reshape(B, T, 1)).cuda())


def test_launch_counters_are_exact_through_replays(card):
    L = WIDTH["num_layers"]
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    sess = GenerationSession(net, batch_capacity=B)
    caches = sess.init_caches()
    rs = np.random.RandomState(1)
    sess.prefill(caches, *_prefill_values(rs, 16, np.ones(B, bool)))
    pfa.FWD_LAUNCHES = 0
    pfa.MODE_LAUNCHES.clear()
    for _ in range(3):
        sess.prefill(caches, *_prefill_values(rs, 16, np.ones(B, bool)))
    assert pfa.FWD_LAUNCHES == 3 * L
    assert pfa.MODE_LAUNCHES == {"fwd small": 3 * L}

    enc = _encoder()
    model = Model(enc).prepare(AdamW(1e-3, parameters=enc.parameters()),
                               CrossEntropyLoss())
    ids, labels = _batch(0)
    model.train_batch([ids], [labels])               # runs, then captures
    pfa.FWD_LAUNCHES = pfa.BWD_LAUNCHES = fl.LAUNCHES = fl.BWD_LAUNCHES = 0
    for _ in range(2):
        model.train_batch([ids], [labels])
    assert (pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES) == (2 * L, 2 * L)
    assert (fl.LAUNCHES, fl.BWD_LAUNCHES) == (4 * L, 4 * L)
    assert model._steps.hits == 2


@pytest.mark.parametrize("amp", [None, "O1", "O2"])
def test_captured_encoder_steps_equal_eager_and_masks_change(card, amp):
    runs = []
    for jit in (False, True, True):
        net = _encoder()
        model = Model(net).prepare(
            AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01),
            CrossEntropyLoss(), amp_configs=amp, jit=jit)
        paddle_tpu_torch.seed(2)
        losses = [model.train_batch(*[[t] for t in _batch(s)])["loss"]
                  for s in range(3)]
        # learning rate 0: the parameters stay, so two steps on one batch
        # differ only by their dropout masks
        model._optimizer.set_lr(0.0)
        frozen = [model.train_batch(*[[t] for t in _batch(9)])["loss"]
                  for _ in range(2)]
        runs.append((torch.stack(losses + frozen),
                     {k: v.clone() for k, v in
                      torch_view(net).state_dict().items()}))
        assert model._steps.compiles == (1 if jit else 0)
    (le, se), (lj, sj), (lj2, sj2) = runs
    assert torch.equal(le, lj), (le, lj)
    assert torch.equal(lj, lj2)
    for k in se:
        assert torch.equal(se[k], sj[k]) and torch.equal(sj[k], sj2[k]), k
    assert lj[3] != lj[4], "the captured step replayed the same masks"


def test_replays_draw_the_eager_seeds_and_masks(card):
    x = torch.randn(64, 128, device="cuda")
    r = torch.randn(64, 128, device="cuda")

    def step(x):
        h = fo.fused_bias_dropout_residual_layer_norm(x, r, dropout_rate=0.5)
        return nn_misc.dropout(h, p=0.3), h

    paddle_tpu_torch.seed(3)
    eager = [step(x) for _ in range(4)]
    paddle_tpu_torch.seed(3)
    exe = StepGraph("masks", step, [torch.empty_like(x)], [x])
    got = [exe.first_outputs] + [tuple(t.clone() for t in exe(x))
                                 for _ in range(3)]
    assert exe.graph is not None and exe.seeds.count == 1
    for (a, ah), (b, bh) in zip(eager, got):
        assert torch.equal(a, b) and torch.equal(ah, bh)
    assert not torch.equal(got[1][0], got[2][0])
    assert not torch.equal(got[1][1], got[2][1])
    # the kernel reads its seed from device memory: a tensor seed is the int
    s = torch.full((1,), 77, dtype=torch.int64, device="cuda")
    v, g = torch.zeros(128, device="cuda"), torch.ones(128, device="cuda")
    assert torch.equal(fl.fused_ln(x, r, v, g, v, s, p=0.5, eps=1e-5),
                       fl.fused_ln(x, r, v, g, v, 77, p=0.5, eps=1e-5))


def test_a_failed_capture_raises_and_names_its_key(card):
    x = torch.ones(8, device="cuda")

    def syncs(t):
        return t * float(t.sum().item())          # a host read mid-step

    with pytest.raises(CaptureError, match="'a-step'"):
        StepGraph("a-step", syncs, [torch.empty_like(x)], [x])
    torch.cuda.synchronize()
    # the card and both generators the graph held still work
    assert torch.equal(x * 2, torch.full_like(x, 2.0))
    assert torch.rand(4, device="cuda").shape == (4,)
    assert nn_misc.dropout(x, p=0.5).shape == x.shape


def test_graphs_of_dropped_models_are_freed_outside_captures(card):
    # models that share a network and drop each other's graphs (garbage in
    # reference cycles) while the next one captures
    net = _encoder()
    ids, labels = _batch(0)
    for amp in (None, "O1", "O2", None):
        model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                                   CrossEntropyLoss(), amp_configs=amp)
        for _ in range(2):
            assert torch.isfinite(model.train_batch([ids], [labels])["loss"])
    assert torch.rand(4, device="cuda").shape == (4,)
