"""The fp16 paths of paddle_tpu_torch's kernels against the JAX reference.

On the CPU every wrapper computes its plain version, which the card's
kernels are held to (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 3).  Here those plain versions run in fp16 on numpy inputs from
seeds and are held against the reference:

- attention, forward and backward (``flash_attention`` and its
  ``FlashAttention`` autograd), against ``paddle_tpu``'s
  ``flash_attention`` under ``jax.vjp``, both on its XLA math (the CPU
  default) and in Pallas interpret mode (``PADDLE_PALLAS_FORCE=1``, as
  ``tests/test_pallas_kernels.py`` runs it), at head dims 16, 64 and 128
  (the last two the Hopper kernel's on the card), causal and not, and at
  a ragged length past one 128-row tile (T 200, where the reference
  takes its XLA math in both modes);
- the fused epilogue's forward and backward in fp16 (x and residual fp16,
  or fp16 x beside an fp32 residual, with fp16 or fp32 parameters),
  against ``paddle_tpu/ops/fused_ops.py``'s ``_fused`` and its vjp with
  the same seed: the dropout mask bit for bit (dx exactly 0 where the
  hash drops);
- ``check_finite_and_unscale`` and ``update_loss_scaling`` against
  ``paddle_tpu/ops/amp_ops.py:16, 32``, with a planted inf and nan, and
  their in-place forms against the reference's jitted step's
  ``g * inv.astype(g.dtype)``;
- the update's skip flag for every kind of ``chip_smoke.UPDATE_CHECKS``
  in every type setup: set, no parameter, slot, master or power moves;
  clear, the step equals a step without the flag, bit for bit.

Tolerances (the reference states none for fp16; bf16's are 3e-2 forward
and 5e-2 gradients, ``tests/test_pallas_kernels.py``, and fp16 has three
more mantissa bits): attention forward atol 1e-2, gradients atol 2e-2;
the epilogue's fp16 outputs and gradients atol 1e-2, fp32 ones 1e-5.
Each test prints its worst error.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from paddle_tpu.ops import amp_ops as ramp_ops
from paddle_tpu.ops import fused_ops as rfo

from paddle_tpu_torch.ops import amp_ops
from paddle_tpu_torch.ops import flash_attention as pfa
from paddle_tpu_torch.ops import fused_ln as fl
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.ops import multi_tensor_update as mtu

rfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

F16, F32 = torch.float16, torch.float32
ATTN_FWD_ATOL, ATTN_GRAD_ATOL = 1e-2, 2e-2
LN_ATOL = {F16: 1e-2, F32: 1e-5}
N, EPS, SEED = 8, 1e-5, 41


# -- attention -------------------------------------------------------------------
def _attention_fp16_case(B, T, H, d, causal, seed):
    """The port's fp16 attention, forward and gradients, against the
    reference's under ``jax.vjp`` on the same numpy inputs; returns the
    worst errors of the output and of the gradients."""
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(B, T, H, d).astype(np.float16) for _ in range(4))
    out, vjp = jax.vjp(lambda a, b, c: rfa.flash_attention(
        a, b, c, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    want = (out,) + vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got_out = pfa.flash_attention(*leaves, causal=causal)
    got_out.backward(torch.from_numpy(g))
    got = (got_out,) + tuple(t.grad for t in leaves)
    errs = []
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == F16 and w.dtype == jnp.float16, name
        err = float(np.abs(a.detach().float().numpy()
                           - np.asarray(w, np.float32)).max())
        errs.append(err)
        assert err <= (ATTN_FWD_ATOL if name == "out" else ATTN_GRAD_ATOL), \
            (name, err)
    return errs[0], max(errs[1:])


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_attention_fp16_matches_the_reference(d, causal, pallas,
                                              monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_FORCE", "1" if pallas else "0")
    B, T, H = 2, 128, 2
    mode = rfa._pallas_mode(T, T, causal)[0]
    assert mode == ("small" if pallas else "xla")
    out, grads = _attention_fp16_case(B, T, H, d, causal, d + 2 * causal)
    print(f"attention fp16 d {d} causal {causal} "
          f"{'pallas' if pallas else 'xla'}: worst out {out:.3g}, "
          f"grads {grads:.3g}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_attention_fp16_ragged_length_matches_the_reference(d, causal,
                                                            monkeypatch):
    # T 200: one full 128-row tile and a ragged one, masked by index in the
    # kernels; the reference takes its XLA math at an unaligned length in
    # both modes, so one mode covers it
    monkeypatch.setenv("PADDLE_PALLAS_FORCE", "1")
    B, T, H = 2, 200, 2
    assert rfa._pallas_mode(T, T, causal)[0] == "xla"
    out, grads = _attention_fp16_case(B, T, H, d, causal, d + 2 * causal + 1)
    print(f"attention fp16 T {T} d {d} causal {causal}: worst out "
          f"{out:.3g}, grads {grads:.3g}")


def test_attention_fp16_scores_past_the_type_range_stay_finite():
    # q k^T reaches ~1e5, past fp16's 65504: the scores are fp32 in the
    # plain version (as in the kernel and the reference), so the result is
    # finite and equals the reference's XLA math
    rs = np.random.RandomState(3)
    q = (60.0 * rs.randn(1, 64, 1, 64)).astype(np.float16)
    k = (60.0 * rs.randn(1, 64, 1, 64)).astype(np.float16)
    v = rs.randn(1, 64, 1, 64).astype(np.float16)
    qk = q[0, :, 0].astype(np.float32) @ k[0, :, 0].astype(np.float32).T
    assert np.abs(qk).max() > 65504
    want = rfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=True)
    got = pfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True)
    assert torch.isfinite(got).all()
    err = float(np.abs(got.float().numpy() - np.asarray(want, np.float32))
                .max())
    print(f"attention fp16 sharp scores: worst {err:.3g}")
    assert err <= ATTN_FWD_ATOL


# -- the fused epilogue ------------------------------------------------------------
# (x, residual, bias, gamma, beta): AMP O2's all-fp16, O1's fp16 x beside
# an fp32 residual with fp32 or fp16 parameters, and O1's triples with
# every parameter fp32 (the layer's, which O1 does not cast): fp16 x over
# an fp16 residual (most layers) and over an fp32 one (the first)
EPILOGUE_TYPES = {"fp16": (F16, F16, F16, F16, F16),
                  "x_fp16": (F16, F32, F16, F32, F32),
                  "x_fp16_params_fp16": (F16, F32, F16, F16, F16),
                  "o1": (F16, F16, F32, F32, F32),
                  "o1_residual_fp32": (F16, F32, F32, F32, F32)}
_JNP = {F16: jnp.float16, F32: jnp.float32}


def _epilogue(D, dtypes, seed):
    rs = np.random.RandomState(seed)
    arrays = (rs.randn(N, D), rs.randn(N, D), rs.randn(D), rs.rand(D) + 0.5,
              rs.randn(D), 0.5 * rs.randn(N, D))
    ts = [torch.from_numpy(a.astype(np.float32)).to(dt)
          for a, dt in zip(arrays, dtypes + (dtypes[0],))]
    js = [jnp.asarray(t.float().numpy(), _JNP[t.dtype]) for t in ts]
    return ts, js


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("D", [64, 768])
@pytest.mark.parametrize("types", sorted(EPILOGUE_TYPES))
def test_epilogue_fp16_forward_and_backward_match_the_reference(types, D,
                                                                p):
    dtypes = EPILOGUE_TYPES[types]
    (x, r, b, ga, be, g), (jx, jr, jb, jga, jbe, jg) = _epilogue(
        D, dtypes, seed=D)
    out, vjp = jax.vjp(lambda *a: rfo._fused(*a, jnp.uint32(SEED), p, EPS,
                                             False), jx, jr, jb, jga, jbe)
    want = (out,) + tuple(vjp(jg))
    got = (fl.fused_ln(x, r, b, ga, be, SEED, p=p, eps=EPS),) + tuple(
        fl.fused_ln_bwd(g, x, r, b, ga, be, SEED, p=p, eps=EPS))
    worst = 0.0
    for name, a, w, t in zip(("out", "dx", "dres", "dbias", "dgamma",
                              "dbeta"), got, want, (x, x, r, b, ga, be)):
        assert a.dtype == t.dtype and w.dtype == _JNP[t.dtype], name
        err = float(np.abs(a.float().numpy() - np.asarray(w, np.float32))
                    .max())
        # the column sums add N rows: N steps of fp16 at most
        atol = LN_ATOL[t.dtype] * (N if name.startswith("db") or
                                   name == "dgamma" else 1)
        assert err <= atol, (name, err)
        worst = max(worst, err)
    if p > 0:
        dropped = fl.hash_uniform(SEED, (N, D)) < torch.tensor(p)
        assert torch.equal(got[1] == 0, dropped)
    print(f"epilogue {types} D {D} p {p}: worst {worst:.3g}")


def test_epilogue_refuses_bf16_beside_fp16_on_the_card():
    x = torch.ones(2, 8, dtype=F16)
    r = torch.ones(2, 8, dtype=torch.bfloat16)
    v = torch.ones(8)
    with pytest.raises(TypeError, match="no pair AMP makes"):
        fl._check_cuda("fused_ln", (x, r, v, v, v), x, r, (v, v, v))
    assert fl._check_cuda("fused_ln", (x, x, v, v, v), x, x,
                          (x[0], v, x[0])) == 2 | 0 << 2 | 2 << 4


# -- AMP ops ---------------------------------------------------------------------------
def _grads(seed, plant=None):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(*s).astype(np.float32) * 1024
              for s in ((7, 5), (3,), (1,), (4, 4))]
    if plant is not None:
        (i, where, value) = plant
        arrays[i].reshape(-1)[where] = value
    return arrays


@pytest.mark.parametrize("plant", [None, (0, 0, np.inf), (3, 7, np.nan),
                                   (2, -1, -np.inf)])
def test_check_finite_and_unscale_matches_the_reference(plant):
    arrays = _grads(0, plant)
    scale = 512.0
    want, wfound = ramp_ops.check_finite_and_unscale(
        [jnp.asarray(a) for a in arrays], jnp.float32(scale))
    got, found = amp_ops.check_finite_and_unscale(
        [torch.from_numpy(a) for a in arrays], torch.tensor(scale))
    assert bool(found) == bool(wfound._data) == (plant is not None)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w._data))
    # the in-place form is the jitted step's g * inv.astype(g.dtype), in
    # each gradient's type; for a power-of-two scale the same values
    for dt in (F32, F16):
        ts = [torch.tensor(a, dtype=dt) for a in arrays]      # copies
        flag = torch.tensor(plant is None)        # cleared by the call
        mtu.multi_tensor_unscale(ts, torch.tensor(scale), flag)
        assert bool(flag) == (plant is not None)
        inv = jnp.float32(1.0) / jnp.float32(scale)
        for t, a in zip(ts, arrays):
            ja = jnp.asarray(a, _JNP[dt])
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(ja * inv.astype(ja.dtype), np.float32))


def test_update_loss_scaling_in_place_matches_the_reference():
    kw = (2, 1, 2.0, 2.0 ** -30)
    state = (torch.tensor(2.0 ** 40), torch.zeros((), dtype=torch.int32),
             torch.zeros((), dtype=torch.int32))
    rstate = (jnp.float32(2.0 ** 40), jnp.int32(0), jnp.int32(0))
    addresses = [t.data_ptr() for t in state]
    for found in (True, False, False, False, True, False, False, False):
        flag = torch.tensor(found)
        amp_ops.update_loss_scaling_(flag, *state, *kw)
        rstate = tuple(t._data for t in ramp_ops.update_loss_scaling(
            jnp.asarray(found), *rstate, *kw))
        assert [float(t) for t in state] == [float(t) for t in rstate]
        assert [t.data_ptr() for t in state] == addresses
    # 2^40 -> 2^10, doubled after two good steps, cut to the floor of 1
    # by the second overflow, doubled again
    assert float(state[0]) == 2.0


# -- the update's skip flag ---------------------------------------------------------
NAMED = [("blocks.w", (6, 5)), ("ln.bias", (5,))] + [
    (n, s) for n, s in chip_smoke.UPDATE_EXTRA if "1048581" not in n]


@pytest.mark.parametrize("route", ["kernel", "per_leaf"])
@pytest.mark.parametrize("setup", chip_smoke.UPDATE_SETUPS)
@pytest.mark.parametrize("label", [c[0] for c in chip_smoke.UPDATE_CHECKS])
def test_a_set_flag_moves_nothing_and_a_clear_one_changes_nothing(
        label, setup, route):
    # one step, then one with the flag set, clear or absent (on the CPU
    # the kernel's route is its plain version); bit for bit, NaN included
    # (the per-leaf path in fp16 without masters makes some, where eps
    # underflows)
    make = dict(chip_smoke.UPDATE_CHECKS)[label]

    def run(found):
        return chip_smoke.update_skip_run(torch, make, NAMED, setup, "cpu",
                                          route, found)
    before, skipped = run(True)
    assert skipped.keys() == before.keys()
    for k in before:
        assert chip_smoke._same_bits(torch, skipped[k], before[k]), k
    (_, plain), (_, clear) = run(None), run(False)
    for k in plain:
        assert chip_smoke._same_bits(torch, clear[k], plain[k]), k
    assert any(not chip_smoke._same_bits(torch, plain[k], before[k])
               for k in plain)


def test_a_skipped_step_still_counts():
    # the reference's step count advances on an overflow (hapi/model.py:595)
    p = torch.nn.Parameter(torch.ones(3))
    opt = popt.Adam(0.1, parameters=[("w", p)])
    p.grad = torch.ones(3)
    opt.step(found_inf=torch.tensor(True))
    assert opt._global_step == 1 and torch.equal(p, torch.ones(3))


def test_the_unscale_pass_takes_one_type_per_table():
    grads = [torch.ones(3), torch.ones(4, dtype=F16), torch.ones(2)]
    cache = {}
    tables = mtu.grad_tables(grads, cache)
    assert [(t.dtype, t.n, t.nchunks) for t in tables] == [
        (F32, 2, 2), (F16, 1, 1)]
    assert mtu.grad_tables(grads, cache) is tables
    with pytest.raises(ValueError, match="contiguous"):
        mtu.grad_tables([torch.ones(4, 4).t()])
    with pytest.raises(ValueError, match="found_inf must be one bool"):
        mtu.multi_tensor_unscale(grads, torch.tensor(2.0), torch.tensor(0))


@pytest.mark.parametrize("change", ["address", "size", "type", "none"])
def test_unscale_tables_follow_each_gradients_address_size_and_type(change):
    # the cache key holds every gradient's address, size and type: the
    # tables a launch reads by address are rebuilt when any of them moves
    grads = [torch.ones(3), torch.ones(8), torch.ones(4, dtype=F16)]
    cache = {}
    tables = mtu.grad_tables(grads, cache)
    if change == "address":
        grads[1] = torch.ones(8)
    elif change == "size":
        grads[1].resize_(6)                  # the same storage, shrunk
    elif change == "type":
        grads[1] = grads[1].view(torch.int32)   # the same address and size
    again = mtu.grad_tables(grads, cache)
    assert (again is tables) == (change == "none")
    assert sum(t.n for t in again) == 3
    if change != "none":
        assert [(t.dtype, t.n) for t in again] == [
            (t.dtype, t.n) for t in mtu.grad_tables(grads)]
