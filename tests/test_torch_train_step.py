"""paddle_tpu_torch's flagship train step against the JAX reference.

The reference's ``build_spmd_train_step`` on a one-device ``{"dp": 1}``
mesh and the port's run at the CPU configuration of ``bench.py:126-128``
(V 1024, D 128, L 4, H 4, T 128, B 8, ffn_mult 2) from the reference's
``init_fn(0)``, carried across with ``gpt_spmd_state_from_paddle_tpu``,
on the same ``np.random.RandomState(0)`` ids and labels.  Gradients are
read from AdamW's first moment after one step (``m = (1 - b1) g``) on both
sides.  On the CPU the port's attention runs the plain versions of its
kernels; the kernels themselves are checked on the card.

Tolerances, fp32: step-1 loss rtol 1e-5 and grads atol 5e-5 (the sums
run in another order); later losses rtol 1e-5; parameters after three
steps atol 5e-4, because AdamW maps a gradient near eps (1e-8) to an
update of order lr (1e-3), so a last-digit difference in such a gradient
moves the parameter by a fraction of lr.  bf16: one step's loss within
2e-2 of the reference's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.topology import build_mesh
from paddle_tpu.models import GPTConfig as RefConfig
from paddle_tpu.models import gpt_spmd as rspmd

from paddle_tpu_torch.models import (GPTConfig, build_spmd_train_step,
                                     gpt_spmd_state_from_paddle_tpu)
from paddle_tpu_torch.models import gpt_spmd as pspmd
from paddle_tpu_torch.ops import flash_attention_qkv as fq
from paddle_tpu_torch.ops import softmax_xent as sx

WIDTH = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
             max_seq_len=128, ffn_mult=2)
B, T, STEPS = 8, 128, 3
B1 = 0.9
GRADS = ("blocks.qkv_w", "blocks.down_w", "blocks.ln1_g", "head_w", "wte",
         "wpe", "ln_f_b")


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, WIDTH["vocab_size"], (B, T)).astype(np.int32)
    labels = rng.randint(0, WIDTH["vocab_size"], (B, T)).astype(np.int32)
    return ids, labels


def _flat(tree):
    """Copies of the leaves: both steps update their state in place (the
    reference donates its buffers)."""
    return {k: np.array(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in pspmd._leaves(tree).items()}


def _run_both(jdtype, tdtype, steps, remat="full"):
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    rstep, rinit = rspmd.build_spmd_train_step(
        RefConfig(**WIDTH), mesh, compute_dtype=jdtype, remat_policy=remat)
    rp, ro = rinit(seed=0)
    params, opt = gpt_spmd_state_from_paddle_tpu(
        jax.tree.map(np.asarray, rp), device="cpu")
    step, _ = build_spmd_train_step(GPTConfig(**WIDTH), compute_dtype=tdtype,
                                    remat_policy=remat, device="cpu")
    ids, labels = _batch()
    out = {"ref_loss": [], "loss": []}
    for i in range(steps):
        rl, rp, ro = rstep(rp, ro, jnp.asarray(ids), jnp.asarray(labels))
        loss, params, opt = step(params, opt, torch.from_numpy(ids),
                                 torch.from_numpy(labels))
        out["ref_loss"].append(float(rl))
        out["loss"].append(loss.item())
        if i == 0:
            out["ref_m1"] = _flat(ro["m"])
            out["m1"] = _flat(opt["m"])
    out.update(ref_params=_flat(rp), params=_flat(params),
               ref_step=int(ro["step"]), step=int(opt["step"]))
    return out


@pytest.fixture(scope="module")
def fp32_run():
    return _run_both(jnp.float32, torch.float32, STEPS)


def test_step_one_loss_and_grads_match(fp32_run):
    r = fp32_run
    np.testing.assert_allclose(r["loss"][0], r["ref_loss"][0], rtol=1e-5)
    for name in GRADS:
        np.testing.assert_allclose(r["m1"][name] / (1 - B1),
                                   r["ref_m1"][name] / (1 - B1), atol=5e-5,
                                   err_msg=name)
    assert set(r["m1"]) == set(r["ref_m1"])


def test_three_steps_track_the_reference(fp32_run):
    r = fp32_run
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-5)
    assert r["loss"][-1] < r["loss"][0]
    assert r["step"] == r["ref_step"] == STEPS
    for name, want in r["ref_params"].items():
        np.testing.assert_allclose(r["params"][name], want, atol=5e-4,
                                   err_msg=name)


def test_bf16_step_matches_reference_loss():
    r = _run_both(jnp.bfloat16, torch.bfloat16, 1, remat="ctx")
    assert abs(r["loss"][0] - r["ref_loss"][0]) < 2e-2


def _loss_and_grads(policy, params, ids, labels):
    live = {k: v.detach().clone().requires_grad_()
            for k, v in pspmd._leaves(params).items()}
    loss = pspmd.loss_fn(pspmd._rebuild(params, live), ids, labels,
                         GPTConfig(**WIDTH), remat_policy=policy)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss, dict(zip(live, grads))


def test_remat_policies_agree_and_run_the_attention_as_often_as_stated(
        monkeypatch):
    params = pspmd.init_gpt_params(
        GPTConfig(**WIDTH), torch.Generator().manual_seed(0), "cpu")
    ids, labels = (torch.from_numpy(a[:2]) for a in _batch())
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fq.flash_qkv_fwd, fq.flash_qkv_bwd

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fq, "flash_qkv_fwd", count("fwd", fwd))
    monkeypatch.setattr(fq, "flash_qkv_bwd", count("bwd", bwd))
    L = WIDTH["num_layers"]
    runs = {}
    for policy, fwd_calls in (("none", L), ("full", 2 * L), ("ctx", L)):
        calls.update(fwd=0, bwd=0)
        runs[policy] = _loss_and_grads(policy, params, ids, labels)
        assert calls == {"fwd": fwd_calls, "bwd": L}, policy
    loss0, grads0 = runs["none"]
    for policy in ("full", "ctx"):
        loss, grads = runs[policy]
        assert loss.item() == pytest.approx(loss0.item(), rel=1e-6)
        for k, g in grads.items():
            torch.testing.assert_close(g, grads0[k], rtol=0, atol=1e-6,
                                       msg=lambda m: f"{policy} {k}: {m}")


def test_cpu_loss_equals_the_fused_head_loss():
    # the CPU loss (chunked CE) and the card's (softmax_xent_loss, here its
    # plain version) are the same function of the trunk output
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 48, 32).astype(np.float32))
    w = torch.from_numpy((rs.randn(32, 70) * 0.1).astype(np.float32))
    lab = torch.from_numpy(rs.randint(0, 70, (2, 48)))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    la = pspmd.chunked_ce(xa, wa, lab)
    lb = sx.softmax_xent_loss(xb.reshape(96, 32), wb, lab.reshape(96))
    torch.testing.assert_close(la, lb, rtol=1e-6, atol=0)
    for a, b in zip(torch.autograd.grad(la, (xa, wa)),
                    torch.autograd.grad(lb, (xb, wb))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_block_and_layernorm_match_reference():
    # tanh GELU and the population variance, on one block in fp32
    cfg = GPTConfig(**WIDTH)
    rp = rspmd.init_gpt_params(RefConfig(**WIDTH), jax.random.PRNGKey(1))
    p_i = {k: np.asarray(v[0]) for k, v in rp["blocks"].items()}
    rs = np.random.RandomState(6)
    p_i["ln1_b"] = rs.randn(*p_i["ln1_b"].shape).astype(np.float32) * 0.1
    x = rs.randn(2, 64, 128).astype(np.float32)
    want = np.asarray(rspmd.make_block_fn(RefConfig(**WIDTH))(
        jax.tree.map(jnp.asarray, p_i), jnp.asarray(x)))
    got = pspmd.make_block_fn(cfg)(
        {k: torch.tensor(v) for k, v in p_i.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    g, b = rs.rand(128).astype(np.float32), rs.rand(128).astype(np.float32)
    np.testing.assert_allclose(
        pspmd._layernorm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b)).numpy(),
        np.asarray(rspmd._layernorm(jnp.asarray(x), g, b)), atol=2e-6)


def test_init_has_the_reference_layout_and_scales():
    cfg = GPTConfig(**WIDTH)
    ref = jax.tree.map(np.asarray, rspmd.init_gpt_params(
        RefConfig(**WIDTH), jax.random.PRNGKey(0)))
    ours = pspmd.init_gpt_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    ref_flat, our_flat = _flat(ref), _flat(ours)
    assert sorted(our_flat) == sorted(ref_flat)
    for name, want in ref_flat.items():
        got = our_flat[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        # same distribution: the draws differ (torch vs jax generators)
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.1,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.mean(), want.mean(), atol=2e-3,
                                   err_msg=name)


def test_adamw_decays_every_leaf():
    params = {"g": torch.ones(3), "w": torch.full((2,), 2.0)}
    grads = {"g": torch.zeros(3), "w": torch.tensor([1.0, -1.0])}
    state = {"m": {k: torch.zeros_like(v) for k, v in params.items()},
             "v": {k: torch.zeros_like(v) for k, v in params.items()},
             "step": torch.zeros((), dtype=torch.int32)}
    pspmd.adamw_update(params, grads, state, learning_rate=0.1,
                       weight_decay=0.5)
    # no gradient: only the decay (1 - lr·wd); unit gradients: one lr step
    torch.testing.assert_close(params["g"], torch.full((3,), 0.95))
    torch.testing.assert_close(params["w"], torch.tensor([1.8, 2.0]),
                               rtol=0, atol=1e-6)
    assert int(state["step"]) == 1


def test_converter_carries_the_optimizer_state():
    params = {"a": np.ones((2, 3), np.float32), "blocks": {
        "b": np.zeros((1, 2), np.float32)}}
    opt = {"m": jax.tree.map(lambda a: a + 1, params),
           "v": jax.tree.map(lambda a: a + 2, params), "step": np.int32(7)}
    p, o = gpt_spmd_state_from_paddle_tpu(params, opt, device="cpu")
    assert torch.equal(p["blocks"]["b"], torch.zeros(1, 2))
    assert torch.equal(o["v"]["a"], torch.full((2, 3), 3.0))
    assert int(o["step"]) == 7 and o["step"].dtype == torch.int32
    _, fresh = gpt_spmd_state_from_paddle_tpu(params, device="cpu")
    assert int(fresh["step"]) == 0 and not fresh["m"]["a"].any()


def test_forward_logits_give_the_loss():
    cfg = GPTConfig(**WIDTH)
    params = pspmd.init_gpt_params(cfg, torch.Generator().manual_seed(2),
                                   "cpu")
    ids, labels = (torch.from_numpy(a[:2, :32]).long() for a in _batch())
    logits = pspmd.forward(params, ids, cfg)
    assert logits.shape == (2, 32, WIDTH["vocab_size"])
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, WIDTH["vocab_size"]), labels.reshape(-1))
    got = pspmd.loss_fn(params, ids, labels, cfg)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kwargs", [
    dict(mesh={"dp": 2}), dict(mesh={"dp": 1, "pp": 2}),
    dict(mesh={"sharding": 2}),
    dict(num_microbatches=2), dict(schedule_mode="1F1B"),
    dict(mesh={"sharding": 2}, offload=True)])
def test_paths_not_ported_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
        build_spmd_train_step(GPTConfig(**WIDTH), device="cpu", **kwargs)


def test_offload_on_one_device_trains_as_without():
    """The reference's offload moves the state to pinned host memory only
    under a "sharding" axis (ZeRO, A5); on one device it changes nothing:
    two steps are bit for bit those of ``offload=False``."""
    cfg = GPTConfig(**WIDTH)
    ids, labels = (torch.from_numpy(a[:2, :32]).long() for a in _batch())
    runs = []
    for offload in (False, True):
        step, init = build_spmd_train_step(cfg, device="cpu", offload=offload,
                                           remat_policy="none")
        params, opt = init(4)
        losses = []
        for _ in range(2):
            loss, params, opt = step(params, opt, ids, labels)
            losses.append(loss)
        runs.append((torch.stack(losses), pspmd._leaves(params),
                     pspmd._leaves(opt["m"])))
    (l0, p0, m0), (l1, p1, m1) = runs
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]) and torch.equal(m0[k], m1[k]), k
