"""The compiled step's remat policies (``paddle_tpu_torch.models.gpt_spmd``
``REMAT_POLICIES``: the reference's ``"none"``, ``"full"``, ``"ctx"``,
``"ctx_ffn"`` and ``"dots"``) against the JAX reference.

- ``"ctx_ffn"`` and ``"dots"`` take one fp32 step against the reference's
  ``build_spmd_train_step`` with the same policy, from the reference's
  ``init_fn(0)`` on ``np.random.RandomState(0)`` ids and labels, at the
  width of ``tests/test_torch_train_step.py`` with L 2; gradients are read
  from AdamW's first moment (``m = (1 - b1) g``).  Tolerances as there:
  loss rtol 1e-5, grads atol 5e-5 (the sums run in another order).
- All five give the same loss and gradients, within 1e-6 (on the CPU they
  agree bit for bit: a kept value is the same computation's result).
- The attention forward kernel runs as often per block as the reference
  runs its Pallas forward under the same policy, counted in the
  reference's jaxpr of the whole step (``PADDLE_PALLAS_FORCE=1``, so the
  kernels are ``pallas_call`` equations): once under ``"none"``,
  ``"ctx"`` and ``"ctx_ffn"``, twice under ``"full"`` and ``"dots"``,
  whose saved products do not include the attention output.  The
  backward kernel runs once per block under every policy.
- What a keeping policy keeps: ``"ctx_ffn"`` reuses the GELU output and
  ``"dots"`` every product's output in the recompute, instead of
  computing them again.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

from paddle_tpu.distributed.topology import build_mesh
from paddle_tpu.models import GPTConfig as RefConfig
from paddle_tpu.models import gpt_spmd as rspmd

from paddle_tpu_torch.models import (GPTConfig, build_spmd_train_step,
                                     gpt_spmd_state_from_paddle_tpu)
from paddle_tpu_torch.models import gpt_spmd as pspmd
from paddle_tpu_torch.ops import flash_attention_qkv as fq

WIDTH = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128, ffn_mult=2)
B, T, B1 = 8, 128, 0.9
LOSS_RTOL, GRAD_ATOL, AGREE_ATOL = 1e-5, 5e-5, 1e-6
GRADS = ("blocks.qkv_w", "blocks.out_w", "blocks.up_w", "blocks.down_w",
         "blocks.ln1_g", "blocks.ln2_b", "head_w", "wte", "wpe", "ln_f_g")
POLICIES = pspmd.REMAT_POLICIES


def _batch(b=B):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, WIDTH["vocab_size"], (B, T)).astype(np.int32)
    labels = rng.randint(0, WIDTH["vocab_size"], (B, T)).astype(np.int32)
    return ids[:b], labels[:b]


def _first_moments(opt):
    return {k: np.array(v, dtype=np.float32)
            for k, v in pspmd._leaves(opt["m"]).items()}


@pytest.mark.parametrize("policy", ["ctx_ffn", "dots"])
def test_policy_step_matches_reference(policy):
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    rstep, rinit = rspmd.build_spmd_train_step(
        RefConfig(**WIDTH), mesh, remat_policy=policy)
    rp, ro = rinit(seed=0)
    params, opt = gpt_spmd_state_from_paddle_tpu(
        jax.tree.map(np.asarray, rp), device="cpu")
    step, _ = build_spmd_train_step(GPTConfig(**WIDTH), remat_policy=policy,
                                    device="cpu")
    ids, labels = _batch()
    rl, rp, ro = rstep(rp, ro, jnp.asarray(ids), jnp.asarray(labels))
    want = _first_moments(ro)
    loss, params, opt = step(params, opt, torch.from_numpy(ids),
                             torch.from_numpy(labels))
    got = _first_moments(opt)
    np.testing.assert_allclose(loss.item(), float(rl), rtol=LOSS_RTOL)
    assert set(got) == set(want)
    for name in GRADS:
        np.testing.assert_allclose(got[name] / (1 - B1),
                                   want[name] / (1 - B1), atol=GRAD_ATOL,
                                   err_msg=name)


def _loss_and_grads(policy, params, ids, labels):
    live = {k: v.detach().clone().requires_grad_()
            for k, v in pspmd._leaves(params).items()}
    loss = pspmd.loss_fn(pspmd._rebuild(params, live), ids, labels,
                         GPTConfig(**WIDTH), remat_policy=policy)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss, dict(zip(live, grads))


def _counting(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)

    def wrap(name):
        fn = getattr(module, name)

        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    for name in names:
        monkeypatch.setattr(module, name, wrap(name))
    return calls


@pytest.fixture(scope="module")
def policy_runs():
    """Each policy's loss, gradients and attention calls on one batch."""
    params = pspmd.init_gpt_params(
        GPTConfig(**WIDTH), torch.Generator().manual_seed(0), "cpu")
    ids, labels = (torch.from_numpy(a) for a in _batch(2))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        calls = _counting(mp, fq, ("flash_qkv_fwd", "flash_qkv_bwd"))
        for policy in POLICIES:
            for k in calls:
                calls[k] = 0
            loss, grads = _loss_and_grads(policy, params, ids, labels)
            runs[policy] = dict(loss=loss, grads=grads, calls=dict(calls))
    return runs


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_give_the_same_loss_and_gradients(policy_runs, policy):
    base, run = policy_runs["none"], policy_runs[policy]
    assert run["loss"].item() == pytest.approx(base["loss"].item(),
                                               rel=AGREE_ATOL)
    for k, g in run["grads"].items():
        torch.testing.assert_close(g, base["grads"][k], rtol=0,
                                   atol=AGREE_ATOL,
                                   msg=lambda m: f"{policy} {k}: {m}")


def _pallas_calls(jaxpr, width, acc):
    """Counts of the jaxpr's ``pallas_call`` equations by direction: the
    forward writes ``(B, T, width)``, the backward ``(B, T, 3·width)``."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            last = eqn.outvars[0].aval.shape[-1]
            acc["fwd" if last == width else "bwd"] += 1
            continue
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _pallas_calls(sub.jaxpr, width, acc)
                elif isinstance(sub, jcore.Jaxpr):
                    _pallas_calls(sub, width, acc)
    return acc


def _reference_kernel_calls(policy):
    """The reference step's attention kernels per step under ``policy``,
    from its jaxpr (traced, not run)."""
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    rstep, rinit = rspmd.build_spmd_train_step(
        RefConfig(**WIDTH), mesh, remat_policy=policy)
    rp, ro = rinit(seed=0)
    ids, labels = (jnp.asarray(a) for a in _batch(2))
    jx = jax.make_jaxpr(rstep)(rp, ro, ids, labels)
    return _pallas_calls(jx.jaxpr, WIDTH["hidden_size"],
                         {"fwd": 0, "bwd": 0})


@pytest.mark.parametrize("policy,per_block", [
    ("none", 1), ("full", 2), ("ctx", 1), ("ctx_ffn", 1), ("dots", 2)])
def test_attention_runs_as_often_as_in_the_reference(
        monkeypatch, policy_runs, policy, per_block):
    monkeypatch.setenv("PADDLE_PALLAS_FORCE", "1")
    L = WIDTH["num_layers"]
    want = {"fwd": per_block * L, "bwd": L}
    assert _reference_kernel_calls(policy) == want
    calls = policy_runs[policy]["calls"]
    assert (calls["flash_qkv_fwd"], calls["flash_qkv_bwd"]) == (
        want["fwd"], want["bwd"])


@pytest.mark.parametrize("policy,products,gelus", [
    ("ctx", 0, 0), ("ctx_ffn", 0, 1), ("dots", 4, 0)])
def test_kept_values_are_reused_in_the_recompute(monkeypatch, policy,
                                                 products, gelus):
    params = pspmd.init_gpt_params(
        GPTConfig(**WIDTH), torch.Generator().manual_seed(1), "cpu")
    ids, labels = (torch.from_numpy(a) for a in _batch(1))
    reused = {"product": 0, "gelu": 0}
    for key, cls in (("product", pspmd._KeptProduct),
                     ("gelu", pspmd._KeptGelu)):
        def counted(*a, _key=key, _apply=cls.apply):
            reused[_key] += 1
            return _apply(*a)
        monkeypatch.setattr(cls, "apply", counted)
    _loss_and_grads(policy, params, ids, labels)
    L = WIDTH["num_layers"]
    assert reused == {"product": products * L, "gelu": gelus * L}
    assert pspmd._KEPT[policy] == {
        "ctx": ("attn_ctx",), "ctx_ffn": ("attn_ctx", "ffn_up"),
        "dots": ("qkv", "out", "up", "down")}[policy]


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        build_spmd_train_step(GPTConfig(**WIDTH), remat_policy="offload",
                              device="cpu")
