"""The fused bias·dropout·residual·LayerNorm of paddle_tpu_torch against the
JAX reference.

On the CPU, ``fused_ln`` computes its plain version; these tests hold it
against the reference's ``fused_ln_pallas`` in interpret mode and its
``_fused_math``, and the op's gradients against ``jax.vjp`` of the
reference's ``_fused``, with the same seed on both sides (the mask is a
hash of (seed, index), bit for bit the reference's).  Tolerances: fp32
atol 1e-6 (tests/test_pallas_kernels.py:369); bf16 one bf16 ulp of the
output, since both sides round the same fp32 value, which may differ in
its last fp32 bits; gradients atol 1e-5.  The CUDA kernel is held against
its plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_ops as rfo
from paddle_tpu.ops.pallas import fused_ln as rfl

import paddle_tpu_torch
from paddle_tpu_torch.ops import fused_ln as fl
from paddle_tpu_torch.ops import fused_ops as fo

SEEDS = (0, 42, 2**31 - 2, 0xFFFFFFFF)
FP32_ATOL, GRAD_ATOL = 1e-6, 1e-5


def _inputs(seed, N=16, D=64):
    rs = np.random.RandomState(seed)
    return (rs.randn(N, D).astype(np.float32),
            rs.randn(N, D).astype(np.float32),
            rs.randn(D).astype(np.float32),
            (rs.rand(D) + 0.5).astype(np.float32),
            rs.randn(D).astype(np.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_uniform_is_the_reference_bit_for_bit(seed):
    # an offset whose indices wrap past 2**32 inside the block
    for shape, offset in (((9, 37), 0), ((5, 64), 2**32 - 100), ((300,), 7)):
        want = np.asarray(rfl.hash_uniform(jnp.uint32(seed), shape,
                                           offset=offset))
        got = fl.hash_uniform(seed, shape, offset=offset).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, want), (shape, offset)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.4])
def test_plain_version_matches_the_pallas_kernel_and_math(p):
    x, r, b, g, be = _inputs(0)
    args = [jnp.asarray(v) for v in (x, r, b, g, be)]
    want = np.asarray(rfl.fused_ln_pallas(*args, 1234, p=p, eps=1e-5,
                                          interpret=True))
    want_math = np.asarray(rfo._fused_math(*args, jnp.uint32(1234), p=p,
                                           eps=1e-5))
    got = fl.fused_ln(*(torch.from_numpy(v) for v in (x, r, b, g, be)),
                      1234, p=p, eps=1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_math, atol=FP32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_bf16_inputs_match_the_reference(p):
    # bf16 x and residual, bias in x's type, gamma and beta fp32 (the
    # reference op's defaults)
    x, r, b, g, be = _inputs(1)
    want = np.asarray(rfl.fused_ln_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), jnp.asarray(g), jnp.asarray(be), 7,
        p=p, eps=1e-5, interpret=True).astype(jnp.float32))
    got = fl.fused_ln(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(r).bfloat16(),
                      torch.from_numpy(b).bfloat16(), torch.from_numpy(g),
                      torch.from_numpy(be), 7, p=p, eps=1e-5)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_bf16_inputs_with_fp32_parameters_match_the_reference(p):
    # AMP O1's triple: bf16 x and residual, bias, gamma and beta all fp32
    # (the layer's fp32 parameters, which O1 does not cast)
    x, r, b, g, be = _inputs(4, N=24, D=256)
    want = np.asarray(rfl.fused_ln_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16),
        jnp.asarray(b), jnp.asarray(g), jnp.asarray(be), 11, p=p, eps=1e-5,
        interpret=True).astype(jnp.float32))
    got = fl.fused_ln(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(r).bfloat16(),
                      *(torch.from_numpy(v) for v in (b, g, be)), 11, p=p,
                      eps=1e-5)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


@pytest.mark.parametrize("mangled,name", [
    ("_ZN44_GLOBAL__N__365dd7d5_11_fused_ln_cu_6e1f8c2a11ln_fwd_tileI13"
     "__nv_bfloat16S1_Li3EEEvNS_4ArgsE", "ln_fwd_tile<bf16,bf16,3>"),
    ("_ZN44_GLOBAL__N__365dd7d5_11_fused_ln_cu_6e1f8c2a11ln_fwd_tileI6"
     "__halffLi4EEEvNS_4ArgsE", "ln_fwd_tile<fp16,fp32,4>"),
    ("_ZN44_GLOBAL__N__365dd7d5_11_fused_ln_cu_6e1f8c2a13fused_ln_warpIf6"
     "__halfLi4EEEvNS_4ArgsE", "fused_ln_warp<fp32,fp16,4>"),
    ("_ZN44_GLOBAL__N__365dd7d5_11_fused_ln_cu_6e1f8c2a12fused_ln_rowIffEEv"
     "NS_4ArgsEi", "fused_ln_row<fp32,fp32>"),
])
def test_the_build_report_names_each_forward_kernel_by_its_types(mangled,
                                                                  name):
    # chip_smoke.py phase 2 prints every kernel's registers and spills
    # under these names, one per instantiation of the epilogue's forward
    import chip_smoke
    report = (f"ptxas info    : Compiling entry function '{mangled}' for "
              f"'sm_90a'\nptxas info    : Function properties for "
              f"{mangled}\n    0 bytes stack frame, 0 bytes spill stores, "
              f"0 bytes spill loads\nptxas info    : Used 72 registers, "
              f"used 1 barriers\n")
    assert chip_smoke.ptxas_summary(report) == [dict(
        kernel=name, registers=72, spill_stores=0, spill_loads=0)]


@pytest.mark.parametrize("kernel,kind", [
    ("void (anonymous namespace)::ln_fwd_tile<__half, __half, 3>(("
     "anonymous namespace)::Args)", "fused_ln (row 12)"),
    ("void (anonymous namespace)::fused_ln_warp<float, float, 4>(("
     "anonymous namespace)::Args)", "fused_ln (row 12)"),
    ("void (anonymous namespace)::ln_bwd_tile<__nv_bfloat16, float, 3>(("
     "anonymous namespace)::Args)", "fused_ln_bwd (the epilogue's backward)"),
    ("void (anonymous namespace)::ln_bwd_fold(float const*, int, int, void*, "
     "void*, void*, int)", "fused_ln_bwd (the epilogue's backward)"),
])
def test_profile_train_files_each_epilogue_kernel_under_its_row(kernel,
                                                                  kind):
    # tools/profile_train.py's device time by kind: a kernel it does not
    # know lands in "other elementwise"
    from paddle_tpu_torch.tools import profile_train
    assert profile_train._kind(kernel) == kind


def test_gradients_match_the_reference_vjp():
    x, r, b, g, be = _inputs(2, N=12, D=48)
    cot = np.random.RandomState(3).randn(12, 48).astype(np.float32)
    seed, p = 99, 0.4
    _, vjp = jax.vjp(lambda *a: rfo._fused(*a, jnp.uint32(seed), p, 1e-5,
                                           False),
                     *(jnp.asarray(v) for v in (x, r, b, g, be)))
    want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, r, b, g, be)]
    out = fo.FusedBiasDropoutResidualLN.apply(*leaves, seed, p, 1e-5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for name, a, w in zip(("x", "residual", "bias", "gamma", "beta"), got,
                          want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def test_op_defaults_flatten_and_draw_a_seed_per_call(monkeypatch):
    x, r, *_ = _inputs(4, N=24, D=32)
    tx = torch.from_numpy(x).reshape(2, 12, 32)
    tr = torch.from_numpy(r).reshape(2, 12, 32)
    drawn = []
    real = fo._next_seed

    def record():
        drawn.append(real())
        return drawn[-1]

    monkeypatch.setattr(fo, "_next_seed", record)
    paddle_tpu_torch.seed(5)
    out = fo.fused_bias_dropout_residual_layer_norm(tx, tr, dropout_rate=0.3)
    evald = fo.fused_bias_dropout_residual_layer_norm(tx, tr,
                                                      dropout_rate=0.3,
                                                      training=False)
    assert out.shape == tx.shape and len(drawn) == 2
    assert all(0 <= s < 2**31 - 1 for s in drawn)
    # bias zeros, ln_scale ones, ln_bias zeros; p 0 when not training
    want = rfo._fused_math(jnp.asarray(x), jnp.asarray(r),
                           jnp.zeros(32), jnp.ones(32), jnp.zeros(32),
                           jnp.uint32(drawn[0]), p=0.3, eps=1e-5)
    np.testing.assert_allclose(out.reshape(24, 32).numpy(), np.asarray(want),
                               atol=FP32_ATOL, rtol=0)
    torch.testing.assert_close(evald, torch.nn.functional.layer_norm(
        tr + tx, (32,)), rtol=0, atol=1e-5)
    # the same seed draws the same seeds again
    paddle_tpu_torch.seed(5)
    again = fo.fused_bias_dropout_residual_layer_norm(tx, tr,
                                                      dropout_rate=0.3)
    assert drawn[2] == drawn[0] and torch.equal(again, out)


def test_wrapper_refuses_mismatched_shapes_and_devices():
    x = torch.rand(4, 8)
    v = torch.rand(8)
    with pytest.raises(ValueError, match="\\(N, D\\)"):
        fl.fused_ln(x, torch.rand(4, 7), v, v, v, 0, p=0.0, eps=1e-5)
    with pytest.raises(ValueError, match="bias, gamma, beta"):
        fl.fused_ln(x, x, torch.rand(7), v, v, 0, p=0.0, eps=1e-5)
    meta = torch.empty((4, 8), device="meta")
    mv = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fl.fused_ln(meta, meta, mv, mv, mv, 0, p=0.0, eps=1e-5)
