"""The fused epilogue's backward (and its forward on mixed types) of
paddle_tpu_torch against the JAX reference.

On the CPU, ``fused_ln_bwd`` computes ``fused_ln_bwd_ref``, the plain
version of ``csrc/fused_ln_bwd.cu``; these tests hold it against
``jax.vjp`` of the reference's ``_fused`` (``ops/fused_ops.py:48``,
``use_pallas=False``, whose backward is ``_fused_bwd`` :62) with the same
seed, on x and residual of the same type and of different types, p 0,
0.1 and 0.5, D 48, 768 (the encoder's width, the kernel's warp path) and
1100 (its block path), and fp32, bf16 or mixed parameters.  The mixed-type
forward is held against ``fused_ln_pallas`` in interpret mode (fault C6).
Tolerances: gradients fp32 atol 1e-5 (``tests/test_torch_fused_ln.py``),
bf16 atol 5e-2 (``tests/test_pallas_kernels.py:138``); the forward fp32
atol 1e-6, bf16 one bf16 ulp of the output.  The kernel is held against
its plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_ops as rfo
from paddle_tpu.ops.pallas import fused_ln as rfl

from paddle_tpu_torch.ops import fused_ln as fl
from paddle_tpu_torch.ops import fused_ops as fo

N, EPS, SEED = 8, 1e-5, 77
GRAD_ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
F32, BF16 = torch.float32, torch.bfloat16
TYPES = {"fp32": (F32, F32), "bf16": (BF16, BF16), "x_bf16": (BF16, F32),
         "res_bf16": (F32, BF16)}
# bias, gamma, beta: fp32 at D 48, bf16 at 768, mixed at 1100
PARAMS = {48: (F32, F32, F32), 768: (BF16, BF16, BF16),
          1100: (BF16, F32, BF16)}
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}


def _arrays(D, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(N, D).astype(np.float32),
            rs.randn(N, D).astype(np.float32),
            rs.randn(D).astype(np.float32),
            (rs.rand(D) + 0.5).astype(np.float32),
            rs.randn(D).astype(np.float32),
            # cotangent: column sums of 8 rows stay below 8, where one bf16
            # ulp is under the atol
            (0.5 * rs.randn(N, D)).astype(np.float32))


def _both(arrays, dtypes):
    """The same values as torch tensors and JAX arrays of ``dtypes``."""
    ts = [torch.from_numpy(a).to(dt) for a, dt in zip(arrays, dtypes)]
    js = [jnp.asarray(t.float().numpy(), _JNP[t.dtype]) for t in ts]
    return ts, js


@pytest.mark.parametrize("D", sorted(PARAMS))
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("types", sorted(TYPES))
def test_plain_backward_matches_the_reference_vjp(types, p, D):
    x_dt, r_dt = TYPES[types]
    dtypes = (x_dt, r_dt, *PARAMS[D], x_dt)
    (x, r, b, ga, be, g), (jx, jr, jb, jga, jbe, jg) = _both(_arrays(D),
                                                             dtypes)
    _, vjp = jax.vjp(lambda *a: rfo._fused(*a, jnp.uint32(SEED), p, EPS,
                                           False), jx, jr, jb, jga, jbe)
    want = vjp(jg)
    got = fl.fused_ln_bwd(g, x, r, b, ga, be, SEED, p=p, eps=EPS)
    for name, a, w, t in zip(("dx", "dres", "dbias", "dgamma", "dbeta"),
                             got, want, (x, r, b, ga, be)):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        assert w.dtype == _JNP[t.dtype], name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=GRAD_ATOL[t.dtype], rtol=0,
                                   err_msg=name)
    # dx and dres are separate tensors even where they agree (p = 0)
    assert got[0].data_ptr() != got[1].data_ptr()
    if p > 0:
        dropped = fl.hash_uniform(SEED, (N, D)) < torch.tensor(p)
        assert torch.equal(got[0] == 0, dropped)


def test_plain_backward_in_float64_is_the_fp32_math():
    # the float64 run chip_smoke.py holds the kernel's column sums to
    ts = [torch.from_numpy(a) for a in _arrays(768, seed=3)]
    x, r, b, ga, be, g = ts
    f32 = fl.fused_ln_bwd_ref(g, x, r, b, ga, be, SEED, p=0.1, eps=EPS)
    f64 = fl.fused_ln_bwd_ref(*(t.double() for t in (g, x, r, b, ga, be)),
                              SEED, p=0.1, eps=EPS)
    for a, w in zip(f32, f64):
        assert w.dtype == torch.float64
        torch.testing.assert_close(a.double(), w, rtol=1e-5, atol=1e-5)
        assert (a.double() == 0).equal(w == 0)


@pytest.mark.parametrize("p", [0.0, 0.4])
@pytest.mark.parametrize("types", ["x_bf16", "res_bf16"])
def test_mixed_type_forward_matches_the_pallas_kernel(types, p):
    x_dt, r_dt = TYPES[types]
    arrays = _arrays(64, seed=5)[:5]
    (x, r, b, ga, be), js = _both(arrays, (x_dt, r_dt, x_dt, F32, F32))
    want = np.asarray(rfl.fused_ln_pallas(*js, 9, p=p, eps=EPS,
                                          interpret=True), np.float32)
    got = fl.fused_ln(x, r, b, ga, be, 9, p=p, eps=EPS)
    assert got.dtype == x_dt
    if x_dt == F32:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_autograd_backward_calls_the_wrapper_by_module_lookup(monkeypatch):
    calls = []
    real = fl.fused_ln_bwd

    def spy(*args, **kwargs):
        calls.append((args[0].shape, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(fl, "fused_ln_bwd", spy)
    x, r, b, ga, be, g = (torch.from_numpy(a) for a in _arrays(48, seed=7))
    leaves = [t.requires_grad_() for t in (x, r, b, ga, be)]
    out = fo.FusedBiasDropoutResidualLN.apply(*leaves, SEED, 0.1, EPS)
    grads = torch.autograd.grad(out, leaves, g)
    assert calls == [((N, 48), dict(p=0.1, eps=EPS))]
    want = real(g, *(t.detach() for t in leaves), SEED, p=0.1, eps=EPS)
    for a, w in zip(grads, want):
        assert torch.equal(a, w)


def test_backward_wrapper_refuses_mismatched_shapes():
    x = torch.rand(4, 8)
    v = torch.rand(8)
    with pytest.raises(ValueError, match="g must be"):
        fl.fused_ln_bwd(torch.rand(4, 7), x, x, v, v, v, 0, p=0.0, eps=EPS)
    with pytest.raises(ValueError, match="\\(N, D\\)"):
        fl.fused_ln_bwd(x, x, torch.rand(4, 7), v, v, v, 0, p=0.0, eps=EPS)
    with pytest.raises(ValueError, match="bias, gamma, beta"):
        fl.fused_ln_bwd(x, x, x, torch.rand(7), v, v, 0, p=0.0, eps=EPS)
