"""The routing and TMA geometry of paddle_tpu_torch's Hopper attention
kernels (``csrc/flash_attn_sm90.cu``, bf16 and fp16), and packed attention
past the old length limit, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  What surrounds them is plain Python and is checked here:
which library a launch goes to, how each operand is described to TMA
(checked against numbers worked out by hand), the type codes the C entry
points take, and that
``flash_attention_qkv`` takes sequences longer than 2048, held against the
JAX package's ``flash_attention_qkv`` (its split path at that length).
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_attention_qkv as fq

rfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5     # tests/test_pallas_kernels.py:57,64


def _packed_views(B, T, H, d, dtype=torch.bfloat16):
    qkv = torch.zeros((B, T, 3 * H * d), dtype=dtype)
    return qkv, fq._views(qkv, H)


# -- routing -------------------------------------------------------------------
@pytest.mark.parametrize("d,route", [(32, "tile"), (64, "sm90"),
                                     (128, "sm90")])
def test_bf16_routes_by_head_dim(d, route):
    _, (q, k, v) = _packed_views(2, 100, 2, d)
    assert fa.kernel_route(torch.bfloat16, d, q, k, v) == route


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fp16_routes_as_bf16_by_head_dim(d):
    # fp16 takes the Hopper kernel where bf16 does (d 64 and 128) and the
    # tile kernels elsewhere, on the same operands
    _, (q, k, v) = _packed_views(2, 100, 2, d, torch.float16)
    route = fa.kernel_route(torch.float16, d, q, k, v)
    assert route == ("sm90" if d in (64, 128) else "tile")
    assert route == fa.kernel_route(torch.bfloat16, d,
                                    *(x.bfloat16() for x in (q, k, v)))


@pytest.mark.parametrize("d", [32, 64, 128])
def test_fp32_stays_on_the_fma_kernels(d):
    _, (q, k, v) = _packed_views(2, 100, 2, d, torch.float32)
    assert fa.kernel_route(torch.float32, d, q, k, v) == "tile"


def test_an_operand_tma_cannot_describe_raises():
    for dt in (torch.bfloat16, torch.float16):
        # a head stride of 68 16-bit elements is 136 bytes: no multiple
        # of 16
        x = torch.zeros((2, 10, 2, 68), dtype=dt)[..., :64]
        with pytest.raises(ValueError, match="TMA cannot describe"):
            fa.kernel_route(dt, 64, x)
        # a base 2 bytes past a 16-byte boundary
        flat = torch.zeros(2 * 10 * 2 * 64 + 8, dtype=dt)
        y = flat[1:1 + 2 * 10 * 2 * 64].view(2, 10, 2, 64)
        assert y.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.kernel_route(dt, 64, y)
    # the FMA kernels' route never looks at TMA
    assert fa.kernel_route(torch.float32, 64, x.float()) == "tile"


# -- tensor-map geometry -------------------------------------------------------
def test_geometry_of_packed_projection_views():
    # B 2, T 100, H 3, d 64: F = 192, a row of the projection is
    # 3F = 576 elements = 1152 bytes, a batch 100 rows = 115200 bytes
    qkv, views = _packed_views(2, 100, 3, 64)
    for i, x in enumerate(views):
        g = fa.tma_geometry(x, rows=128)
        assert g == dict(dims=(64, 3, 100, 2), strides=(128, 1152, 115200),
                         box=(64, 1, 128, 1))
        # q, k and v start F = 192 elements (384 bytes) apart
        assert x.data_ptr() - qkv.data_ptr() == i * 384


def test_geometry_of_a_contiguous_bshd_tensor():
    x = torch.zeros((2, 50, 4, 128), dtype=torch.bfloat16)
    assert fa.tma_geometry(x, rows=64) == dict(
        dims=(128, 4, 50, 2), strides=(256, 1024, 51200),
        box=(64, 1, 64, 1))


def test_geometry_of_a_folded_tensor():
    # (BH, T, d) is read as (BH, T, 1, d): the head axis of extent 1
    # takes the stride d * 2 bytes
    x = fa._as_bshd(torch.zeros((6, 100, 64), dtype=torch.bfloat16))
    assert fa.tma_geometry(x, rows=128) == dict(
        dims=(64, 1, 100, 6), strides=(128, 128, 12800),
        box=(64, 1, 128, 1))


def test_geometry_array_the_kernel_takes():
    # B 2, T 8, H 2, d 64: rows of 3 * 128 elements (768 bytes), batches
    # of 8 rows (6144 bytes); 7 values an operand
    _, (q, k, v) = _packed_views(2, 8, 2, 64)
    geo = fa._sm90_geometry(torch.bfloat16, 64, q, k)
    assert list(geo) == [64, 2, 8, 2, 128, 768, 6144] * 2
    # fp16 is 2 bytes too: the same array for the same shape
    _, (q16, k16, _v) = _packed_views(2, 8, 2, 64, torch.float16)
    assert list(fa._sm90_geometry(torch.float16, 64, q16, k16)) == list(geo)
    assert fa._sm90_geometry(torch.float32, 64, q.float()) is None


def test_type_codes_match_the_c_entry_points():
    # the wrapper passes _DTYPE_CODES[dtype]; flash_attn_sm90.cu takes
    # DTYPE_BF16 and DTYPE_F16 and refuses every other code, the tile
    # kernels switch on 0 (fp32), 1 (bf16) and 2 (fp16)
    csrc = Path(fa.__file__).resolve().parent.parent / "csrc"
    sm90 = (csrc / "flash_attn_sm90.cu").read_text()
    codes = dict(re.findall(r"DTYPE_(BF16|F16) = (\d+)", sm90))
    assert {"BF16": int(codes["BF16"]), "F16": int(codes["F16"])} == {
        "BF16": fa._DTYPE_CODES[torch.bfloat16],
        "F16": fa._DTYPE_CODES[torch.float16]}
    for name, entry in (("flash_sm90_fwd", "run_fwd"),
                        ("flash_sm90_bwd", "run_bwd")):
        body = sm90[sm90.index(f'extern "C" int {name}('):]
        body = body[:body.index("\n}\n")]
        assert re.findall(r"case (DTYPE_\w+):\s+return (\w+)<(\w+)>",
                          body) == [("DTYPE_BF16", entry, "__nv_bfloat16"),
                                    ("DTYPE_F16", entry, "__half")]
        assert "default:\n      return ERR_DTYPE;" in body
    for src in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        text = (csrc / src).read_text()
        types = dict(re.findall(r"case (\d):\s+return \(int\)run<(\w+)>",
                                text))
        assert types == {str(fa._DTYPE_CODES[torch.float32]): "float",
                         str(fa._DTYPE_CODES[torch.bfloat16]):
                             "__nv_bfloat16",
                         str(fa._DTYPE_CODES[torch.float16]): "__half"}


# -- packed attention past T 2048 ---------------------------------------------
def _inputs(seed, B, T, H, d):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, T, 3 * H * d).astype(np.float32),
            rs.rand(B, T, H * d).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_packed_attention_past_2048_matches_reference(causal):
    T = 2304
    assert rfa._pallas_mode(T, T, causal)[0] != "small"  # split path
    qkv, g = _inputs(0, 1, T, 2, 32)
    want, vjp = jax.vjp(lambda x: rfa.flash_attention_qkv(x, 2,
                                                          causal=causal),
                        jnp.asarray(qkv))
    want_d = vjp(jnp.asarray(g))[0]
    x = torch.from_numpy(qkv).requires_grad_()
    out = fq.flash_attention_qkv(x, 2, causal=causal)
    (got_d,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    assert out.shape == (1, T, 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               atol=GRAD_ATOL)
