"""The LM head's sm90 route (csrc/softmax_xent_sm90.cu) on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain versions there).  Here:

- ``softmax_xent._route``, the pure-Python choice of the CUDA source;
- a plain PyTorch model of the sm90 forward's algorithm (per tile of
  ``SM90_BN`` columns, each row's max and sum of exponentials over the
  columns below V and its label logit from the tile that holds it, then
  each row's partials folded in tile order), held
  against the reference's Pallas kernel in interpret mode
  (``paddle_tpu.ops.pallas.softmax_xent.softmax_xent_fwd``, as
  tests/test_torch_softmax_xent.py runs it) and against the port's plain
  version, at shapes whose V and N are not multiples of the tile, with
  labels outside ``[0, V)``.  Tolerance: lse and at within 1e-5
  (tests/test_pallas_kernels.py :288), both sides summing exact products
  of the inputs in fp32 in another order.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops import softmax_xent as sx

rsx = importlib.import_module("paddle_tpu.ops.pallas.softmax_xent")

STAT_ATOL = 1e-5                      # tests/test_pallas_kernels.py:288
REF_BLOCK_V = 512                     # the reference kernel's vocab tile


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _misaligned(rows, cols):
    """A contiguous bf16 (rows, cols) view whose base is 2 bytes off a
    16-byte boundary."""
    flat = torch.zeros(rows * cols + 16, dtype=torch.bfloat16)
    off = (16 - flat.data_ptr() % 16) % 16 // 2 + 1
    return flat[off:off + rows * cols].view(rows, cols)


@pytest.mark.parametrize("N,D,V", [(65536, 8, 16), (4096, 64, 520),
                                   (1000, 768, 30528), (7, 8, 8)])
def test_route_takes_sm90_for_bf16_rows_tma_can_describe(N, D, V):
    assert sx._route(_bf16(N, D), _bf16(D, V)) == "sm90"


@pytest.mark.parametrize("case", ["fp32", "fp32_w", "v700", "d100",
                                  "x_not_contiguous", "w_not_contiguous",
                                  "x_misaligned", "w_misaligned"])
def test_route_sends_the_rest_to_the_tile_kernels(case):
    x, w = _bf16(64, 64), _bf16(64, 512)
    if case == "fp32":
        x, w = x.float(), w.float()
    elif case == "fp32_w":
        w = w.float()
    elif case == "v700":                   # HEAD_SHAPES' 1400-byte rows
        w = _bf16(64, 700)
    elif case == "d100":
        x, w = _bf16(64, 100), _bf16(100, 512)
    elif case == "x_not_contiguous":
        x = _bf16(64, 64).t()
    elif case == "w_not_contiguous":
        w = _bf16(512, 64).t()
    elif case == "x_misaligned":
        x = _misaligned(64, 64)
    else:
        w = _misaligned(64, 512)
    assert sx._route(x, w) == "tile"


def tiled_fwd_model(x, w, labels, bn=sx.SM90_BN):
    """The sm90 forward's algorithm in plain PyTorch: per column tile the
    fp32 logits, each row's max and sum of exp over the columns < V (the
    tile past V is zero-filled, as TMA fills it, and masked by index), the
    label logit where the tile holds the label; then per row the partials
    folded in tile order.  (Rows are independent: the kernel's row tiles
    change nothing here.)"""
    N, V = x.shape[0], w.shape[1]
    nvt = -(-V // bn)
    wp = torch.zeros((w.shape[0], nvt * bn), dtype=torch.float32)
    wp[:, :V] = w.float()
    part_m = torch.empty((nvt, N))
    part_l = torch.empty((nvt, N))
    at = torch.zeros(N)
    lab = labels.long()
    xf = x.float()
    for vt in range(nvt):
        s = xf @ wp[:, vt * bn:(vt + 1) * bn]
        cols = torch.arange(vt * bn, (vt + 1) * bn)
        valid = cols < V
        m = s.masked_fill(~valid, float("-inf")).max(1).values
        e = torch.where(valid, torch.exp(s - m[:, None]), torch.zeros_like(s))
        part_m[vt], part_l[vt] = m, e.sum(1)
        hit = (cols[None, :] == lab[:, None]) & valid
        at[hit.any(1)] = s[hit]
    M = part_m[0].clone()
    for vt in range(1, nvt):
        M = torch.maximum(M, part_m[vt])
    L = torch.zeros(N)
    for vt in range(nvt):
        L = L + part_l[vt] * torch.exp(part_m[vt] - M)
    return M + torch.log(L), at


# V below, between and past the 256-column tile; N past the 128-row tile
SHAPES = [(200, 64, 600), (130, 48, 520), (64, 32, 264), (300, 96, 1032)]


def _inputs(seed, N, D, V, dtype):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, D).astype(np.float32)
    w = (rs.randn(D, V) * 0.1).astype(np.float32)
    lab = rs.randint(0, V, (N,)).astype(np.int32)
    lab[:4] = (0, V - 1, -1, -7)
    if dtype == "bfloat16":               # both sides see the same values
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    return x, w, lab


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,V", SHAPES)
def test_tiled_forward_model_matches_reference_kernel(N, D, V, dtype):
    x, w, lab = _inputs(N + V, N, D, V, dtype)
    # past the reference's padded vocabulary a label selects nothing there
    # either (a label in [V, padded V) selects a pad column, -1e30, in the
    # reference; the port gives 0 for every label outside [0, V), which
    # the next test holds against the port's plain version)
    vp = -(-V // REF_BLOCK_V) * REF_BLOCK_V
    lab[4] = vp + 3
    jdt = getattr(jnp, dtype)
    want_lse, want_at = rsx.softmax_xent_fwd(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(lab),
        interpret=True)
    tdt = getattr(torch, dtype)
    lse, at = tiled_fwd_model(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w).to(tdt),
                              torch.from_numpy(lab))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=STAT_ATOL, rtol=0)
    np.testing.assert_allclose(at.numpy(), np.asarray(want_at),
                               atol=STAT_ATOL, rtol=0)
    assert at[2] == at[3] == at[4] == 0


@pytest.mark.parametrize("N,D,V", SHAPES)
def test_tiled_forward_model_matches_plain_version(N, D, V):
    x, w, lab = _inputs(N * V, N, D, V, "bfloat16")
    lab[4] = V                            # the first label past V
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
            torch.from_numpy(lab))
    lse, at = tiled_fwd_model(*args)
    want_lse, want_at = sx.softmax_xent_fwd(*args)     # CPU: plain version
    torch.testing.assert_close(lse, want_lse, atol=STAT_ATOL, rtol=0)
    torch.testing.assert_close(at, want_at, atol=STAT_ATOL, rtol=0)
    assert at[2] == at[3] == at[4] == 0


def test_cpu_calls_count_no_launch_on_either_route():
    before = dict(sx.ROUTE_LAUNCHES)
    x, w = torch.randn(64, 64).bfloat16(), torch.randn(64, 512).bfloat16()
    lab = torch.arange(64, dtype=torch.int32)
    lse, at = sx.softmax_xent_fwd(x, w, lab)
    sx.softmax_xent_dlogits(x, w, lab, lse, torch.tensor(0.5))
    assert sx.ROUTE_LAUNCHES == before
    assert set(before) == {"sm90_fwd", "tile_fwd", "sm90_dlogits",
                           "tile_dlogits"}
