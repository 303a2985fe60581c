"""The rows pass of the optimizer update on the card: ``mt_update_rows``
(``csrc/multi_tensor_update.cu``) against its plain version
``multi_tensor_update_rows_ref``, for SGD, Adam and AdamW in each type
setup, on merged row-sparse gradients with repeated and padding ids, a
row width that is no multiple of a vector, no touched row, a regularizer
and the ``found_inf`` skip; and a sparse embedding's step on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sparse_cuda.py -q
"""
import pytest
import torch

from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.ops import multi_tensor_update as mtu
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW

pytestmark = pytest.mark.cuda

SETUPS = {"fp32": (torch.float32, False), "bf16_master": (torch.bfloat16, True),
          "bf16": (torch.bfloat16, False),
          "fp16_master": (torch.float16, True), "fp16": (torch.float16, False)}
OPTS = {"sgd": lambda: SGD(0.1), "adam": lambda: Adam(0.01),
        "adamw": lambda: AdamW(0.01, weight_decay=0.1)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the rows pass has no CPU mode")
    return torch.device("cuda")


def _records(kind, setup, V, D, ids, dev, reg=None, seed=0):
    """A record of a (V, D) parameter in ``setup`` with random slots and
    powers (after a few steps' worth) and the merged gradient of ``ids``;
    the same state twice, for the kernel and the plain version."""
    gen = torch.Generator().manual_seed(seed)
    dtype, master = SETUPS[setup]
    opt = OPTS[kind]()
    spec = opt._kernel_spec()
    w32 = torch.randn(V, D, generator=gen)
    vals = torch.randn(len(ids), D, generator=gen).to(dtype)
    rows = torch.tensor(ids, dtype=torch.int64)
    merged = SelectedRows(rows, vals, (V, D)).merged()
    slots = [torch.rand(V, D, generator=gen) * (0.5 if k == "moment2" else 1)
             for k in spec.slots]
    pows = [torch.tensor(b ** 3, dtype=torch.float32) for b in spec.betas]
    out = []
    for _ in range(2):
        p = w32.to(dtype).to(dev)
        m = w32.to(dev) if master else None
        target_dtype = torch.float32 if master else dtype
        out.append(mtu.Record(
            name="emb", param=p, grad=merged._values.to(dev).contiguous(),
            master=m, slots=tuple(s.to(dev, target_dtype) for s in slots),
            pows=tuple(t.clone().to(dev) for t in pows), reg=reg,
            reg_coeff=0.01 if reg else 0.0,
            decay=0.1 if kind == "adamw" else 0.0,
            rows=merged._rows.to(dev)))
    return spec, opt, out


def _state(r):
    return [r.param, r.master, *r.slots, *r.pows]


@pytest.mark.parametrize("setup", list(SETUPS))
@pytest.mark.parametrize("kind", list(OPTS))
@pytest.mark.parametrize("D, ids", [
    (768, [5, 0, 9, 5, 5, 63, 0, 1]),      # repeats, padding id 0
    (13, [2, 2, 7, 40]),                   # D no multiple of a vector
    (64, [])])                             # no row touched
def test_rows_pass_matches_its_plain_version(card, kind, setup, D, ids):
    spec, opt, (k, p) = _records(kind, setup, 64, D, ids, card,
                                 reg=None if kind == "adamw" else "L2Decay")
    lr = torch.full((), 0.1, device=card)
    before = [t.clone() for t in _state(k) if t is not None]
    mtu.ROWS_LAUNCHES = 0
    mtu.multi_tensor_update_rows(spec, mtu.RowsTable(spec, [k]), lr,
                                 opt._update)
    mtu.multi_tensor_update_rows_ref(spec, [p], lr, opt._update)
    torch.cuda.synchronize()
    assert mtu.ROWS_LAUNCHES == (1 if ids else 0)
    touched = torch.zeros(64, dtype=torch.bool, device=card)
    touched[torch.tensor(ids, dtype=torch.int64, device=card)] = True
    for a, b, old in zip([t for t in _state(k) if t is not None],
                         [t for t in _state(p) if t is not None], before):
        if a.dim() == 0:
            assert torch.equal(a, b)
            continue
        assert torch.equal(a[~touched], old[~touched])
        assert a.dtype == b.dtype
        # fp32 as the dense pass is held (chip_smoke.py UPDATE_ATOL and
        # UPDATE_RTOL); a 16-bit value within one step of its type
        x, y = a.float(), b.float()
        if a.dtype == torch.float32:
            tol = 1e-6 + 1e-5 * y.abs()
        else:
            tol = torch.finfo(a.dtype).eps * torch.maximum(x.abs(), y.abs())
        assert bool(((x - y).abs() <= tol + 1e-30).all())
    if k.master is not None:
        assert torch.equal(k.param, k.master.to(k.param.dtype))


@pytest.mark.parametrize("kind", list(OPTS))
def test_found_inf_leaves_every_value(card, kind):
    spec, opt, (k, _) = _records(kind, "bf16_master", 32, 16, [1, 3, 3],
                                 card)
    before = [t.clone() for t in _state(k) if t is not None]
    flag = torch.ones((), dtype=torch.bool, device=card)
    mtu.multi_tensor_update_rows(spec, mtu.RowsTable(spec, [k]),
                                 torch.full((), 0.1, device=card),
                                 opt._update, found_inf=flag)
    for a, b in zip([t for t in _state(k) if t is not None], before):
        assert torch.equal(a, b)


def test_a_sparse_embedding_step_on_the_card_runs_the_rows_pass(card):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place as port_place
    port_place._place = None
    paddle.seed(0)
    emb = paddle.nn.Embedding(1000, 64, padding_idx=0, sparse=True)
    opt = paddle.optimizer.Adam(0.01, parameters=emb.parameters())
    w0 = emb.weight.numpy().copy()
    ids = paddle.to_tensor([[0, 3, 3, 999], [5, 0, 7, 3]])
    paddle.mean(emb(ids) ** 2).backward()
    g = emb.weight.grad
    assert isinstance(g, SelectedRows) and g.values.shape == [8, 64]
    mtu.ROWS_LAUNCHES = mtu.POW_LAUNCHES = 0
    mtu.LAUNCHES.clear()
    opt.step()
    torch.cuda.synchronize()
    assert (mtu.ROWS_LAUNCHES, mtu.POW_LAUNCHES, mtu.LAUNCHES) == (1, 1, {})
    w1 = emb.weight.numpy()
    moved = sorted(set(range(1000)) - {
        i for i in range(1000) if (w1[i] == w0[i]).all()})
    assert moved == [3, 5, 7, 999]
