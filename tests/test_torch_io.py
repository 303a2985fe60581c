"""The port's ``io`` against the JAX package's: samplers, collate,
``DataLoader`` and the device prefetch stage.

The samplers draw from numpy's global RNG in both packages, so one
``np.random.seed`` gives the same orders.  Collated values are equal;
the port's types follow its rule (floats float32, integers int64), the
reference's its jax x64-off canonicalisation (integers int32).  The
prefetcher runs here with ``device="cpu"``, where it collates on its
thread and moves nothing; its copies onto the card are tested in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as rio

from paddle_tpu_torch import NoCudaDevice
from paddle_tpu_torch import io


class ArrayDS(io.Dataset):
    """Twenty (x float32 (4,), y int64 (1,)) samples."""

    def __init__(self, n=20):
        rng = np.random.RandomState(0)
        self.x = rng.rand(n, 4).astype("float32")
        self.y = rng.randint(0, 3, (n, 1))

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class RefArrayDS(rio.Dataset):
    def __init__(self, n=20):
        self.inner = ArrayDS(n)

    def __getitem__(self, i):
        return self.inner[i]

    def __len__(self):
        return len(self.inner)


class WorkerDS(ArrayDS):
    """Samples that say which worker process fetched them."""

    def __getitem__(self, i):
        info = io.get_worker_info()
        return self.x[i], -1 if info is None else info.id


def _np(t):
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(_np(a), _np(b))


# -- samplers ----------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda m, ds: m.SequenceSampler(ds),
    lambda m, ds: m.RandomSampler(ds),
    lambda m, ds: m.RandomSampler(ds, replacement=True, num_samples=30),
    lambda m, ds: m.RandomSampler(ds, num_samples=7),
    lambda m, ds: m.WeightedRandomSampler(np.arange(1, 21), 25),
    lambda m, ds: m.WeightedRandomSampler(np.arange(1, 21), 10,
                                          replacement=False),
], ids=["sequence", "random", "replacement", "num_samples", "weighted",
        "weighted_no_replacement"])
def test_sampler_orders_match_the_reference(make):
    orders = []
    for mod in (rio, io):
        np.random.seed(11)
        sampler = make(mod, ArrayDS())
        orders.append((list(sampler), list(sampler), len(sampler)))
    assert orders[0] == orders[1]


def test_random_split_matches_the_reference():
    np.random.seed(3)
    want = [s.indices for s in rio.random_split(ArrayDS(), [5, 15])]
    np.random.seed(3)
    got = io.random_split(ArrayDS(), [5, 15])
    assert [s.indices for s in got] == want
    assert len(got[0]) == 5 and got[1][0][0].shape == (4,)


@pytest.mark.parametrize("n,bs,drop", [(20, 6, False), (20, 6, True),
                                       (18, 6, False), (3, 6, True)])
def test_batch_sampler_lengths_and_batches(n, bs, drop):
    ds = ArrayDS(n)
    got = io.BatchSampler(ds, batch_size=bs, drop_last=drop)
    want = rio.BatchSampler(ds, batch_size=bs, drop_last=drop)
    assert len(got) == len(want) == len(list(got))
    assert list(got) == list(want)


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, False),
                                          (True, True)])
def test_distributed_shards_match_the_reference(shuffle, drop):
    ds = ArrayDS(20)
    for rank in range(3):
        got = io.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                         shuffle=shuffle, drop_last=drop)
        want = rio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                           shuffle=shuffle, drop_last=drop)
        assert len(got) == len(want)
        for epoch in range(2):            # the shuffle moves per epoch
            assert list(got) == list(want), (rank, epoch)
    shards = [sum(io.DistributedBatchSampler(ds, 4, num_replicas=3,
                                             rank=r), []) for r in range(3)]
    assert sorted(sum(shards, [])) == sorted(list(range(20)) + [0])


def test_distributed_rank_and_world_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    s = io.DistributedBatchSampler(ArrayDS(10), 2)
    assert (s.nranks, s.local_rank) == (4, 3)
    assert list(s) == [[3, 7], [1]]
    monkeypatch.delenv("PADDLE_TRAINERS_NUM")
    monkeypatch.delenv("PADDLE_TRAINER_ID")
    s = io.DistributedBatchSampler(ArrayDS(10), 2)
    assert (s.nranks, s.local_rank) == (1, 0)


# -- collate -----------------------------------------------------------------
def test_collate_values_match_and_types_follow_the_rule():
    rs = np.random.RandomState(1)
    batch = [{"f64": rs.rand(3), "i64": rs.randint(0, 9, (2,)),
              "i32": rs.randint(0, 9, (2,)).astype(np.int32),
              "u8": rs.randint(0, 9, (2,)).astype(np.uint8),
              "pair": (float(rs.rand()), int(rs.randint(9))),
              "tag": "s", "flag": rs.rand(2) > 0.5}
             for _ in range(4)]
    want = rio.default_collate_fn(batch)
    got = io.default_collate_fn(batch)
    assert got["f64"].dtype == torch.float32
    assert got["i64"].dtype == got["i32"].dtype == torch.int64
    assert got["u8"].dtype == torch.uint8 and got["flag"].dtype == torch.bool
    assert got["pair"][0].dtype == torch.float32
    assert got["pair"][1].dtype == torch.int64
    assert got["tag"] == want["tag"] == ["s"] * 4
    for k in ("f64", "i64", "i32", "u8", "flag"):
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))
    for g, w in zip(got["pair"], want["pair"]):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    rows = [torch.tensor([1.5, 2.0], dtype=torch.float64)] * 3
    assert io.default_collate_fn(rows).dtype == torch.float32


def test_tensor_dataset_converts_once_by_the_rule():
    ids = np.arange(12).reshape(6, 2)
    ds = io.TensorDataset([ids, ids.astype(np.float64)])
    assert [t.dtype for t in ds.tensors] == [torch.int64, torch.float32]
    assert len(ds) == 6 and torch.equal(ds[2][0], torch.tensor([4, 5]))
    ref = rio.TensorDataset([ids, ids.astype(np.float64)])
    for i in range(6):
        for g, w in zip(ds[i], ref[i]):
            np.testing.assert_array_equal(g.numpy(), _np(w))


# -- DataLoader --------------------------------------------------------------
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, True)])
def test_loader_batches_match_the_reference(workers, shuffle, drop):
    np.random.seed(5)
    want = list(rio.DataLoader(RefArrayDS(), batch_size=6, shuffle=shuffle,
                               drop_last=drop))
    np.random.seed(5)
    loader = io.DataLoader(ArrayDS(), batch_size=6, shuffle=shuffle,
                           drop_last=drop, num_workers=workers)
    got = list(loader)
    assert len(loader) == len(want)
    _same_batches(got, want)
    assert got[0][0].dtype == torch.float32
    assert got[0][1].dtype == torch.int64


def test_workers_report_their_info():
    assert io.get_worker_info() is None
    batches = list(io.DataLoader(WorkerDS(), batch_size=5, num_workers=2))
    ids = set(torch.cat([b[1] for b in batches]).tolist())
    assert ids <= {0, 1} and ids


def test_iterable_dataset_and_chain():
    class Count(io.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(np.arange(self.n, dtype=np.float64))

    loader = io.DataLoader(io.ChainDataset([Count(3), Count(4)]),
                           batch_size=3, num_workers=2)
    got = [b.tolist() for b in loader]
    assert got == [[0.0, 1.0, 2.0], [0.0, 1.0, 2.0], [3.0]]
    with pytest.raises(TypeError, match="no fixed length"):
        len(loader)
    comp = io.ComposeDataset([ArrayDS(5), ArrayDS(4)])
    assert len(comp) == 4 and len(comp[0]) == 4


# -- DevicePrefetcher --------------------------------------------------------
def test_prefetch_gives_the_plain_loaders_batches():
    np.random.seed(7)
    want = list(io.DataLoader(ArrayDS(), batch_size=4, shuffle=True))
    np.random.seed(7)
    loader = io.DataLoader(ArrayDS(), batch_size=4, shuffle=True,
                           prefetch_to_device=2, places="cpu")
    _same_batches(list(loader), want)
    assert loader._last_prefetcher.stats["produced"] == 5


def test_prefetcher_is_one_shot_and_bounded():
    loader = io.DataLoader(ArrayDS(), batch_size=2, prefetch_to_device=3,
                           places=["cpu"])
    assert len(list(loader)) == 10
    pf = loader._last_prefetcher
    assert pf.stats["produced"] == pf.stats["gets"] == 10
    assert pf.stats["max_depth"] <= 3
    with pytest.raises(RuntimeError, match="one-shot"):
        list(pf)
    assert len(list(loader)) == 10 and loader._last_prefetcher is not pf


def test_prefetcher_iterator_mode_nested_structures():
    batches = [{"a": np.ones((2, 3), np.float32) * i,
                "b": (np.arange(2, dtype=np.int32) + i, "tag")}
               for i in range(4)]
    got = list(io.DevicePrefetcher(iter(batches), depth=2, device="cpu"))
    assert len(got) == 4
    for i, b in enumerate(got):
        assert isinstance(b["a"], torch.Tensor)
        np.testing.assert_array_equal(b["a"].numpy(), batches[i]["a"])
        assert b["b"][1] == "tag"


def test_prefetcher_surfaces_an_upstream_error_in_order():
    def gen():
        yield np.zeros((2,), np.float32)
        yield np.ones((2,), np.float32)
        raise ValueError("boom")
    it = iter(io.DevicePrefetcher(gen(), depth=2, device="cpu"))
    assert next(it).sum() == 0 and next(it).sum() == 2
    with pytest.raises(ValueError, match="boom"):
        next(it)


class FlakyDS(ArrayDS):
    """Sample ``bad`` fails its first ``fails`` reads."""

    def __init__(self, bad, fails):
        super().__init__()
        self.bad, self.left = bad, fails

    def __getitem__(self, i):
        if i == self.bad and self.left > 0:
            self.left -= 1
            raise OSError("worker died")
        return super().__getitem__(i)


def test_prefetcher_refetches_a_failed_batch():
    want = list(io.DataLoader(ArrayDS(), batch_size=4))
    loader = io.DataLoader(FlakyDS(9, 1), batch_size=4, prefetch_to_device=2,
                           places="cpu")
    with pytest.warns(UserWarning, match="refetching"):
        got = list(loader)
    _same_batches(got, want)
    assert loader._last_prefetcher.stats["refetch"] == 1
    loader = io.DataLoader(FlakyDS(9, 10), batch_size=4,
                           prefetch_to_device=2, places="cpu")
    with pytest.warns(UserWarning), \
            pytest.raises(RuntimeError, match="refetches"):
        list(loader)


def test_prefetcher_wants_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        io.DevicePrefetcher(iter([]), depth=1)
    with pytest.raises(NoCudaDevice):
        list(io.DataLoader(ArrayDS(), batch_size=4, prefetch_to_device=2))
