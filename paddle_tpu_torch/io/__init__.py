"""``paddle.io`` of the port — the counterpart of ``paddle_tpu/io/__init__.py``:
datasets, samplers, ``default_collate_fn`` and ``DataLoader``, and the
device prefetch stage (``io/prefetch.py``, :class:`DevicePrefetcher`).

The samplers draw from numpy's global RNG as the reference's do
(``RandomSampler`` a ``np.random.permutation``, ``WeightedRandomSampler``
a ``np.random.choice``, ``random_split`` a permutation), so one
``np.random.seed`` gives both packages the same batch order.
``DistributedBatchSampler`` shuffles with ``np.random.RandomState(epoch)``
and pads as the reference does; its rank and world size default to
``PADDLE_TRAINER_ID`` and ``PADDLE_TRAINERS_NUM``.

**Collated types.**  The reference runs with jax x64 off, so its batches
of int64 come out int32 and of float64 float32.  The port collates to
CPU ``torch`` tensors by this rule: floating leaves of float64 (numpy
arrays, Python floats) become float32; integer leaves (numpy arrays,
Python ints) other than uint8 become int64, the type ``nn.Embedding`` and
the losses take; bool, uint8, float16, bfloat16 and float32 stay as they
are; strings stay lists.  The values are the reference's.

``DataLoader`` with ``num_workers == 0`` collates in the calling thread;
with ``num_workers > 0`` it hands PyTorch's worker processes
(``torch.utils.data.DataLoader``) this loader's ``BatchSampler`` as
``batch_sampler`` and its collate, so the index draw stays in the main
process and the order stays the reference's.  An ``IterableDataset`` is
read in the calling thread either way, as in the reference.  With
``prefetch_to_device=N`` every epoch runs through a fresh
:class:`DevicePrefetcher` of depth N onto ``places`` (the card unless
given ``"cpu"``).
"""
from __future__ import annotations

import math
import os
from typing import List

import numpy as np
import torch

from .prefetch import DevicePrefetcher

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "DataLoader",
           "DevicePrefetcher", "default_collate_fn", "get_worker_info"]


def _canonical(t: torch.Tensor) -> torch.Tensor:
    """The collated type of ``t`` (the module docstring's rule)."""
    if t.dtype == torch.float64:
        return t.to(torch.float32)
    if not t.is_floating_point() and not t.is_complex() and t.dtype not in (
            torch.bool, torch.uint8, torch.int64):
        return t.to(torch.int64)
    return t


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return _canonical(a)
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return _canonical(torch.from_numpy(a))


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Rows of equally long tensors or arrays, converted once by the
    collated-type rule."""

    def __init__(self, tensors):
        self.tensors = [_as_tensor(t) for t in tensors]
        n = self.tensors[0].shape[0]
        assert all(t.shape[0] == n for t in self.tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            sample = ds[idx]
            out.extend(sample if isinstance(sample, (tuple, list)) else
                       [sample])
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = sum(lengths)
    assert total == len(dataset)
    perm = np.random.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else \
                SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _env_rank() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)


def _env_world_size() -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)


class DistributedBatchSampler(BatchSampler):
    """This rank's share of the index space: the indices padded to a
    multiple of the world size, every ``nranks``-th from ``local_rank``
    (reference ``io/__init__.py:193``)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else \
            _env_world_size()
        self.local_rank = rank if rank is not None else _env_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
            self.epoch += 1
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def get_worker_info():
    """Inside a ``DataLoader`` worker process: its ``id``,
    ``num_workers`` and ``dataset``; None elsewhere."""
    return torch.utils.data.get_worker_info()


def default_collate_fn(batch):
    """Stack a list of samples into a batch, leaf by leaf, to CPU tensors
    of the collated types (module docstring)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return _canonical(torch.stack(batch))
    if isinstance(sample, np.ndarray):
        return _as_tensor(np.stack(batch))
    if isinstance(sample, float):
        return torch.tensor(batch, dtype=torch.float32)
    if isinstance(sample, int) and not isinstance(sample, bool):
        return torch.tensor(batch, dtype=torch.int64)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    return _as_tensor(np.asarray(batch))


class DataLoader:
    """Batches of ``dataset`` in the order of its ``batch_sampler`` (module
    docstring).  ``places`` is where ``prefetch_to_device`` lands the
    batches: a device (or a list of them, the first taken), the card when
    None.  ``feed_list``, ``return_list``, ``use_buffer_reader`` and
    ``use_shared_memory`` are taken and change nothing."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, use_shared_memory=True,
                 prefetch_factor=2, timeout=0, worker_init_fn=None,
                 persistent_workers=False, prefetch_to_device=0):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_to_device = int(prefetch_to_device or 0)
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self._device = places           # Model.fit sets its model's device
        self._last_prefetcher = None
        self.timeout = timeout
        self.prefetch_factor = max(2, prefetch_factor)
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif not self._iterable_mode:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)

    def _fetch(self, indices: List[int]):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not getattr(self, "drop_last", False):
            yield self.collate_fn(batch)

    def __iter__(self):
        if self.prefetch_to_device > 0:
            # one fresh (one-shot) stage per epoch
            pf = DevicePrefetcher.for_loader(
                self, depth=self.prefetch_to_device, device=self._device)
            self._last_prefetcher = pf
            yield from pf
            return
        yield from self._iter_batches()

    def _iter_batches(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        yield from torch.utils.data.DataLoader(
            self.dataset, batch_sampler=self.batch_sampler,
            collate_fn=self.collate_fn, num_workers=self.num_workers,
            timeout=self.timeout, worker_init_fn=self.worker_init_fn,
            prefetch_factor=self.prefetch_factor,
            persistent_workers=self.persistent_workers)
