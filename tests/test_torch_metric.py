"""The port's metrics against the JAX package's, on the same arrays.

``compute`` runs on tensors in each package (``jax.lax.top_k`` there,
``torch.topk`` here); ``update`` and ``accumulate`` keep the reference's
numpy state, so every result is equal, not close.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import metric as rmetric
from paddle_tpu.core.tensor import Tensor

from paddle_tpu_torch import metric


def _logits(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _labels(shape, classes, seed):
    return np.random.RandomState(seed).randint(0, classes, shape)


@pytest.mark.parametrize("topk", [1, (1, 5)])
@pytest.mark.parametrize("layout", ["2d", "3d", "onehot"])
def test_accuracy_matches_the_reference(topk, layout):
    ref = rmetric.Accuracy(topk=topk)
    port = metric.Accuracy(topk=topk)
    assert port.name() == ref.name()
    for seed in range(3):
        if layout == "2d":
            pred, label = _logits((16, 10), seed), _labels((16, 1), 10, seed)
        elif layout == "3d":          # (B, T, V) logits, (B, T, 1) labels
            pred = _logits((2, 8, 10), seed)
            label = _labels((2, 8, 1), 10, seed)
        else:
            pred = _logits((16, 10), seed)
            label = np.eye(10, dtype=np.float32)[_labels(16, 10, seed)]
        want = ref.update(ref.compute(Tensor(jnp.asarray(pred)),
                                      Tensor(jnp.asarray(label))))
        correct = port.compute(torch.from_numpy(pred),
                               torch.from_numpy(label))
        assert isinstance(correct, torch.Tensor)
        assert port.update(correct) == want
    assert port.accumulate() == ref.accumulate()
    port.reset()
    assert not port.total.any() and not port.count.any()


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_the_reference(cls):
    ref, port = getattr(rmetric, cls)(), getattr(metric, cls)()
    for seed in range(3):
        rs = np.random.RandomState(seed)
        probs = rs.rand(32).astype(np.float32)
        if cls == "Auc":                  # two columns, the last one read
            probs = np.stack([1 - probs, probs], 1)
        labels = rs.randint(0, 2, (32, 1))
        ref.update(Tensor(jnp.asarray(probs)), Tensor(jnp.asarray(labels)))
        port.update(torch.from_numpy(probs), torch.from_numpy(labels))
    assert port.accumulate() == ref.accumulate()
    assert 0.0 < port.accumulate() < 1.0
    assert port.name() == ref.name()
    port.reset()
    assert port.accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy_matches_the_reference(k):
    pred, label = _logits((20, 7), 5), _labels((20, 1), 7, 5)
    want = float(np.asarray(rmetric.accuracy(Tensor(jnp.asarray(pred)),
                                             Tensor(jnp.asarray(label)),
                                             k=k)._data))
    got = metric.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                          k=k)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert float(got) == want


def test_compute_runs_where_the_prediction_lives():
    pred = torch.from_numpy(_logits((4, 6), 0))
    correct = metric.Accuracy().compute(pred, np.array([[1], [2], [3], [4]]))
    assert correct.device == pred.device and correct.dtype == torch.bool
    assert correct.shape == (4, 1)
