"""paddle_tpu_torch's profiler windows on the card: the device trace of a
captured train step names the ``flash_attn_sm90`` kernels its replay ran.

Every test needs an NVIDIA card and skips without one.  The file imports no
JAX, so it runs on the card's machine (without the repo's conftest, which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiler_cuda.py -q
"""
from collections import Counter

import numpy as np
import pytest
import torch

from paddle_tpu_torch import Model
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.cuda

WIDTH = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128)                    # head dim 64

# csrc/flash_attn_sm90.cu's kernels as the trace names them (anonymous
# namespace, demangled): the forward, and a backward's three passes
SM90 = {"fwd": "(anonymous namespace)::fwd_kernel<",
        "delta": "(anonymous namespace)::delta_kernel<",
        "dkv": "(anonymous namespace)::dkv_kernel<",
        "dq": "(anonymous namespace)::dq_kernel<"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the device trace is "
                    "torch.profiler's CUPTI session")


def _kernels(events):
    out = Counter()
    for e in events:
        if e.get("cat") == "kernel":
            for k, pat in SM90.items():
                if pat in e["name"]:
                    out[k] += 1
    return out


def test_captured_step_window_names_the_sm90_kernels(card, tmp_path):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss(), amp_configs="O1")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, WIDTH["vocab_size"], (4, 128))
    labels = np.roll(ids, -1, 1).reshape(4, 128, 1)
    model.train_batch([ids], [labels])             # captures
    p = prof.Profiler(with_device_trace=True, log_dir=str(tmp_path))
    p.start()
    fa.SM90_FWD_LAUNCHES = fa.SM90_BWD_LAUNCHES = 0
    model.train_batch([ids], [labels])             # a replay
    fwd, bwd = fa.SM90_FWD_LAUNCHES, fa.SM90_BWD_LAUNCHES
    p.step()
    p.stop()
    assert (fwd, bwd) == (2, 2)
    trace = p.device_trace
    launches = [e for e in trace["events"]
                if e.get("name") == "cudaGraphLaunch"]
    assert len(launches) == 1
    assert _kernels(trace["events"]) == {"fwd": fwd, "delta": bwd,
                                         "dkv": bwd, "dq": bwd}
    assert trace["path"].startswith(str(tmp_path))
    # the legacy session writes its file too
    prof.start_profiler(log_dir=str(tmp_path / "legacy"))
    model.train_batch([ids], [labels])
    prof.stop_profiler()
    assert _kernels(prof._last_device["events"])["fwd"] == 2
    assert not prof._device_live
