"""paddle_tpu_torch's HTTP serving path, weight swap and memory accounting
on the card.

Every test needs an NVIDIA card and skips without one.  The file imports no
JAX, so it runs on the card's machine (without the repo's conftest, which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_server_cuda.py -q
"""
import http.client
import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch.generation import GenerationSession
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.profiler import memscope
from paddle_tpu_torch.serving import (GenerationEngine,
                                      GenerationEngineConfig, ServingServer)

pytestmark = pytest.mark.cuda

WIDTH = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128)                    # head dim 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the serving steps are captured "
                    "CUDA graphs over the flash-attention kernel")


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(1, WIDTH["vocab_size"], n).astype(np.int32)
            for n in (3, 20, 9, 5)]


def _uncaptured(net, prompts, n):
    sess = GenerationSession(net, batch_capacity=4)

    def direct(kind, make, types, values):
        return make()(*[torch.as_tensor(np.asarray(v)).to(sess.device, t)
                        for v, t in zip(values, types)])
    sess._compiled = direct
    return [r.tolist() for r in sess.generate(prompts, max_new_tokens=n)]


def test_swap_weights_under_captured_graphs(card):
    """The swap copies into the parameters the graphs bind: the next
    replays read the new weights, nothing is captured again, and swapping
    back gives the first streams bit for bit."""
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    other = GPT(GPTConfig(**WIDTH), device="cuda", seed=1)
    first = {k: v.clone() for k, v in net.state_dict().items()}
    prompts = _prompts()
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=4, max_new_tokens=12, warmup=True,
            name="cuda_swap")) as eng:
        compiles = eng.session._cache.compiles
        want = [eng.generate(p, timeout=120).tolist() for p in prompts]
        ptrs = [p.data_ptr() for p in net.parameters()]
        eng.swap_weights(other.state_dict())
        got = [eng.generate(p, timeout=120).tolist() for p in prompts]
        assert got == _uncaptured(other, prompts, 12)
        eng.swap_weights({k: v.cpu().numpy() for k, v in first.items()})
        back = [eng.generate(p, timeout=120).tolist() for p in prompts]
        assert back == want
        assert [p.data_ptr() for p in net.parameters()] == ptrs
        assert eng.session._cache.compiles == compiles
        assert all(e.graph is not None
                   for e in eng.session._cache.entries().values())


def test_memscope_reads_the_allocator(card):
    memscope.reset()
    memscope.enable()
    try:
        keep = torch.empty(1 << 20, dtype=torch.float32, device="cuda")
        assert memscope.live_bytes() == torch.cuda.memory_allocated() > 0
        stats = memscope.device_stats()
        assert set(stats) == {"bytes_in_use", "peak_bytes_in_use",
                              "bytes_limit", "largest_alloc_size",
                              "bytes_reserved"}
        assert stats["largest_alloc_size"] >= keep.numel() * 4
        assert stats["bytes_limit"] >= stats["bytes_reserved"] >= \
            stats["bytes_in_use"]
        c = memscope.census()
        assert c["live_arrays"] > 0
        assert c["live_bytes_total"] == torch.cuda.memory_allocated()
        assert memscope.peak_bytes() >= torch.cuda.max_memory_allocated()
        net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
        with GenerationEngine(net, GenerationEngineConfig(
                max_slots=4, max_new_tokens=4, name="cuda_mem")) as eng:
            tags = memscope.tag_bytes()
            params = sum(p.numel() for p in net.parameters()) * 4
            caches = 2 * 2 * 4 * 128 * 128 * 4    # L, k/v, S, T, D fp32
            assert tags["params"] == params and tags["kv_arena"] == caches
            eng.generate([3, 4, 5], timeout=60)
        ledger = [e for e in memscope.compile_entries()
                  if e["site"] == "cuda_mem"]
        assert len(ledger) == 2 and all(e["wall_ms"] > 0 for e in ledger)
        del keep
    finally:
        memscope.disable()
        memscope.reset()


def test_http_streams_equal_the_engine_on_the_card(card):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    prompts = _prompts()
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=4, max_new_tokens=8, warmup=True,
            name="cuda_http")) as eng:
        want = _uncaptured(net, prompts, 8)
        with ServingServer(eng) as srv:
            for p, w in zip(prompts, want):
                for stream in (False, True):
                    conn = http.client.HTTPConnection(srv.host, srv.port,
                                                      timeout=120)
                    conn.request("POST", "/v1/generate", json.dumps(
                        {"prompt_ids": p.tolist(), "stream": stream}),
                        {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    data = r.read().decode()
                    conn.close()
                    assert r.status == 200
                    if stream:
                        toks = [json.loads(ln[6:])["token"]
                                for ln in data.split("\n")
                                if ln.startswith("data: ")
                                and '"token"' in ln]
                    else:
                        toks = json.loads(data)["tokens"]
                    assert toks == w
