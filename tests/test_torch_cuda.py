"""paddle_tpu_torch on the card: the CUDA kernel and the paths that launch it.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on the card's machine, which has none (the
repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.generation import GenerationSession
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.ops import flash_attention as pfa
from paddle_tpu_torch.serving import GenerationEngine, GenerationEngineConfig

pytestmark = pytest.mark.cuda

WIDTH = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128)                    # head dim 64
FP32_ATOL, BF16_ATOL = 2e-5, 3e-2                # tests/test_pallas_kernels.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def _kernel_cases():
    cases = [(tq, tk, 64, causal, dtype)
             for tq, tk in [(1, 1), (7, 7), (100, 100), (128, 256),
                            (512, 512)]
             for causal in (False, True)
             for dtype in (torch.float32, torch.bfloat16)]
    return cases + [(128, 128, d, True, torch.float32) for d in (32, 128)]


def test_kernel_matches_plain_version(card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tq, tk, d, causal, dtype in _kernel_cases():
        q, k, v = (torch.rand((24, t, d), generator=gen, device="cuda")
                   .to(dtype) for t in (tq, tk, tk))
        before = pfa.LAUNCHES
        out = pfa.flash_attn_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert pfa.LAUNCHES == before + 1
        ref = pfa.flash_attention_ref(q, k, v, causal=causal)
        atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
        assert out.dtype == dtype
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=atol)


def test_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="head dim"):
        pfa.flash_attn_fwd(*(torch.rand(2, 8, 48, device="cuda")
                             for _ in range(3)))
    x = torch.rand(2, 64, 8, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pfa.flash_attn_fwd(x, x, x)
    h = torch.rand(2, 8, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        pfa.flash_attn_fwd(h, h, h)


def test_gpt_on_the_card_matches_the_cpu(card):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    cpu = GPT(GPTConfig(**WIDTH), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    ids = torch.randint(0, WIDTH["vocab_size"], (2, 100))
    before = pfa.LAUNCHES
    with torch.inference_mode():
        got = net(ids.cuda())
        want = cpu(ids)
        assert pfa.LAUNCHES == before + WIDTH["num_layers"]
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
        # a prefill through the kernel equals the masked path on the card
        kc, mc = net.gen_caches(2, 100), net.gen_caches(2, 100)
        by_kernel, _ = net(ids, caches=kc)
        by_mask, _ = net(ids, caches=mc, positions=torch.zeros(2))
    torch.testing.assert_close(by_kernel, by_mask, rtol=0, atol=1e-4)
    # layer 0 caches the same projections; deeper layers see inputs that
    # differ by the two attentions' rounding
    torch.testing.assert_close(kc[0].k, mc[0].k, rtol=0, atol=0)
    for a, b in zip(kc, mc):
        torch.testing.assert_close(a.v, b.v, rtol=0, atol=1e-5)


def test_engine_streams_equal_solo_streams_on_the_card(card):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(1, WIDTH["vocab_size"], n).astype(np.int32),
             dict(do_sample=i % 2 == 1, temperature=0.8, top_p=0.9,
                  seed=i)) for i, n in enumerate((3, 20, 9, 5, 17, 2))]
    before = pfa.LAUNCHES
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=4, max_new_tokens=16)) as engine:
        streams = [engine.submit(p, **kw) for p, kw in reqs]
        outs = [s.result(timeout=120) for s in streams]
        groups = engine.stats()["prefill_steps"]
    assert pfa.LAUNCHES - before == WIDTH["num_layers"] * groups
    solo = GenerationSession(net, batch_capacity=4)
    for (p, kw), out in zip(reqs, outs):
        np.testing.assert_array_equal(
            out, solo.generate([p], max_new_tokens=16, **kw)[0])
