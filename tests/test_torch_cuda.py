"""paddle_tpu_torch on the card: the CUDA kernels and the paths that launch them.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on the card's machine, which has none (the
repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.generation import GenerationSession
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.ops import flash_attention as pfa
from paddle_tpu_torch.ops import flash_attention_qkv as fq
from paddle_tpu_torch.ops import fused_ln as fl
from paddle_tpu_torch.ops import multi_tensor_update as mtu
from paddle_tpu_torch.ops import softmax_xent as sx
from paddle_tpu_torch.serving import GenerationEngine, GenerationEngineConfig

pytestmark = pytest.mark.cuda

WIDTH = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128)                    # head dim 64
FP32_ATOL, BF16_ATOL = 2e-5, 3e-2                # tests/test_pallas_kernels.py
GRAD_ATOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
# the head kernel and its plain version both sum exact products of the
# inputs in fp32 and differ only in the order of the sums
HEAD_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4, torch.float16: 1e-5}


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
        before = pfa.FWD_LAUNCHES
        out = pfa.flash_attn_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert pfa.FWD_LAUNCHES == before + 1
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
    # fp16 runs on the kernels (flash_attn_sm90 at d 64 / 128, the tile
    # kernels elsewhere); fp64 is refused
    h = torch.rand(2, 8, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        pfa.flash_attn_fwd(h, h, h)


def test_gpt_on_the_card_matches_the_cpu(card):
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    cpu = GPT(GPTConfig(**WIDTH), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    ids = torch.randint(0, WIDTH["vocab_size"], (2, 100))
    before = pfa.FWD_LAUNCHES
    with torch.inference_mode():
        got = net(ids.cuda())
        want = cpu(ids)
        assert pfa.FWD_LAUNCHES == before + WIDTH["num_layers"]
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
    before = pfa.FWD_LAUNCHES
    with GenerationEngine(net, GenerationEngineConfig(
            max_slots=4, max_new_tokens=16)) as engine:
        streams = [engine.submit(p, **kw) for p, kw in reqs]
        outs = [s.result(timeout=120) for s in streams]
        groups = engine.stats()["prefill_steps"]
    assert pfa.FWD_LAUNCHES - before == WIDTH["num_layers"] * groups
    solo = GenerationSession(net, batch_capacity=4)
    for (p, kw), out in zip(reqs, outs):
        np.testing.assert_array_equal(
            out, solo.generate([p], max_new_tokens=16, **kw)[0])


def _qkv_cases():
    cases = [(2, T, 2, d, causal, dtype)
             for T in (64, 100, 256, 1024) for d in (32, 64, 128)
             for causal in (False, True)
             for dtype in (torch.float32, torch.bfloat16)]
    return cases + [(2, 512, 12, 64, True, dtype)
                    for dtype in (torch.float32, torch.bfloat16)]


def test_packed_attention_kernels_match_plain_versions(card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, T, H, d, causal, dtype in _qkv_cases():
        qkv = torch.rand((B, T, 3 * H * d), generator=gen,
                         device="cuda").to(dtype)
        g = torch.rand((B, T, H * d), generator=gen, device="cuda").to(dtype)
        f0, b0 = fq.FWD_LAUNCHES, fq.BWD_LAUNCHES
        out, lse = fq.flash_qkv_fwd(qkv, H, causal=causal)
        dqkv = fq.flash_qkv_bwd(qkv, out, lse, g, H, causal=causal)
        torch.cuda.synchronize()
        assert (fq.FWD_LAUNCHES, fq.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
        ref, ref_lse = fq.flash_qkv_fwd_ref(qkv, H, causal=causal)
        ref_d = fq.flash_qkv_bwd_ref(qkv, ref, ref_lse, g, H, causal=causal)
        atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
        case = (B, T, H, d, causal, dtype)
        assert out.dtype == dtype and dqkv.dtype == dtype, case
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=atol, msg=lambda m: f"{case}: {m}")
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4,
                                   msg=lambda m: f"{case}: {m}")
        torch.testing.assert_close(dqkv.float(), ref_d.float(), rtol=0,
                                   atol=GRAD_ATOL[dtype],
                                   msg=lambda m: f"{case}: {m}")


def test_packed_attention_autograd_goes_through_both_kernels(card):
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.rand((2, 128, 3 * 128), generator=gen,
                     device="cuda").requires_grad_()
    f0, b0 = fq.FWD_LAUNCHES, fq.BWD_LAUNCHES
    out = fq.flash_attention_qkv(qkv, 2, causal=True)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (fq.FWD_LAUNCHES, fq.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
    ref_in = qkv.detach().clone().requires_grad_()
    fq.flash_attention_qkv_ref(ref_in, 2, causal=True).square().sum() \
        .backward()
    torch.testing.assert_close(qkv.grad, ref_in.grad, rtol=0,
                               atol=GRAD_ATOL[torch.float32])


def test_head_kernel_matches_plain_version(card):
    rs = np.random.RandomState(0)
    for N, D, V in ((256, 64, 512), (256, 64, 700), (100, 64, 1000),
                    (300, 96, 30528)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rs.randn(N, D)).to("cuda", dtype)
            w = torch.from_numpy(rs.randn(D, V) * 0.05).to("cuda", dtype)
            lab = torch.from_numpy(rs.randint(0, V, N)).to("cuda")
            before = sx.LAUNCHES
            lse, at = sx.softmax_xent_fwd(x, w, lab)
            torch.cuda.synchronize()
            assert sx.LAUNCHES == before + 1
            ref_lse, ref_at = sx.softmax_xent_fwd_ref(x, w, lab)
            case = (N, D, V, dtype)
            torch.testing.assert_close(lse, ref_lse, rtol=0,
                                       atol=HEAD_ATOL[dtype],
                                       msg=lambda m: f"{case}: {m}")
            torch.testing.assert_close(at, ref_at, rtol=0,
                                       atol=HEAD_ATOL[dtype],
                                       msg=lambda m: f"{case}: {m}")


def test_new_wrappers_refuse_what_the_kernels_do_not_take(card):
    qkv = torch.rand(2, 8, 3 * 2 * 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fq.flash_qkv_fwd(qkv, 2)
    # fp16 runs (since the compiled step's fp16); mixed types raise
    qkv = torch.rand(2, 8, 3 * 64, device="cuda").half()
    out, lse = fq.flash_qkv_fwd(qkv, 1)
    with pytest.raises(TypeError, match="mixed types"):
        fq.flash_qkv_bwd(qkv, out, lse, out.bfloat16(), 1)
    x = torch.rand(4, 8, device="cuda")
    lab = torch.zeros(4, dtype=torch.int64, device="cuda")
    for xt, wt in ((torch.float32, torch.float16),
                   (torch.bfloat16, torch.float16),
                   (torch.float16, torch.bfloat16)):
        with pytest.raises(TypeError, match="of one type"):
            sx.softmax_xent_fwd(x.to(xt), torch.rand(8, 8, device="cuda")
                                .to(wt), lab)


def _split_cases():
    cases = [(2, tq, tk, 2, d, causal, dtype)
             for tq, tk in [(64, 64), (100, 100), (128, 256), (640, 1280),
                            (1000, 1000)]
             for d in (32, 64, 128)
             for causal in (False, True)
             for dtype in (torch.float32, torch.bfloat16)]
    return cases + [(1, 4100, 4100, 2, 64, True, torch.float32)]


def test_split_layout_kernels_match_plain_versions(card):
    # forward with lse and the backward on head views of one packed
    # projection (Tq == Tk) or on separate (B, S, H, D) tensors
    gen = torch.Generator(device="cuda").manual_seed(2)
    for B, tq, tk, H, d, causal, dtype in _split_cases():
        if tq == tk:
            q, k, v = torch.rand((B, tq, 3, H, d), generator=gen,
                                 device="cuda").to(dtype).unbind(2)
        else:
            q, k, v = (torch.rand((B, t, H, d), generator=gen,
                                  device="cuda").to(dtype)
                       for t in (tq, tk, tk))
        g = torch.rand((B, tq, H, d), generator=gen, device="cuda").to(dtype)
        f0, b0 = pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES
        out, lse = pfa.flash_attn_fwd(q, k, v, causal=causal,
                                      return_lse=True)
        grads = pfa.flash_attn_bwd(q, k, v, out, lse, g, causal=causal)
        torch.cuda.synchronize()
        assert (pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
        ref, ref_lse = pfa.flash_attn_fwd_ref(q, k, v, causal=causal,
                                              return_lse=True)
        ref_grads = pfa.flash_attn_bwd_ref(q, k, v, ref, ref_lse, g,
                                           causal=causal)
        case = (B, tq, tk, H, d, causal, dtype)
        atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=atol, msg=lambda m: f"{case}: {m}")
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5,
                                   msg=lambda m: f"{case}: {m}")
        for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
            assert a.dtype == dtype and a.shape == b.shape
            torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                       atol=GRAD_ATOL[dtype],
                                       msg=lambda m: f"{case} {name}: {m}")


def test_sdpa_gradients_flow_through_the_kernels(card):
    # q, k and v get their gradients from the backward kernel, within
    # 5e-5 of the plain versions' (the fault the autograd function fixes)
    from paddle_tpu_torch.ops.nn_misc import scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.rand((2, 256, 3, 2, 64), generator=gen, device="cuda")
    g = torch.rand((2, 256, 2, 64), generator=gen, device="cuda")
    leaves = qkv.clone().requires_grad_()
    f0, b0 = pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES
    out = scaled_dot_product_attention(*leaves.unbind(2), is_causal=True)
    out.backward(g)
    torch.cuda.synchronize()
    assert (pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
    assert leaves.grad is not None and leaves.grad.abs().sum() > 0
    plain = qkv.clone().requires_grad_()
    q, k, v = plain.unbind(2)
    fold = [x.permute(0, 2, 1, 3).reshape(4, 256, 64) for x in (q, k, v)]
    pfa.flash_attention_ref(*fold, causal=True).reshape(2, 2, 256, 64) \
        .permute(0, 2, 1, 3).backward(g)
    torch.testing.assert_close(leaves.grad, plain.grad, rtol=0,
                               atol=GRAD_ATOL[torch.float32])


def test_eager_gpt_train_batch_goes_through_the_kernels(card):
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters(),
                                     weight_decay=0.01), CrossEntropyLoss())
    rs = np.random.RandomState(0)
    ids = rs.randint(0, WIDTH["vocab_size"], (2, 100))
    labels = np.roll(ids, -1, 1).reshape(2, 100, 1)
    f0, b0 = pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES
    losses = [float(model.train_batch([ids], [labels])["loss"])
              for _ in range(5)]
    assert (pfa.FWD_LAUNCHES - f0, pfa.BWD_LAUNCHES - b0) == (
        5 * WIDTH["num_layers"], 5 * WIDTH["num_layers"])
    assert losses[-1] < losses[0]


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``t`` (fp32)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(1e-30))) - 7)


def test_fused_ln_kernel_matches_plain_version(card):
    # the warp path (D <= 1024, vector and scalar loads) and the block
    # path with the row in shared memory (D 4096, 12288) and recomputed
    # (D 12800), fp32 atol 1e-5; bf16: both round fp32 values that differ
    # by up to 1e-5, so 1e-5 plus one bf16 ulp of the output
    gen = torch.Generator(device="cuda").manual_seed(4)
    seeds = (0, 2**31 - 2, 0xFFFFFFFF)
    i = 0
    for D in (64, 100, 768, 4096, 12288, 12800):
        for N in (1, 37, 600):
            for dtype in (torch.float32, torch.bfloat16):
                for p in (0.0, 0.1, 0.5):
                    i += 1
                    x, r = (torch.randn((N, D), generator=gen, device="cuda")
                            .to(dtype) for _ in range(2))
                    pdt = dtype if i % 2 else torch.float32
                    b, g, be = (torch.randn(D, generator=gen, device="cuda")
                                .to(pdt) for _ in range(3))
                    seed = seeds[i % 3]
                    before = fl.LAUNCHES
                    out = fl.fused_ln(x, r, b, g, be, seed, p=p, eps=1e-5)
                    torch.cuda.synchronize()
                    assert fl.LAUNCHES == before + 1
                    ref = fl.fused_ln_ref(x, r, b, g, be, seed, p=p,
                                          eps=1e-5)
                    case = (N, D, dtype, p, seed)
                    assert out.dtype == dtype and out.shape == x.shape, case
                    err = (out.float() - ref.float()).abs()
                    tol = 1e-5 if dtype == torch.float32 else \
                        1e-5 + _bf16_ulp(ref.float())
                    assert (err <= tol).all(), (case, err.max().item())


def test_fused_ln_mask_is_the_hash_bit_for_bit(card):
    # x = 1, residual = bias = beta = 0, gamma = 1: an element's output is
    # positive exactly when it was kept
    N, D = 256, 768
    one = torch.ones((N, D), device="cuda")
    zero = torch.zeros((N, D), device="cuda")
    for p in (0.1, 0.5):
        for seed in (0, 2**31 - 2, 0xFFFFFFFF):
            out = fl.fused_ln(one, zero, zero[0], one[0], zero[0], seed, p=p,
                              eps=1e-5)
            keep = fl.hash_uniform(seed, (N, D), device="cuda") >= \
                torch.tensor(p, dtype=torch.float32)
            assert torch.equal(out > 0, keep), (p, seed)


def test_dlogits_kernel_matches_plain_version(card):
    rs = np.random.RandomState(1)
    for C, D, V in ((256, 64, 512), (256, 64, 700), (100, 64, 1001)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rs.randn(C, D)).to("cuda", dtype)
            w = torch.from_numpy(rs.randn(D, V) * 0.05).to("cuda", dtype)
            lab = torch.from_numpy(rs.randint(0, V, C)).to("cuda",
                                                            torch.int32)
            lse = torch.logsumexp(sx.matmul_f32(x, w), -1)
            g = torch.tensor(0.37, device="cuda")
            before = sx.DLOGITS_LAUNCHES
            out = sx.softmax_xent_dlogits(x, w, lab, lse, g)
            torch.cuda.synchronize()
            assert sx.DLOGITS_LAUNCHES == before + 1
            ref = sx.softmax_xent_dlogits_ref(x, w, lab, lse, g)
            case = (C, D, V, dtype)
            assert out.dtype == dtype and out.shape == (C, V), case
            # fp32 atol 1e-5; bf16 each element within 1e-6·|g| plus one
            # bf16 ulp of the plain value (a typical element, |g|/V, is
            # far above that, so a wrong softmax term fails)
            err = (out.float() - ref.float()).abs()
            tol = 1e-5 if dtype == torch.float32 else \
                1e-6 * 0.37 + _bf16_ulp(ref.float())
            assert (err <= tol).all(), (case, err.max().item())


def test_head_backward_goes_through_the_dlogits_kernel(card):
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(8192, 64)).float().cuda().requires_grad_()
    w = torch.from_numpy(rs.randn(64, 700) * 0.05).float().cuda() \
        .requires_grad_()
    lab = torch.from_numpy(rs.randint(0, 700, 8192)).cuda()
    before = sx.DLOGITS_LAUNCHES
    dx, dw = torch.autograd.grad(sx.softmax_xent_loss(x, w, lab), (x, w))
    torch.cuda.synchronize()
    assert sx.DLOGITS_LAUNCHES == before + 2          # chunks of 4096
    ref = torch.nn.functional.cross_entropy(x @ w, lab)
    rdx, rdw = torch.autograd.grad(ref, (x, w))
    torch.testing.assert_close(dx, rdx, rtol=0, atol=1e-7)
    torch.testing.assert_close(dw, rdw, rtol=0, atol=1e-6)


def test_encoder_gradients_flow_through_the_fused_ln_kernel(card):
    import paddle_tpu_torch
    from unittest import mock
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    layer = FusedTransformerEncoderLayer(128, 2, 256, dropout_rate=0.1,
                                         activation="gelu",
                                         attn_dropout_rate=0.0,
                                         act_dropout_rate=0.0, device="cuda")
    layer.train()
    x = torch.randn((2, 100, 128), device="cuda")

    def grads():
        paddle_tpu_torch.seed(7)
        layer.zero_grad()
        xi = x.clone().requires_grad_()
        layer(xi).square().sum().backward()
        return [xi.grad] + [p.grad.clone() for p in layer.parameters()
                            if p.grad is not None]

    f0, b0, a0 = fl.LAUNCHES, fl.BWD_LAUNCHES, pfa.FWD_LAUNCHES
    got = grads()
    torch.cuda.synchronize()
    assert (fl.LAUNCHES - f0, fl.BWD_LAUNCHES - b0,
            pfa.FWD_LAUNCHES - a0) == (2, 2, 1)
    with mock.patch.object(fl, "fused_ln", fl.fused_ln_ref), \
            mock.patch.object(fl, "fused_ln_bwd", fl.fused_ln_bwd_ref):
        want = grads()
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# -- csrc/fused_ln_bwd.cu: the epilogue's backward; mixed types (C5, C6) -------
F32, BF16 = torch.float32, torch.bfloat16
LN_TYPES = ((F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16))


def _ln_operands(gen, N, D, x_dt, r_dt, p_dt):
    x, r, g = (torch.randn((N, D), generator=gen, device="cuda")
               for _ in range(3))
    b, be = (torch.randn(D, generator=gen, device="cuda").to(p_dt)
             for _ in range(2))
    gam = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(p_dt)
    return g.to(x_dt), x.to(x_dt), r.to(r_dt), b, gam, be


def test_fused_ln_mixed_types_match_plain_version(card):
    # fault C6: x and residual of different types, out in x's type
    gen = torch.Generator(device="cuda").manual_seed(20)
    for D in (64, 768, 1100):
        for x_dt, r_dt in LN_TYPES[2:]:
            for p in (0.0, 0.1):
                _, x, r, b, gam, be = _ln_operands(gen, 300, D, x_dt, r_dt,
                                                   F32)
                before = fl.LAUNCHES
                out = fl.fused_ln(x, r, b, gam, be, 5, p=p, eps=1e-5)
                torch.cuda.synchronize()
                assert fl.LAUNCHES == before + 1
                ref = fl.fused_ln_ref(x, r, b, gam, be, 5, p=p, eps=1e-5)
                assert out.dtype == x_dt
                err = (out.float() - ref.float()).abs()
                tol = 1e-5 if x_dt == F32 else 1e-5 + _bf16_ulp(ref.float())
                assert (err <= tol).all(), (D, x_dt, r_dt, p)


def test_fused_ln_bwd_kernel_matches_plain_version(card):
    # the warp path (D 64, 100, 768, 1024) and the block path (D 1100,
    # 4096); dx, dres by their type's grads atol (fp32 5e-5, bf16 5e-2);
    # the column sums in fp32 at relative L2 1e-5 against a float64 run
    # of the plain backward; dx exactly 0 where the forward dropped
    gen = torch.Generator(device="cuda").manual_seed(21)
    i = 0
    for D in (64, 100, 768, 1024, 1100, 4096):
        for N in (1, 37, 2000):
            for x_dt, r_dt in LN_TYPES:
                for p in (0.0, 0.1, 0.5):
                    i += 1
                    p_dt = x_dt if i % 2 else F32
                    args = _ln_operands(gen, N, D, x_dt, r_dt, p_dt) + (i,)
                    before = fl.BWD_LAUNCHES
                    got = fl.fused_ln_bwd(*args, p=p, eps=1e-5)
                    torch.cuda.synchronize()
                    assert fl.BWD_LAUNCHES == before + 1
                    ref = fl.fused_ln_bwd_ref(*args, p=p, eps=1e-5)
                    case = (N, D, x_dt, r_dt, p)
                    for a, w in zip(got[:2], ref[:2]):
                        assert a.dtype == w.dtype, case
                        torch.testing.assert_close(
                            a.float(), w.float(), rtol=0,
                            atol=GRAD_ATOL[a.dtype], msg=str(case))
                    truth = ref[2:] if (x_dt, r_dt) != (F32, F32) else \
                        fl.fused_ln_bwd_ref(*(t.double() for t in args[:6]),
                                            i, p=p, eps=1e-5)[2:]
                    tol = 5e-2 if (x_dt, r_dt) != (F32, F32) else 1e-5
                    for a, w in zip(got[2:], truth):
                        assert a.dtype == p_dt, case
                        rel = (a.double() - w.double()).norm() / \
                            w.double().norm()
                        assert rel.item() <= tol, case
                    if p > 0:
                        dropped = fl.hash_uniform(i, (N, D), device="cuda") \
                            < torch.tensor(p)
                        assert torch.equal(got[0] == 0, dropped), case


def test_fused_ln_bwd_repeats_bit_for_bit(card):
    gen = torch.Generator(device="cuda").manual_seed(22)
    args = _ln_operands(gen, 16384, 768, F32, F32, F32) + (3,)
    first = fl.fused_ln_bwd(*args, p=0.1, eps=1e-5)
    second = fl.fused_ln_bwd(*args, p=0.1, eps=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    # dres and dx (p 0) are separate tensors
    dx, dres = fl.fused_ln_bwd(*args, p=0.0, eps=1e-5)[:2]
    assert torch.equal(dx, dres) and dx.data_ptr() != dres.data_ptr()


def _small_encoder():
    from paddle_tpu_torch.tools.profile_train import build_encoder
    return build_encoder(dict(vocab_size=97, d_model=128, num_layers=2,
                              nhead=2, dim_feedforward=256, max_len=128,
                              dropout_rate=0.1), device="cuda")


def test_encoder_train_step_never_reaches_a_plain_epilogue(card):
    # fault C5: with both plain versions made to raise, a train step of
    # the encoder still runs, through 2L + 2L epilogue launches
    from unittest import mock
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    net = _small_encoder()

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 97, (4, 128))).cuda()
    labels = ids.roll(-1, 1)[..., None]
    for amp in (None, "O1", "O2"):
        model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                                   CrossEntropyLoss(), amp_configs=amp)
        f0, b0 = fl.LAUNCHES, fl.BWD_LAUNCHES
        with mock.patch.object(fl, "fused_ln_ref", refuse), \
                mock.patch.object(fl, "fused_ln_bwd_ref", refuse):
            loss = model.train_batch([ids], [labels])["loss"]
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        assert (fl.LAUNCHES - f0, fl.BWD_LAUNCHES - b0) == (4, 4), amp


def test_amp_o1_steps_run_bf16_attention_on_sm90(card):
    # the eager GPT and the encoder under O1: every attention launch in
    # bf16 on flash_attn_sm90.cu; the step against the plain versions
    # (loss rtol 1e-3, grads relative L2 5e-2)
    from unittest import mock
    import paddle_tpu_torch
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 97, (4, 128))).cuda()
    labels = ids.roll(-1, 1)[..., None]
    for net in (GPT(GPTConfig(**WIDTH), device="cuda", seed=0),
                _small_encoder()):
        model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                                   CrossEntropyLoss(), amp_configs="O1")

        def step():
            paddle_tpu_torch.seed(4)
            loss = model.train_batch([ids], [labels], update=False)["loss"]
            grads = [p.grad.clone() for p in net.parameters()
                     if p.grad is not None]
            model._optimizer.clear_grad()
            return loss.item(), grads

        s0, b0 = pfa.SM90_FWD_LAUNCHES, pfa.SM90_BWD_LAUNCHES
        loss, grads = step()
        assert (pfa.SM90_FWD_LAUNCHES - s0, pfa.SM90_BWD_LAUNCHES - b0) == \
            (2, 2)
        with mock.patch.object(pfa, "flash_attn_fwd",
                               pfa.flash_attn_fwd_ref), \
                mock.patch.object(pfa, "flash_attn_bwd",
                                  pfa.flash_attn_bwd_ref), \
                mock.patch.object(fl, "fused_ln", fl.fused_ln_ref), \
                mock.patch.object(fl, "fused_ln_bwd", fl.fused_ln_bwd_ref):
            ref_loss, ref_grads = step()
        assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss)
        assert len(grads) == len(ref_grads) > 10
        for a, b in zip(grads, ref_grads):
            assert a.dtype == torch.float32
            assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() \
                <= 5e-2


# -- csrc/flash_attn_sm90.cu: bf16 attention on wgmma and TMA -------------------
SM90_TS = (100, 128, 256, 512, 1024, 2048, 4096)   # chip_smoke QKV_TS + 4096


def _packed_check(qkv, g, H, causal, dtype):
    out, lse = fq.flash_qkv_fwd(qkv, H, causal=causal)
    dqkv = fq.flash_qkv_bwd(qkv, out, lse, g, H, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fq.flash_qkv_fwd_ref(qkv, H, causal=causal)
    ref_d = fq.flash_qkv_bwd_ref(qkv, ref, ref_lse, g, H, causal=causal)
    atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    case = (tuple(qkv.shape), H, causal, dtype)
    assert out.dtype == dtype and dqkv.dtype == dtype, case
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol,
                               msg=lambda m: f"{case}: {m}")
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4,
                               msg=lambda m: f"{case}: {m}")
    torch.testing.assert_close(dqkv.float(), ref_d.float(), rtol=0,
                               atol=GRAD_ATOL[dtype],
                               msg=lambda m: f"{case}: {m}")


def test_sm90_kernels_match_plain_versions(card):
    gen = torch.Generator(device="cuda").manual_seed(5)
    for T in SM90_TS:
        for d in (64, 128):
            for causal in (False, True):
                qkv = torch.rand((1, T, 3 * 2 * d), generator=gen,
                                 device="cuda").bfloat16()
                g = torch.rand((1, T, 2 * d), generator=gen,
                               device="cuda").bfloat16()
                f0, b0 = pfa.SM90_FWD_LAUNCHES, pfa.SM90_BWD_LAUNCHES
                _packed_check(qkv, g, 2, causal, torch.bfloat16)
                assert (pfa.SM90_FWD_LAUNCHES, pfa.SM90_BWD_LAUNCHES) == (
                    f0 + 1, b0 + 1)


def test_sm90_backward_repeats_bit_for_bit(card):
    gen = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn((2, 1024, 3 * 12 * 64), generator=gen,
                      device="cuda").bfloat16()
    g = torch.randn((2, 1024, 12 * 64), generator=gen,
                    device="cuda").bfloat16()
    out, lse = fq.flash_qkv_fwd(qkv, 12, causal=True)
    first = fq.flash_qkv_bwd(qkv, out, lse, g, 12, causal=True)
    second = fq.flash_qkv_bwd(qkv, out, lse, g, 12, causal=True)
    assert torch.equal(first, second)


def test_packed_attention_past_2048_on_the_card(card):
    # fault C3: flash_attention_qkv raised ValueError for T > 2048 on a
    # CUDA tensor, where the reference trains
    gen = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            qkv = torch.rand((1, 4096, 3 * 2 * 64), generator=gen,
                             device="cuda").to(dtype)
            g = torch.rand((1, 4096, 2 * 64), generator=gen,
                           device="cuda").to(dtype)
            _packed_check(qkv, g, 2, causal, dtype)
            x = qkv.clone().requires_grad_()
            fq.flash_attention_qkv(x, 2, causal=causal).backward(g)
            assert x.grad.shape == qkv.shape


def test_sm90_refuses_an_operand_tma_cannot_describe(card):
    # bf16 and fp16 alike: never sent to the tile kernels, which are not
    # built for them at d 64
    n = 128 * 2 * 64
    for dt in (torch.bfloat16, torch.float16):
        flat = torch.zeros(n + 8, dtype=dt, device="cuda")
        q = flat[1:1 + n].view(1, 128, 2, 64)          # base 2 bytes off
        out = torch.empty((1, 128, 2, 64), dtype=dt, device="cuda")
        before = pfa.SM90_FWD_LAUNCHES, pfa.FWD_LAUNCHES
        with pytest.raises(ValueError, match="16-byte aligned"):
            pfa._launch_fwd(q, q, q, out, None, False, None)
        with pytest.raises(ValueError, match="16-byte aligned"):
            pfa.flash_attn_fwd(q, q, q)
        assert (pfa.SM90_FWD_LAUNCHES, pfa.FWD_LAUNCHES) == before


# -- head dims 16, 80 and 96 (fault C4) and the fp32 product -----------------------
NEW_DIMS = (16, 80, 96)


def _split_check(B, tq, tk, H, d, causal, dtype, gen):
    """Forward with lse and backward on head views of one packed
    projection (tq == tk) or separate tensors, against the plain
    versions; returns the launches counted."""
    if tq == tk:
        q, k, v = torch.rand((B, tq, 3, H, d), generator=gen,
                             device="cuda").to(dtype).unbind(2)
    else:
        q, k, v = (torch.rand((B, t, H, d), generator=gen,
                              device="cuda").to(dtype) for t in (tq, tk, tk))
    g = torch.rand((B, tq, H, d), generator=gen, device="cuda").to(dtype)
    f0, b0 = pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES
    out, lse = pfa.flash_attn_fwd(q, k, v, causal=causal, return_lse=True)
    grads = pfa.flash_attn_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    launched = (pfa.FWD_LAUNCHES - f0, pfa.BWD_LAUNCHES - b0)
    ref, ref_lse = pfa.flash_attn_fwd_ref(q, k, v, causal=causal,
                                          return_lse=True)
    ref_grads = pfa.flash_attn_bwd_ref(q, k, v, ref, ref_lse, g,
                                       causal=causal)
    case = (B, tq, tk, H, d, causal, dtype)
    atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol,
                               msg=lambda m: f"{case}: {m}")
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5,
                               msg=lambda m: f"{case}: {m}")
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=GRAD_ATOL[dtype],
                                   msg=lambda m: f"{case} {name}: {m}")
    return launched


def test_new_head_dims_split_layout_match_plain_versions(card):
    gen = torch.Generator(device="cuda").manual_seed(8)
    for d in NEW_DIMS:
        for tq, tk in ((7, 7), (100, 100), (128, 256), (1000, 1000)):
            for causal in (False, True):
                for dtype in (torch.float32, torch.bfloat16):
                    assert _split_check(2, tq, tk, 2, d, causal, dtype,
                                        gen) == (1, 1)


def test_new_head_dims_packed_match_plain_versions(card):
    gen = torch.Generator(device="cuda").manual_seed(9)
    for d in NEW_DIMS:
        for T in (16, 100, 512, 1024):
            for causal in (False, True):
                for dtype in (torch.float32, torch.bfloat16):
                    qkv = torch.rand((2, T, 3 * 2 * d), generator=gen,
                                     device="cuda").to(dtype)
                    g = torch.rand((2, T, 2 * d), generator=gen,
                                   device="cuda").to(dtype)
                    f0, b0 = fq.FWD_LAUNCHES, fq.BWD_LAUNCHES
                    _packed_check(qkv, g, 2, causal, dtype)
                    assert (fq.FWD_LAUNCHES, fq.BWD_LAUNCHES) == (
                        f0 + 1, b0 + 1)


def test_other_head_dims_still_raise(card):
    for d in (24, 256):
        x = torch.rand(1, 8, 2, d, device="cuda")
        with pytest.raises(ValueError, match=r"\(16, 32, 64, 80, 96, 128\)"):
            pfa.flash_attn_fwd(x, x, x)
        with pytest.raises(ValueError, match=r"\(16, 32, 64, 80, 96, 128\)"):
            fq.flash_qkv_fwd(torch.rand(1, 8, 3 * 2 * d, device="cuda"), 2)


def test_fp32_rows_2_and_7_at_their_timing_shapes(card):
    # row 2: the streaming forward with lse (B 1, T 8192, H 12, d 64);
    # row 7: the tiled backward (B 32, T 1024, H 12, d 64); fp32, causal
    gen = torch.Generator(device="cuda").manual_seed(10)
    assert _split_check(1, 8192, 8192, 12, 64, True, torch.float32,
                        gen) == (1, 1)
    assert pfa._pallas_mode(8192, 8192, True) == "stream"
    assert _split_check(32, 1024, 1024, 12, 64, True, torch.float32,
                        gen) == (1, 1)
    assert pfa.reference_rows("bwd", pfa._pallas_mode(1024, 1024, True),
                              1024) == (7,)


def test_fp32_backward_repeats_bit_for_bit(card):
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, g = (torch.randn((2, 1000, 4, 64), generator=gen,
                              device="cuda") for _ in range(4))
    out, lse = pfa.flash_attn_fwd(q, k, v, causal=True, return_lse=True)
    first = pfa.flash_attn_bwd(q, k, v, out, lse, g, causal=True)
    second = pfa.flash_attn_bwd(q, k, v, out, lse, g, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_dryrun_config_compiled_step_through_the_kernels(card):
    # the reference's dryrun model (__graft_entry__.py:101-102), head dim
    # 16: one fp32 step through the kernels against the same step with the
    # plain versions swapped in (relative L2 1e-4 on the gradients)
    from unittest import mock
    from paddle_tpu_torch.models import build_spmd_train_step
    from paddle_tpu_torch.models.gpt_spmd import _leaves, _rebuild
    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=4,
                    num_heads=2, max_seq_len=32, ffn_mult=2)
    step, init_fn = build_spmd_train_step(cfg, device="cuda")
    params, opt = init_fn(0)
    rs = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rs.randint(0, 128, (4, 16))).cuda()
                   for _ in range(2))

    def one_step():
        p, o = (_rebuild(t, {k: v.clone() for k, v in _leaves(t).items()})
                for t in (params, opt))
        loss, _, o = step(p, o, ids, labels)
        return loss.item(), {k: v / 0.1 for k, v in _leaves(o["m"]).items()}

    f0, b0 = fq.FWD_LAUNCHES, fq.BWD_LAUNCHES
    loss, grads = one_step()
    assert (fq.FWD_LAUNCHES - f0, fq.BWD_LAUNCHES - b0) == (8, 4)
    with mock.patch.object(fq, "flash_qkv_fwd", fq.flash_qkv_fwd_ref), \
            mock.patch.object(fq, "flash_qkv_bwd", fq.flash_qkv_bwd_ref):
        ref_loss, ref_grads = one_step()
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, want in ref_grads.items():
        err = ((grads[name] - want).norm() / want.norm().clamp_min(1e-30))
        assert err.item() <= 1e-4, name


# -- csrc/softmax_xent_sm90.cu: the LM head's bf16 kernels on TMA and wgmma -------
# N and V past the kernel's 128-row / 256-column tile (30528 = 119 x 256 +
# 64, 520 = 2 x 256 + 8), one-chunk and ragged depths; the first labels
# are 0, V - 1, -1 and V
SM90_HEAD_SHAPES = ((1000, 768, 30528), (4096, 64, 520), (130, 40, 264),
                    (7, 8, 8), (256, 64, 512))


def _head_inputs(rs, N, D, V, dtype=torch.bfloat16):
    x = torch.from_numpy(rs.randn(N, D)).to("cuda", dtype)
    w = torch.from_numpy(rs.randn(D, V) * 0.05).to("cuda", dtype)
    lab = torch.from_numpy(rs.randint(0, V, N)).to("cuda", torch.int32)
    edge = torch.tensor([0, V - 1, -1, V], dtype=torch.int32)[:N]
    lab[:len(edge)] = edge.cuda()
    return x, w, lab


def _routes():
    return dict(sx.ROUTE_LAUNCHES)


def _moved(before):
    return {k: v - before[k] for k, v in sx.ROUTE_LAUNCHES.items()
            if v != before[k]}


def test_sm90_head_kernels_match_plain_versions(card):
    rs = np.random.RandomState(3)
    for N, D, V in SM90_HEAD_SHAPES:
        x, w, lab = _head_inputs(rs, N, D, V)
        case = (N, D, V)
        before = _routes()
        lse, at = sx.softmax_xent_fwd(x, w, lab)
        g = torch.tensor(0.37, device="cuda")
        out = sx.softmax_xent_dlogits(x, w, lab, lse, g)
        torch.cuda.synchronize()
        assert _moved(before) == {"sm90_fwd": 1, "sm90_dlogits": 1}, case
        ref_lse, ref_at = sx.softmax_xent_fwd_ref(x, w, lab)
        torch.testing.assert_close(lse, ref_lse, rtol=0,
                                   atol=HEAD_ATOL[torch.bfloat16],
                                   msg=lambda m: f"{case}: {m}")
        torch.testing.assert_close(at, ref_at, rtol=0,
                                   atol=HEAD_ATOL[torch.bfloat16],
                                   msg=lambda m: f"{case}: {m}")
        assert at[2].item() == at[3].item() == 0.0, case
        ref = sx.softmax_xent_dlogits_ref(x, w, lab, lse, g)
        assert out.dtype == torch.bfloat16 and out.shape == (N, V), case
        # each element within 1e-6·|g| plus one bf16 ulp of the plain value
        err = (out.float() - ref.float()).abs()
        assert (err <= 1e-6 * 0.37 + _bf16_ulp(ref.float())).all(), \
            (case, err.max().item())


def test_sm90_head_kernels_match_plain_versions_in_fp16(card):
    # fp16 rows TMA can describe take softmax_xent_sm90.cu, V 700 the tile
    # kernels; at g = 1/65536 (the full-width step's g/N) the label column
    # is an fp16 subnormal, which the kernel's cast keeps
    rs = np.random.RandomState(5)
    for N, D, V in SM90_HEAD_SHAPES + ((256, 64, 700),):
        x, w, lab = _head_inputs(rs, N, D, V, torch.float16)
        route = "tile" if V % 8 else "sm90"
        for g_val in (0.37, 2.0 ** -16):
            case = (N, D, V, g_val)
            before = _routes()
            lse, at = sx.softmax_xent_fwd(x, w, lab)
            g = torch.tensor(g_val, device="cuda")
            out = sx.softmax_xent_dlogits(x, w, lab, lse, g)
            torch.cuda.synchronize()
            assert _moved(before) == {f"{route}_fwd": 1,
                                      f"{route}_dlogits": 1}, case
            ref_lse, ref_at = sx.softmax_xent_fwd_ref(x, w, lab)
            torch.testing.assert_close(lse, ref_lse, rtol=0,
                                       atol=HEAD_ATOL[torch.float16],
                                       msg=lambda m: f"{case}: {m}")
            torch.testing.assert_close(at, ref_at, rtol=0,
                                       atol=HEAD_ATOL[torch.float16],
                                       msg=lambda m: f"{case}: {m}")
            ref = sx.softmax_xent_dlogits_ref(x, w, lab, lse, g)
            assert out.dtype == torch.float16 and out.shape == (N, V), case
            err = (out.float() - ref.float()).abs()
            step = torch.clamp(_bf16_ulp(ref.float()) / 8, min=2.0 ** -24)
            assert (err <= 1e-6 * g_val + step).all(), \
                (case, err.max().item())
            rows = torch.arange(N, device="cuda")[4:]
            label = out[rows, lab[4:].long()].float()
            assert bool((label < 0).all()), case


def test_sm90_head_kernels_repeat_bit_for_bit(card):
    rs = np.random.RandomState(4)
    x, w, lab = _head_inputs(rs, 4096, 768, 30528)
    first = sx.softmax_xent_fwd(x, w, lab)
    second = sx.softmax_xent_fwd(x, w, lab)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    g = torch.tensor(1.0 / 4096, device="cuda")
    assert torch.equal(sx.softmax_xent_dlogits(x, w, lab, first[0], g),
                       sx.softmax_xent_dlogits(x, w, lab, first[0], g))


def test_compiled_fp16_step_runs_on_the_sm90_kernels(card):
    from paddle_tpu_torch.models import build_spmd_train_step
    cfg = GPTConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    step, init_fn = build_spmd_train_step(cfg, compute_dtype=torch.float16,
                                          remat_policy="ctx", device="cuda")
    params, opt = init_fn(0)
    rs = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rs.randint(0, 1000, (64, 128))).cuda()
                   for _ in range(2))
    before = _routes()
    f0 = (pfa.SM90_FWD_LAUNCHES, pfa.SM90_BWD_LAUNCHES)
    loss, _, _ = step(params, opt, ids, labels)
    torch.cuda.synchronize()
    assert torch.isfinite(loss).item()
    assert _moved(before) == {"sm90_fwd": 1, "sm90_dlogits": 2}
    assert (pfa.SM90_FWD_LAUNCHES - f0[0], pfa.SM90_BWD_LAUNCHES - f0[1]) \
        == (2, 2)


@pytest.mark.parametrize("policy", ["ctx_ffn", "dots"])
def test_compiled_step_remat_policies_equal_ctx(card, policy):
    # a kept value is the result of the same launch on the same inputs,
    # and each kept value's backward makes autograd's own calls
    from paddle_tpu_torch.models import build_spmd_train_step
    from paddle_tpu_torch.models.gpt_spmd import _leaves
    cfg = GPTConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    rs = np.random.RandomState(1)
    ids, labels = (torch.from_numpy(rs.randint(0, 1000, (16, 128))).cuda()
                   for _ in range(2))
    out = {}
    for name in ("ctx", policy):
        step, init_fn = build_spmd_train_step(
            cfg, compute_dtype=torch.bfloat16, remat_policy=name,
            device="cuda")
        params, opt = init_fn(0)
        loss, params, _ = step(params, opt, ids, labels)
        out[name] = (loss, _leaves(params))
    assert torch.equal(out["ctx"][0], out[policy][0])
    for k, v in out["ctx"][1].items():
        assert torch.equal(v, out[policy][1][k]), k


def test_compiled_bf16_step_head_takes_the_sm90_route(card):
    from paddle_tpu_torch.models import build_spmd_train_step
    cfg = GPTConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    step, init_fn = build_spmd_train_step(cfg, compute_dtype=torch.bfloat16,
                                          remat_policy="ctx", device="cuda")
    params, opt = init_fn(0)
    rs = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rs.randint(0, 1000, (64, 128))).cuda()
                   for _ in range(2))
    before = _routes()
    loss, _, _ = step(params, opt, ids, labels)
    torch.cuda.synchronize()
    assert torch.isfinite(loss).item()
    # 8192 rows: one forward, two 4096-row dlogits chunks
    assert _moved(before) == {"sm90_fwd": 1, "sm90_dlogits": 2}


def test_fp32_and_misaligned_bf16_head_take_the_tile_route(card):
    rs = np.random.RandomState(5)
    for dtype, V in ((torch.float32, 512), (torch.bfloat16, 700)):
        x, w, lab = _head_inputs(rs, 256, 64, V, dtype)
        assert sx._route(x, w) == "tile"
        before = _routes()
        lse, at = sx.softmax_xent_fwd(x, w, lab)
        out = sx.softmax_xent_dlogits(x, w, lab, lse,
                                      torch.tensor(0.5, device="cuda"))
        torch.cuda.synchronize()
        assert _moved(before) == {"tile_fwd": 1, "tile_dlogits": 1}
        ref_lse, _ = sx.softmax_xent_fwd_ref(x, w, lab)
        torch.testing.assert_close(lse, ref_lse, rtol=0,
                                   atol=HEAD_ATOL[dtype])
        assert out.shape == (256, V)


def test_sm90_head_refuses_an_operand_tma_cannot_describe(card):
    N, D, V = 256, 64, 512
    flat = torch.zeros(N * D + 8, dtype=torch.bfloat16, device="cuda")
    x = flat[1:1 + N * D].view(N, D)               # base 2 bytes off
    w = torch.zeros((D, V), dtype=torch.bfloat16, device="cuda")
    lab = torch.zeros(N, dtype=torch.int32, device="cuda")
    lse = torch.empty(N, device="cuda")
    at = torch.zeros(N, device="cuda")
    out = torch.empty((N, V), dtype=torch.bfloat16, device="cuda")
    assert sx._route(x, w) == "tile"
    # on the sm90 route the encode of its tensor map refuses it: the launch
    # raises, and nothing runs on the other route
    before = _routes()
    with pytest.raises(RuntimeError, match="refused an operand"):
        sx._launch_sm90_fwd(x, w, lab, lse, at)
    with pytest.raises(RuntimeError, match="refused an operand"):
        sx._launch_sm90_dlogits(x, w, lab, lse,
                                torch.tensor(1.0, device="cuda"), out)
    assert _moved(before) == {}


# -- Model.fit and its input pipeline on the card ----------------------------
def _fit_data(n, seed=0, vocab=WIDTH["vocab_size"], T=64):
    ids = np.random.RandomState(seed).randint(0, vocab, (n, T))
    return [ids, np.roll(ids, -1, 1).reshape(n, T, 1)]


def test_prefetcher_lands_batches_on_the_card(card):
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    ds = TensorDataset(_fit_data(10))
    plain = list(DataLoader(ds, batch_size=4))
    loader = DataLoader(ds, batch_size=4, prefetch_to_device=2)
    got = list(loader)
    assert len(got) == 3 and loader._last_prefetcher.stats["produced"] == 3
    for (gi, gl), (pi, pl) in zip(got, plain):
        assert gi.is_cuda and gl.is_cuda and gi.dtype == torch.int64
        assert torch.equal(gi.cpu(), pi) and torch.equal(gl.cpu(), pl)


def test_a_batch_on_the_card_is_copied_device_to_device(card, monkeypatch):
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    model = Model(net).prepare(AdamW(1e-3, parameters=net.parameters()),
                               CrossEntropyLoss())
    ids, labels = (torch.from_numpy(a).cuda() for a in _fit_data(2))
    model.train_batch([ids], [labels])             # captures

    def refuse(*a, **k):
        raise AssertionError("a batch on the card was pinned")
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    loss = model.train_batch([ids], [labels])["loss"]
    assert loss.is_cuda and torch.isfinite(loss)


def _fit(jit=True, metric=False, prefetch=2, strict=False, epochs=2):
    """Model.fit of the WIDTH GPT from seed 0 as the fine-tuning recipe:
    (losses, parameters, the step cache's compiles per epoch start and
    at the end, attention launches of each step)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.tools.profile_train import fit_recipe
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    paddle_tpu_torch.seed(0)
    np.random.seed(0)
    model = fit_recipe(net, jit=jit, metric=metric)
    seen = dict(losses=[], compiles=[], launches=[])

    class Watch(Callback):
        def on_epoch_begin(self, epoch, logs=None):
            seen["compiles"].append(self.model._steps.compiles)
            if strict and epoch == epochs - 1:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")

        def on_train_batch_begin(self, step, logs=None):
            self.f0, self.b0 = pfa.FWD_LAUNCHES, pfa.BWD_LAUNCHES

        def on_train_batch_end(self, step, logs=None):
            seen["losses"].append(logs["loss"])
            seen["launches"].append((pfa.FWD_LAUNCHES - self.f0,
                                     pfa.BWD_LAUNCHES - self.b0))

        def on_epoch_end(self, epoch, logs=None):
            torch.cuda.set_sync_debug_mode(0)

    try:
        model.fit(TensorDataset(_fit_data(10)), batch_size=4, epochs=epochs,
                  verbose=0, prefetch_to_device=prefetch, callbacks=[Watch()])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    seen["compiles"].append(model._steps.compiles)
    return (torch.stack(seen["losses"]),
            {k: v.clone() for k, v in net.state_dict().items()},
            seen["compiles"], seen["launches"])


def test_fit_on_the_card_is_exact_captured_and_sync_free(card):
    # the warmup moves the rate every step and the clip scales every
    # gradient: a rate or a scale frozen at capture would part the captured
    # run from the uncaptured one after its first replay
    losses, state, compiles, launches = _fit(strict=True)
    L = WIDTH["num_layers"]
    assert compiles == [0, 2, 2]           # batches of 4 and 2, epoch 1 only
    assert launches == [(L, L)] * 6
    assert torch.isfinite(losses).all()
    for kw in (dict(prefetch=0), dict(jit=False), dict(metric=True)):
        other, other_state, _, _ = _fit(**kw)
        assert torch.equal(other, losses), kw
        assert all(torch.equal(v, other_state[k])
                   for k, v in state.items()), kw



# every optimizer of the port, built as chip_smoke.py phase 13a builds
# them, and LAMB under amp.decorate as phase 13b does: (AMP level,
# decorated, make(optimizer module, regularizer module, parameters))
CARD_OPTIMIZERS = {label: (amp, decorate, make)
                   for label, amp, decorate, make in chip_smoke.OPTIMIZERS}
CARD_OPTIMIZERS["Lamb decorated O2"] = ("O2", True, lambda o, r, P: o.Lamb(
    chip_smoke.LAMB_LR, chip_smoke.LAMB_WD, parameters=P))


def _optimizer_run(make, jit, amp, decorate):
    """Three train_batch steps of the GPT at WIDTH from seed 0: the
    losses and copies of every parameter, slot and master."""
    import paddle_tpu_torch
    from paddle_tpu_torch import Model, regularizer
    from paddle_tpu_torch import amp as pamp
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import CrossEntropyLoss
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    opt = make(optimizer, regularizer, net.parameters())
    if decorate:
        net, opt = pamp.decorate(net, opt, level="O2")
    model = Model(net).prepare(opt, CrossEntropyLoss(), amp_configs=amp,
                               jit=jit)
    paddle_tpu_torch.seed(2)
    rs = np.random.RandomState(0)
    losses = []
    updates = sum(mtu.LAUNCHES.values())
    for _ in range(3):
        ids = rs.randint(0, WIDTH["vocab_size"], (4, 128))
        labels = np.roll(ids, -1, 1).reshape(4, 128, 1)
        losses.append(model.train_batch([ids], [labels])["loss"])
        if decorate:
            for p in net.parameters():
                assert torch.equal(p, opt._master_weights[id(p)].to(p.dtype))
    torch.cuda.synchronize()
    updates = sum(mtu.LAUNCHES.values()) - updates
    state = {f"param {n}": p.detach().clone()
             for n, p in net.named_parameters()}
    state.update({f"slot {k}": v.clone() for k, v in
                  opt.state_dict().items() if torch.is_tensor(v)})
    state.update({f"master {n}": opt._master_weights[id(p)].clone()
                  for n, p in net.named_parameters()
                  if id(p) in opt._master_weights})
    return torch.stack(losses), state, model._steps.compiles, updates


@pytest.mark.parametrize("case", list(CARD_OPTIMIZERS))
def test_captured_optimizer_steps_equal_uncaptured(card, case):
    amp, decorate, make = CARD_OPTIMIZERS[case]
    (le, se, ce, ue), (lj, sj, cj, uj) = (
        _optimizer_run(make, jit, amp, decorate) for jit in (False, True))
    assert (ce, cj) == (0, 1)
    # every step, replays included, on the update kernel: one group
    assert (ue, uj) == (3, 3)
    assert torch.equal(le, lj), (le, lj)
    assert se.keys() == sj.keys()
    if decorate:
        assert sum(k.startswith("master") for k in sj) == len(
            [k for k in sj if k.startswith("param")])
    for k in se:
        assert torch.equal(se[k], sj[k]), k


# the fused optimizer update at small shapes: a vector body with a scalar
# tail, one element, a tensor of zeros, more than one chunk
UPDATE_NAMED = (("blocks.0.attn.qkv.weight", (64, 192)),
                ("blocks.0.attn.qkv.bias", (192,)),
                ("blocks.0.ln1.weight", (64,)), ("numel_1", (1,)),
                ("numel_3", (3,)), ("zero_1023", (1023,)),
                ("wte.weight", (1001, 67)))


def test_update_kernel_matches_plain_version(card):
    rows = chip_smoke.check_update_kernel(torch, "cuda", UPDATE_NAMED)
    assert len(rows) == len(chip_smoke.UPDATE_CHECKS) * len(
        chip_smoke.UPDATE_SETUPS)
    assert all(r["ok"] for r in rows)


@pytest.mark.parametrize("label", ["Lamb", "LarsMomentum", "AdamW"])
def test_update_kernel_repeats_bit_for_bit(card, label):
    make = dict(chip_smoke.UPDATE_CHECKS)[label]
    a, _ = chip_smoke.update_run(torch, make, UPDATE_NAMED, "fp32", "cuda",
                                 "kernel")
    b, _ = chip_smoke.update_run(torch, make, UPDATE_NAMED, "fp32", "cuda",
                                 "kernel")
    assert all(torch.equal(v, b[k]) for k, v in a.items())


def test_update_tables_are_bound_and_never_built_in_a_capture(
        card, monkeypatch):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.optimizer import fused_update
    p = torch.nn.Parameter(torch.ones(5, device="cuda"))
    opt = optimizer.Lamb(0.1, parameters=[p])
    p.grad = torch.ones(5, device="cuda")
    opt.step()
    bound = {t.data_ptr() for t in opt.bound_tensors()}
    (table,) = fused_update.tables(opt)
    assert len(table.tensors()) == 4              # recs, prefix, norm buffers
    assert {t.data_ptr() for t in table.tensors()} <= bound
    old = p.grad                                  # kept: a new address
    p.grad = torch.ones(5, device="cuda")         # a new gradient: rebuild
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="captured"):
        opt.step()
    del old


def test_a_failing_update_build_raises(card, monkeypatch):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.ops import _build

    def refuse(name):
        raise _build.BuildError(f"nvcc failed on csrc/{name}.cu")
    monkeypatch.setattr(mtu, "_lib", None)
    monkeypatch.setattr(_build, "load", refuse)
    p = torch.nn.Parameter(torch.ones(5, device="cuda"))
    opt = optimizer.SGD(0.1, parameters=[p])
    p.grad = torch.ones(5, device="cuda")
    with pytest.raises(_build.BuildError, match="multi_tensor_update"):
        opt.step()
    assert torch.equal(p.detach(), torch.ones(5, device="cuda"))


@pytest.mark.parametrize("grad", ["transposed", "bf16"])
def test_update_kernel_steps_a_staged_gradient(card, grad):
    """A gradient in another layout or type is copied into a bound buffer
    in the parameter's type; the kernel steps it as the per-leaf path
    steps the gradient itself, eager and captured."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.optimizer import fused_update
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 48, generator=gen, device="cuda")
    g = torch.randn(48, 64, generator=gen, device="cuda").t()
    g = g if grad == "transposed" else g.contiguous().bfloat16()

    def run(route, capture=False):
        p = torch.nn.Parameter(w.clone())
        if hasattr(p, "grad_dtype"):
            p.grad_dtype = None
        p.grad = g
        opt = optimizer.Adam(0.1, parameters=[("w", p)])
        with chip_smoke._update_route(route):
            opt.step()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                opt.step()
            torch.cuda.current_stream().wait_stream(side)
            if capture:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    opt.step()
                graph.replay()
            else:
                opt.step()
        torch.cuda.synchronize()
        return p.detach().clone(), opt
    got, opt = run("kernel")
    cap, _ = run("kernel", capture=True)
    want, _ = run("per_leaf")
    bufs = opt._fused_grads
    assert len(bufs) == 1
    assert {b.data_ptr() for b in bufs.values()} <= {
        t.data_ptr() for t in opt.bound_tensors()}
    assert fused_update.tables(opt)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    assert torch.equal(got, cap)


# -- fp16 (AMP in fp16 on the card) ------------------------------------------
F16 = torch.float16


def test_fp16_attention_kernels_match_plain_versions(card):
    # fp16 at every built head dim, forward with lse and backward, causal
    # and not, Tq < Tk, and raw scores past fp16's range: d 64 and 128 on
    # flash_attn_sm90, the rest on the tile kernels
    gen = torch.Generator(device="cuda").manual_seed(21)
    before = pfa.FWD_LAUNCHES, pfa.SM90_FWD_LAUNCHES, pfa.SM90_BWD_LAUNCHES
    for tq, tk in ((7, 7), (128, 128), (100, 300), (600, 600)):
        for d in pfa.HEAD_DIMS:
            for causal in (False, True):
                q, k, v, g = chip_smoke._split_operands(
                    torch, gen, "cuda", 2, tq, tk, 2, d, F16)
                sm90 = pfa.SM90_FWD_LAUNCHES, pfa.SM90_BWD_LAUNCHES
                out, lse = pfa.flash_attn_fwd(q, k, v, causal=causal,
                                              return_lse=True)
                grads = pfa.flash_attn_bwd(q, k, v, out, lse, g,
                                           causal=causal)
                want = (1, 1) if d in pfa.SM90_HEAD_DIMS else (0, 0)
                assert (pfa.SM90_FWD_LAUNCHES - sm90[0],
                        pfa.SM90_BWD_LAUNCHES - sm90[1]) == want, \
                    (tq, tk, d, causal)
                ref, ref_lse = pfa.flash_attn_fwd_ref(q, k, v, causal=causal,
                                                      return_lse=True)
                ref_g = pfa.flash_attn_bwd_ref(q, k, v, ref, ref_lse, g,
                                               causal=causal)
                torch.cuda.synchronize()
                case = (tq, tk, d, causal)
                assert out.dtype == F16, case
                torch.testing.assert_close(
                    out.float(), ref.float(), rtol=0,
                    atol=chip_smoke.ATOL["float16"],
                    msg=lambda m: f"{case} {m}")
                torch.testing.assert_close(lse, ref_lse, rtol=0,
                                           atol=chip_smoke.SPLIT_LSE_ATOL)
                for a, b in zip(grads, ref_g):
                    torch.testing.assert_close(
                        a.float(), b.float(), rtol=0,
                        atol=chip_smoke.GRAD_ATOL["float16"],
                        msg=lambda m: f"{case} {m}")
    assert pfa.FWD_LAUNCHES - before[0] == 4 * len(pfa.HEAD_DIMS) * 2
    # d 64 and 128 on flash_attn_sm90, each launch of both directions
    n_sm90 = 4 * len(pfa.SM90_HEAD_DIMS) * 2
    assert (pfa.SM90_FWD_LAUNCHES - before[1],
            pfa.SM90_BWD_LAUNCHES - before[2]) == (n_sm90, n_sm90)
    # each row also holds its route: ok needs flash_attn_sm90's launches
    rows = chip_smoke.check_fp16_range(torch, pfa, "cuda", gen)
    assert rows and all(r["ok"] and r["route"] == "sm90" for r in rows)


def test_fp16_epilogue_matches_plain_version(card):
    gen = torch.Generator(device="cuda").manual_seed(22)
    for x_dt, r_dt in chip_smoke.fused_ln_types(torch):
        if F16 not in (x_dt, r_dt):
            continue
        for D, N in ((768, 1000), (1100, 7)):
            for p_dt in (torch.float32, F16):
                x, r, b, gam, be = chip_smoke._fused_ln_operands(
                    torch, gen, "cuda", N, D, x_dt, r_dt, p_dt)
                out = fl.fused_ln(x, r, b, gam, be, 5, p=0.1, eps=1e-5)
                ref = fl.fused_ln_ref(x, r, b, gam, be, 5, p=0.1, eps=1e-5)
                err, tol, ok = chip_smoke._fused_ln_err(torch, out, ref)
                assert ok and out.dtype == x_dt, (x_dt, r_dt, D, err, tol)
                g = torch.randn((N, D), generator=gen, device="cuda").to(x_dt)
                got = fl.fused_ln_bwd(g, x, r, b, gam, be, 5, p=0.1, eps=1e-5)
                want = fl.fused_ln_bwd_ref(g, x, r, b, gam, be, 5, p=0.1,
                                           eps=1e-5)
                for a, w in zip(got, want):
                    assert a.dtype == w.dtype
                    name = chip_smoke._dtype_name(a.dtype)
                    if a.dim() == 2:
                        torch.testing.assert_close(
                            a.float(), w.float(), rtol=0,
                            atol=chip_smoke.GRAD_ATOL[name])
                    else:
                        assert chip_smoke._rel_l2(a, w) <= \
                            chip_smoke.FUSED_LN_BWD_COL_RTOL["float16"]
    x = torch.ones(2, 8, device="cuda", dtype=F16)
    with pytest.raises(TypeError, match="no pair AMP makes"):
        fl.fused_ln(x, x.bfloat16(), x[0], x[0], x[0], 0, p=0.0, eps=1e-5)


def test_unscale_kernel_matches_plain_version(card):
    rows = chip_smoke.check_unscale(torch, "cuda", list(UPDATE_NAMED))
    assert len(rows) == 3 * len(chip_smoke.UNSCALE_PLANTS)
    assert all(r["ok"] for r in rows)


def test_unscale_clears_a_set_flag_and_replays_with_its_own_flag(card):
    # the kernel writes found_inf itself (no fill launch): a flag set
    # before an eager call reads false after finite gradients, and a
    # captured call replayed with a planted inf, then without, reads true,
    # then false; the fold word is zero again after every launch
    grads = [torch.ones(1000, device="cuda"),
             torch.ones(70000, device="cuda", dtype=torch.bfloat16),
             torch.ones(33, device="cuda", dtype=torch.float16)]
    scale = torch.full((), 2.0, device="cuda")
    found = torch.ones((), dtype=torch.bool, device="cuda")
    cache = {}
    before = mtu.UNSCALE_LAUNCHES
    mtu.multi_tensor_unscale(grads, scale, found, cache)
    torch.cuda.synchronize()
    assert mtu.UNSCALE_LAUNCHES == before + 3 and not bool(found)
    assert all(bool((g == 0.5).all()) for g in grads)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mtu.multi_tensor_unscale(grads, scale, found, cache)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mtu.multi_tensor_unscale(grads, scale, found, cache)
    seen = []
    for plant in (1, None, 0, None, 2):
        for g in grads:
            g.fill_(1.0)
        if plant is not None:
            grads[plant].view(-1)[-1] = float("inf")
        graph.replay()
        torch.cuda.synchronize()
        seen.append(bool(found))
    assert seen == [True, False, True, False, True]
    assert all(int(t.fold.abs().sum()) == 0 for t in cache["tables"])


def test_unscale_matches_plain_version_at_ragged_sizes(card):
    # sizes that end mid-vector and mid-chunk, a NaN in one: bit for bit
    gen = torch.Generator(device="cuda").manual_seed(23)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        grads = [torch.randn(n, generator=gen, device="cuda").to(dtype)
                 for n in (1, 3, 40000, 2**20 + 5, 70001)]
        grads[3][12345] = float("nan")
        plain = [g.clone() for g in grads]
        found = torch.zeros((), dtype=torch.bool, device="cuda")
        found_ref = torch.zeros((), dtype=torch.bool, device="cuda")
        mtu.multi_tensor_unscale(grads, torch.full((), 8.0, device="cuda"),
                                 found)
        mtu.multi_tensor_unscale_ref(plain, torch.full((), 8.0,
                                                       device="cuda"),
                                     found_ref)
        torch.cuda.synchronize()
        assert bool(found) and bool(found_ref)
        assert all(chip_smoke._same_bits(torch, a, b)
                   for a, b in zip(grads, plain))


@pytest.mark.parametrize("x_dt,r_dt", [(BF16, BF16), (BF16, F32),
                                       (F16, F16), (F16, F32)])
def test_16bit_backward_at_the_encoders_shape(card, x_dt, r_dt):
    # the 16-bit warp path at N 16384, D 768, p 0.1: dx and dres by their
    # type's grads atol, the column sums by FUSED_LN_BWD_COL_RTOL against
    # the plain version, dx 0 wherever the forward dropped, and a second
    # call equal to the first bit for bit
    gen = torch.Generator(device="cuda").manual_seed(24)
    p_dt = x_dt if r_dt == x_dt else F32
    args = _ln_operands(gen, 16384, 768, x_dt, r_dt, p_dt) + (11,)
    got = fl.fused_ln_bwd(*args, p=0.1, eps=1e-5)
    again = fl.fused_ln_bwd(*args, p=0.1, eps=1e-5)
    want = fl.fused_ln_bwd_ref(*args, p=0.1, eps=1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    low = chip_smoke._dtype_name(x_dt)
    for a, w in zip(got[:2], want[:2]):
        assert a.dtype == w.dtype
        torch.testing.assert_close(
            a.float(), w.float(), rtol=0,
            atol=chip_smoke.GRAD_ATOL[chip_smoke._dtype_name(a.dtype)])
    for a, w in zip(got[2:], want[2:]):
        assert a.dtype == p_dt
        assert chip_smoke._rel_l2(a, w) <= \
            chip_smoke.FUSED_LN_BWD_COL_RTOL[low]
    dropped = fl.hash_uniform(11, (16384, 768), device="cuda") < \
        torch.tensor(0.1)
    assert bool((got[0][dropped] == 0).all())


def test_update_skip_flag_moves_nothing(card):
    rows = chip_smoke.check_update_skip(torch, "cuda", list(UPDATE_NAMED))
    assert len(rows) == len(chip_smoke.UPDATE_CHECKS) * len(
        chip_smoke.UPDATE_SETUPS)
    assert all(r["ok"] for r in rows)


def _fp16_run(jit, amp):
    """Three fp16 train_batch steps of the GPT at WIDTH: the losses, every
    parameter, slot and the scaler's state, the update and unscale
    launches."""
    import paddle_tpu_torch
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    opt = AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01)
    model = Model(net).prepare(opt, CrossEntropyLoss(), amp_configs=amp,
                               jit=jit)
    paddle_tpu_torch.seed(2)
    rs = np.random.RandomState(0)
    losses, found = [], []
    launches = (sum(mtu.LAUNCHES.values()), mtu.UNSCALE_LAUNCHES)
    for _ in range(3):
        ids = rs.randint(0, WIDTH["vocab_size"], (4, 128))
        labels = np.roll(ids, -1, 1).reshape(4, 128, 1)
        losses.append(model.train_batch([ids], [labels])["loss"])
        found.append(model._amp_found_inf.clone())
    torch.cuda.synchronize()
    launches = (sum(mtu.LAUNCHES.values()) - launches[0],
                mtu.UNSCALE_LAUNCHES - launches[1])
    state = chip_smoke._train_state(net, opt)
    state.update(chip_smoke._scaler_state(model))
    return torch.stack(losses), torch.stack(found), state, launches, \
        model._steps.compiles


def test_fp16_captured_steps_equal_uncaptured(card):
    (le, fe, se, ue, ce), (lj, fj, sj, uj, cj) = (
        _fp16_run(jit, dict(chip_smoke.FP16_O1)) for jit in (False, True))
    assert (ce, cj) == (0, 1)
    assert ue == uj == (3, 3)          # one update, one unscale a step
    assert torch.equal(le, lj) and torch.equal(fe, fj)
    assert not fe.any()
    assert se.keys() == sj.keys() and "scaler scale" in se
    for k in se:
        assert torch.equal(se[k], sj[k]), k


def test_fp16_overflow_in_a_replay_moves_nothing(card):
    cfg = dict(width=WIDTH, batch=4, seq=128)
    report = chip_smoke.fp16_overflow(torch, pfa, "cuda", cfg)
    assert report["ok"]
    assert [r["found_inf"] for r in report["steps"]] == [True, False, True,
                                                         False]
