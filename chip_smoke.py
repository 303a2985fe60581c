#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, each of which fails the run (non-zero exit, no result line):

1. card     name and power limit, torch and CUDA versions; exit 1 with no
            card, or with no ``paddle_tpu_torch/`` beside this script
2. build    nvcc builds every kernel source in paddle_tpu_torch/csrc;
            each kernel's registers and spills (-Xptxas -v)
3. kernels  each kernel against its plain PyTorch version on the card,
            at every shape the serving, scoring and train paths give it
            and around them (packed attention T 100 ... 2048 at every
            built head dim, d 16/32/64/80/96/128, and T 4096 at d 64; bf16
            at d 64/128 on flash_attn_sm90, also with sharp inputs;
            split-layout forward with lse and backward T 128 ... 8192 and
            Tq < Tk, every built head dim; the fp32 kernels and the plain
            fp32 versions against float64, causal, T 1024 ... 8192; LM
            head forward and dlogits up to N 4096, V 30528, on both
            routes (bf16 on softmax_xent_sm90.cu, fp32 and bf16 V 700 on
            the tile kernels), N and V past the sm90 tile, labels 0,
            V - 1, -1 and V; the fused epilogue at D 64 ... 12800, N 1
            ... 16384, p 0 / 0.1 / 0.5, x and residual of one type or
            mixed (fp32 and bf16), and its dropout mask against the hash
            bit for bit; the epilogue's backward kernel at D 64 ... 4096
            (and 12800), N 1 ... 16384, the same types and p: dx, dres by
            their type's grads atol, the column sums in fp32 against a
            float64 run of the plain backward, dx exactly 0 where the
            forward dropped)
4. scoring  the full-width GPT (V 30528, D 768, L 12, H 12) scores
            (8, 512) through the kernel: 12 launches, logits against the
            same model with the plain attention swapped in
5. serving  GenerationEngine (8 slots, 64 new tokens, warmup=True: every
            prompt bucket's prefill and the decode step captured in a
            CUDA graph, 7 + 1 of them, before the clients start) answers
            16 requests from 4 client threads by replays (12 launches a
            prefill, counted through the replays; no capture while
            serving); every stream equals its solo-session stream, a
            second run repeats every stream exactly, and every bucket's
            replay, out of capture order, and the decode's equal a direct
            call of the same step on the same inputs, tokens and caches
            bit for bit; capture ms, the graphs' pools, tokens/s, decode
            ms/step and TTFT p50 and p99
6. timing   kernel, plain and library times with CUDA events beside the
            card's bound, at the serving and train paths' shapes (every
            fp32 attention row: 1 at bh 96, T 512; 3 and 4 at B 32, T 512;
            3 and 5 at B 8, T 1024; 2 and 6-9 at T 512, 1024 and 8192;
            each with its fp32 bound and its 3xTF32 bound, and the names
            of the kernels SDPA runs there, from a torch.profiler trace;
            the head's forward at N 65536 and dlogits at one chunk; the
            fused epilogue and its backward at the encoder's N 16384,
            D 768, p 0.1 and 0), each kernel's result held against its
            plain version there too; rows 3, 4, 10, 11, 12, the
            epilogue's backward and SDPA also in device time
            (torch.profiler), with the share of the bound
7. train    the flagship train step at full width (B 128, T 512, bf16,
            remat "ctx"): one step through the kernels (12 + 12 attention
            launches, all of them flash_attn_sm90's, the fused head's
            forward and 16 dlogits launches, all softmax_xent_sm90's)
            against the
            same step with the plain versions swapped in; two runs of two
            steps repeat bit for bit; the loss falls over 12 steps on one
            batch; step ms, seq/s, MFU and peak memory
8. train    T 1024 at reduced depth (L 2, B 8, fp32, remat "full"): one
   long     step through the kernels (2 dlogits launches, the head on
            the tile kernels) against the
            plain versions; the same for the reference's dryrun model
            (V 128, hidden 32, 2 heads: head dim 16, L 4, B 4, T 16)
9. eager    Model(GPT).prepare(AdamW, CrossEntropyLoss).train_batch at
            full width (B 32, T 512, fp32): one step through the kernels
            (12 + 12 launches, mode "small", row 6) against the plain
            versions; 3 steps with jit=True (captured in a CUDA graph,
            replayed) against jit=False from the same state and seeds, bit
            for bit, and a second captured run repeating bit for bit, with
            12 + 12 launches counted in a replay; the loss falls over 12
            steps of each engine; step ms, seq/s, peak memory of both.
            Then the same under AMP O1 in bf16 (prepare(amp_configs="O1"):
            12 + 12 attention launches, all flash_attn_sm90's; against the
            plain versions at the compiled bf16 step's tolerances, loss
            rtol 1e-3, grads 5e-2 relative L2), and O2 (fp32 masters) at
            L 2
10. eager   the same at L 2: T 1024, B 8 (row 7) and T 8192, B 1 (rows 2,
    long    8 and 9), each one step through the kernels against the plain
            versions, with the launches per mode
11. encoder 12 post-LN FusedTransformerEncoderLayer(768, 12, 3072,
            dropout 0.1, gelu, no attention dropout) between token and
            position embeddings (V 30528, 512 positions) and an untied
            head: Model.predict_batch on (8, 512) (24 fused-epilogue and
            12 attention launches, logits against the plain versions);
            Model.train_batch at B 32, T 512, fp32: one step through the
            kernels (24 + 24 epilogue launches, forward and backward,
            12 + 12 attention launches, non-causal) against the plain
            versions with the same seeds; captured against uncaptured
            steps and two captured runs as in phase 9, and two captured
            steps at learning rate 0 on one batch that differ (new dropout
            masks and epilogue seeds at every replay); the loss falls over
            12 steps of each engine; step ms, seq/s, peak memory.  Then
            the same under AMP O1 (the epilogue on bf16 x and an fp32 or
            bf16 residual, attention on flash_attn_sm90) and O2 at L 2, as
            in phase 9

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  With ``--json PATH`` everything
measured is also written to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32
# work is bounded by the fp32 rate outside the tensor cores (its type's
# peak, the `bound_ms` of the kernels line); the fp32 attention kernels
# run it on the tensor cores in split precision, three tf32 products per
# fp32 product, whose bound (`bound_3xtf32_ms`, in the log and the
# report's timing sections, not in the kernels line) is 3 x flops at the
# tf32 rate; bf16 kernels run on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32X3_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12

GPT_WIDTH = dict(vocab_size=30528, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=512)
# every prompt bucket (8 ... 256) the serving path hands the kernel, the
# scoring shape (512, 512), ragged and one-token edges, a longer key axis
KERNEL_SHAPES = [(1, 1), (7, 7), (8, 8), (16, 16), (32, 32), (64, 64),
                 (100, 100), (128, 128), (128, 256), (256, 256), (512, 512),
                 (1024, 1024)]
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_pallas_kernels.py
# bf16 with a sharp softmax: q, k ~ 2·N(0, 1) and v ~ N(0, 1), so the
# output spreads over several units and a flattened softmax (every row
# near v's mean) misses it by more than 1.  Held to two bf16 ulps of the
# output: |err| <= 1.6e-2 + 1.6e-2·|ref|.  The reference rounds p to bf16
# before its product, the kernel does not, so the two differ by about an
# ulp where |out| > 2
SHARP_SHAPES = [(32, 32), (512, 512)]
SHARP_TOL, SHARP_MIN_STD = 1.6e-2, 0.5
SCORING_ATOL = 1e-3
SLOTS, NEW_TOKENS, CLIENTS, REQUESTS, SAMPLED = 8, 64, 4, 16, 4

# packed attention (rows 3/4/5): every length from 128 to 2048 and one
# ragged one, each head dim, causal and not, fp32 and bf16; T 4096 at d 64,
# past the reference's packed kernels, which the port's take
QKV_TS = (100, 128, 256, 512, 1024, 2048)
QKV_LONG = ((4096, 64),)
GRAD_ATOL = {"float32": 5e-5, "bfloat16": 5e-2}  # test_pallas_kernels.py
LSE_ATOL = 1e-4
# bf16 packed attention with sharp inputs (q, k ~ 2·N(0, 1), v and the
# output gradient ~ N(0, 1)), where torch.rand's flat softmax would hide a
# wrongly rescaled output: the forward is held to SHARP_TOL per element
# (as row 1's sharp checks), dq, dk and dv each to a relative L2 error of
# SHARP_GRAD_RTOL.  A per-element bound does not fit them: both versions
# round P and dS = P (dP - delta) to bf16, the kernel with delta =
# rowsum(dO * O) from the bf16 output and the plain version with
# rowsum(P * dP) in fp32, and dP - delta cancels, so an element that is a
# sum of large terms of both signs differs by several of its ulps.  The
# relative L2 error this leaves is about 0.5% (up to 1% at T 7); a wrong
# rescale or a dropped tile gives errors of order 1.  The output's spread
# is reported but not held to row 1's SHARP_MIN_STD: without a mask each
# row averages more keys as T grows, and at T 2048 its std is 0.48.
SHARP_QKV = [(T, d) for T in (100, 512, 2048) for d in (64, 128)] + [
    (4096, 64)]
SHARP_GRAD_RTOL = 2e-2
# LM head (rows 10 and 11): lse and at from exact products of the inputs
# summed in fp32 by both versions, in another order; bf16 logits here
# reach ~10, where fp32 sums of 768 terms differ in their last bits.  bf16
# takes csrc/softmax_xent_sm90.cu where D and V are multiples of 8 (V 700
# stays on the tile kernels, as does fp32); the last three shapes are the
# sm90 route's edges: N past a multiple of its 128-row tile, V past a
# multiple of its 256-column tile (30528 = 119 x 256 + 64, 520 = 2 x 256 +
# 8), a one-chunk depth and a ragged one.  The first four labels of every
# case are 0, V - 1, -1 and V (the last two select nothing: at 0, no
# column of dlogits loses 1)
HEAD_SHAPES = ((256, 64, 512), (256, 64, 700), (4096, 768, 30528),
               (1000, 768, 30528), (4096, 64, 520), (130, 40, 264))
HEAD_ATOL = {"float32": 1e-5, "bfloat16": 1e-4}

# the train path (bench.py:119-124): BERT-base GPT, B 128, T 512, bf16
TRAIN = dict(width=dict(vocab_size=30528, hidden_size=768, num_layers=12,
                        num_heads=12, max_seq_len=512),
             batch=128, seq=512, dtype="bfloat16", remat="ctx")
# rows 3 and 4 in fp32 (the tile kernels' packed path, T <= 512): the
# compiled step's width at B 32, fp32; timed only
TRAIN_FP32 = dict(width=dict(vocab_size=30528, hidden_size=768,
                             num_layers=12, num_heads=12, max_seq_len=512),
                  batch=32, seq=512, dtype="float32", remat="full")
# the reference's dryrun model (__graft_entry__.py:101-102): hidden 32
# over 2 heads, head dim 16 (fault C4), B 4, T 16, fp32
DRYRUN = dict(width=dict(vocab_size=128, hidden_size=32, num_layers=4,
                         num_heads=2, max_seq_len=32, ffn_mult=2),
              batch=4, seq=16, dtype="float32", remat="full")
# row 5's regime (512 < T <= 2048) at reduced depth, fp32
TRAIN_LONG = dict(width=dict(vocab_size=30528, hidden_size=768,
                             num_layers=2, num_heads=12, max_seq_len=1024),
                  batch=8, seq=1024, dtype="float32", remat="full")
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
# phases 9 and 11: steps of Model.train_batch with jit=True (captured in a
# CUDA graph) against jit=False, on the batch rolled by 0, 1, 2 rows
JIT_STEPS = 3

# split-layout attention (rows 1, 2, 6-9): every mode's lengths, a ragged
# one and Tq < Tk; forward with lse and backward on (B, S, H, D) operands
SPLIT_SHAPES = [(t, t) for t in (128, 256, 512, 1000, 1024, 2048, 4096,
                                 8192)] + [(128, 256), (640, 1280)]
SPLIT_LSE_ATOL = 1e-5                            # test_pallas_kernels.py:288
# the fp32 kernels and the plain fp32 versions against float64: causal,
# where each key's dK and dV sum over up to T queries
FP64_SHAPES = ((1024, 64), (4096, 128), (8192, 64))
# (batch, length) of the split-layout timing: rows 6, 7 and 2/8/9 at the
# eager train path's shapes (H 12, d 64, fp32, causal)
SPLIT_TIMING = ((32, 512), (32, 1024), (1, 8192))
# the eager train path (Model.train_batch): the serving width at T 512
EAGER = dict(width=GPT_WIDTH, batch=32, seq=512)
EAGER_LONG = (dict(width=dict(GPT_WIDTH, num_layers=2, max_seq_len=1024),
                   batch=8, seq=1024),
              dict(width=dict(GPT_WIDTH, num_layers=2, max_seq_len=8192),
                   batch=1, seq=8192))
# fp32 on both sides: the kernels and the plain versions sum in another
# order, carried through 12 blocks
EAGER_LOSS_RTOL, EAGER_GRAD_RTOL = 1e-4, 1e-4
# kernels against plain versions over one bf16 step: each attention
# output and the head's statistics differ in bf16 roundings, carried
# through 12 blocks
TRAIN_LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-4}
TRAIN_GRAD_RTOL = {"bfloat16": 5e-2, "float32": 1e-4}   # relative L2
TRAIN_GRADS = ("blocks.qkv_w", "head_w", "wte")
ADAM_B1 = 0.9

# the fused epilogue (row 12): the warp path (D <= 1024, 16-byte and
# one-value loads) and the block path with the row in shared memory (up to
# D 12288, GPT-3's width) and recomputed (D 12800), one row to the
# encoder's 16384 rows
FUSED_LN_DS = (64, 100, 768, 1024, 4096, 12288, 12800)
FUSED_LN_NS = (1, 7, 1000, 16384)
FUSED_LN_PS = (0.0, 0.1, 0.5)
FUSED_LN_SEEDS = (0, 1, 2**31 - 2, 0xFFFFFFFF)
# fp32: both sum the same fp32 values in another order; bf16: both round
# fp32 values that differ by up to that atol, so the outputs may differ by
# the atol plus one bf16 ulp of the output (an output near 0 comes from a
# cancellation of gamma·ẑ against beta, where the fp32 difference is
# larger than the output's ulp)
FUSED_LN_ATOL = 1e-5
# the epilogue's backward (fused_ln_bwd.cu): the warp path at D 64 ... 1024
# and the block path at D 1100 and 4096 (z in shared memory) and 12800
# (recomputed), N 1 ... 16384; dx and dres by GRAD_ATOL of their type;
# the column sums (N rows summed in another order) in fp32 at relative L2
# 1e-5 against a float64 run of the plain backward, in bf16 at 5e-2
# against the plain version
FUSED_LN_BWD_SHAPES = tuple((D, N) for D in (64, 100, 768, 1024, 1100, 4096)
                            for N in (1, 7, 1000, 16384)) + ((12800, 7),)
FUSED_LN_BWD_COL_RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
# the head's dlogits (row 11): fp32 atol 1e-5 (tests/test_pallas_kernels.py
# :322); bf16 each element within 1e-6·|g| plus one bf16 ulp of the plain
# value (both round fp32 values whose products summed in another order; at
# the label p - 1 cancels).  A typical element, |g|/V, is 30 times that
# atol at V 30528, so a wrong softmax term fails
DLOGITS_G, DLOGITS_ATOL, DLOGITS_BF16_ATOL_PER_G = 2.0, 1e-5, 1e-6
# the encoder path (phase 11): profile_train.ENCODER, BERT-base
# (bert-base-uncased) at the flagship vocabulary (bench.py:1027-1029),
# built by profile_train.build_encoder
ENCODER_SCORE_BATCH, ENCODER_BATCH = 8, 32          # T = max_len, 512
# phases 9 and 11 under AMP: O1 at full width, O2 at this depth
AMP_O2_LAYERS = 2


def log(msg: str = ""):
    print(msg, flush=True)


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def pct(values, q):
    import numpy as np
    return float(np.percentile(np.asarray(values, float), q))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 2 -------------------------------------------------------------------
def ptxas_summary(report: str):
    """Each kernel of one ``nvcc -Xptxas -v`` report: a short name (the
    kernel and its integer template arguments), registers, spill bytes."""
    out, name, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"([a-z_]*kernel[a-z0-9_]*)", m.group(1))
            args = re.findall(r"Li(\d+)E", m.group(1))
            if "bfloat16" in m.group(1):
                args.insert(0, "bf16")
            elif re.search(r"I(?:K)?fLi", m.group(1)):
                args.insert(0, "fp32")
            name = (k.group(1) if k else m.group(1)) + (
                f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(dict(kernel=name, registers=int(m.group(1)),
                            spill_stores=spill[0], spill_loads=spill[1]))
            name, spill = None, (0, 0)
    return out


# -- phase 3 -------------------------------------------------------------------
def check_kernels(torch, fa, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(96, tq, tk, 64, causal, dtype)
             for tq, tk in KERNEL_SHAPES for causal in (False, True)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(96, 128, 128, d, True, dtype) for d in fa.HEAD_DIMS
              if d != 64 for dtype in (torch.float32, torch.bfloat16)]
    cases = [c + ("rand",) for c in cases] + [
        (96, tq, tk, 64, causal, torch.bfloat16, "sharp")
        for tq, tk in SHARP_SHAPES for causal in (False, True)]
    results = []
    for bh, tq, tk, d, causal, dtype, inputs in cases:
        if inputs == "rand":
            q, k, v = (torch.rand((bh, t, d), generator=gen, device=dev)
                       .to(dtype) for t in (tq, tk, tk))
        else:
            q, k, v = (torch.randn((bh, t, d), generator=gen, device=dev)
                       .mul(s).to(dtype)
                       for t, s in ((tq, 2.0), (tk, 2.0), (tk, 1.0)))
        out = fa.flash_attn_fwd(q, k, v, causal=causal)
        ref = fa.flash_attention_ref(q, k, v, causal=causal)
        sync(torch, dev)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        name = str(dtype).replace("torch.", "")
        ok = out.dtype == dtype and out.shape == q.shape
        if inputs == "rand":
            tol = f"atol={ATOL[name]:.0e}"
            ok = ok and err <= ATOL[name]
        else:
            spread = ref.float().std().item()
            worst = (diff / (SHARP_TOL + SHARP_TOL * ref.float().abs())
                     ).max().item()
            tol = (f"err/({SHARP_TOL:.1e}+{SHARP_TOL:.1e}|ref|)={worst:.3f} "
                   f"ref_std={spread:.3f}")
            ok = ok and worst <= 1.0 and spread >= SHARP_MIN_STD
        results.append(dict(bh=bh, tq=tq, tk=tk, d=d, causal=causal,
                            dtype=name, inputs=inputs, max_abs_err=err,
                            tolerance=tol, ok=ok))
        log(f"  flash_attn_fwd bh={bh} tq={tq} tk={tk} d={d} "
            f"causal={int(causal)} {name:8s} {inputs:5s} "
            f"max_abs_err={err:.3e} {tol} {'ok' if ok else 'FAIL'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel checks disagree with the "
                             f"plain version: {bad}")
    return results


def _qkv_case(torch, fq, gen, dev, T, d, causal, dtype, inputs):
    """One packed-attention check: forward, lse and dqkv of the kernels
    against the plain versions on (2, T, 3·H·d) inputs."""
    H = 12 if d == 64 else 4
    if inputs == "rand":
        qkv = torch.rand((2, T, 3 * H * d), generator=gen, device=dev)
        g = torch.rand((2, T, H * d), generator=gen, device=dev)
    else:
        qkv = torch.randn((2, T, 3, H * d), generator=gen, device=dev)
        qkv[:, :, :2] *= 2.0
        qkv = qkv.reshape(2, T, 3 * H * d)
        g = torch.randn((2, T, H * d), generator=gen, device=dev)
    qkv, g = qkv.to(dtype), g.to(dtype)
    out, lse = fq.flash_qkv_fwd(qkv, H, causal=causal)
    dqkv = fq.flash_qkv_bwd(qkv, out, lse, g, H, causal=causal)
    ref, ref_lse = fq.flash_qkv_fwd_ref(qkv, H, causal=causal)
    ref_d = fq.flash_qkv_bwd_ref(qkv, ref, ref_lse, g, H, causal=causal)
    sync(torch, dev)
    name = str(dtype).replace("torch.", "")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    err_d = (dqkv.float() - ref_d.float()).abs().max().item()
    ok = (out.dtype == dtype and dqkv.shape == qkv.shape
          and err_lse <= LSE_ATOL)
    r = dict(b=2, t=T, h=H, d=d, causal=causal, dtype=name, inputs=inputs,
             max_abs_err=err, max_abs_err_lse=err_lse,
             max_abs_err_dqkv=err_d)
    if inputs == "rand":
        ok = ok and err <= ATOL[name] and err_d <= GRAD_ATOL[name]
        tol = (f"out atol {ATOL[name]:.0e}, lse atol {LSE_ATOL:.0e}, dqkv "
               f"atol {GRAD_ATOL[name]:.0e}")
    else:
        worst = (diff / (SHARP_TOL + SHARP_TOL * ref.float().abs())
                 ).max().item()
        spread = ref.float().std().item()
        rel = {}
        for i, part in enumerate(("dq", "dk", "dv")):
            a = dqkv.view(2, T, 3, -1)[:, :, i].float()
            b = ref_d.view(2, T, 3, -1)[:, :, i].float()
            rel[part] = ((a - b).norm() / b.norm()).item()
        ok = (ok and worst <= 1.0
              and all(v <= SHARP_GRAD_RTOL for v in rel.values()))
        r.update(out_err_over_tol=worst, ref_std=spread, dqkv_rel_l2=rel)
        tol = (f"out err/({SHARP_TOL:.1e}+{SHARP_TOL:.1e}|ref|) "
               f"{worst:.3f} (ref std {spread:.2f}), lse atol "
               f"{LSE_ATOL:.0e}, dq/dk/dv rel L2 "
               f"{'/'.join(f'{v:.1e}' for v in rel.values())} (limit "
               f"{SHARP_GRAD_RTOL:.0e})")
    r.update(tolerance=tol, ok=ok)
    log(f"  flash_qkv T={T:4d} H={H:2d} d={d:3d} causal={int(causal)} "
        f"{name:8s} {inputs:5s} out {err:.2e} lse {err_lse:.2e} dqkv "
        f"{err_d:.2e}; {tol} {'ok' if ok else 'FAIL'}")
    return r


def check_qkv_kernels(torch, fq, dev):
    """Rows 3/4/5: forward, lse and dqkv against the plain versions; bf16
    at d 64 and 128 runs on flash_attn_sm90, the rest on the tile
    kernels."""
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = [(T, d) for T in QKV_TS for d in fq.HEAD_DIMS] + list(QKV_LONG)
    cases = [(T, d, causal, dtype, "rand") for T, d in shapes
             for causal in (False, True)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(T, d, causal, torch.bfloat16, "sharp") for T, d in SHARP_QKV
              for causal in (False, True)]
    results = [_qkv_case(torch, fq, gen, dev, *c) for c in cases]
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} packed-attention checks disagree "
                             f"with the plain versions: {bad}")
    return results


def _head_labels(torch, rs, N, V, dev, dtype=None):
    """Labels for a head check: random, the first four 0, V - 1, -1, V."""
    lab = torch.from_numpy(rs.randint(0, V, N))
    edge = torch.tensor([0, V - 1, -1, V])[:N]
    lab[:len(edge)] = edge
    return lab.to(dev, dtype)


def _routed(sx, x, w, before, kind):
    """The route (:func:`softmax_xent._route`) a head launch took, checked
    against the route counters: exactly one launch on it, none elsewhere
    (a CPU tensor's plain version is not checked)."""
    route = sx._route(x, w)
    moved = {k: v - before[k] for k, v in sx.ROUTE_LAUNCHES.items()}
    want = {k: int(k == f"{route}_{kind}") for k in moved}
    return route, moved == want or not x.is_cuda


def check_head_kernel(torch, sx, dev):
    """Row 10 on both routes: lse and at against the plain version."""
    import numpy as np
    rs = np.random.RandomState(4)
    results = []
    for N, D, V in HEAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rs.randn(N, D).astype(np.float32)).to(
                dev, dtype)
            w = torch.from_numpy((rs.randn(D, V) * 0.05).astype(
                np.float32)).to(dev, dtype)
            lab = _head_labels(torch, rs, N, V, dev)
            before = dict(sx.ROUTE_LAUNCHES)
            lse, at = sx.softmax_xent_fwd(x, w, lab)
            route, counted = _routed(sx, x, w, before, "fwd")
            ref_lse, ref_at = sx.softmax_xent_fwd_ref(x, w, lab)
            sync(torch, dev)
            name = str(dtype).replace("torch.", "")
            err = max((lse - ref_lse).abs().max().item(),
                      (at - ref_at).abs().max().item())
            ok = err <= HEAD_ATOL[name] and counted
            results.append(dict(n=N, d=D, v=V, dtype=name, route=route,
                                max_abs_err=err, atol=HEAD_ATOL[name],
                                ok=ok))
            log(f"  softmax_xent_fwd N={N} D={D} V={V} {name:8s} "
                f"{route:5s} lse/at max_abs_err={err:.3e} (atol "
                f"{HEAD_ATOL[name]:.0e}) {'ok' if ok else 'FAIL'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} LM-head checks disagree with the "
                             f"plain version: {bad}")
    return results


def _split_operands(torch, gen, dev, B, tq, tk, H, d, dtype):
    """q, k, v, dout: head views of one packed projection when tq == tk
    (the eager GPT's layout), else separate (B, S, H, D) tensors."""
    if tq == tk:
        q, k, v = torch.rand((B, tq, 3, H, d), generator=gen,
                             device=dev).to(dtype).unbind(2)
    else:
        q, k, v = (torch.rand((B, t, H, d), generator=gen, device=dev)
                   .to(dtype) for t in (tq, tk, tk))
    g = torch.rand((B, tq, H, d), generator=gen, device=dev).to(dtype)
    return q, k, v, g


def check_split_kernels(torch, fa, dev):
    """Rows 1, 2 and 6-9: the forward with lse and the backward on
    (B, S, H, D) operands against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(6)
    results = []
    for tq, tk in SPLIT_SHAPES:
        B, H = (2, 2) if max(tq, tk) <= 2048 else (1, 2)
        for d in fa.HEAD_DIMS:
            for causal in (False, True):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v, g = _split_operands(torch, gen, dev, B, tq, tk,
                                                 H, d, dtype)
                    out, lse = fa.flash_attn_fwd(q, k, v, causal=causal,
                                                 return_lse=True)
                    grads = fa.flash_attn_bwd(q, k, v, out, lse, g,
                                              causal=causal)
                    ref, ref_lse = fa.flash_attn_fwd_ref(
                        q, k, v, causal=causal, return_lse=True)
                    ref_g = fa.flash_attn_bwd_ref(q, k, v, ref, ref_lse, g,
                                                  causal=causal)
                    sync(torch, dev)
                    name = str(dtype).replace("torch.", "")
                    err = (out.float() - ref.float()).abs().max().item()
                    err_lse = (lse - ref_lse).abs().max().item()
                    err_g = max((a.float() - b.float()).abs().max().item()
                                for a, b in zip(grads, ref_g))
                    mode = fa._pallas_mode(tq, tk, causal)
                    rows = (fa.reference_rows("fwd", mode, tk)
                            + fa.reference_rows("bwd", mode, tk))
                    ok = (out.dtype == dtype and out.shape == q.shape
                          and all(a.shape == x.shape for a, x in
                                  zip(grads, (q, k, v)))
                          and err <= ATOL[name] and err_lse <= SPLIT_LSE_ATOL
                          and err_g <= GRAD_ATOL[name])
                    results.append(dict(b=B, tq=tq, tk=tk, h=H, d=d,
                                        causal=causal, dtype=name, mode=mode,
                                        rows=rows, max_abs_err=err,
                                        max_abs_err_lse=err_lse,
                                        max_abs_err_grads=err_g, ok=ok))
                    log(f"  flash_attn tq={tq:4d} tk={tk:4d} d={d:3d} "
                        f"causal={int(causal)} {name:8s} {mode:6s} rows "
                        f"{rows} out {err:.2e} (atol {ATOL[name]:.0e}) lse "
                        f"{err_lse:.2e} (atol {SPLIT_LSE_ATOL:.0e}) dq/dk/dv "
                        f"{err_g:.2e} (atol {GRAD_ATOL[name]:.0e}) "
                        f"{'ok' if ok else 'FAIL'}")
                    del q, k, v, g, out, lse, grads, ref, ref_lse, ref_g
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} split-layout attention checks "
                             f"disagree with the plain versions: {bad}")
    return results


def _attention_fp64(torch, fa, q, k, v, do, causal):
    """out, lse and (dq, dk, dv) of (B, S, H, D) operands in float64,
    folded to (B*H, S, D): the truth both fp32 versions are held to."""
    q, k, v, do = (fa._fold(x).double() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = q @ k.transpose(1, 2) * scale
    if causal:
        s = s.masked_fill(~fa._visible(s.shape[-2], s.shape[-1], s.device),
                          float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = p @ v
    ds = p * (do @ v.transpose(1, 2) - (do * out).sum(-1, keepdim=True))
    return out, lse, (ds @ k * scale, ds.transpose(1, 2) @ q * scale,
                      p.transpose(1, 2) @ do)


def check_fp64_truth(torch, fa, dev):
    """The fp32 kernels (split-precision TF32) and the plain fp32 versions
    (full fp32 products), each against float64 on the same causal inputs:
    the kernel is held to the fp32 tolerances against the truth; the plain
    version's own error is reported beside it."""
    gen = torch.Generator(device=dev).manual_seed(12)
    results = []
    for T, d in FP64_SHAPES:
        q, k, v = torch.rand((1, T, 3, 2, d), generator=gen,
                             device=dev).unbind(2)
        g = torch.rand((1, T, 2, d), generator=gen, device=dev)
        out, lse = fa.flash_attn_fwd(q, k, v, causal=True, return_lse=True)
        grads = fa.flash_attn_bwd(q, k, v, out, lse, g, causal=True)
        p_out, p_lse = fa.flash_attn_fwd_ref(q, k, v, causal=True,
                                             return_lse=True)
        p_grads = fa.flash_attn_bwd_ref(q, k, v, p_out, p_lse, g,
                                        causal=True)
        t_out, t_lse, t_grads = _attention_fp64(torch, fa, q, k, v, g, True)
        sync(torch, dev)

        def errs(o, l, gs):
            e = dict(out=(fa._fold(o).double() - t_out).abs().max().item(),
                     lse=(l.reshape(t_lse.shape).double() - t_lse).abs()
                     .max().item())
            for name, a, b in zip(("dq", "dk", "dv"), gs, t_grads):
                e[name] = (fa._fold(a).double() - b).abs().max().item()
            return e

        kern, plain = errs(out, lse, grads), errs(p_out, p_lse, p_grads)
        ok = (kern["out"] <= ATOL["float32"] and kern["lse"] <= SPLIT_LSE_ATOL
              and max(kern[n] for n in ("dq", "dk", "dv"))
              <= GRAD_ATOL["float32"])
        results.append(dict(b=1, t=T, h=2, d=d, causal=True, kernel=kern,
                            plain=plain, ok=ok))
        log(f"  fp64 truth T={T} d={d} causal: kernel "
            f"{', '.join(f'{n} {v:.2e}' for n, v in kern.items())}; plain "
            f"fp32 {', '.join(f'{n} {v:.2e}' for n, v in plain.items())} "
            f"{'ok' if ok else 'FAIL'}")
        del q, k, v, g, out, lse, grads, p_out, p_lse, p_grads, t_out, \
            t_lse, t_grads
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} fp32 kernel results miss the fp32 "
                             f"tolerances against float64: {bad}")
    return results


def _bf16_ulp(torch, t):
    """One bf16 ulp of each value of the fp32 tensor ``t``."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(1e-30))) - 7)


def _fused_ln_err(torch, out, ref):
    """The epilogue forward's agreement with its plain version: (max abs
    error, limit text, ok) under the fp32 atol, or in bf16 each element
    within that atol plus one bf16 ulp of the plain value."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if out.dtype == torch.float32:
        return err, f"atol {FUSED_LN_ATOL:.0e}", err <= FUSED_LN_ATOL
    ulps = ((diff - FUSED_LN_ATOL).clamp_min(0.0)
            / _bf16_ulp(torch, ref.float())).max().item()
    return err, f"atol {FUSED_LN_ATOL:.0e} + {ulps:.2f} bf16 ulp (limit 1)", \
        ulps <= 1.0


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _fused_ln_operands(torch, gen, dev, N, D, x_dt, r_dt, p_dt):
    x = torch.randn((N, D), generator=gen, device=dev).to(x_dt)
    r = torch.randn((N, D), generator=gen, device=dev).to(r_dt)
    b, be = (torch.randn(D, generator=gen, device=dev).to(p_dt)
             for _ in range(2))
    g = (1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(p_dt)
    return x, r, b, g, be


def fused_ln_types(torch):
    """(x, residual) type pairs the epilogue's kernels take."""
    f32, bf16 = torch.float32, torch.bfloat16
    return ((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16))


def check_fused_ln(torch, fl, dev):
    """Row 12: the fused epilogue against its plain version, every D, N,
    pair of x and residual types (the same, and each mixed with the
    other, fault C6), p, the seeds in turn, bias/gamma/beta in x's type
    or fp32."""
    gen = torch.Generator(device=dev).manual_seed(8)
    results = []
    i = 0
    for D in FUSED_LN_DS:
        for N in FUSED_LN_NS:
            for x_dt, r_dt in fused_ln_types(torch):
                for p in FUSED_LN_PS:
                    seed = FUSED_LN_SEEDS[i % len(FUSED_LN_SEEDS)]
                    pdt = x_dt if i % 2 else torch.float32
                    i += 1
                    x, r, b, g, be = _fused_ln_operands(
                        torch, gen, dev, N, D, x_dt, r_dt, pdt)
                    out = fl.fused_ln(x, r, b, g, be, seed, p=p, eps=1e-5)
                    ref = fl.fused_ln_ref(x, r, b, g, be, seed, p=p,
                                          eps=1e-5)
                    sync(torch, dev)
                    err, tol, ok = _fused_ln_err(torch, out, ref)
                    ok = ok and out.dtype == x_dt and out.shape == x.shape
                    results.append(dict(
                        n=N, d=D, dtype=_dtype_name(x_dt),
                        residual_dtype=_dtype_name(r_dt), p=p, seed=seed,
                        param_dtype=_dtype_name(pdt), max_abs_err=err,
                        tolerance=tol, ok=ok))
                    log(f"  fused_ln N={N:5d} D={D:5d} x "
                        f"{_dtype_name(x_dt):8s} residual "
                        f"{_dtype_name(r_dt):8s} p={p:.1f} seed={seed:10d} "
                        f"params {results[-1]['param_dtype']:8s} "
                        f"max_abs_err={err:.2e} {tol} "
                        f"{'ok' if ok else 'FAIL'}")
                    del x, r, out, ref
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} fused-epilogue checks disagree "
                             f"with the plain version: {bad}")
    return results


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()
            .clamp_min(1e-300)).item()


def check_fused_ln_bwd(torch, fl, dev):
    """The epilogue's backward kernel against its plain version, every D,
    N, type pair and p, the seeds in turn, parameters in x's type or fp32:
    dx and dres by the atol of their type; dbias, dgamma, dbeta in fp32 at
    relative L2 against a float64 run of the plain backward, in bf16
    against the plain version; dx exactly 0 exactly where the forward
    dropped."""
    gen = torch.Generator(device=dev).manual_seed(12)
    results = []
    i = 0
    for D, N in FUSED_LN_BWD_SHAPES:
        for x_dt, r_dt in fused_ln_types(torch):
            for p in FUSED_LN_PS:
                seed = FUSED_LN_SEEDS[i % len(FUSED_LN_SEEDS)]
                pdt = x_dt if i % 2 else torch.float32
                i += 1
                x, r, b, gam, be = _fused_ln_operands(
                    torch, gen, dev, N, D, x_dt, r_dt, pdt)
                g = torch.randn((N, D), generator=gen, device=dev).to(x_dt)
                args = (g, x, r, b, gam, be, seed)
                before = fl.BWD_LAUNCHES
                got = fl.fused_ln_bwd(*args, p=p, eps=1e-5)
                sync(torch, dev)
                counted = fl.BWD_LAUNCHES == before + 1
                ref = fl.fused_ln_bwd_ref(*args, p=p, eps=1e-5)
                errs, ok = {}, counted
                for name, a, w in zip(("dx", "dres"), got, ref):
                    errs[name] = (a.float() - w.float()).abs().max().item()
                    ok = ok and a.dtype == w.dtype and a.shape == w.shape \
                        and errs[name] <= GRAD_ATOL[_dtype_name(a.dtype)]
                if x_dt == torch.float32 and r_dt == torch.float32:
                    truth = fl.fused_ln_bwd_ref(
                        *(t.double() for t in args[:6]), seed, p=p,
                        eps=1e-5)[2:]
                    col_tol = FUSED_LN_BWD_COL_RTOL["float32"]
                    col_vs = "float64"
                else:
                    truth, col_tol = ref[2:], FUSED_LN_BWD_COL_RTOL[
                        "bfloat16"]
                    col_vs = "plain"
                for name, a, w in zip(("dbias", "dgamma", "dbeta"), got[2:],
                                      truth):
                    errs[name] = _rel_l2(a, w)
                    ok = ok and a.dtype == pdt and errs[name] <= col_tol
                dropped = fl.hash_uniform(seed, (N, D), device=dev) < \
                    torch.tensor(p, dtype=torch.float32) if p > 0 else \
                    torch.zeros((N, D), dtype=torch.bool, device=dev)
                zero_where_dropped = bool(torch.equal(got[0] == 0, dropped))
                separate = got[0].data_ptr() != got[1].data_ptr()
                ok = ok and zero_where_dropped and separate
                results.append(dict(
                    n=N, d=D, dtype=_dtype_name(x_dt),
                    residual_dtype=_dtype_name(r_dt), p=p, seed=seed,
                    param_dtype=_dtype_name(pdt), errors=errs,
                    max_abs_err=max(errs["dx"], errs["dres"]),
                    columns_against=col_vs, columns_rel_l2_limit=col_tol,
                    dx_zero_exactly_where_dropped=zero_where_dropped,
                    counted=counted, ok=ok))
                log(f"  fused_ln_bwd N={N:5d} D={D:5d} x "
                    f"{_dtype_name(x_dt):8s} residual {_dtype_name(r_dt):8s}"
                    f" p={p:.1f} params {_dtype_name(pdt):8s}: dx "
                    f"{errs['dx']:.2e} dres {errs['dres']:.2e} (atol by "
                    f"type: fp32 {GRAD_ATOL['float32']:.0e}, bf16 "
                    f"{GRAD_ATOL['bfloat16']:.0e}); rel L2 vs {col_vs} dbias "
                    f"{errs['dbias']:.1e} dgamma {errs['dgamma']:.1e} dbeta "
                    f"{errs['dbeta']:.1e} (limit {col_tol:.0e}); dx == 0 "
                    f"exactly where dropped: {zero_where_dropped} "
                    f"{'ok' if ok else 'FAIL'}")
                del x, r, g, got, ref, truth, dropped
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} fused-epilogue backward checks "
                             f"disagree with the plain version: {bad}")
    return results


def check_fused_ln_mask(torch, fl, dev, N=4096, D=768):
    """Row 12's dropout mask bit for bit: with x = 1, residual = bias =
    beta = 0 and gamma = 1 an output is positive exactly where the element
    was kept, which must be where the plain hash is >= p."""
    one = torch.ones((N, D), device=dev)
    zero = torch.zeros((N, D), device=dev)
    results = []
    for p in (0.1, 0.5):
        for seed in FUSED_LN_SEEDS:
            out = fl.fused_ln(one, zero, zero[0], one[0], zero[0], seed, p=p,
                              eps=1e-5)
            keep = fl.hash_uniform(seed, (N, D), device=dev) >= \
                torch.tensor(p, dtype=torch.float32)
            signed = bool((out != 0).all().item())
            same = bool(torch.equal(out > 0, keep))
            kept = keep.float().mean().item()
            results.append(dict(n=N, d=D, p=p, seed=seed, kept_share=kept,
                                every_sign_defined=signed, equal=same,
                                ok=same and signed))
            log(f"  fused_ln mask N={N} D={D} p={p:.1f} seed={seed:10d}: "
                f"kept {kept:.4f}, signs equal to the hash's keep bits: "
                f"{same} {'ok' if same and signed else 'FAIL'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"the kernel's dropout mask differs from the "
                             f"hash: {bad}")
    return results


def _dlogits_err(torch, out, ref, g):
    """Row 11's agreement with its plain version: (max_abs_err, limit
    text, ok) under the fp32 atol, or in bf16 each element's error against
    1e-6·|g| plus one bf16 ulp of the plain value."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if out.dtype == torch.float32:
        return err, f"atol {DLOGITS_ATOL:.0e}", err <= DLOGITS_ATOL
    atol = DLOGITS_BF16_ATOL_PER_G * abs(float(g))
    ulps = ((diff - atol).clamp_min(0.0)
            / _bf16_ulp(torch, ref.float())).max().item()
    return err, f"atol {atol:.1e} + {ulps:.2f} bf16 ulp (limit 1)", \
        ulps <= 1.0


def check_dlogits(torch, sx, dev):
    """Row 11 on both routes: the head's dlogits against the plain
    version."""
    import numpy as np
    rs = np.random.RandomState(9)
    results = []
    for N, D, V in HEAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rs.randn(N, D).astype(np.float32)).to(
                dev, dtype)
            w = torch.from_numpy((rs.randn(D, V) * 0.05).astype(
                np.float32)).to(dev, dtype)
            lab = _head_labels(torch, rs, N, V, dev, torch.int32)
            lse, _ = sx.softmax_xent_fwd_ref(x, w, lab)
            g = torch.tensor(DLOGITS_G, device=dev)
            before = dict(sx.ROUTE_LAUNCHES)
            out = sx.softmax_xent_dlogits(x, w, lab, lse, g)
            route, counted = _routed(sx, x, w, before, "dlogits")
            ref = sx.softmax_xent_dlogits_ref(x, w, lab, lse, g)
            sync(torch, dev)
            name = str(dtype).replace("torch.", "")
            err, tol, ok = _dlogits_err(torch, out, ref, DLOGITS_G)
            ok = ok and out.dtype == dtype and out.shape == (N, V) \
                and counted
            results.append(dict(n=N, d=D, v=V, dtype=name, route=route,
                                g=DLOGITS_G, max_abs_err=err, tolerance=tol,
                                ok=ok))
            log(f"  softmax_xent_dlogits N={N} D={D} V={V} {name:8s} "
                f"{route:5s} max_abs_err={err:.3e} ({tol}) "
                f"{'ok' if ok else 'FAIL'}")
            del x, w, out, ref
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} dlogits checks disagree with the "
                             f"plain version: {bad}")
    return results


# -- phase 4 -------------------------------------------------------------------
def scoring(torch, fa, net, batch=8):
    cfg, dev = net.cfg, net.device
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                        generator=gen, device=dev)
    with torch.inference_mode():
        net(ids)                                      # warm-up
        sync(torch, dev)
        fa.FWD_LAUNCHES = 0
        t0 = time.perf_counter()
        logits = net(ids)
        sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = fa.FWD_LAUNCHES
        with mock.patch.object(fa, "flash_attn_fwd", fa.flash_attn_fwd_ref):
            t0 = time.perf_counter()
            plain = net(ids)
            sync(torch, dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
    err = (logits - plain).abs().max().item()
    finite = bool(torch.isfinite(logits).all().item())
    shape = tuple(logits.shape)
    log(f"  logits {shape} finite={finite} max_abs_err_vs_plain={err:.3e} "
        f"(atol {SCORING_ATOL:.0e}) launches={launches} "
        f"forward_ms={ms:.3f} plain_forward_ms={plain_ms:.3f}")
    if shape != (batch, cfg.max_seq_len, cfg.vocab_size) or not finite:
        raise AssertionError("scoring logits have the wrong shape or are "
                             "not finite")
    if launches != cfg.num_layers:
        raise AssertionError(f"scoring launched the kernel {launches} "
                             f"times, expected {cfg.num_layers}")
    if err > SCORING_ATOL:
        raise AssertionError(f"scoring logits differ from the plain path "
                             f"by {err} > {SCORING_ATOL}")
    return dict(launches=launches, max_abs_err=err, atol=SCORING_ATOL,
                forward_ms=ms, plain_forward_ms=plain_ms)


# -- phase 5 -------------------------------------------------------------------
def make_requests(vocab):
    """16 prompts of 4-32 tokens; the last 4 sample (T 0.8, top_p 0.95)."""
    import numpy as np
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(REQUESTS):
        prompt = rng.randint(1, vocab, rng.randint(4, 33)).astype(np.int32)
        kw = dict(do_sample=False)
        if i >= REQUESTS - SAMPLED:
            kw = dict(do_sample=True, temperature=0.8, top_p=0.95,
                      seed=1000 + i)
        reqs.append((prompt, kw))
    return reqs


def run_engine(torch, fa, net, reqs):
    """Serve ``reqs`` from CLIENTS threads (each submits its share, then
    waits) through an engine built with ``warmup=True`` (every prefill
    bucket and the decode step captured before the clients start); returns
    the streams, the engine's counts and step times, and its executable
    cache's."""
    import gc
    from paddle_tpu_torch.serving import (GenerationEngine,
                                          GenerationEngineConfig)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    engine = GenerationEngine(net, GenerationEngineConfig(
        max_slots=SLOTS, max_new_tokens=NEW_TOKENS, warmup=True))
    warmup_s = time.perf_counter() - t0
    pool = torch.cuda.memory_reserved() - reserved
    results, ttft, errors = [None] * len(reqs), [None] * len(reqs), []

    def client(c):
        try:
            mine = list(range(c, len(reqs), CLIENTS))
            streams = [engine.submit(reqs[i][0], max_new_tokens=NEW_TOKENS,
                                     **reqs[i][1]) for i in mine]
            for i, s in zip(mine, streams):
                results[i] = s.result(timeout=600)
                ttft[i] = s.ttft_s
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    cache = engine.session._cache
    try:
        hits0, compiles0 = cache.hits, cache.compiles
        fa.FWD_LAUNCHES = 0
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = fa.FWD_LAUNCHES
    finally:
        engine.close()
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("a client thread did not finish")
    sess = engine.session
    entries = cache.entries()
    return dict(results=results, ttft=ttft, wall_s=wall, launches=launches,
                prefill_steps=sess.steps["prefill"],
                decode_steps=sess.steps["decode"],
                prefill_ms=list(sess.step_ms["prefill"]),
                decode_ms=list(sess.step_ms["decode"]),
                stats=engine.stats(), warmed_buckets=engine.warmed_buckets,
                warmup_s=warmup_s, construction_reserved_bytes=pool,
                capture_ms={k[0]: e.capture_ms for k, e in entries.items()},
                graph_pool_bytes={k[0]: e.pool_bytes
                                  for k, e in entries.items()},
                captured=_all_captured(entries.values()),
                hits=cache.hits - hits0, compiles=cache.compiles - compiles0,
                warmup_compiles=compiles0)


def _all_captured(entries) -> bool:
    """Whether an executable cache's entries are all captured graphs."""
    entries = list(entries)
    return bool(entries) and all(e.graph is not None for e in entries)


def check_replays(torch, net, seed=5):
    """Every prefill bucket, replayed out of capture order, and the decode
    step against a direct call of the same step function on the same
    inputs (uncaptured): the tokens and every cache buffer bit for bit."""
    import numpy as np
    from paddle_tpu_torch.generation import GenerationSession
    from paddle_tpu_torch.generation import session as psession
    from paddle_tpu_torch.serving import seq_buckets
    S, V = SLOTS, net.cfg.vocab_size
    sess = GenerationSession(net, batch_capacity=S)
    caches = sess.init_caches()
    rs = np.random.RandomState(seed)
    buckets = seq_buckets(sess.max_length, sess.prompt_bucket_min)
    knobs = (rs.randint(0, 2**31, S).astype(np.int64),
             np.where(np.arange(S) % 2 == 1, 0.8, 0.0).astype(np.float32),
             np.where(np.arange(S) % 4 == 1, 40, 0).astype(np.int32),
             np.where(np.arange(S) % 4 == 3, 0.9, 1.0).astype(np.float32))

    def prefill_values(P, mask):
        return (rs.randint(1, V, (S, P)).astype(np.int32),
                rs.randint(1, P + 1, S).astype(np.int32), mask) + knobs

    def snapshot():
        return [(c.k.clone(), c.v.clone()) for c in caches]

    def direct(fn, types, values):
        net.eval()
        with torch.inference_mode():
            tok = fn(*[torch.as_tensor(np.asarray(v)).to(net.device, t)
                       for v, t in zip(values, types)])
        return tok.cpu().numpy().astype(np.int32)

    def compare(name, run, fn, types, values):
        before = snapshot()
        tok, _ = run(caches, *values)
        replayed = snapshot()
        for c, (k, v) in zip(caches, before):
            c.k.copy_(k)
            c.v.copy_(v)
        want = direct(fn, types, values)
        same = bool(np.array_equal(tok, want)) and all(
            torch.equal(c.k, k) and torch.equal(c.v, v)
            for c, (k, v) in zip(caches, replayed))
        return dict(step=name, equal=same)

    for P in buckets:                        # captured in bucket order
        sess.prefill(caches, *prefill_values(P, np.ones(S, bool)))
    order = list(np.random.RandomState(seed).permutation(buckets))
    partial = np.arange(S) % 3 != 1
    rows = [compare(f"prefill:{P}", sess.prefill, sess._make_prefill(int(P)),
                    psession._PREFILL_TYPES,
                    prefill_values(int(P), partial)) for P in order]
    positions = rs.randint(4, 200, S).astype(np.int32)
    for i in range(2):
        values = (rs.randint(1, V, S).astype(np.int32), positions + i) + knobs
        rows.append(compare("decode", sess.decode, sess._make_decode(),
                            psession._DECODE_TYPES, values))
    equal = sum(r["equal"] for r in rows)
    log(f"  replays against direct calls, buckets in the order "
        f"{[int(P) for P in order]} then 2 decodes: {equal}/{len(rows)} "
        f"bit for bit (tokens and caches); cache compiles "
        f"{sess._cache.compiles}, hits {sess._cache.hits}")
    if equal != len(rows):
        raise AssertionError(f"replayed steps differ from direct calls: "
                             f"{[r['step'] for r in rows if not r['equal']]}")
    return dict(order=[int(P) for P in order], steps=rows,
                compiles=sess._cache.compiles, hits=sess._cache.hits)


def serving(torch, fa, net):
    import gc
    import numpy as np
    from paddle_tpu_torch.generation import GenerationSession
    from paddle_tpu_torch.serving import seq_buckets
    reqs = make_requests(net.cfg.vocab_size)
    first = run_engine(torch, fa, net, reqs)
    answered = sum(r is not None and len(r) > 0 for r in first["results"])
    tokens = sum(len(r) for r in first["results"] if r is not None)
    groups = first["prefill_steps"]
    want_buckets = len(seq_buckets(net.cfg.max_seq_len, 8)) + 1
    log(f"  warmup: {first['warmed_buckets']} steps captured (the bound, "
        f"{want_buckets}: every prompt bucket and decode) in "
        f"{first['warmup_s']:.3f} s; capture ms "
        f"{ {k: round(v, 3) for k, v in first['capture_ms'].items()} }; "
        f"the graphs' pools reserve "
        f"{sum(first['graph_pool_bytes'].values()) / 2**30:.3f} GiB "
        f"({first['graph_pool_bytes']}); the engine's construction "
        f"(KV caches, warm-up steps, graphs) "
        f"{first['construction_reserved_bytes'] / 2**30:.3f} GiB")
    log(f"  requests answered {answered}/{REQUESTS}, tokens {tokens}, "
        f"wall {first['wall_s']:.3f} s, tokens/s "
        f"{tokens / first['wall_s']:.1f}")
    log(f"  prefill groups {groups}, kernel launches {first['launches']} "
        f"(replays), decode steps {first['decode_steps']}; executable "
        f"cache while serving: hits {first['hits']}, compiles "
        f"{first['compiles']}")
    log(f"  prefill ms p50 {pct(first['prefill_ms'], 50):.3f}; decode "
        f"ms/step p50 {pct(first['decode_ms'], 50):.3f} p99 "
        f"{pct(first['decode_ms'], 99):.3f}; ttft ms p50 "
        f"{pct(first['ttft'], 50) * 1e3:.3f} p99 "
        f"{pct(first['ttft'], 99) * 1e3:.3f}")
    if answered != REQUESTS:
        raise AssertionError(f"only {answered} of {REQUESTS} requests "
                             "answered")
    if first["warmed_buckets"] != want_buckets or not first["captured"]:
        raise AssertionError(f"warmup left {first['warmed_buckets']} steps "
                             f"(captured: {first['captured']}); expected "
                             f"{want_buckets} captured")
    if first["compiles"] or first["hits"] != groups + first["decode_steps"]:
        raise AssertionError(f"serving compiled {first['compiles']} steps "
                             f"and hit {first['hits']}; expected 0 and "
                             f"{groups + first['decode_steps']}")
    if first["launches"] != net.cfg.num_layers * groups:
        raise AssertionError(
            f"{first['launches']} kernel launches over {groups} prefill "
            f"groups; expected {net.cfg.num_layers} per group")

    # the engine's contract: each stream equals generate() run alone
    solo = GenerationSession(net, batch_capacity=SLOTS)
    differ = [i for i, (prompt, kw) in enumerate(reqs)
              if not np.array_equal(
                  solo.generate([prompt], max_new_tokens=NEW_TOKENS,
                                **kw)[0], first["results"][i])]
    log(f"  streams equal to their solo-session streams: "
        f"{REQUESTS - len(differ)}/{REQUESTS}")
    if differ:
        raise AssertionError(f"engine streams {differ} differ from their "
                             "solo-session streams")
    del solo

    second = run_engine(torch, fa, net, reqs)
    changed = [i for i in range(REQUESTS) if not np.array_equal(
        first["results"][i], second["results"][i])]
    log(f"  a second engine run repeats {REQUESTS - len(changed)}/"
        f"{REQUESTS} streams ({SAMPLED} of them sampled); tokens/s "
        f"{tokens / second['wall_s']:.1f}, decode ms/step p50 "
        f"{pct(second['decode_ms'], 50):.3f}")
    if changed:
        raise AssertionError(f"streams {changed} changed between two runs "
                             "with the same seeds")
    replays = check_replays(torch, net)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(requests=REQUESTS, answered=answered, tokens=tokens,
                wall_s=first["wall_s"], tokens_per_s=tokens / first["wall_s"],
                prefill_groups=groups, decode_steps=first["decode_steps"],
                launches=first["launches"],
                prefill_ms_p50=pct(first["prefill_ms"], 50),
                decode_ms_p50=pct(first["decode_ms"], 50),
                decode_ms_p99=pct(first["decode_ms"], 99),
                ttft_ms_p50=pct(first["ttft"], 50) * 1e3,
                ttft_ms_p99=pct(first["ttft"], 99) * 1e3,
                stats=first["stats"], warmed_buckets=first["warmed_buckets"],
                warmup_s=first["warmup_s"], capture_ms=first["capture_ms"],
                graph_pool_bytes=first["graph_pool_bytes"],
                construction_reserved_bytes=first[
                    "construction_reserved_bytes"],
                cache_hits=first["hits"], cache_compiles=first["compiles"],
                warmup_compiles=first["warmup_compiles"],
                second_run=dict(wall_s=second["wall_s"],
                                tokens_per_s=tokens / second["wall_s"],
                                decode_ms_p50=pct(second["decode_ms"], 50),
                                decode_ms_p99=pct(second["decode_ms"], 99),
                                ttft_ms_p50=pct(second["ttft"], 50) * 1e3),
                replays=replays)


# -- phase 6 -------------------------------------------------------------------
def time_ms(torch, fn, reps=25, warmup=3):
    """Median device time of one ``fn()`` over ``reps`` timed launches."""
    import numpy as np
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(flops, nbytes, flops_per_s):
    """Least time for the work on an H100: the larger of the operations
    over the peak rate for their type and the bytes (each input read
    once, each output written once) over the memory rate."""
    t_ops = flops / flops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_3xtf32(flops, nbytes):
    """The fp32 attention kernels' own bound: three tf32 products per fp32
    product at the tf32 rate, or the bytes."""
    return bound(3 * flops, nbytes, 3 * TF32X3_FLOPS_PER_S)[0]


def library_kernels(torch, fn):
    """The CUDA kernels one ``fn()`` launches and the device ms of each (a
    torch.profiler trace), longest first: which kernels
    F.scaled_dot_product_attention picks, and its backward kernel's time
    apart from its forward's."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:120]
            ms[name] = ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return [dict(name=n, device_ms=t)
            for n, t in sorted(ms.items(), key=lambda kv: -kv[1])]


def kernels_line(kernels):
    """library_kernels' result, short, for the log."""
    return "; ".join(f"{k['name'][:70]} {k['device_ms']:.4f} ms"
                     for k in kernels)


def timing(torch, fa):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    bh, d = 96, 64
    for T in (32, 128, 512):
        q, k, v = (torch.rand((bh, T, d), generator=gen, device="cuda")
                   for _ in range(3))
        with torch.inference_mode():
            ms = time_ms(torch, lambda: fa.flash_attn_fwd(
                q, k, v, causal=True))
            plain = time_ms(torch, lambda: fa.flash_attention_ref(
                q, k, v, causal=True))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
        flops, nbytes = 2.0 * bh * T * T * d, 4.0 * bh * d * 4 * T
        b_ms, b_by = bound(flops, nbytes, FP32_FLOPS_PER_S)
        rows.append(dict(bh=bh, t=T, d=d, dtype="float32", causal=True,
                         ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_3xtf32_ms=bound_3xtf32(flops, nbytes)))
        log(f"  T={T:4d} bh={bh} d={d} fp32 causal: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, F.scaled_dot_product_attention "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; fp32 67 TFLOP/s, "
            f"3.35 TB/s), 3xTF32 bound {rows[-1]['bound_3xtf32_ms']:.4f} ms")
    rows[-1]["library_kernels"] = library_kernels(
        torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True))
    log(f"  SDPA's kernels at T 512: "
        f"{kernels_line(rows[-1]['library_kernels'])}")
    return rows


def timing_train_kernels(torch, fq, sx, cfg, dev="cuda", head=True):
    """Rows 3, 4/5 and (with ``head``) 10 at the shapes of the train
    config ``cfg``, each also held against its plain version there."""
    import torch.nn.functional as F
    w = cfg["width"]
    B, T, H = cfg["batch"], cfg["seq"], w["num_heads"]
    D, V = w["hidden_size"], w["vocab_size"]
    d, N = D // H, B * T
    dt = getattr(torch, cfg["dtype"])
    name = cfg["dtype"]
    gen = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn((B, T, 3 * D), generator=gen, device=dev).to(dt)
    g = torch.randn((B, T, D), generator=gen, device=dev).to(dt)
    rows = {}
    with torch.no_grad():
        out, lse = fq.flash_qkv_fwd(qkv, H, causal=True)
        dqkv = fq.flash_qkv_bwd(qkv, out, lse, g, H, causal=True)
        ref, ref_lse = fq.flash_qkv_fwd_ref(qkv, H, causal=True)
        ref_d = fq.flash_qkv_bwd_ref(qkv, ref, ref_lse, g, H, causal=True)
        err = (out.float() - ref.float()).abs().max().item()
        err_d = (dqkv.float() - ref_d.float()).abs().max().item()
        del ref, ref_lse, ref_d
        fwd_ms = time_ms(torch, lambda: fq.flash_qkv_fwd(qkv, H,
                                                         causal=True))
        fwd_plain = time_ms(torch, lambda: fq.flash_qkv_fwd_ref(
            qkv, H, causal=True), reps=5)
        bwd_ms = time_ms(torch, lambda: fq.flash_qkv_bwd(
            qkv, out, lse, g, H, causal=True))
        bwd_plain = time_ms(torch, lambda: fq.flash_qkv_bwd_ref(
            qkv, out, lse, g, H, causal=True), reps=5)
        q, k, v = qkv.view(B, T, 3, H, d).permute(2, 0, 3, 1, 4)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    go = g.view(B, T, H, d).permute(0, 2, 1, 3)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), go)

    lib_fb = time_ms(torch, sdpa_fwd_bwd)
    # device time alone (torch.profiler): CUDA events around one call also
    # count the host's time to issue it when the card waits for it
    from paddle_tpu_torch.tools.profile_train import device_ms_per_call
    with torch.no_grad():
        dev_fwd = device_ms_per_call(lambda: fq.flash_qkv_fwd(
            qkv, H, causal=True))
        dev_bwd = device_ms_per_call(lambda: fq.flash_qkv_bwd(
            qkv, out, lse, g, H, causal=True))
        dev_lib_fwd = device_ms_per_call(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    dev_lib_fb = device_ms_per_call(sdpa_fwd_bwd)
    with torch.no_grad():
        lib_names_fwd = library_kernels(
            torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True))
    lib_names_fb = library_kernels(torch, sdpa_fwd_bwd)
    half = 2.0 * B * H * T * T * d / 2      # one causal T x T x d product
    el = qkv.element_size()
    f_bytes = el * B * T * 4 * D + 4.0 * B * H * T
    b_bytes = el * B * T * (3 * D + 2 * D + 3 * D) + 4.0 * B * H * T
    rows["flash_qkv_fwd"] = dict(
        ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib_fwd,
        library="F.scaled_dot_product_attention forward on split "
                "(B, H, T, d) views",
        max_abs_err=err, atol=ATOL[name],
        shape=f"B {B}, T {T}, H {H}, d {d}, {name}, causal",
        flops=2 * half, bytes=f_bytes, device_ms=dev_fwd,
        library_device_ms=dev_lib_fwd, library_kernels=lib_names_fwd)
    rows["flash_qkv_bwd"] = dict(
        ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib_fb,
        library="F.scaled_dot_product_attention forward + backward on "
                "split views (compare with fwd_plus_bwd_ms)",
        fwd_plus_bwd_ms=fwd_ms + bwd_ms, max_abs_err=err_d,
        atol=GRAD_ATOL[name], shape=rows["flash_qkv_fwd"]["shape"],
        flops=5 * half, bytes=b_bytes, device_ms=dev_bwd,
        fwd_plus_bwd_device_ms=dev_fwd + dev_bwd,
        library_device_ms=dev_lib_fb, library_kernels=lib_names_fb)
    del qkv, g, out, lse, dqkv, q, k, v, qg, kg, vg, go
    rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S
    if head:
        rows["softmax_xent_fwd"] = _time_head(torch, sx, gen, dev, dt, N, D,
                                              V)
    for key, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["bytes"], rate)
        if dt == torch.float32 and key != "softmax_xent_fwd":
            r["bound_3xtf32_ms"] = bound_3xtf32(r["flops"], r["bytes"])
        ok = r["max_abs_err"] <= r["atol"]
        r["ok"] = ok
        extra = (f", fwd+bwd {r['fwd_plus_bwd_ms']:.4f} ms"
                 if "fwd_plus_bwd_ms" in r else "")
        extra += (f", torch.matmul(x, w) alone {r['matmul_ms']:.4f} ms"
                  if "matmul_ms" in r else "")
        extra += (f"; device time (torch.profiler) kernel "
                  f"{r['device_ms']:.4f} ms" if "device_ms" in r else "")
        extra += (f", library {r['library_device_ms']:.4f} ms"
                  if "library_device_ms" in r else "")
        if "route" in r:
            r["share_of_bound"] = r["bound_ms"] / r["device_ms"]
            extra += (f"; route {r['route']}, {r['share_of_bound']:.1%} of "
                      f"the bound in device time")
        extra += (f", 3xTF32 bound {r['bound_3xtf32_ms']:.4f} ms"
                  if "bound_3xtf32_ms" in r else "")
        extra += (f"; library kernels {kernels_line(r['library_kernels'])}"
                  if "library_kernels" in r else "")
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        log(f"  {key} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}{extra}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{rate / 1e12:.0f} TFLOP/s, 3.35 TB/s); max_abs_err vs plain "
            f"{r['max_abs_err']:.3e} (atol {r['atol']:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"{bad} disagree with their plain versions at "
                             "the train path's shapes")
    return rows


def _time_head(torch, sx, gen, dev, dt, N, D, V):
    """Row 10 at the train path's shape: CUDA events and device time (both
    launches: the tiles and, on the sm90 route, the fold of their
    partials), its route, the plain version and ``torch.matmul(x, w)``
    alone (the product without the softmax, writing the logits)."""
    from paddle_tpu_torch.tools.profile_train import device_ms_per_call
    name = str(dt).replace("torch.", "")
    el = torch.empty((), dtype=dt).element_size()
    x = (torch.randn((N, D), generator=gen, device=dev)).to(dt)
    hw = (torch.randn((D, V), generator=gen, device=dev) * 0.01).to(dt)
    lab = torch.randint(0, V, (N,), generator=gen, device=dev)
    with torch.no_grad():
        lse, at = sx.softmax_xent_fwd(x, hw, lab)
        ref_lse, ref_at = sx.softmax_xent_fwd_ref(x, hw, lab)
        err = max((lse - ref_lse).abs().max().item(),
                  (at - ref_at).abs().max().item())
        del ref_lse, ref_at
        ms = time_ms(torch, lambda: sx.softmax_xent_fwd(x, hw, lab))
        dev_ms = device_ms_per_call(lambda: sx.softmax_xent_fwd(x, hw, lab))
        plain = time_ms(torch, lambda: sx.softmax_xent_fwd_ref(x, hw, lab),
                        reps=5)
        mm = time_ms(torch, lambda: torch.matmul(x, hw), reps=10)
    return dict(
        ms=ms, device_ms=dev_ms, route=sx._route(x, hw), plain_ms=plain,
        library_ms=None,
        library="none (no single PyTorch call computes lse and the label "
                "logit)", matmul_ms=mm, max_abs_err=err,
        atol=HEAD_ATOL[name], shape=f"N {N}, D {D}, V {V}, {name}",
        flops=2.0 * N * D * V,
        bytes=el * (N * D + D * V) + 4.0 * N + 8.0 * N)


def timing_split_kernels(torch, fa, dev="cuda", shapes=SPLIT_TIMING):
    """Rows 2, 6, 7, 8 and 9 at the eager train path's shapes (H 12, d 64,
    fp32, causal, head views of one packed projection), each result also
    held against its plain version there.  The streaming rows 8 and 9 are
    the backward's passes timed apart: delta + dQ, and dK/dV."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(7)
    H, d = 12, 64
    rows = {}
    for B, T in shapes:
        qkv = torch.randn((B, T, 3, H, d), generator=gen, device=dev)
        q, k, v = qkv.unbind(2)
        g = torch.randn((B, T, H, d), generator=gen, device=dev)
        with torch.no_grad():
            out, lse = fa.flash_attn_fwd(q, k, v, causal=True,
                                         return_lse=True)
            grads = fa.flash_attn_bwd(q, k, v, out, lse, g, causal=True)
            ref, ref_lse = fa.flash_attn_fwd_ref(q, k, v, causal=True,
                                                 return_lse=True)
            ref_g = fa.flash_attn_bwd_ref(q, k, v, ref, ref_lse, g,
                                          causal=True)
            err_f = max((out - ref).abs().max().item(),
                        (lse - ref_lse).abs().max().item())
            err_b = max((a - b).abs().max().item()
                        for a, b in zip(grads, ref_g))
            del ref, ref_lse, ref_g, grads
            fwd_ms = time_ms(torch, lambda: fa.flash_attn_fwd(
                q, k, v, causal=True, return_lse=True))
            fwd_plain = time_ms(torch, lambda: fa.flash_attn_fwd_ref(
                q, k, v, causal=True, return_lse=True), reps=5)
            bwd_ms = time_ms(torch, lambda: fa.flash_attn_bwd(
                q, k, v, out, lse, g, causal=True))
            bwd_plain = time_ms(torch, lambda: fa.flash_attn_bwd_ref(
                q, k, v, out, lse, g, causal=True), reps=5)
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            delta = torch.empty((B, H, T), device=dev)

            def passes(mask):
                fa._launch_bwd(q, k, v, out, lse, g, dq, dk, dv, delta, True,
                               None, passes=mask)

            passes(fa.ALL_PASSES)
            dq_ms = time_ms(torch, lambda: passes(fa.PASS_DELTA | fa.PASS_DQ))
            dkv_ms = time_ms(torch, lambda: passes(fa.PASS_DKV))
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True))
        qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))
        gh = g.transpose(1, 2)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            torch.autograd.grad(o, (qg, kg, vg), gh)

        lib_fb = time_ms(torch, sdpa_fwd_bwd)
        with torch.no_grad():
            names_fwd = library_kernels(
                torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True))
        names_fb = library_kernels(torch, sdpa_fwd_bwd)
        n_el = 4.0 * B * T * H * d            # bytes of one operand, fp32
        stats = 4.0 * B * H * T               # bytes of lse (or delta)
        # flops of one causal T x T x d product (half of 2*T*T*d): the
        # forward needs 2 (S, PV), the backward 5 (S, dP, dV, dQ, dK); the
        # dQ pass runs 3 of them, the dK/dV pass 4
        prod = 1.0 * B * H * T * T * d
        shape = f"B {B}, T {T}, H {H}, d {d}, fp32, causal"
        lib_note = "F.scaled_dot_product_attention forward + backward on " \
                   "(B, H, T, d) views"
        common = dict(shape=shape, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                      max_abs_err_fwd=err_f, max_abs_err_bwd=err_b,
                      library_fwd_ms=lib_fwd, library_kernels=names_fb,
                      library_fwd_kernels=names_fwd)
        mode = fa._pallas_mode(T, T, True)
        if mode == "stream":
            rows[2] = dict(common, kernel="flash_attn_fwd (with lse)",
                           ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib_fwd,
                           library="F.scaled_dot_product_attention forward "
                                   "on (B, H, T, d) views",
                           max_abs_err=err_f, atol=SPLIT_LSE_ATOL,
                           flops=2 * prod, bytes=4 * n_el + stats)
            # plain: the whole plain backward (no plain version of one pass)
            rows[8] = dict(common, kernel="flash_attn_bwd passes delta + dQ",
                           ms=dq_ms, plain_ms=bwd_plain, library_ms=lib_fb,
                           library=lib_note, max_abs_err=err_b,
                           atol=GRAD_ATOL["float32"], flops=3 * prod,
                           bytes=6 * n_el + stats)
            rows[9] = dict(common, kernel="flash_attn_bwd pass dK/dV",
                           ms=dkv_ms, plain_ms=bwd_plain, library_ms=lib_fb,
                           library=lib_note, max_abs_err=err_b,
                           atol=GRAD_ATOL["float32"], flops=4 * prod,
                           bytes=6 * n_el + 2 * stats)
        else:
            row = fa.reference_rows("bwd", mode, T)[0]
            rows[row] = dict(common, kernel="flash_attn_bwd", ms=bwd_ms,
                             plain_ms=bwd_plain, library_ms=lib_fb,
                             library=lib_note, max_abs_err=err_b,
                             atol=GRAD_ATOL["float32"], flops=5 * prod,
                             bytes=8 * n_el + stats, dq_pass_ms=dq_ms,
                             dkv_pass_ms=dkv_ms)
        del qkv, q, k, v, g, out, lse, dq, dk, dv, delta, qg, kg, vg, gh
    for row, r in sorted(rows.items()):
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["bytes"],
                                             FP32_FLOPS_PER_S)
        r["bound_3xtf32_ms"] = bound_3xtf32(r["flops"], r["bytes"])
        r["ok"] = r["max_abs_err"] <= r["atol"]
        log(f"  row {row} {r['kernel']} ({r['shape']}): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['flops'] / 1e9:.2f} GFLOP at 67 TFLOP/s "
            f"fp32, {r['bytes'] / 1e6:.2f} MB at 3.35 TB/s); forward "
            f"{r['fwd_ms']:.4f} ms, backward {r['bwd_ms']:.4f} ms; 3xTF32 "
            f"bound {r['bound_3xtf32_ms']:.4f} ms; max_abs_err "
            f"vs plain {r['max_abs_err']:.3e} (atol {r['atol']:.0e}) "
            f"{'ok' if r['ok'] else 'FAIL'}; SDPA's kernels "
            f"{kernels_line(r['library_kernels'])}")
    bad = [row for row, r in rows.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"rows {bad} disagree with their plain versions "
                             "at the eager train path's shapes")
    return rows


def timing_fused_ln(torch, fl, p, dev="cuda", N=16384, D=768):
    """Row 12 at the encoder's shape (N = B 32 x T 512, D 768, fp32) with
    the train path's p 0.1, and p 0 (scoring): CUDA events around one
    call and device time alone (``torch.profiler``, 10 calls), its share
    of the bound in device time.  No PyTorch call computes the function
    (``library_ms`` None); ``F.layer_norm`` on the precomputed
    ``residual + x + bias`` is timed beside it as a smaller function (one
    (N, D) tensor read and one written, against the kernel's two read and
    one written)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.tools.profile_train import device_ms_per_call
    gen = torch.Generator(device=dev).manual_seed(10)
    x, r = (torch.randn((N, D), generator=gen, device=dev) for _ in range(2))
    b, g, be = (torch.randn(D, generator=gen, device=dev) for _ in range(3))
    with torch.no_grad():
        out = fl.fused_ln(x, r, b, g, be, 3, p=p, eps=1e-5)
        ref = fl.fused_ln_ref(x, r, b, g, be, 3, p=p, eps=1e-5)
        err = (out - ref).abs().max().item()
        del out, ref

        def kernel(p_):
            return lambda: fl.fused_ln(x, r, b, g, be, 3, p=p_, eps=1e-5)

        ms, ms_p0 = time_ms(torch, kernel(p)), time_ms(torch, kernel(0.0))
        dev_ms = device_ms_per_call(kernel(p))
        dev_ms_p0 = device_ms_per_call(kernel(0.0))
        plain = time_ms(torch, lambda: fl.fused_ln_ref(x, r, b, g, be, 3,
                                                       p=p, eps=1e-5),
                        reps=5)
        z = r + x + b
        lib = time_ms(torch, lambda: F.layer_norm(z, (D,), g, be, 1e-5))
    nbytes = 4.0 * (3 * N * D + 3 * D)
    b_ms, b_by = bound(10.0 * N * D, nbytes, FP32_FLOPS_PER_S)
    row = dict(ms=ms, ms_p0=ms_p0, device_ms=dev_ms, device_ms_p0=dev_ms_p0,
               share_of_bound=b_ms / dev_ms, share_of_bound_p0=b_ms /
               dev_ms_p0, plain_ms=plain, library_ms=None,
               library="none (no PyTorch call computes LayerNorm(residual "
                       "+ dropout(x + bias)))", layer_norm_ms=lib,
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=err,
               atol=FUSED_LN_ATOL, shape=f"N {N}, D {D}, fp32, p {p}")
    row["ok"] = err <= FUSED_LN_ATOL
    log(f"  fused_ln ({row['shape']}): kernel {ms:.4f} ms events, "
        f"{dev_ms:.4f} ms device ({row['share_of_bound']:.1%} of the bound) "
        f"(p 0: {ms_p0:.4f} events, {dev_ms_p0:.4f} device, "
        f"{row['share_of_bound_p0']:.1%}), plain {plain:.4f} ms, "
        f"F.layer_norm on the precomputed sum (a smaller function) "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB "
        f"at 3.35 TB/s); max_abs_err vs plain {err:.3e} (atol "
        f"{FUSED_LN_ATOL:.0e}) {'ok' if row['ok'] else 'FAIL'}")
    if not row["ok"]:
        raise AssertionError("fused_ln disagrees with its plain version at "
                             "the encoder's shape")
    return row


def timing_fused_ln_bwd(torch, fl, p, dev="cuda", N=16384, D=768):
    """The epilogue's backward kernel (both launches) at the encoder's
    shape, fp32, p 0.1 and p 0: CUDA events, device time, the plain
    version, the bound (g, x, residual read, dx, dres written, the (D,)
    vectors read and written once) and the share of it in device time.
    No PyTorch call computes the function; ATen's LayerNorm backward on
    the precomputed sum (g and z read, dz written, no dropout, no second
    output) is timed beside it as a smaller function."""
    from paddle_tpu_torch.tools.profile_train import device_ms_per_call
    gen = torch.Generator(device=dev).manual_seed(13)
    x, r, g = (torch.randn((N, D), generator=gen, device=dev)
               for _ in range(3))
    b, gam, be = (torch.randn(D, generator=gen, device=dev)
                  for _ in range(3))
    args = (g, x, r, b, gam, be, 3)
    with torch.no_grad():
        got = fl.fused_ln_bwd(*args, p=p, eps=1e-5)
        ref = fl.fused_ln_bwd_ref(*args, p=p, eps=1e-5)
        err = max((a - w).abs().max().item() for a, w in
                  zip(got[:2], ref[:2]))
        del got, ref

        def kernel(p_):
            return lambda: fl.fused_ln_bwd(*args, p=p_, eps=1e-5)

        ms, ms_p0 = time_ms(torch, kernel(p)), time_ms(torch, kernel(0.0))
        dev_ms = device_ms_per_call(kernel(p))
        dev_ms_p0 = device_ms_per_call(kernel(0.0))
        plain = time_ms(torch, lambda: fl.fused_ln_bwd_ref(*args, p=p,
                                                           eps=1e-5),
                        reps=5)
        z = r + x + b
        _, mean, rstd = torch.ops.aten.native_layer_norm(z, (D,), gam, be,
                                                         1e-5)
        lib = time_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
            g, z, (D,), mean, rstd, gam, be, [True, True, True]))
    nbytes = 4.0 * (5 * N * D + 6 * D)
    b_ms, b_by = bound(30.0 * N * D, nbytes, FP32_FLOPS_PER_S)
    row = dict(ms=ms, ms_p0=ms_p0, device_ms=dev_ms, device_ms_p0=dev_ms_p0,
               share_of_bound=b_ms / dev_ms,
               share_of_bound_p0=b_ms / dev_ms_p0, plain_ms=plain,
               library_ms=None,
               library="none (no PyTorch call computes the epilogue's "
                       "backward)", layer_norm_backward_ms=lib,
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=err,
               atol=GRAD_ATOL["float32"], shape=f"N {N}, D {D}, fp32, p {p}")
    row["ok"] = err <= GRAD_ATOL["float32"]
    log(f"  fused_ln_bwd ({row['shape']}): kernel {ms:.4f} ms events, "
        f"{dev_ms:.4f} ms device ({row['share_of_bound']:.1%} of the bound) "
        f"(p 0: {ms_p0:.4f} events, {dev_ms_p0:.4f} device, "
        f"{row['share_of_bound_p0']:.1%}), plain {plain:.4f} ms, ATen's "
        f"LayerNorm backward on the precomputed sum (a smaller function) "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB "
        f"at 3.35 TB/s); max_abs_err vs plain {err:.3e} (atol "
        f"{GRAD_ATOL['float32']:.0e}) {'ok' if row['ok'] else 'FAIL'}")
    if not row["ok"]:
        raise AssertionError("fused_ln_bwd disagrees with its plain version "
                             "at the encoder's shape")
    return row


def timing_dlogits(torch, sx, cfg, dev="cuda"):
    """Row 11 at one chunk of the compiled step's head backward (C 4096,
    D 768, V 30528, bf16); library: the chunk's pb as the step formed it
    before the kernel (``matmul_f32``, which is ``torch.mm(...,
    out_dtype=float32)`` for bf16 on the card, ``exp``, the label index,
    the scale and the cast).  CUDA events and device time."""
    from paddle_tpu_torch.tools.profile_train import device_ms_per_call
    w_ = cfg["width"]
    D, V = w_["hidden_size"], w_["vocab_size"]
    N = cfg["batch"] * cfg["seq"]
    C = sx._chunk(N)
    dt = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((C, D), generator=gen, device=dev).to(dt)
    w = (torch.randn((D, V), generator=gen, device=dev) * 0.01).to(dt)
    lab = torch.randint(0, V, (C,), generator=gen, device=dev,
                        dtype=torch.int32)
    g = torch.tensor(1.0 / N, device=dev)
    with torch.no_grad():
        lse, _ = sx.softmax_xent_fwd_ref(x, w, lab)
        out = sx.softmax_xent_dlogits(x, w, lab, lse, g)
        ref = sx.softmax_xent_dlogits_ref(x, w, lab, lse, g)
        err, tol, ok = _dlogits_err(torch, out, ref, 1.0 / N)
        del out, ref
        rows = torch.arange(C, device=dev)
        lab64 = lab.long()

        def step_pb():
            p = torch.exp(sx.matmul_f32(x, w) - lse[:, None])
            p[rows, lab64] -= 1.0
            return (p * g).to(x.dtype)

        ms = time_ms(torch, lambda: sx.softmax_xent_dlogits(x, w, lab, lse,
                                                            g))
        dev_ms = device_ms_per_call(lambda: sx.softmax_xent_dlogits(
            x, w, lab, lse, g))
        plain = time_ms(torch, lambda: sx.softmax_xent_dlogits_ref(
            x, w, lab, lse, g), reps=5)
        lib = time_ms(torch, step_pb, reps=10)
    el = x.element_size()
    flops = 2.0 * C * D * V
    nbytes = el * (C * D + D * V + C * V) + 8.0 * C
    rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S
    b_ms, b_by = bound(flops, nbytes, rate)
    per_step = N // C
    row = dict(ms=ms, device_ms=dev_ms, route=sx._route(x, w),
               share_of_bound=b_ms / dev_ms, plain_ms=plain, library_ms=lib,
               library="the chunk's pb as formed before the kernel: "
                       "torch.mm(x, w, out_dtype=float32), exp, label "
                       "index, scale, cast",
               bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
               launches_per_step=per_step, bound_per_step_ms=b_ms * per_step,
               ms_per_step=ms * per_step, max_abs_err=err, tolerance=tol,
               shape=f"C {C}, D {D}, V {V}, {cfg['dtype']}", ok=ok)
    log(f"  softmax_xent_dlogits ({row['shape']}): kernel {ms:.4f} ms, "
        f"device time {dev_ms:.4f} ms (route {row['route']}, "
        f"{row['share_of_bound']:.1%} of the bound), "
        f"plain {plain:.4f} ms, the step's former pb {lib:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.1f} GFLOP at "
        f"{rate / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s); "
        f"{per_step} per step: {ms * per_step:.3f} ms against a bound of "
        f"{b_ms * per_step:.3f} ms; max_abs_err vs plain {err:.3e} ({tol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not row["ok"]:
        raise AssertionError("softmax_xent_dlogits disagrees with its plain "
                             "version at the step's chunk")
    return row


# -- phases 7 and 8 ------------------------------------------------------------
def _clone_state(params, opt):
    """Copies of a train state (the step updates its state in place)."""
    from paddle_tpu_torch.models.gpt_spmd import _leaves, _rebuild

    def clone(tree):
        return _rebuild(tree, {k: v.clone() for k, v in _leaves(tree).items()})

    return clone(params), clone(opt)


def _plain_kernels(fq, sx):
    """Every kernel wrapper of the train path swapped for its plain
    version."""
    from contextlib import ExitStack
    stack = ExitStack()
    stack.enter_context(mock.patch.object(fq, "flash_qkv_fwd",
                                          fq.flash_qkv_fwd_ref))
    stack.enter_context(mock.patch.object(fq, "flash_qkv_bwd",
                                          fq.flash_qkv_bwd_ref))
    stack.enter_context(mock.patch.object(sx, "softmax_xent_fwd",
                                          sx.softmax_xent_fwd_ref))
    stack.enter_context(mock.patch.object(sx, "softmax_xent_dlogits",
                                          sx.softmax_xent_dlogits_ref))
    return stack


def _reset(fq, sx):
    fq.FWD_LAUNCHES = fq.BWD_LAUNCHES = sx.LAUNCHES = 0
    sx.DLOGITS_LAUNCHES = 0
    for k in sx.ROUTE_LAUNCHES:
        sx.ROUTE_LAUNCHES[k] = 0
    fq._fa.SM90_FWD_LAUNCHES = fq._fa.SM90_BWD_LAUNCHES = 0


def _launches(fq, sx):
    return dict(flash_qkv_fwd=fq.FWD_LAUNCHES, flash_qkv_bwd=fq.BWD_LAUNCHES,
                flash_attn_sm90_fwd=fq._fa.SM90_FWD_LAUNCHES,
                flash_attn_sm90_bwd=fq._fa.SM90_BWD_LAUNCHES,
                softmax_xent_fwd=sx.LAUNCHES,
                softmax_xent_dlogits=sx.DLOGITS_LAUNCHES,
                **{f"softmax_xent_{k}": v
                   for k, v in sx.ROUTE_LAUNCHES.items()})


def _grads_after_one_step(opt, names):
    """The step's gradients, read from AdamW's first moment after step 1
    (m = (1 - b1) g)."""
    from paddle_tpu_torch.models.gpt_spmd import _leaves
    m = _leaves(opt["m"])
    return {n: m[n] / (1 - ADAM_B1) for n in names}


def train(torch, fq, sx, dev, cfg, timed=True):
    """One config of the train path; returns its report."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, build_spmd_train_step
    w = cfg["width"]
    L, V, D = w["num_layers"], w["vocab_size"], w["hidden_size"]
    B, T, name = cfg["batch"], cfg["seq"], cfg["dtype"]
    step, init_fn = build_spmd_train_step(
        GPTConfig(**w), compute_dtype=getattr(torch, name),
        remat_policy=cfg["remat"], device=dev)
    params, opt = init_fn(0)
    rng = np.random.RandomState(0)                # bench.py:137-139
    ids = torch.from_numpy(rng.randint(0, V, (B, T))).to(dev)
    labels = torch.from_numpy(rng.randint(0, V, (B, T))).to(dev)
    state0 = _clone_state(params, opt)

    # the main path: one step through the kernels, counted
    sync(torch, dev)
    _reset(fq, sx)
    loss_k, _, opt_k = step(*_clone_state(*state0), ids, labels)
    sync(torch, dev)
    launches = _launches(fq, sx)
    fwd_per_step = L * (2 if cfg["remat"] == "full" else 1)
    chunks = B * T // sx._chunk(B * T)
    # bf16 at d 64 / 128: every attention launch is flash_attn_sm90's
    sm90 = (name == "bfloat16"
            and D // w["num_heads"] in fq._fa.SM90_HEAD_DIMS)
    want_sm90 = (fwd_per_step, L) if sm90 else (0, 0)
    # the head: bf16 with D and V multiples of 8 on softmax_xent_sm90.cu,
    # the rest (fp32 here) on the tile kernels; every launch on that route
    head = "sm90" if name == "bfloat16" and D % 8 == 0 and V % 8 == 0 \
        else "tile"
    other = "tile" if head == "sm90" else "sm90"
    head_ok = (launches[f"softmax_xent_{head}_fwd"]
               == launches["softmax_xent_fwd"] >= 1
               and launches[f"softmax_xent_{head}_dlogits"]
               == launches["softmax_xent_dlogits"] == chunks
               and launches[f"softmax_xent_{other}_fwd"]
               == launches[f"softmax_xent_{other}_dlogits"] == 0)
    log(f"  step 1 through the kernels: loss {loss_k.item():.6f}, "
        f"launches {launches} (expected flash_qkv_fwd {fwd_per_step}, "
        f"flash_qkv_bwd {L}, of them flash_attn_sm90 {want_sm90[0]} + "
        f"{want_sm90[1]}, softmax_xent_fwd >= 1 and softmax_xent_dlogits "
        f"{chunks}, all on the {head} route)")
    if (launches["flash_qkv_fwd"] != fwd_per_step
            or launches["flash_qkv_bwd"] != L
            or (launches["flash_attn_sm90_fwd"],
                launches["flash_attn_sm90_bwd"]) != want_sm90
            or not head_ok):
        raise AssertionError(f"train step launched {launches}; expected "
                             f"{fwd_per_step} / {L} (flash_attn_sm90 "
                             f"{want_sm90}) / >= 1 / {chunks} (head route "
                             f"{head})")
    grads_k = _grads_after_one_step(opt_k, TRAIN_GRADS)
    del opt_k

    with _plain_kernels(fq, sx):
        loss_p, _, opt_p = step(*_clone_state(*state0), ids, labels)
    grads_p = _grads_after_one_step(opt_p, TRAIN_GRADS)
    del opt_p
    d_loss = abs(loss_k.item() - loss_p.item())
    rel = {n: ((grads_k[n] - grads_p[n]).float().norm()
               / grads_p[n].float().norm()).item() for n in TRAIN_GRADS}
    rtol = TRAIN_LOSS_RTOL[name]
    loss_ok = d_loss <= rtol * abs(loss_p.item())
    grads_ok = all(v <= TRAIN_GRAD_RTOL[name] for v in rel.values())
    log(f"  same step with the plain versions: loss {loss_p.item():.6f}, "
        f"|difference| {d_loss:.3e} (limit rtol {rtol:.0e}); grads "
        f"relative L2 {', '.join(f'{k} {v:.3e}' for k, v in rel.items())} "
        f"(limit {TRAIN_GRAD_RTOL[name]:.0e})")
    finite = bool(torch.isfinite(loss_k).item())
    if not (loss_ok and grads_ok and finite):
        raise AssertionError("the step through the kernels disagrees with "
                             "the step through the plain versions")
    del grads_k, grads_p
    out = dict(config=cfg, loss_step1=loss_k.item(),
               loss_step1_plain=loss_p.item(), loss_abs_diff=d_loss,
               grad_rel_l2=rel, launches=launches)
    if not timed:
        return out

    # two runs of two steps from the same state repeat bit for bit
    from paddle_tpu_torch.models.gpt_spmd import _leaves
    runs = []
    for _ in range(2):
        p, o = _clone_state(*state0)
        losses = []
        for _ in range(2):
            loss, p, o = step(p, o, ids, labels)
            losses.append(loss.clone())
        runs.append((torch.stack(losses), _leaves(p)))
        del o
    same = bool(torch.equal(runs[0][0], runs[1][0])) and all(
        torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    log(f"  two runs of two steps: losses {runs[0][0].tolist()} and "
        f"{runs[1][0].tolist()}; bit-identical losses and parameters: "
        f"{same}")
    if not same:
        raise AssertionError("two identical runs of the train step differ")
    del runs

    # 2 warm-ups, then timed steps on one fixed batch; the loss falls
    del state0
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss, params, opt = step(params, opt, ids, labels)
        b.record()
        b.synchronize()
        losses.append(loss.item())
        if i >= TRAIN_WARMUP:
            times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    step_ms = pct(times, 50)
    seq_s = B / (step_ms / 1e3)
    # bench.py:187: fwd+bwd matmul and attention flops per token, the
    # attention counted non-causal, no remat recompute
    flops_tok = 6 * (L * 12 * D * D + D * V) + 12 * L * T * D
    mfu = seq_s * T * flops_tok / BF16_FLOPS_PER_S
    log(f"  losses over {len(losses)} steps: {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    log(f"  step ms p50 {step_ms:.3f} (min {min(times):.3f}, max "
        f"{max(times):.3f}, {TRAIN_TIMED} steps after {TRAIN_WARMUP} "
        f"warm-ups, CUDA events); {seq_s:.2f} seq/s; MFU {mfu:.4f} "
        f"(bench.py:187 FLOP count, non-causal attention, against 989 "
        f"TFLOP/s bf16); peak memory {peak / 2**30:.3f} GiB")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    out.update(losses=losses, step_ms=times, step_ms_p50=step_ms,
               seq_per_s=seq_s, mfu=mfu, flops_per_token=flops_tok,
               peak_memory_bytes=peak, deterministic=same)
    return out


# -- phases 9 and 10 -----------------------------------------------------------
def _plain_attention(fa):
    """The attention kernels' wrappers swapped for their plain versions."""
    from contextlib import ExitStack
    stack = ExitStack()
    stack.enter_context(mock.patch.object(fa, "flash_attn_fwd",
                                          fa.flash_attn_fwd_ref))
    stack.enter_context(mock.patch.object(fa, "flash_attn_bwd",
                                          fa.flash_attn_bwd_ref))
    return stack


def model_train(torch, net, ids, labels, names, reset, launches, want,
                plain, note="", timed=True, amp=None, repeat=True,
                dropout=False):
    """The train path on ``net``: ``Model(net).prepare(AdamW(1e-3,
    weight_decay=0.01), CrossEntropyLoss(), amp_configs=amp, jit=...)
    .train_batch`` on (ids, labels).  Step 1 (``update=False``, uncaptured
    in both engines) runs through the kernels with the counts ``reset``
    just before and ``launches()`` read just after (they must equal
    ``want``), then again inside ``plain()`` (the plain versions), held to
    the fp32 tolerances, or under AMP to the compiled bf16 step's.  With
    ``repeat``: JIT_STEPS steps on rolled batches with ``jit=False``
    (uncaptured), then twice with ``jit=True`` (a step captured in a CUDA
    graph and replayed), from the same state and seeds; the captured runs
    must repeat bit for bit, equal the uncaptured run bit for bit (else
    within the tolerances above, reported), keep the parameters fp32, and
    count ``want`` launches in a replayed step; with ``dropout``, two more
    steps at learning rate 0 on one batch must differ (new masks at every
    replay).  With ``timed``, each engine takes 12 steps on the batch (the
    loss must fall): step ms p50, seq/s, peak memory.  Every run starts
    from ``paddle_tpu_torch.seed``, so the fused epilogue's seeds and the
    dropout masks repeat.  Returns the report."""
    import gc
    import numpy as np
    import paddle_tpu_torch
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    dev = ids.device
    B = ids.shape[0]
    state0 = {k: v.clone() for k, v in net.state_dict().items()}

    def fresh(jit=True):
        net.load_state_dict(state0)
        return Model(net).prepare(
            AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01),
            CrossEntropyLoss(), amp_configs=amp, jit=jit)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    loss_rtol = EAGER_LOSS_RTOL if amp is None else \
        TRAIN_LOSS_RTOL["bfloat16"]
    grad_rtol = EAGER_GRAD_RTOL if amp is None else \
        TRAIN_GRAD_RTOL["bfloat16"]

    def first_step(model):
        paddle_tpu_torch.seed(1)
        loss = model.train_batch([ids], [labels], update=False)["loss"]
        params = dict(net.named_parameters())
        grads = {n: params[n].grad.clone() for n in names}
        model._optimizer.clear_grad()
        return loss.item(), grads

    # the main path: step 1 through the kernels, counted
    model = fresh()
    sync(torch, dev)
    reset()
    loss_k, grads_k = first_step(model)
    sync(torch, dev)
    counts = launches()
    log(f"  step 1 through the kernels: loss {loss_k:.6f}, launches "
        f"{counts} (expected {want}{note})")
    if counts != want:
        raise AssertionError(f"the step launched {counts}; expected {want}")

    with plain():
        loss_p, grads_p = first_step(model)
    d_loss = abs(loss_k - loss_p)
    rel = {n: ((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm()).item()
           for n in names}
    log(f"  same step with the plain versions and the same seeds: loss "
        f"{loss_p:.6f}, |difference| {d_loss:.3e} (limit rtol "
        f"{loss_rtol:.0e}); grads relative L2 "
        f"{', '.join(f'{k} {v:.3e}' for k, v in rel.items())} (limit "
        f"{grad_rtol:.0e})")
    if not (np.isfinite(loss_k) and d_loss <= loss_rtol * abs(loss_p)
            and all(v <= grad_rtol for v in rel.values())):
        raise AssertionError("the step through the kernels disagrees with "
                             "the step through the plain versions")
    del grads_k, grads_p, model
    out = dict(loss_step1=loss_k, loss_step1_plain=loss_p,
               loss_abs_diff=d_loss, loss_rtol=loss_rtol, grad_rel_l2=rel,
               grad_rtol=grad_rtol, launches=counts, amp=amp)
    if not repeat:
        return out

    # captured (jit=True) against uncaptured (jit=False): the same state,
    # seeds and batches; the captured run twice
    batches = [(ids.roll(i, 0), labels.roll(i, 0)) for i in range(JIT_STEPS)]
    replay_counts = {}

    def run_steps(jit, count=False):
        model = fresh(jit)
        paddle_tpu_torch.seed(2)
        losses = []
        for i, (b_ids, b_labels) in enumerate(batches):
            if count and i == 1:                 # a replay, counted
                sync(torch, dev)
                reset()
            losses.append(model.train_batch([b_ids], [b_labels])["loss"])
            if count and i == 1:
                sync(torch, dev)
                replay_counts.update(launches())
        if dropout:
            model._optimizer.set_lr(0.0)
            losses += [model.train_batch([ids], [labels])["loss"]
                       for _ in range(2)]
        captured = _all_captured(model._steps.entries().values())
        return torch.stack(losses), {k: v.clone() for k, v in
                                     net.state_dict().items()}, captured

    runs = []
    for jit, count in ((False, False), (True, True), (True, False)):
        runs.append(run_steps(jit, count))
        release()
    (l_e, s_e, cap_e), (l_j, s_j, cap_j), (l_j2, s_j2, cap_j2) = runs
    exact = bool(torch.equal(l_e, l_j)) and all(torch.equal(v, s_j[k])
                                                for k, v in s_e.items())
    repeats = bool(torch.equal(l_j, l_j2)) and all(
        torch.equal(v, s_j2[k]) for k, v in s_j.items())
    fp32 = all(v.dtype == torch.float32 for v in s_j.values()
               if v.is_floating_point())
    d_losses = ((l_j - l_e).abs() / l_e.abs()).max().item()
    d_params = max(((s_j[k].float() - v.float()).norm()
                    / v.float().norm().clamp_min(1e-30)).item()
                   for k, v in s_e.items() if v.is_floating_point())
    log(f"  {JIT_STEPS} steps{' (+ 2 at learning rate 0)' if dropout else ''}"
        f", jit=False / jit=True / jit=True: losses "
        f"{l_e.tolist()} / {l_j.tolist()} / {l_j2.tolist()}; captured "
        f"{cap_e} / {cap_j} / {cap_j2}")
    log(f"  captured = uncaptured bit for bit (losses and parameters): "
        f"{exact} (max loss rel diff {d_losses:.3e}, params rel L2 "
        f"{d_params:.3e}); two captured runs bit for bit: {repeats}; "
        f"parameters fp32: {fp32}; a replayed step's launches "
        f"{replay_counts} (expected {want})")
    if cap_e or not (cap_j and cap_j2):
        raise AssertionError("jit=True did not capture, or jit=False did")
    if not repeats:
        raise AssertionError("two captured runs differ")
    if not exact and not (d_losses <= loss_rtol and d_params <= grad_rtol):
        raise AssertionError("the captured steps differ from the uncaptured "
                             "ones beyond the tolerances")
    if not fp32:
        raise AssertionError("the step left parameters that are not fp32")
    if replay_counts != want:
        raise AssertionError(f"a replayed step counted {replay_counts}; "
                             f"expected {want}")
    masks = None
    if dropout:
        masks = bool(l_j[-2] != l_j[-1]) and bool(l_e[-2] != l_e[-1])
        log(f"  two steps at learning rate 0 on one batch: losses "
            f"{l_j[-2].item():.7f}, {l_j[-1].item():.7f} (captured): new "
            f"dropout masks at every replay: {masks}")
        if not masks:
            raise AssertionError("the captured step replayed the same "
                                 "dropout masks")
    del runs, s_e, s_j, s_j2
    out.update(jit_steps=JIT_STEPS, deterministic=repeats,
               captured_equals_uncaptured=exact,
               captured_vs_uncaptured=dict(loss_rel=d_losses,
                                           params_rel_l2=d_params),
               losses_uncaptured=l_e.tolist(), losses_captured=l_j.tolist(),
               replay_launches=replay_counts, masks_change=masks,
               params_fp32=fp32)
    if not timed:
        return out

    # per engine: 2 warm-ups (the captured engine's first one captures),
    # then timed steps on one fixed batch; the loss falls
    for engine, jit in (("uncaptured", False), ("captured", True)):
        release()
        torch.cuda.reset_peak_memory_stats()
        model = fresh(jit)
        paddle_tpu_torch.seed(3)
        losses, times = [], []
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loss = model.train_batch([ids], [labels])["loss"]
            b.record()
            b.synchronize()
            losses.append(loss.item())
            if i >= TRAIN_WARMUP:
                times.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        step_ms = pct(times, 50)
        seq_s = B / (step_ms / 1e3)
        log(f"  {engine} (jit={jit}): losses over {len(losses)} steps: "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        log(f"  {engine}: step ms p50 {step_ms:.3f} (min {min(times):.3f}, "
            f"max {max(times):.3f}, {TRAIN_TIMED} steps after "
            f"{TRAIN_WARMUP} warm-ups, CUDA events); {seq_s:.2f} seq/s; "
            f"peak memory {peak / 2**30:.3f} GiB, reserved "
            f"{reserved / 2**30:.3f} GiB")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        out[engine] = dict(losses=losses, step_ms=times, step_ms_p50=step_ms,
                           seq_per_s=seq_s, peak_memory_bytes=peak,
                           reserved_bytes=reserved)
        del model
    out.update(out["captured"])
    del state0
    release()
    return out


def _batch(torch, vocab, B, T, dev):
    """ids from ``np.random.RandomState(0)`` and labels = ids rolled by one
    (``tests/test_models.py:57-58``), on ``dev``."""
    import numpy as np
    ids = np.random.RandomState(0).randint(0, vocab, (B, T))
    labels = np.roll(ids, -1, 1).reshape(B, T, 1)
    return tuple(torch.from_numpy(a).to(dev) for a in (ids, labels))


def _reset_attention(fa):
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
    fa.SM90_FWD_LAUNCHES = fa.SM90_BWD_LAUNCHES = 0
    fa.MODE_LAUNCHES.clear()


def _attention_launches(fa):
    return dict(fwd=fa.FWD_LAUNCHES, bwd=fa.BWD_LAUNCHES,
                sm90_fwd=fa.SM90_FWD_LAUNCHES, sm90_bwd=fa.SM90_BWD_LAUNCHES,
                modes=dict(fa.MODE_LAUNCHES))


def _attention_want(L, fwd_mode, bwd_mode, amp):
    """L forward and L backward launches in their modes; under AMP (bf16
    at d 64) every one of them on flash_attn_sm90.cu, else none."""
    sm90 = L if amp else 0
    return dict(fwd=L, bwd=L, sm90_fwd=sm90, sm90_bwd=sm90,
                modes={f"fwd {fwd_mode}": L, f"bwd {bwd_mode}": L})


def eager_train(torch, fa, dev, cfg, timed=True, amp=None, repeat=True):
    """The eager GPT of one config through :func:`model_train`; L forward
    and L backward attention launches in the mode of its length (under
    AMP all on flash_attn_sm90.cu)."""
    from paddle_tpu_torch.models import GPT, GPTConfig
    w = cfg["width"]
    L, T = w["num_layers"], cfg["seq"]
    net = GPT(GPTConfig(**w), device=dev, seed=0)
    ids, labels = _batch(torch, w["vocab_size"], cfg["batch"], T, dev)
    mode = fa._pallas_mode(T, T, True)
    rows = dict(fwd=fa.reference_rows("fwd", mode, T),
                bwd=fa.reference_rows("bwd", mode, T))
    want = _attention_want(L, mode, mode, amp)
    out = model_train(
        torch, net, ids, labels,
        ("blocks.0.attn.qkv.weight", "wte.weight",
         f"blocks.{L - 1}.down.weight"),
        lambda: _reset_attention(fa), lambda: _attention_launches(fa),
        want, lambda: _plain_attention(fa), note=f"; rows {rows}",
        timed=timed, amp=amp, repeat=repeat)
    return dict(out, config=cfg, mode=mode, rows=rows)


# -- phase 11 ------------------------------------------------------------------
def _plain_encoder_kernels(fa, fl):
    """The encoder path's kernel wrappers swapped for their plain versions:
    attention forward and backward, and the fused epilogue's forward and
    backward."""
    stack = _plain_attention(fa)
    stack.enter_context(mock.patch.object(fl, "fused_ln", fl.fused_ln_ref))
    stack.enter_context(mock.patch.object(fl, "fused_ln_bwd",
                                          fl.fused_ln_bwd_ref))
    return stack


def _reset_encoder(fa, fl):
    _reset_attention(fa)
    fl.LAUNCHES = fl.BWD_LAUNCHES = 0


def _encoder_launches(fa, fl):
    return dict(_attention_launches(fa), fused_ln=fl.LAUNCHES,
                fused_ln_bwd=fl.BWD_LAUNCHES)


def encoder_scoring(torch, fa, fl, net, cfg, batch=ENCODER_SCORE_BATCH):
    """``Model(net).predict_batch`` on (batch, max_len) in eval mode: the
    fused epilogue at p 0, attention forward without lse."""
    import numpy as np
    from paddle_tpu_torch import Model
    L, T, V = cfg["num_layers"], cfg["max_len"], cfg["vocab_size"]
    ids = np.random.RandomState(11).randint(0, V, (batch, T))
    model = Model(net)
    model.predict_batch([ids])                        # warm-up
    sync(torch, next(net.parameters()).device)
    _reset_encoder(fa, fl)
    t0 = time.perf_counter()
    logits = model.predict_batch([ids])[0]
    ms = (time.perf_counter() - t0) * 1e3
    launches = _encoder_launches(fa, fl)
    with _plain_encoder_kernels(fa, fl):
        t0 = time.perf_counter()
        plain = model.predict_batch([ids])[0]
        plain_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(logits - plain).max())
    finite = bool(np.isfinite(logits).all())
    want = dict(fwd=L, bwd=0, sm90_fwd=0, sm90_bwd=0, modes={"fwd small": L},
                fused_ln=2 * L, fused_ln_bwd=0)
    log(f"  predict_batch logits {logits.shape} finite={finite} "
        f"max_abs_err_vs_plain={err:.3e} (atol {SCORING_ATOL:.0e}) "
        f"launches {launches} (expected {want}); {ms:.3f} ms with the "
        f"host copy of the logits, plain {plain_ms:.3f} ms")
    if logits.shape != (batch, T, V) or not finite:
        raise AssertionError("encoder logits have the wrong shape or are "
                             "not finite")
    if launches != want:
        raise AssertionError(f"encoder scoring launched {launches}; "
                             f"expected {want}")
    if err > SCORING_ATOL:
        raise AssertionError(f"encoder logits differ from the plain path by "
                             f"{err} > {SCORING_ATOL}")
    return dict(launches=launches, max_abs_err=err, atol=SCORING_ATOL,
                predict_ms=ms, plain_predict_ms=plain_ms)


def encoder_train(torch, fa, fl, net, cfg, dev="cuda", batch=ENCODER_BATCH,
                  timed=True, amp=None, repeat=True):
    """The encoder through :func:`model_train` at (batch, max_len), fp32
    or under AMP: per step 2L fused-epilogue launches each way and L + L
    non-causal attention launches (under AMP all on flash_attn_sm90.cu)."""
    L, T = cfg["num_layers"], cfg["max_len"]
    ids, labels = _batch(torch, cfg["vocab_size"], batch, T, dev)
    mode = fa._pallas_mode(T, T, False)
    rows = dict(fwd=fa.reference_rows("fwd", mode, T),
                bwd=fa.reference_rows("bwd", mode, T))
    want = dict(_attention_want(L, mode, mode, amp), fused_ln=2 * L,
                fused_ln_bwd=2 * L)
    out = model_train(
        torch, net, ids, labels,
        ("layers.0.fused_attn.qkv_weight", "layers.0.ffn.ln2_scale",
         f"layers.{L - 1}.fused_attn.ln_scale", "wte.weight"),
        lambda: _reset_encoder(fa, fl), lambda: _encoder_launches(fa, fl),
        want, lambda: _plain_encoder_kernels(fa, fl),
        note=f"; attention rows {rows}, non-causal", timed=timed, amp=amp,
        repeat=repeat, dropout=cfg["dropout_rate"] > 0)
    return dict(out, config=dict(cfg, batch=batch, seq=T), mode=mode,
                rows=rows)


def _o2_gpt(cfg):
    """The eager config cut to AMP_O2_LAYERS layers."""
    w = cfg["width"]
    return dict(cfg, width=dict(w, num_layers=min(AMP_O2_LAYERS,
                                                  w["num_layers"])))


def run(torch, dev, width, train_cfg=TRAIN, long_cfg=TRAIN_LONG,
        eager_cfg=EAGER, eager_long=EAGER_LONG, encoder_cfg=None,
        encoder_batch=ENCODER_BATCH, fp32_cfg=TRAIN_FP32, dryrun_cfg=DRYRUN):
    """Phases 3-11 on ``dev`` with a serving GPT of ``width``, the two
    train configs, the eager train configs and the encoder; returns the
    report and the ``kernels`` entries."""
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_attention_qkv as fq
    from paddle_tpu_torch.ops import fused_ln as fl
    from paddle_tpu_torch.ops import softmax_xent as sx
    from paddle_tpu_torch.tools.profile_train import ENCODER, build_encoder

    encoder_cfg = encoder_cfg or ENCODER
    dev = torch.device(dev)
    log("== phase 3: kernels against their plain versions")
    checks = check_kernels(torch, fa, dev)
    qkv_checks = check_qkv_kernels(torch, fq, dev)
    head_checks = check_head_kernel(torch, sx, dev)
    dlogits_checks = check_dlogits(torch, sx, dev)
    split_checks = check_split_kernels(torch, fa, dev)
    fp64_checks = check_fp64_truth(torch, fa, dev)
    ln_checks = check_fused_ln(torch, fl, dev)
    mask_checks = check_fused_ln_mask(torch, fl, dev)
    ln_bwd_checks = check_fused_ln_bwd(torch, fl, dev)
    log("== phase 4: full-width scoring")
    net = GPT(GPTConfig(**width), device=dev, seed=0)
    score = scoring(torch, fa, net)
    log("== phase 5: serving")
    serve = serving(torch, fa, net)
    log("== phase 6: kernel times")
    times = timing(torch, fa)
    main_shape = times[-1]                            # T = 512
    train_times = timing_train_kernels(torch, fq, sx, train_cfg, dev)
    long_times = timing_train_kernels(torch, fq, sx, long_cfg, dev,
                                      head=False)
    fp32_times = timing_train_kernels(torch, fq, sx, fp32_cfg, dev,
                                      head=False)
    split_times = timing_split_kernels(torch, fa, dev)
    dlogits_time = timing_dlogits(torch, sx, train_cfg, dev)
    ln_time = timing_fused_ln(torch, fl, encoder_cfg["dropout_rate"], dev)
    ln_bwd_time = timing_fused_ln_bwd(torch, fl, encoder_cfg["dropout_rate"],
                                      dev)
    del net
    torch.cuda.empty_cache()
    log("== phase 7: train at full width")
    trained = train(torch, fq, sx, dev, train_cfg)
    log("== phase 8: train at T 1024, reduced depth")
    trained_long = train(torch, fq, sx, dev, long_cfg, timed=False)
    log("== phase 8: the reference's dryrun model (head dim 16)")
    trained_dryrun = train(torch, fq, sx, dev, dryrun_cfg, timed=False)
    torch.cuda.empty_cache()
    log("== phase 9: eager train at full width (Model.train_batch)")
    eager = eager_train(torch, fa, dev, eager_cfg)
    torch.cuda.empty_cache()
    log("== phase 9: the same under AMP O1 (bf16)")
    eager_o1 = eager_train(torch, fa, dev, eager_cfg, amp="O1")
    torch.cuda.empty_cache()
    log(f"== phase 9: AMP O2 (bf16, fp32 masters) at L {AMP_O2_LAYERS}")
    eager_o2 = eager_train(torch, fa, dev, _o2_gpt(eager_cfg), amp="O2")
    eager_runs = []
    for cfg in eager_long:
        torch.cuda.empty_cache()
        log(f"== phase 10: eager train at T {cfg['seq']}, reduced depth")
        eager_runs.append(eager_train(torch, fa, dev, cfg, timed=False,
                                      repeat=False))
    torch.cuda.empty_cache()
    log("== phase 11: the fused post-LN encoder (incubate.nn) at full width")
    enc = build_encoder(encoder_cfg, dev)
    enc_score = encoder_scoring(torch, fa, fl, enc, encoder_cfg)
    enc_train = encoder_train(torch, fa, fl, enc, encoder_cfg, dev,
                              batch=encoder_batch)
    del enc
    torch.cuda.empty_cache()
    log("== phase 11: the same under AMP O1 (bf16)")
    enc_o1 = encoder_train(torch, fa, fl, build_encoder(encoder_cfg, dev),
                           encoder_cfg, dev, batch=encoder_batch, amp="O1")
    torch.cuda.empty_cache()
    log(f"== phase 11: AMP O2 (bf16, fp32 masters) at L {AMP_O2_LAYERS}")
    o2_cfg = dict(encoder_cfg, num_layers=min(AMP_O2_LAYERS,
                                              encoder_cfg["num_layers"]))
    enc_o2 = encoder_train(torch, fa, fl, build_encoder(o2_cfg, dev), o2_cfg,
                           dev, batch=encoder_batch, amp="O2")
    kernels = [dict(
        name="flash_attn_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:205",
        launches=serve["launches"],
        max_abs_err=max(c["max_abs_err"] for c in checks
                        if c["dtype"] == "float32"),
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"],
        library_kernels=main_shape["library_kernels"],
        timed_shape="bh 96, T 512, d 64, fp32, causal",
        launches_scoring=score["launches"], checks=len(checks),
        launches_eager_forward=eager["launches"]["fwd"],
        max_abs_err_bf16=max(c["max_abs_err"] for c in checks
                             if c["dtype"] == "bfloat16"
                             and c["inputs"] == "rand"),
        max_abs_err_bf16_sharp=max(c["max_abs_err"] for c in checks
                                   if c["inputs"] == "sharp"))]

    def entry(key, source, replaces, launches, checks_err, **extra):
        t = train_times[key]
        return dict(name=key, route="cuda",
                    source=f"paddle_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches,
                    max_abs_err=checks_err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t["library_ms"],
                    library=t["library"], timed_shape=t["shape"],
                    max_abs_err_timed_shape=t["max_abs_err"], **extra)

    def worst(rows, key, dtype):
        return max(r[key] for r in rows if r["dtype"] == dtype
                   and r.get("inputs", "rand") == "rand")

    def routed(rows, route, dtype):
        return max(r["max_abs_err"] for r in rows
                   if r["route"] == route and r["dtype"] == dtype)

    def tile_route(rows, kind):
        # the head's other source: fp32, and bf16 that TMA cannot describe
        return dict(tile_source=f"paddle_tpu_torch/csrc/softmax_xent_{kind}"
                                f".cu",
                    max_abs_err_tile_fp32=routed(rows, "tile", "float32"),
                    max_abs_err_tile_bf16=routed(rows, "tile", "bfloat16"),
                    launches_t1024=ll[f"softmax_xent_tile_{kind}"],
                    launches_dryrun=dl[f"softmax_xent_tile_{kind}"])

    sharp_qkv = [r for r in qkv_checks if r["inputs"] == "sharp"]
    sharp_fields = dict(
        sharp_checks=len(sharp_qkv),
        sharp_out_err_over_tol=max(r["out_err_over_tol"] for r in sharp_qkv),
        sharp_dqkv_rel_l2=max(max(r["dqkv_rel_l2"].values())
                              for r in sharp_qkv))

    tl = trained["launches"]
    ll = trained_long["launches"]
    dl = trained_dryrun["launches"]

    def fp32_rows(key):
        # the fp32 path of a packed kernel: row 3 / 4 at T 512 (B 32) and
        # rows 3 / 5 at T 1024 (B 8), the bound and SDPA's kernels (the
        # 3xTF32 bound stays in the report's timing sections)
        return {f"t{t['shape'].split(', ')[1][2:]}": {k: t[k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "device_ms", "library_device_ms", "fwd_plus_bwd_ms",
            "fwd_plus_bwd_device_ms", "library_kernels", "max_abs_err")
            if k in t}
            for t in (fp32_times[key], long_times[key])}
    kernels += [
        entry("flash_qkv_fwd", "flash_attn_sm90.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:276",
              tl["flash_attn_sm90_fwd"], worst(qkv_checks, "max_abs_err",
                                               "float32"),
              launches_wrapper=tl["flash_qkv_fwd"],
              max_abs_err_bf16=worst(qkv_checks, "max_abs_err", "bfloat16"),
              max_abs_err_lse=max(r["max_abs_err_lse"] for r in qkv_checks),
              device_ms=train_times["flash_qkv_fwd"]["device_ms"],
              library_device_ms=train_times["flash_qkv_fwd"][
                  "library_device_ms"],
              fp32_source="paddle_tpu_torch/csrc/flash_attn_fwd.cu",
              launches_t1024=ll["flash_qkv_fwd"], checks=len(qkv_checks),
              launches_dryrun=dl["flash_qkv_fwd"],
              launches_eager_amp_o1=eager_o1["launches"]["sm90_fwd"],
              launches_encoder_amp_o1=enc_o1["launches"]["sm90_fwd"],
              fp32=fp32_rows("flash_qkv_fwd"), **sharp_fields),
        entry("flash_qkv_bwd", "flash_attn_sm90.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:303",
              tl["flash_attn_sm90_bwd"], worst(qkv_checks,
                                               "max_abs_err_dqkv", "float32"),
              launches_wrapper=tl["flash_qkv_bwd"],
              replaces_also="paddle_tpu/ops/pallas/flash_attention.py:442",
              max_abs_err_bf16=worst(qkv_checks, "max_abs_err_dqkv",
                                     "bfloat16"),
              fwd_plus_bwd_ms=train_times["flash_qkv_bwd"][
                  "fwd_plus_bwd_ms"],
              device_ms=train_times["flash_qkv_bwd"]["device_ms"],
              fwd_plus_bwd_device_ms=train_times["flash_qkv_bwd"][
                  "fwd_plus_bwd_device_ms"],
              library_device_ms=train_times["flash_qkv_bwd"][
                  "library_device_ms"],
              fp32_source="paddle_tpu_torch/csrc/flash_attn_bwd.cu",
              launches_t1024=ll["flash_qkv_bwd"], checks=len(qkv_checks),
              launches_dryrun=dl["flash_qkv_bwd"],
              launches_eager_amp_o1=eager_o1["launches"]["sm90_bwd"],
              launches_encoder_amp_o1=enc_o1["launches"]["sm90_bwd"],
              fp32=fp32_rows("flash_qkv_bwd"), **sharp_fields),
        entry("softmax_xent_fwd", "softmax_xent_sm90.cu",
              "paddle_tpu/ops/pallas/softmax_xent.py:48",
              tl["softmax_xent_sm90_fwd"],
              routed(head_checks, "sm90", "bfloat16"),
              launches_wrapper=tl["softmax_xent_fwd"],
              device_ms=train_times["softmax_xent_fwd"]["device_ms"],
              share_of_bound=train_times["softmax_xent_fwd"][
                  "share_of_bound"],
              matmul_ms=train_times["softmax_xent_fwd"]["matmul_ms"],
              checks=len(head_checks), **tile_route(head_checks, "fwd"))]

    def split_entry(name, row, source, replaces, launches, key):
        t = split_times[row]
        worst_fp32 = max(c[key] for c in split_checks
                         if row in c["rows"] and c["dtype"] == "float32")
        worst_bf16 = max(c[key] for c in split_checks
                         if row in c["rows"] and c["dtype"] == "bfloat16")
        return dict(name=name, route="cuda",
                    source=f"paddle_tpu_torch/csrc/{source}",
                    replaces=replaces, row=row, launches=launches,
                    max_abs_err=worst_fp32, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t["library_ms"],
                    library=t["library"], timed_shape=t["shape"],
                    timed=t["kernel"], max_abs_err_bf16=worst_bf16,
                    max_abs_err_timed_shape=t["max_abs_err"],
                    library_kernels=t["library_kernels"],
                    checks=sum(row in c["rows"] for c in split_checks))

    t1024, t8192 = (r["launches"]["modes"] for r in eager_runs)
    fa_py = "paddle_tpu/ops/pallas/flash_attention.py"
    kernels += [
        split_entry("flash_attn_fwd_stream", 2, "flash_attn_fwd.cu",
                    f"{fa_py}:94", t8192["fwd stream"], "max_abs_err"),
        split_entry("flash_attn_bwd_small", 6, "flash_attn_bwd.cu",
                    f"{fa_py}:733", eager["launches"]["modes"]["bwd small"],
                    "max_abs_err_grads"),
        split_entry("flash_attn_bwd_tiled", 7, "flash_attn_bwd.cu",
                    f"{fa_py}:649", t1024["bwd small"], "max_abs_err_grads"),
        split_entry("flash_attn_bwd_dq", 8, "flash_attn_bwd.cu",
                    f"{fa_py}:808", t8192["bwd stream"], "max_abs_err_grads"),
        split_entry("flash_attn_bwd_dkv", 9, "flash_attn_bwd.cu",
                    f"{fa_py}:856", t8192["bwd stream"], "max_abs_err_grads")]
    def timed_entry(name, source, replaces, launches, t, checks_, **extra):
        return dict(name=name, route="cuda",
                    source=f"paddle_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches,
                    max_abs_err=worst(checks_, "max_abs_err", "float32"),
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], library=t["library"],
                    timed_shape=t["shape"],
                    max_abs_err_timed_shape=t["max_abs_err"],
                    max_abs_err_bf16=worst(checks_, "max_abs_err",
                                           "bfloat16"),
                    checks=len(checks_), **extra)

    kernels += [
        dict(timed_entry("softmax_xent_dlogits", "softmax_xent_sm90.cu",
                         "paddle_tpu/ops/pallas/softmax_xent.py:132",
                         tl["softmax_xent_sm90_dlogits"], dlogits_time,
                         dlogits_checks,
                         launches_wrapper=tl["softmax_xent_dlogits"],
                         device_ms=dlogits_time["device_ms"],
                         share_of_bound=dlogits_time["share_of_bound"],
                         ms_per_step=dlogits_time["ms_per_step"],
                         bound_per_step_ms=dlogits_time[
                             "bound_per_step_ms"],
                         **tile_route(dlogits_checks, "dlogits")),
             max_abs_err=routed(dlogits_checks, "sm90", "bfloat16")),
        timed_entry("fused_ln", "fused_ln.cu",
                    "paddle_tpu/ops/pallas/fused_ln.py:55",
                    enc_train["launches"]["fused_ln"], ln_time, ln_checks,
                    ms_p0=ln_time["ms_p0"], device_ms=ln_time["device_ms"],
                    device_ms_p0=ln_time["device_ms_p0"],
                    share_of_bound=ln_time["share_of_bound"],
                    layer_norm_ms=ln_time["layer_norm_ms"],
                    launches_scoring=enc_score["launches"]["fused_ln"],
                    launches_amp_o1=enc_o1["launches"]["fused_ln"],
                    mixed_type_checks=sum(r["dtype"] != r["residual_dtype"]
                                          for r in ln_checks),
                    mask_checks_equal=sum(r["equal"] for r in mask_checks),
                    mask_checks=len(mask_checks)),
        dict(timed_entry("fused_ln_bwd", "fused_ln_bwd.cu",
                         "paddle_tpu/ops/fused_ops.py:62",
                         enc_train["launches"]["fused_ln_bwd"], ln_bwd_time,
                         ln_bwd_checks, tpu_kernel=None,
                         note="the epilogue's backward: the reference's "
                              "_fused_bwd is plain XLA, no Pallas kernel",
                         ms_p0=ln_bwd_time["ms_p0"],
                         device_ms=ln_bwd_time["device_ms"],
                         device_ms_p0=ln_bwd_time["device_ms_p0"],
                         share_of_bound=ln_bwd_time["share_of_bound"],
                         layer_norm_backward_ms=ln_bwd_time[
                             "layer_norm_backward_ms"],
                         launches_amp_o1=enc_o1["launches"]["fused_ln_bwd"],
                         launches_scoring=enc_score["launches"][
                             "fused_ln_bwd"],
                         columns_rel_l2_vs_float64=max(
                             max(r["errors"][k] for k in
                                 ("dbias", "dgamma", "dbeta"))
                             for r in ln_bwd_checks
                             if r["columns_against"] == "float64"),
                         dx_zero_exactly_where_dropped=all(
                             r["dx_zero_exactly_where_dropped"]
                             for r in ln_bwd_checks)),
             max_abs_err=max(r["max_abs_err"] for r in ln_bwd_checks
                             if r["dtype"] == r["residual_dtype"] ==
                             "float32"),
             max_abs_err_bf16=max(r["max_abs_err"] for r in ln_bwd_checks
                                  if r["dtype"] == r["residual_dtype"] ==
                                  "bfloat16"))]
    report = dict(checks=checks, qkv_checks=qkv_checks,
                  fp64_checks=fp64_checks,
                  head_checks=head_checks, dlogits_checks=dlogits_checks,
                  split_checks=split_checks, fused_ln_checks=ln_checks,
                  fused_ln_mask_checks=mask_checks, scoring=score,
                  serving=serve, timing=times, train_timing=train_times,
                  train_long_timing=long_times, train_fp32_timing=fp32_times,
                  train_dryrun=trained_dryrun,
                  split_timing={str(k): v for k, v in split_times.items()},
                  dlogits_timing=dlogits_time, fused_ln_timing=ln_time,
                  train=trained, train_long=trained_long, eager=eager,
                  eager_long=eager_runs, encoder_scoring=enc_score,
                  encoder_train=enc_train, eager_amp_o1=eager_o1,
                  eager_amp_o2=eager_o2, encoder_amp_o1=enc_o1,
                  encoder_amp_o2=enc_o2, fused_ln_bwd_checks=ln_bwd_checks,
                  fused_ln_bwd_timing=ln_bwd_time)
    return report, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write every measurement to PATH")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.ops import _build

    t_start = time.perf_counter()
    log("== phase 1: card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {kind}, count "
        f"{torch.cuda.device_count()}")

    log("== phase 2: build")
    built = _build.build()
    for name, info in built.items():
        log(f"  {name}: {info['seconds']:.2f} s -> {info['path']}")
        info["kernels"] = ptxas_summary(info["report"])
        for k in info["kernels"]:
            log(f"    {k['kernel']}: {k['registers']} registers, spill "
                f"stores {k['spill_stores']} B, loads {k['spill_loads']} B")

    report, kernels = run(torch, "cuda", GPT_WIDTH)
    report.update(card=card, device=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build=built, kernels=kernels,
                  seconds=time.perf_counter() - t_start)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(f"== done in {report['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
