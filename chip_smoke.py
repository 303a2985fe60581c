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
            built head dim, d 16/32/64/80/96/128, and T 4096 at d 64, in
            fp32, bf16 and fp16; bf16 and fp16 at d 64/128 on
            flash_attn_sm90 (each check holds the route, kernel_route,
            and its launch counters), also with sharp inputs;
            split-layout forward with lse and backward T 128 ... 8192 and
            Tq < Tk, every built head dim; the fp32 kernels and the plain
            fp32 versions against float64, causal, T 1024 ... 8192; LM
            head forward and dlogits up to N 4096, V 30528, on both
            routes (bf16 and fp16 on softmax_xent_sm90.cu, fp32 and the
            16-bit types at V 700 on the tile kernels), N and V past the
            sm90 tile, labels 0, V - 1, -1 and V, and fp16 dlogits at g =
            1/65536 (the fp16 step's g/N: every label value a subnormal,
            kept); the fused epilogue at D 64 ... 12800, N 1
            ... 16384, p 0 / 0.1 / 0.5, x and residual of one type or
            mixed (fp32 and bf16), and its dropout mask against the hash
            bit for bit; the epilogue's backward kernel at D 64 ... 4096
            (and 12800), N 1 ... 16384, the same types and p: dx, dres by
            their type's grads atol, the column sums in fp32 against a
            float64 run of the plain backward, dx exactly 0 where the
            forward dropped); the fused optimizer update
            (multi_tensor_update.cu) for every kind of UPDATE_CHECKS (the
            twelve optimizers, Momentum with and without Nesterov,
            RMSProp centered and not, Ftrl at lr_power -0.5 and -0.7,
            LarsMomentum excluding names, AdamW's decay function
            rejecting some) in five type setups (fp32, bf16 and fp16
            over fp32 masters, bf16 and fp16 alone), three steps on the
            GPT's 149 parameter shapes and numel 1, 3, 1023 (zeros) and
            2^20 + 5, with L1 and L2 regularizers and lr scales on some
            tensors: parameters, slots, powers and masters against the
            plain version, 16-bit values by steps of their type and share
            of the move, a check that must fail two planted mutations of
            the plain version (the parameter's store skipped, the rate
            halved).  fp16 (on flash_attn_sm90 at d 64/128, the tile
            kernels elsewhere): attention at every shape and head dim
            above in fp16, forward with lse and backward, and with raw
            scores past fp16's range (q, k ~ 60·N(0, 1));
            the epilogue and its backward on fp16 x and residual, and fp16
            beside fp32 each way, fp16 or fp32 parameters; the unscale
            pass (mt_unscale) on the GPT's 149 gradient shapes and numel
            1, 3, 2^20 + 5 in fp32, bf16 and fp16, with no non-finite
            value and with an inf or nan planted at the first, a middle
            and the last element (bit for bit, found_inf exact); the
            update's skip flag for every kind and setup of UPDATE_CHECKS
            (set: nothing moves; clear: the step without the flag, bit for
            bit), kernel and plain version
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
            (torch.profiler), with the share of the bound; rows 3, 4, 10
            and 11 again in fp16 at the compiled step's shapes, and rows
            3 and 5 in fp16 and in bf16 at B 8, T 1024; and
            optimizer.step() at the GPT's full width for each optimizer
            of phase 13a, fp32 and decorated (bf16 over fp32 masters):
            the update kernel, its plain version, the per-leaf path
            (FLAGS_fused_optimizer=0) and, for Adam and AdamW in fp32,
            torch._fused_adam(w)_, beside the bytes bound (one pass;
            LarsMomentum and Lamb also at the kernel's two passes).  fp16
            and bf16: rows 1, 2 and 6-9 at those shapes, all on
            flash_attn_sm90 (rows 1 and 6 also in device time), and SDPA
            in each type; row 12 and its backward
            at N 16384, D 768 in fp16 and fp16 x over an fp32 residual;
            the unscale pass on the GPT's gradients (events, a replayed
            graph, the plain version, and
            torch._amp_foreach_non_finite_check_and_unscale_ in events and
            a replayed graph, the two graphs in alternating rounds)
            against its bytes bound
7. train    the flagship train step at full width (B 128, T 512, bf16,
            remat "ctx"): one step through the kernels (12 + 12 attention
            launches, all of them flash_attn_sm90's, the fused head's
            forward and 16 dlogits launches, all softmax_xent_sm90's)
            against the
            same step with the plain versions swapped in, every gradient
            finite; two runs of two
            steps repeat bit for bit; the loss falls over 12 steps on one
            batch; step ms, seq/s, MFU and peak memory.  Then the same in
            fp16 (compute_dtype=float16, no loss scaling, as the
            reference), and one step each under remat "ctx_ffn" and
            "dots" (bf16) held bit for bit to the "ctx" step, with their
            attention launches (12 + 12; "dots" 24 + 12), peak memory and
            step ms
8. train    T 1024 at reduced depth (L 2, B 8, fp32, remat "full"): one
   long     step through the kernels (2 dlogits launches, the head on
            the tile kernels) against the
            plain versions; the same in fp16 (row 5 on flash_attn_sm90,
            the head on softmax_xent_sm90); the same for the reference's
            dryrun model
            (V 128, hidden 32, 2 heads: head dim 16, L 4, B 4, T 16)
9. eager    Model(GPT).prepare(AdamW, CrossEntropyLoss).train_batch at
            full width (B 32, T 512, fp32): one step through the kernels
            (12 + 12 launches, mode "small", row 6) against the plain
            versions; 3 steps with jit=True (captured in a CUDA graph,
            replayed) against jit=False from the same state and seeds, bit
            for bit, and a second captured run repeating bit for bit, with
            12 + 12 launches counted in a replay and the optimizer's step
            on the update kernel (one update launch per type setup and
            the passes its kind adds); the loss falls over 12
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
12. fit     Model.fit at that GPT width as BERT-style fine-tuning runs it
            (AdamW under LinearWarmup(PolynomialDecay(1e-4, 40), 4, 0,
            1e-4), weight decay 0.01, ClipGradByGlobalNorm(1.0),
            Accuracy): 136 sequences of T 512 from seed 0 in shuffled
            batches of 32 (the last of 8), 2 epochs, eval_data 40 more,
            verbose=0, prefetch_to_device=2, captured; fp32, then AMP O1.
            Bit for bit equal to a hand loop of captured train_batch over
            the same batches, to prefetch_to_device=0, to jit=False, and
            to the runs without the metric (one with no prefetch); the
            second epoch captures nothing and, without the metric, runs no
            synchronising call (torch.cuda.set_sync_debug_mode("error"));
            every replayed step launches 12 + 12 attention kernels and
            AdamW's update once (and its powers' advance);
            evaluate equals an eval_batch loop.  Step ms p50 of each run
            (with and without prefetch and metric), the hand loop's, the
            idle share of fit (profile_train.profile), the graphs' pools
            (the partial batch's too) and peak memory.  Then the fused
            encoder under O1 for one epoch with eval_data: equal to its
            hand loop and to jit=False, 24 + 24 epilogue, 12 + 12
            attention and one update launch a replayed step
13. optim-  13a: phase 9's GPT under AMP O1, captured, once with each
    izers   optimizer of OPTIMIZERS (Momentum with Nesterov and L2Decay,
            LarsMomentum, Adamax, Adagrad, Adadelta, centered RMSProp with
            momentum, Lamb, Ftrl, DecayedAdagrad, SGD with L1Decay, Adam
            with lazy_mode, and AdamW through amp.decorate O2: bf16
            parameters, fp32 masters): one step through the kernels,
            counted, 3 captured steps against 3 uncaptured bit for bit
            (parameters, every slot and master), a second captured run
            repeating them and going on to 12 steps (the loss falls; step
            ms p50 of the last 10), 12 + 12 flash_attn_sm90 launches and
            the update kernel's launches a replay, and optimizer.step()'s
            device time alone, through the kernel and per leaf
            (FLAGS_fused_optimizer=0), beside its bound (the bytes it
            moves over 3.35 TB/s).  13b: phase
            11's encoder trained with LAMB on bf16 parameters over fp32
            masters (amp.decorate O2, prepare(amp_configs="O2")): every
            parameter bf16 and equal to its master cast to bf16 after
            every step, kernels against plain at the O1 tolerances,
            captured = uncaptured, 24 + 24 epilogue and 12 + 12 attention
            launches a replay, the loss falling; step ms p50 and peak
            memory beside the same model undecorated (fp32 parameters,
            bf16 views) and phase 11's O1 run
14. fp16    AMP in fp16 (PR 13): phase 9's GPT at full width under
            prepare(amp_configs={"level": "O1", "dtype": "float16"}),
            AdamW: one step through the kernels against the plain
            versions, 3 captured steps against 3 uncaptured bit for bit
            (parameters, slots, the scale, good and bad counts), 12 + 12
            attention launches a replay, all on flash_attn_sm90, one
            unscale and one update launch, the loss falling over 12 steps
            of each engine; step ms p50, seq/s, peak memory beside phase
            9's bf16 O1.  A planted overflow (initial scale 2^40): that
            step, and a replay planted the same way, move no parameter,
            slot or power, the scale falls by 2^-30, the next steps
            update.  Phase 11's encoder under fp16 O1 (24 + 24 epilogue
            launches a replay on fp16 x, captured = uncaptured, the loss
            falls), O2 at L 2 through amp.decorate(level="O2",
            dtype="float16") (fp16 parameters equal to their fp32 masters
            cast after every step), and one eager GradScaler loop of 3
            steps on the GPT
15. remat,  the budget remat (FLAGS_program_remat, FLAGS_remat_budget_mb
    offload set through set_flags): phase 9's GPT and phase 11's dropout
            encoder under AMP O1, 3 captured steps each with and without
            it, bit for bit (parameters and slots), a replayed remat step
            launching each forward kernel twice (attention rows 1, the
            epilogue row 12) and each backward once, the reference's
            warning; step ms p50 over 10 steps, peak memory and graph
            pool beside the run without it.  Optimizer-state offload
            (prepare(offload=True)): that GPT with AdamW, 3 captured steps
            bit for bit those of offload=False, every slot pinned host
            memory (cudaPointerGetAttributes), a replayed step launching
            the update pass once per stage of the staged route, step ms,
            peak memory, optimizer.step()'s device time on both routes
            (staged, in place) against the bound of the pinned 1 GiB copy
            rates measured each way and both at once; LAMB on the
            decorated O2 encoder at L 2 (slots pinned, masters on the
            card) and build_spmd_train_step(offload=True) at L 2, each bit
            for bit against offload=False; the seconds the phase took
16. fit     Model.fit's fault-tolerance hooks on the O1 GPT at full width
    hooks   (AdamW, constant lr, B 32, T 512): a run resumed from an
            AsyncCheckpointer (distributed/checkpoint.py) after 6 of 12
            steps equal to the uninterrupted run bit for bit (losses,
            parameters, slots, step count), the replayed batches
            untrained, the newest tree verified; FLAGS_anomaly_action
            skip with step.loss poisoned at step 4 equal to a hand loop
            that reverts that step, raise naming the step, rollback to
            the newest committed step; the guard on an offloaded
            optimizer keeping its pinned slots; step ms p50 without hooks,
            with a checkpointer (saving and not), with the guard
            (offloaded too), save()'s host time, the write's seconds and
            GB/s, the manifest's, verify's and restore's seconds

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  With ``--json PATH`` everything
measured is also written to PATH.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
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
ATOL = {"float32": 2e-5, "bfloat16": 3e-2,   # tests/test_pallas_kernels.py
        # fp16: the reference states none; bf16's, narrowed for fp16's
        # three more mantissa bits (tests/test_torch_fp16_kernels.py)
        "float16": 1e-2}
# bf16 with a sharp softmax: q, k ~ 2·N(0, 1) and v ~ N(0, 1), so the
# output spreads over several units and a flattened softmax (every row
# near v's mean) misses it by more than 1.  Held to two bf16 ulps of the
# output: |err| <= 1.6e-2 + 1.6e-2·|ref|.  The reference rounds p to bf16
# before its product, the kernel does not, so the two differ by about an
# ulp where |out| > 2
SHARP_SHAPES = [(32, 32), (512, 512)]
SHARP_TOL, SHARP_MIN_STD = 1.6e-2, 0.5
# fp16 with raw scores past fp16's range (65504): q, k ~ 60·N(0, 1) and v,
# dO ~ N(0, 1) in fp16, so q·k reaches ~1e5 (std 28800 at d 64), which
# only the fp32 accumulators hold, and each softmax row is all but one-hot.
# The two versions sum products of ~3600 in another order (fp32 ulp 0.0078
# at 1e5), so a scaled score differs by up to ~0.01: lse is held to
# FP16_RANGE_LSE_RTOL of the largest |lse| (the scores' scale; measured on
# the H100 1.46e-2 at a largest lse of ~1.6e4, 0.9e-6 of it), the output
# to ATOL's fp16 atol.  The gradients are ill-conditioned there: where a
# row's two best keys nearly tie, dS is of order one and moves with the
# score's last bits, and measured against the plain version they differed
# by up to 6.3e-2 relative L2.  So each of dq, dk, dv is held, with the
# plain fp16 version, against a float64 run of the same inputs: its
# relative L2 error at most FP16_RANGE_GRAD_RATIO times the plain
# version's plus FP16_RANGE_GRAD_SLACK; every value finite
FP16_RANGE_SCALE, FP16_RANGE_LSE_RTOL = 60.0, 4e-6
FP16_RANGE_GRAD_RATIO, FP16_RANGE_GRAD_SLACK = 2.0, 1e-3
FP16_RANGE_SHAPES = ((512, 512), (128, 256), (1000, 1000))
SCORING_ATOL = 1e-3
SLOTS, NEW_TOKENS, CLIENTS, REQUESTS, SAMPLED = 8, 64, 4, 16, 4

# packed attention (rows 3/4/5): every length from 128 to 2048 and one
# ragged one, each head dim, causal and not, fp32 and bf16; T 4096 at d 64,
# past the reference's packed kernels, which the port's take
QKV_TS = (100, 128, 256, 512, 1024, 2048)
QKV_LONG = ((4096, 64),)
GRAD_ATOL = {"float32": 5e-5, "bfloat16": 5e-2,  # test_pallas_kernels.py
             "float16": 2e-2}                       # as ATOL's fp16
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
# fp16: the same fp32 sums (1e-4 is bf16's, 0.0128 of a bf16 step at 1;
# fp16's, no looser by that ratio, would be 1.25e-5)
HEAD_ATOL = {"float32": 1e-5, "bfloat16": 1e-4, "float16": 1e-5}

# the train path (bench.py:119-124): BERT-base GPT, B 128, T 512, bf16
TRAIN = dict(width=dict(vocab_size=30528, hidden_size=768, num_layers=12,
                        num_heads=12, max_seq_len=512),
             batch=128, seq=512, dtype="bfloat16", remat="ctx")
# the same step in fp16 (the reference's compute_dtype=float16: no
# loss scaling, so the head's dlogits (p - 1)·g/N at g/N = 1/65536 are fp16
# subnormals, and every other gradient of the trunk is near fp16's range's
# foot); and the two remat policies besides "ctx", in bf16
TRAIN_FP16 = dict(TRAIN, dtype="float16")
REMAT_POLICIES, REMAT_TIMED = ("ctx_ffn", "dots"), 5
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
# row 5 in fp16 (phase 8): the same shape through the Hopper kernels
TRAIN_LONG_FP16 = dict(TRAIN_LONG, dtype="float16")
# rows 3 and 5 in bf16 at that shape (phase 6 times them beside fp16's)
TRAIN_LONG_BF16 = dict(TRAIN_LONG, dtype="bfloat16")
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
# through 12 blocks.  fp16 (phase 14's O1 GPT and encoder, O2 at L 2):
# measured on an H100 at most 9.2e-8 relative in the loss and 6.2e-3
# relative L2 in a gradient (O2's fp16 wte); the limits keep ~2.4x of
# headroom on the gradients and stay inside bf16's, so a step whose
# attention ran in bf16 (~6e-3 to 1.6e-2 against its own plain version)
# can fail them.
TRAIN_LOSS_RTOL = {"bfloat16": 1e-3, "float16": 1e-5, "float32": 1e-4}
TRAIN_GRAD_RTOL = {"bfloat16": 5e-2, "float16": 1.5e-2,   # relative L2
                   "float32": 1e-4}
TRAIN_GRADS = ("blocks.qkv_w", "head_w", "wte")
# the compiled step in fp16 has no loss scaling (as the reference's): g/N
# is 1/65536 at B 128, T 512, the head's dlogits are fp16 subnormals
# ((p - 1)·g/N at the label, 0 elsewhere), and the trunk's gradients
# (~1e-7 and less) lie at fp16's subnormal foot, a few steps of 2^-24
# each, where the two versions' last-bit differences are whole steps: on
# an H100 they differ by 0.77 (qkv_w) and 0.86 (wte) relative L2 while
# the losses agree exactly.  So the unscaled step holds the head's
# gradient alone (it reads the subnormal dlogits in fp32), and the same
# backward is held again with the loss gradient scaled by the step's
# token count N (g/N = 1, every gradient normal in fp16), every name of
# TRAIN_GRADS at fp16's TRAIN_GRAD_RTOL
FP16_UNSCALED_HELD = ("head_w",)
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
FUSED_LN_BWD_COL_RTOL = {"float32": 1e-5, "bfloat16": 5e-2,
                         "float16": 1e-2}
# the head's dlogits (row 11): fp32 atol 1e-5 (tests/test_pallas_kernels.py
# :322); bf16 each element within 1e-6·|g| plus one bf16 ulp of the plain
# value (both round fp32 values whose products summed in another order; at
# the label p - 1 cancels).  A typical element, |g|/V, is 30 times that
# atol at V 30528, so a wrong softmax term fails
DLOGITS_G, DLOGITS_ATOL, DLOGITS_BF16_ATOL_PER_G = 2.0, 1e-5, 1e-6
# fp16 (rows 10 and 11 in fp16) as bf16, one fp16 step; and g =
# 1/65536, the full-width step's g/N, where the label column's (p - 1)·g
# is an fp16 subnormal (~1.5e-5 against fp16's smallest normal 6.1e-5)
# that the kernel's cast must keep, not flush to 0
DLOGITS_SUBNORMAL_G = 2.0 ** -16
DLOGITS_SUBNORMAL_SHAPES = ((4096, 768, 30528), (256, 64, 700))
# the encoder path (phase 11): profile_train.ENCODER, BERT-base
# (bert-base-uncased) at the flagship vocabulary (bench.py:1027-1029),
# built by profile_train.build_encoder
ENCODER_SCORE_BATCH, ENCODER_BATCH = 8, 32          # T = max_len, 512
# phases 9 and 11 under AMP: O1 at full width, O2 at this depth
AMP_O2_LAYERS = 2
# phase 12: Model.fit on the eager GPT (and the encoder) at full width,
# 136 train sequences (4 batches of 32 and one of 8), 40 to evaluate (32
# and 8); profile_train.profile over epochs of profile_steps full batches
FIT = dict(width=GPT_WIDTH, batch=32, seq=512, train=136, eval=40,
           profile_steps=4)
# and under AMP O1 in fp16 (the default loss scaling), one epoch with the
# gradients of two batches summed before each update
FIT_FP16 = {"level": "O1", "dtype": "float16"}
FIT_ACCUMULATE = 2
# the fused optimizer update (ops/multi_tensor_update.py), phase 3: every
# kind of the kernel and its variants, (label, make(optimizer module,
# regularizer module, parameters)); update_params gives every third tensor
# an L1Decay and the next an L2Decay of its own, every fourth an lr scale
# of 0.5.  LarsMomentum excludes the GPT's biases and LayerNorms, AdamW's
# decay function rejects the biases
UPDATE_CHECKS = (
    ("SGD", lambda o, r, P: o.SGD(0.05, parameters=P)),
    ("Momentum", lambda o, r, P: o.Momentum(0.01, 0.9, P)),
    ("Momentum Nesterov", lambda o, r, P: o.Momentum(0.01, 0.9, P,
                                                     use_nesterov=True)),
    ("LarsMomentum", lambda o, r, P: o.LarsMomentum(
        0.1, parameters=P, exclude_from_weight_decay=["bias", "ln"])),
    ("Adam", lambda o, r, P: o.Adam(1e-3, parameters=P)),
    ("AdamW", lambda o, r, P: o.AdamW(
        1e-3, parameters=P, weight_decay=0.01,
        apply_decay_param_fun=lambda n: "bias" not in n)),
    ("Adamax", lambda o, r, P: o.Adamax(1e-3, parameters=P)),
    ("Adagrad", lambda o, r, P: o.Adagrad(0.01, parameters=P,
                                          initial_accumulator_value=0.1)),
    ("Adadelta", lambda o, r, P: o.Adadelta(1.0, parameters=P)),
    ("RMSProp", lambda o, r, P: o.RMSProp(1e-3, parameters=P)),
    ("RMSProp centered", lambda o, r, P: o.RMSProp(
        1e-3, parameters=P, centered=True, momentum=0.9)),
    ("Lamb", lambda o, r, P: o.Lamb(1e-2, parameters=P)),
    ("Ftrl", lambda o, r, P: o.Ftrl(1e-2, l1=1e-4, l2=1e-4, parameters=P)),
    ("Ftrl lr_power -0.7", lambda o, r, P: o.Ftrl(
        1e-2, l1=1e-4, l2=1e-4, lr_power=-0.7, parameters=P)),
    ("DecayedAdagrad", lambda o, r, P: o.DecayedAdagrad(2e-4,
                                                        parameters=P)))
# fp32 parameters; bf16 over fp32 masters (amp.decorate's
# multi_precision); bf16 without masters (bf16 slots); the same in fp16
UPDATE_SETUPS = ("fp32", "bf16 master", "bf16", "fp16 master", "fp16")
# beside the GPT's 149 parameters: one element, a scalar tail, a tensor of
# zeros (the trust ratios' "a norm is 0" branch) and one past 2^20
UPDATE_EXTRA = (("numel_1", (1,)), ("numel_3", (3,)), ("zero_1023", (1023,)),
                ("numel_1048581", (2 ** 20 + 5,)))
UPDATE_STEPS = 3
# fp32 values (parameters, slots, powers, masters): the tolerances of
# tests/test_torch_optimizers.py; the kernel and its plain version run the
# same fp32 operations and differ only where a norm sums in another order
# or powf rounds otherwise.  16-bit values (bf16 and fp16 parameters and
# slots): at most UPDATE_PAST_SHARE of a run's 16-bit elements more than
# one step of their type apart (at max(|kernel|, |plain|)), and none
# further than one step plus UPDATE_REL of the largest move in its tensor
# (|plain - before| over the three steps).  Both round once from fp32
# values that differ in their last bits (Lamb's and LarsMomentum's
# norms), so a value may round across a boundary (one step); the next
# step carries that on, and where w - lr·trust·r, or LarsMomentum's
# velocity, cancels to a value far under its terms, one step of a term is
# many of the result but a small share of the tensor's move.  A kernel
# that skips the parameter's store or halves the rate fails this: phase 3
# plants both mutations in the plain version and requires the check to
# fail them.  Measured at the GPT's shapes (H100 80GB HBM3, 700 W): the
# kernel puts at most 3.41e-6 of the elements past one step (LarsMomentum
# in bf16; Lamb 1.6e-7, every other kind none), by at most 0.0026 of the
# tensor's move (Lamb); the mutations put 0.0142-0.923 past one step
UPDATE_ATOL, UPDATE_RTOL = 1e-6, 1e-5
UPDATE_PAST_SHARE, UPDATE_REL = 1e-4, 2.0 ** -6


# the run's start (main() sets it): each "== phase" line carries the
# seconds since, so a slow run shows which phase took the time
_RUN_START = []


def log(msg: str = ""):
    if msg.startswith("== ") and _RUN_START:
        msg += f"  [{time.perf_counter() - _RUN_START[0]:.1f} s]"
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
_MANGLED_TYPES = (("13__nv_bfloat16", "bf16"), ("6__half", "fp16"),
                  ("f", "fp32"))


def _template_args(rest: str):
    """The template arguments at the start of a mangled name's tail
    (``I...E``): fp32, bf16, fp16 and integers, a substitution (``S1_``)
    read as the type before it."""
    if not rest.startswith("I"):
        return []
    out, i = [], 1
    while i < len(rest) and rest[i] not in "E":
        m = re.match(r"Li(\d+)E|K?(S\d*_)", rest[i:])
        if m:
            if m.group(1):
                out.append(m.group(1))
            elif out:
                out.append(out[-1])
            i += m.end()
            continue
        for code, name in _MANGLED_TYPES:
            if rest.startswith(code, i):
                out.append(name)
                i += len(code)
                break
        else:
            break
    return out


def ptxas_summary(report: str):
    """Each kernel of one ``nvcc -Xptxas -v`` report: a short name (the
    kernel and its integer template arguments), registers, spill bytes."""
    out, name, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d((?:ln_bwd|ln_fwd|fused_ln)_[a-z]+)(?=[IE])|"
                          r"([a-z_]*kernel[a-z0-9_]*)", m.group(1))
            args = _template_args(m.group(1)[k.end():]) if k else []
            name = (k.group(1) or k.group(2) if k else m.group(1)) + (
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
def _fp16_range(torch, gen, dev, shape, k_shape):
    """q (``shape``) and k, v (``k_shape``) in fp16 whose raw scores pass
    fp16's range (FP16_RANGE_SCALE), v ~ N(0, 1); raises if no score
    does."""
    q, k = (FP16_RANGE_SCALE * torch.randn(sh, generator=gen, device=dev)
            for sh in (shape, k_shape))
    v = torch.randn(k_shape, generator=gen, device=dev).half()
    q, k = q.half(), k.half()
    raw = torch.einsum("...qhd,...khd->...hqk" if q.dim() == 4 else
                       "bqd,bkd->bqk", q.float(), k.float()).abs().max()
    if raw.item() <= 65504:
        raise AssertionError(f"fp16-range inputs reach only {raw.item()}")
    return q, k, v


def _route(fa, dtype, *operands):
    """The library an attention launch on ``operands`` takes
    (``fa.kernel_route``) and the flash_attn_sm90 launches (forward,
    backward) counted so far; :func:`_routed_ok` holds a call to them."""
    ops = [fa._as_bshd(x) for x in operands]
    return (fa.kernel_route(dtype, ops[0].shape[-1], *ops),
            fa.SM90_FWD_LAUNCHES, fa.SM90_BWD_LAUNCHES)


def _routed_ok(fa, route, bwd=True):
    """Whether the calls since ``route = _route(...)`` launched
    flash_attn_sm90 once a direction (forward, and the backward if
    ``bwd``) where the route is "sm90", and never where it is "tile"."""
    name, fwd0, bwd0 = route
    want = int(name == "sm90")
    return (fa.SM90_FWD_LAUNCHES - fwd0 == want
            and fa.SM90_BWD_LAUNCHES - bwd0 == (want if bwd else 0))


def check_kernels(torch, fa, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    types = (torch.float32, torch.bfloat16, torch.float16)
    cases = [(96, tq, tk, 64, causal, dtype)
             for tq, tk in KERNEL_SHAPES for causal in (False, True)
             for dtype in types]
    cases += [(96, 128, 128, d, True, dtype) for d in fa.HEAD_DIMS
              if d != 64 for dtype in types]
    cases = [c + ("rand",) for c in cases] + [
        (96, tq, tk, 64, causal, torch.bfloat16, "sharp")
        for tq, tk in SHARP_SHAPES for causal in (False, True)] + [
        (96, tq, tk, d, causal, torch.float16, "fp16_range")
        for tq, tk in FP16_RANGE_SHAPES[:2] for d in (64, 128)
        for causal in (False, True)]
    results = []
    for bh, tq, tk, d, causal, dtype, inputs in cases:
        if inputs == "rand":
            q, k, v = (torch.rand((bh, t, d), generator=gen, device=dev)
                       .to(dtype) for t in (tq, tk, tk))
        elif inputs == "fp16_range":
            q, k, v = _fp16_range(torch, gen, dev, (bh, tq, d), (bh, tk, d))
        else:
            q, k, v = (torch.randn((bh, t, d), generator=gen, device=dev)
                       .mul(s).to(dtype)
                       for t, s in ((tq, 2.0), (tk, 2.0), (tk, 1.0)))
        route = _route(fa, dtype, q, k, v)
        out = fa.flash_attn_fwd(q, k, v, causal=causal)
        routed = _routed_ok(fa, route, bwd=False)
        ref = fa.flash_attention_ref(q, k, v, causal=causal)
        sync(torch, dev)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        name = str(dtype).replace("torch.", "")
        ok = out.dtype == dtype and out.shape == q.shape and routed
        if inputs == "rand":
            tol = f"atol={ATOL[name]:.0e}"
            ok = ok and err <= ATOL[name]
        elif inputs == "fp16_range":
            tol = f"atol={ATOL[name]:.0e}, raw scores past 65504"
            ok = ok and err <= ATOL[name] and bool(torch.isfinite(out).all())
        else:
            spread = ref.float().std().item()
            worst = (diff / (SHARP_TOL + SHARP_TOL * ref.float().abs())
                     ).max().item()
            tol = (f"err/({SHARP_TOL:.1e}+{SHARP_TOL:.1e}|ref|)={worst:.3f} "
                   f"ref_std={spread:.3f}")
            ok = ok and worst <= 1.0 and spread >= SHARP_MIN_STD
        results.append(dict(bh=bh, tq=tq, tk=tk, d=d, causal=causal,
                            dtype=name, inputs=inputs, route=route[0],
                            routed=routed, max_abs_err=err, tolerance=tol,
                            ok=ok))
        log(f"  flash_attn_fwd bh={bh} tq={tq} tk={tk} d={d} "
            f"causal={int(causal)} {name:8s} {inputs:5s} {route[0]:4s} "
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
    route = (fq._fa.kernel_route(dtype, d, *fq._views(qkv, H)),
             fq._fa.SM90_FWD_LAUNCHES, fq._fa.SM90_BWD_LAUNCHES)
    out, lse = fq.flash_qkv_fwd(qkv, H, causal=causal)
    dqkv = fq.flash_qkv_bwd(qkv, out, lse, g, H, causal=causal)
    routed = _routed_ok(fq._fa, route)
    ref, ref_lse = fq.flash_qkv_fwd_ref(qkv, H, causal=causal)
    ref_d = fq.flash_qkv_bwd_ref(qkv, ref, ref_lse, g, H, causal=causal)
    sync(torch, dev)
    name = str(dtype).replace("torch.", "")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    err_d = (dqkv.float() - ref_d.float()).abs().max().item()
    ok = (out.dtype == dtype and dqkv.shape == qkv.shape
          and err_lse <= LSE_ATOL and routed)
    r = dict(b=2, t=T, h=H, d=d, causal=causal, dtype=name, inputs=inputs,
             route=route[0], routed=routed, max_abs_err=err,
             max_abs_err_lse=err_lse, max_abs_err_dqkv=err_d)
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
        f"{name:8s} {inputs:5s} {route[0]:4s} out {err:.2e} lse "
        f"{err_lse:.2e} dqkv {err_d:.2e}; {tol} {'ok' if ok else 'FAIL'}")
    return r


def check_qkv_kernels(torch, fq, dev):
    """Rows 3/4/5: forward, lse and dqkv against the plain versions; bf16
    and fp16 at d 64 and 128 run on flash_attn_sm90, the rest on the tile
    kernels (each check holds its route and the SM90 launches it took).
    The fp16 cases (the compiled step's) come after the fp32 and bf16
    ones, so those draw the inputs they drew before."""
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = [(T, d) for T in QKV_TS for d in fq.HEAD_DIMS] + list(QKV_LONG)
    cases = [(T, d, causal, dtype, "rand") for T, d in shapes
             for causal in (False, True)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(T, d, causal, torch.bfloat16, "sharp") for T, d in SHARP_QKV
              for causal in (False, True)]
    cases += [(T, d, causal, torch.float16, "rand") for T, d in shapes
              for causal in (False, True)]
    cases += [(T, d, causal, torch.float16, "sharp") for T, d in SHARP_QKV
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
    """Row 10 on both routes: lse and at against the plain version, fp32,
    bf16 and fp16 (the 16-bit types on softmax_xent_sm90.cu where TMA
    can describe their rows)."""
    import numpy as np
    rs = np.random.RandomState(4)
    results = []
    for N, D, V in HEAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
    (B, S, H, D) operands against their plain versions, fp32, bf16 and
    fp16; then fp16 with scores past fp16's range (:func:`_fp16_range`)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    results = []
    for tq, tk in SPLIT_SHAPES:
        B, H = (2, 2) if max(tq, tk) <= 2048 else (1, 2)
        for d in fa.HEAD_DIMS:
            for causal in (False, True):
                for dtype in (torch.float32, torch.bfloat16,
                              torch.float16):
                    q, k, v, g = _split_operands(torch, gen, dev, B, tq, tk,
                                                 H, d, dtype)
                    route = _route(fa, dtype, q, k, v)
                    out, lse = fa.flash_attn_fwd(q, k, v, causal=causal,
                                                 return_lse=True)
                    grads = fa.flash_attn_bwd(q, k, v, out, lse, g,
                                              causal=causal)
                    routed = _routed_ok(fa, route)
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
                          and err_g <= GRAD_ATOL[name] and routed)
                    results.append(dict(b=B, tq=tq, tk=tk, h=H, d=d,
                                        causal=causal, dtype=name, mode=mode,
                                        rows=rows, route=route[0],
                                        routed=routed, max_abs_err=err,
                                        max_abs_err_lse=err_lse,
                                        max_abs_err_grads=err_g, ok=ok))
                    log(f"  flash_attn tq={tq:4d} tk={tk:4d} d={d:3d} "
                        f"causal={int(causal)} {name:8s} {mode:6s} "
                        f"{route[0]:4s} rows {rows} out {err:.2e} (atol "
                        f"{ATOL[name]:.0e}) lse "
                        f"{err_lse:.2e} (atol {SPLIT_LSE_ATOL:.0e}) dq/dk/dv "
                        f"{err_g:.2e} (atol {GRAD_ATOL[name]:.0e}) "
                        f"{'ok' if ok else 'FAIL'}")
                    del q, k, v, g, out, lse, grads, ref, ref_lse, ref_g
    results += check_fp16_range(torch, fa, dev, gen)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} split-layout attention checks "
                             f"disagree with the plain versions: {bad}")
    return results


def check_fp16_range(torch, fa, dev, gen):
    """fp16 forward with lse and backward whose raw scores pass fp16's
    range (:func:`_fp16_range`), (B 2, H 2), d 64 and 128, causal and not:
    each result finite, out within ATOL of the plain version (fp16), lse
    within FP16_RANGE_LSE_RTOL of its largest value, dq, dk, dv as close to
    a float64 run as FP16_RANGE_GRAD_RATIO times the plain version's."""
    results = []
    for tq, tk in FP16_RANGE_SHAPES:
        for d in (64, 128):
            for causal in (False, True):
                q, k, v = _fp16_range(torch, gen, dev, (2, tq, 2, d),
                                      (2, tk, 2, d))
                g = torch.randn((2, tq, 2, d), generator=gen,
                                device=dev).half()
                route = _route(fa, torch.float16, q, k, v)
                out, lse = fa.flash_attn_fwd(q, k, v, causal=causal,
                                             return_lse=True)
                grads = fa.flash_attn_bwd(q, k, v, out, lse, g, causal=causal)
                routed = _routed_ok(fa, route)
                ref, ref_lse = fa.flash_attn_fwd_ref(q, k, v, causal=causal,
                                                     return_lse=True)
                ref_g = fa.flash_attn_bwd_ref(q, k, v, ref, ref_lse, g,
                                              causal=causal)
                sync(torch, dev)
                rel = {n: (a.float() - b.float()).abs().max().item()
                       for n, a, b in zip(("out", "dq", "dk", "dv"),
                                          (out,) + tuple(grads),
                                          (ref,) + tuple(ref_g))}
                err_lse = ((lse - ref_lse).abs().max()
                           / ref_lse.abs().max()).item()
                _, _, truth = _attention_fp64(torch, fa, q, k, v, g, causal)
                rel_l2 = {n: (_rel_l2(fa._fold(a).double(), t),
                              _rel_l2(fa._fold(b).double(), t))
                          for n, a, b, t in zip(("dq", "dk", "dv"), grads,
                                                ref_g, truth)}
                del truth
                finite = all(bool(torch.isfinite(t).all())
                             for t in (out, lse) + tuple(grads))
                mode = fa._pallas_mode(tq, tk, causal)
                rows = (fa.reference_rows("fwd", mode, tk)
                        + fa.reference_rows("bwd", mode, tk))
                grad_abs = max(rel["dq"], rel["dk"], rel["dv"])
                ok = finite and routed and \
                    err_lse <= FP16_RANGE_LSE_RTOL and \
                    rel["out"] <= ATOL["float16"] and all(
                        kern <= FP16_RANGE_GRAD_RATIO * plain
                        + FP16_RANGE_GRAD_SLACK
                        for kern, plain in rel_l2.values())
                results.append(dict(
                    b=2, tq=tq, tk=tk, h=2, d=d, causal=causal,
                    dtype="float16", inputs="fp16_range", mode=mode,
                    rows=rows, route=route[0], routed=routed, errors=rel,
                    rel_l2=rel_l2,
                    max_abs_err=rel["out"],
                    max_abs_err_lse=err_lse, max_abs_err_grads=grad_abs,
                    finite=finite, ok=ok))
                log(f"  flash_attn fp16 past its range tq={tq:4d} tk={tk:4d} "
                    f"d={d:3d} causal={int(causal)} {route[0]} rows {rows}: "
                    f"max abs "
                    f"{', '.join(f'{n} {x:.2e}' for n, x in rel.items())} "
                    f"(atol out {ATOL['float16']:.0e}); rel L2 to float64 "
                    f"kernel / plain "
                    f"{', '.join(f'{n} {a:.2e} / {b:.2e}' for n, (a, b) in rel_l2.items())}"
                    f" (limit {FP16_RANGE_GRAD_RATIO:g} x plain + "
                    f"{FP16_RANGE_GRAD_SLACK:.0e}), lse {err_lse:.2e} of its "
                    f"largest (limit {FP16_RANGE_LSE_RTOL:.0e}), finite "
                    f"{finite} {'ok' if ok else 'FAIL'}")
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


def _fp16_step(torch, t):
    """One fp16 step at each value of the fp32 tensor ``t``: 2^-24 (the
    subnormal spacing) below fp16's smallest normal, 0 included."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -14)))
                      - 10)


def _fused_ln_err(torch, out, ref):
    """The epilogue forward's agreement with its plain version: (max abs
    error, limit text, ok) under the fp32 atol, or in bf16 and fp16 each
    element within that atol plus one ulp of the plain value in its
    type."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if out.dtype == torch.float32:
        return err, f"atol {FUSED_LN_ATOL:.0e}", err <= FUSED_LN_ATOL
    ulp = _bf16_ulp(torch, ref.float())
    if out.dtype == torch.float16:      # 10 mantissa bits, not 7
        ulp = torch.maximum(ulp / 8, torch.full_like(ulp, 2.0 ** -24))
    ulps = ((diff - FUSED_LN_ATOL).clamp_min(0.0) / ulp).max().item()
    return err, (f"atol {FUSED_LN_ATOL:.0e} + {ulps:.2f} "
                 f"{_dtype_name(out.dtype)} ulp (limit 1)"), ulps <= 1.0


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
    """(x, residual) type pairs the epilogue's kernels take: a 16-bit
    type beside itself or fp32 (bf16 beside fp16 is no pair AMP makes)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    return ((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16), (f16, f16),
            (f16, f32), (f32, f16))


def fused_ln_route(torch, D, x_dt):
    """The forward kernel that rows of D values in x's type take, operands
    16-byte aligned: ``"tile"`` (ln_fwd_tile: 16-bit x, D <= 1024, D % 8
    == 0), ``"warp"`` (fused_ln_warp, the other rows up to D 1024) or
    ``"row"`` (fused_ln_row)."""
    if D > 1024:
        return "row"
    return "tile" if x_dt != torch.float32 and D % 8 == 0 else "warp"


def check_fused_ln(torch, fl, dev):
    """Row 12: the fused epilogue against its plain version, every D, N,
    pair of x and residual types (the same, and each mixed with the
    other, fault C6), p, the seeds in turn, bias/gamma/beta in x's type
    or fp32 in turn, and each launch on the kernel its rows take
    (:func:`fused_ln_route`, read from ``fl.ROUTE_LAUNCHES``).  Where the
    16-bit tile takes the rows (D <= 1024) the check runs once more with
    the other parameter type, so that every AMP triple (x, residual,
    parameters: the 16-bit type beside itself or fp32, parameters in x's
    type or fp32; O1 hands fp32 parameters) is held at every D, N and
    p."""
    gen = torch.Generator(device=dev).manual_seed(8)
    results = []
    i = 0
    for D in FUSED_LN_DS:
        for N in FUSED_LN_NS:
            for x_dt, r_dt in fused_ln_types(torch):
                for p in FUSED_LN_PS:
                    seed = FUSED_LN_SEEDS[i % len(FUSED_LN_SEEDS)]
                    pdts = (x_dt if i % 2 else torch.float32,)
                    i += 1
                    route = fused_ln_route(torch, D, x_dt)
                    if route == "tile":         # the other parameter type
                        pdts += (torch.float32 if pdts[0] == x_dt
                                 else x_dt,)
                    for pdt in pdts:
                        results.append(_fused_ln_case(
                            torch, fl, gen, dev, N, D, x_dt, r_dt, pdt, p,
                            seed, route))
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} fused-epilogue checks disagree "
                             f"with the plain version: {bad}")
    return results


def _fused_ln_case(torch, fl, gen, dev, N, D, x_dt, r_dt, pdt, p, seed,
                   route):
    x, r, b, g, be = _fused_ln_operands(torch, gen, dev, N, D, x_dt, r_dt,
                                        pdt)
    before = fl.ROUTE_LAUNCHES[route]
    out = fl.fused_ln(x, r, b, g, be, seed, p=p, eps=1e-5)
    ref = fl.fused_ln_ref(x, r, b, g, be, seed, p=p, eps=1e-5)
    sync(torch, dev)
    err, tol, ok = _fused_ln_err(torch, out, ref)
    routed = fl.ROUTE_LAUNCHES[route] == before + 1
    ok = ok and out.dtype == x_dt and out.shape == x.shape and routed
    row = dict(n=N, d=D, dtype=_dtype_name(x_dt),
               residual_dtype=_dtype_name(r_dt), p=p, seed=seed,
               param_dtype=_dtype_name(pdt), route=route, routed=routed,
               max_abs_err=err, tolerance=tol, ok=ok)
    log(f"  fused_ln N={N:5d} D={D:5d} x {_dtype_name(x_dt):8s} residual "
        f"{_dtype_name(r_dt):8s} p={p:.1f} seed={seed:10d} params "
        f"{row['param_dtype']:8s} max_abs_err={err:.2e} {tol} on {route}"
        f"{'' if routed else ' (NOT LAUNCHED THERE)'} "
        f"{'ok' if ok else 'FAIL'}")
    return row


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()
            .clamp_min(1e-300)).item()


def check_fused_ln_bwd(torch, fl, dev):
    """The epilogue's backward kernel against its plain version, every D,
    N, type pair and p, the seeds in turn, parameters in x's type or fp32:
    dx and dres by the atol of their type; dbias, dgamma, dbeta in fp32 at
    relative L2 against a float64 run of the plain backward, in bf16 and
    fp16 against the plain version; dx exactly 0 exactly where the forward
    dropped (fp16 dx: 0 wherever dropped, and elsewhere only where the
    plain value is under fp16's smallest normal, 2^-14, and underflows)."""
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
                    low = x_dt if x_dt != torch.float32 else r_dt
                    truth, col_tol = ref[2:], FUSED_LN_BWD_COL_RTOL[
                        _dtype_name(low)]
                    col_vs = "plain"
                for name, a, w in zip(("dbias", "dgamma", "dbeta"), got[2:],
                                      truth):
                    errs[name] = _rel_l2(a, w)
                    ok = ok and a.dtype == pdt and errs[name] <= col_tol
                dropped = fl.hash_uniform(seed, (N, D), device=dev) < \
                    torch.tensor(p, dtype=torch.float32) if p > 0 else \
                    torch.zeros((N, D), dtype=torch.bool, device=dev)
                zero_where_dropped = bool(torch.equal(got[0] == 0, dropped))
                if x_dt == torch.float16 and not zero_where_dropped:
                    # fp16 dx also underflows to 0 where the plain value
                    # is under fp16's smallest normal: 0 wherever dropped,
                    # and every other 0 one the plain version nearly has
                    other = (got[0] == 0) & ~dropped
                    zero_where_dropped = bool(
                        (got[0][dropped] == 0).all()) and bool(
                        (ref[0].float()[other].abs() < 2.0 ** -14).all())
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
                    f"{GRAD_ATOL['bfloat16']:.0e}, fp16 "
                    f"{GRAD_ATOL['float16']:.0e}); rel L2 vs {col_vs} dbias "
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
    """Row 12's dropout mask bit for bit, in each kernel's x type (fp32 on
    fused_ln_warp, bf16 and fp16 on ln_fwd_tile): with x = 1, residual =
    bias = beta = 0 and gamma = 1 an output is positive exactly where the
    element was kept, which must be where the plain hash is >= p."""
    results = []
    for x_dt in (torch.float32, torch.bfloat16, torch.float16):
        one = torch.ones((N, D), device=dev, dtype=x_dt)
        zero = torch.zeros((N, D), device=dev, dtype=x_dt)
        vec_one = torch.ones(D, device=dev)
        vec_zero = torch.zeros(D, device=dev)
        route = fused_ln_route(torch, D, x_dt)
        for p in (0.1, 0.5):
            for seed in FUSED_LN_SEEDS:
                before = fl.ROUTE_LAUNCHES[route]
                out = fl.fused_ln(one, zero, vec_zero, vec_one, vec_zero,
                                  seed, p=p, eps=1e-5)
                keep = fl.hash_uniform(seed, (N, D), device=dev) >= \
                    torch.tensor(p, dtype=torch.float32)
                signed = bool((out != 0).all().item())
                same = bool(torch.equal(out > 0, keep))
                routed = fl.ROUTE_LAUNCHES[route] == before + 1
                kept = keep.float().mean().item()
                ok = same and signed and routed
                results.append(dict(n=N, d=D, dtype=_dtype_name(x_dt), p=p,
                                    seed=seed, route=route, routed=routed,
                                    kept_share=kept,
                                    every_sign_defined=signed, equal=same,
                                    ok=ok))
                log(f"  fused_ln mask N={N} D={D} x {_dtype_name(x_dt):8s} "
                    f"p={p:.1f} seed={seed:10d} on {route}: kept "
                    f"{kept:.4f}, signs equal to the hash's keep bits: "
                    f"{same} {'ok' if ok else 'FAIL'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"the kernel's dropout mask differs from the "
                             f"hash: {bad}")
    return results


def _dlogits_err(torch, out, ref, g):
    """Row 11's agreement with its plain version: (max_abs_err, limit
    text, ok) under the fp32 atol, or in bf16 and fp16 each element's
    error against 1e-6·|g| plus one step of its type at the plain value
    (fp16's subnormal step, 2^-24, below its smallest normal)."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if out.dtype == torch.float32:
        return err, f"atol {DLOGITS_ATOL:.0e}", err <= DLOGITS_ATOL
    atol = DLOGITS_BF16_ATOL_PER_G * abs(float(g))
    if out.dtype == torch.bfloat16:
        step = _bf16_ulp(torch, ref.float())
    else:
        step = _fp16_step(torch, ref.float())
    ulps = ((diff - atol).clamp_min(0.0) / step).max().item()
    return err, (f"atol {atol:.1e} + {ulps:.2f} {_dtype_name(out.dtype)} "
                 f"ulp (limit 1)"), ulps <= 1.0


def _label_column(torch, out, lab):
    """dlogits at each row's label (rows whose label lies in [0, V))."""
    V = out.shape[1]
    rows = torch.nonzero((lab >= 0) & (lab < V))[:, 0]
    return out[rows, lab[rows].long()].float()


def check_dlogits(torch, sx, dev):
    """Row 11 on both routes: the head's dlogits against the plain
    version, fp32, bf16 and fp16; then fp16 at g = 1/65536 on both
    routes, where every label value must stay a non-zero subnormal."""
    import numpy as np
    rs = np.random.RandomState(9)
    cases = [(N, D, V, dtype, DLOGITS_G) for N, D, V in HEAD_SHAPES
             for dtype in (torch.float32, torch.bfloat16, torch.float16)]
    cases += [(N, D, V, torch.float16, DLOGITS_SUBNORMAL_G)
              for N, D, V in DLOGITS_SUBNORMAL_SHAPES]
    results = []
    for N, D, V, dtype, g_val in cases:
        x = torch.from_numpy(rs.randn(N, D).astype(np.float32)).to(
            dev, dtype)
        w = torch.from_numpy((rs.randn(D, V) * 0.05).astype(
            np.float32)).to(dev, dtype)
        lab = _head_labels(torch, rs, N, V, dev, torch.int32)
        lse, _ = sx.softmax_xent_fwd_ref(x, w, lab)
        g = torch.tensor(g_val, device=dev)
        before = dict(sx.ROUTE_LAUNCHES)
        out = sx.softmax_xent_dlogits(x, w, lab, lse, g)
        route, counted = _routed(sx, x, w, before, "dlogits")
        ref = sx.softmax_xent_dlogits_ref(x, w, lab, lse, g)
        sync(torch, dev)
        name = str(dtype).replace("torch.", "")
        err, tol, ok = _dlogits_err(torch, out, ref, g_val)
        ok = ok and out.dtype == dtype and out.shape == (N, V) and counted
        r = dict(n=N, d=D, v=V, dtype=name, route=route, g=g_val,
                 max_abs_err=err, tolerance=tol)
        if g_val == DLOGITS_SUBNORMAL_G:
            col = _label_column(torch, out, lab)
            kept = bool(((col < 0) & (col > -2.0 ** -14)).all())
            tol += f"; label column subnormal and kept: {kept}"
            r.update(label_subnormal_kept=kept, tolerance=tol,
                     label_min_abs=col.abs().min().item())
            ok = ok and kept
        r["ok"] = ok
        results.append(r)
        log(f"  softmax_xent_dlogits N={N} D={D} V={V} {name:8s} "
            f"g={g_val:.3g} {route:5s} max_abs_err={err:.3e} ({tol}) "
            f"{'ok' if ok else 'FAIL'}")
        del x, w, out, ref
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} dlogits checks disagree with the "
                             f"plain version: {bad}")
    return results


# -- the fused optimizer update (phases 3, 6, 13) -------------------------------
def _update_route(route):
    """What a fused step runs in: ``"kernel"`` as it is (the kernel on the
    card, its plain version on the CPU), ``"plain"`` with the kernel's
    plain version swapped in, ``"per_leaf"`` under
    ``FLAGS_fused_optimizer=0``; and two planted mutations of the plain
    version that the check of phase 3 must fail: ``"no_store"`` leaves
    every parameter (and master) as it was, ``"half_lr"`` steps at half
    the rate."""
    from contextlib import nullcontext
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    ref = mtu.multi_tensor_update_ref

    def no_store(spec, table, lr, update, found_inf=None):
        kept = [(t, t.clone()) for r in table.records
                for t in (r.param, r.master) if t is not None]
        ref(spec, table.records, lr, update, found_inf)
        for t, was in kept:
            t.copy_(was)
    plain = {"plain": lambda spec, table, lr, update, found_inf=None: ref(
                 spec, table.records, lr, update, found_inf),
             "half_lr": lambda spec, table, lr, update, found_inf=None: ref(
                 spec, table.records, lr * 0.5, update, found_inf),
             "no_store": no_store}
    if route in plain:
        return mock.patch.object(mtu, "multi_tensor_update", plain[route])
    if route == "per_leaf":
        return port_flags({"FLAGS_fused_optimizer": False})
    return nullcontext()


@contextmanager
def port_flags(flags):
    """The port's runtime flags set (``paddle_tpu_torch.set_flags``) for
    the block, then restored."""
    from paddle_tpu_torch.utils.flags import get_flags, set_flags
    was = get_flags(list(flags))
    set_flags(flags)
    try:
        yield
    finally:
        set_flags(was)


def update_shapes(torch, width, dev):
    """(name, shape) of every parameter of the GPT at ``width``."""
    from paddle_tpu_torch.models import GPT, GPTConfig
    net = GPT(GPTConfig(**width), device=dev, seed=0)
    out = [(n, tuple(p.shape)) for n, p in net.named_parameters()]
    del net
    return out


def update_dtype(torch, setup):
    """The parameters' type in an UPDATE_SETUPS setup."""
    return {"fp32": torch.float32, "bf16": torch.bfloat16,
            "fp16": torch.float16}[setup.split()[0]]


def update_params(torch, named, setup, dev, gen, attrs=True):
    """Parameters of ``named`` ((name, shape) pairs), 0.1·N(0, 1) from
    ``gen`` (zero where the name starts with "zero"), in ``setup``'s type
    (:func:`update_dtype`); with ``attrs`` the regularizers and lr scales
    of UPDATE_CHECKS's comment."""
    from paddle_tpu_torch import regularizer
    out = []
    for i, (name, shape) in enumerate(named):
        w = 0.1 * torch.randn(shape, generator=gen, device=dev)
        if name.startswith("zero"):
            w.zero_()
        p = torch.nn.Parameter(w.to(update_dtype(torch, setup)))
        if attrs and i % 3:
            p.regularizer = (regularizer.L1Decay(1e-4) if i % 3 == 1
                             else regularizer.L2Decay(1e-3))
        if attrs and i % 4 == 3:
            p.optimize_attr = {"learning_rate": 0.5}
        out.append((name, p))
    return out


def update_grads(torch, params, gen):
    """A gradient of 0.01·N(0, 1) from ``gen`` for every parameter."""
    for _, p in params:
        p.grad = (0.01 * torch.randn(p.shape, generator=gen,
                                     device=p.device)).to(p.dtype)


def update_optimizer(make, params, setup):
    """``make(optimizer, regularizer, params)``, with fp32 masters under a
    "... master" ``setup`` (``multi_precision``, as amp.decorate sets
    it)."""
    from paddle_tpu_torch import optimizer, regularizer
    opt = make(optimizer, regularizer, params)
    if setup.endswith("master"):
        opt._multi_precision = True
    return opt


def update_run(torch, make, named, setup, dev, route, steps=UPDATE_STEPS,
               seed=0):
    """``steps`` steps of the optimizer ``make`` on update_params's
    parameters by ``route`` (:func:`_update_route`), the same parameters
    and gradients for every route.  Returns (copies of every parameter,
    slot, power and master by key; under masters whether every parameter
    equals its master cast to its type, else None).  ``steps`` 0 gives
    the values before the first step, slots and masters made."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = update_params(torch, named, setup, dev, gen)
    opt = update_optimizer(make, params, setup)
    for _, p in params:
        opt._slot(p)
    for _ in range(steps):
        update_grads(torch, params, gen)
        with _update_route(route):
            opt.step()
    out = {}
    for n, p in params:
        out[f"param {n}"] = p.detach().clone()
        for k, v in opt._state[id(p)].items():
            out[f"slot {n}_{k}"] = v.clone()
        if id(p) in opt._master_weights:
            out[f"master {n}"] = opt._master_weights[id(p)].clone()
    tied = all(torch.equal(p, opt._master_weights[id(p)].to(p.dtype))
               for _, p in params) if setup.endswith("master") else None
    return out, tied


def ulp(torch, x, dtype):
    """The step of ``dtype`` at each magnitude of ``x`` (fp32)."""
    fi = torch.finfo(dtype)
    step = torch.ldexp(torch.full_like(x, fi.eps),
                       torch.frexp(x.abs()).exponent - 1)
    return torch.clamp(step, min=fi.smallest_normal * fi.eps)


def update_close(torch, got, want, base):
    """Per key of ``want``: dict(err: max |got - want|, ok: every element
    within its tolerance, n: elements, past: 16-bit elements more than one
    step apart, steps: the worst one's distance in steps, share: the
    worst distance past one step over the tensor's largest move).  fp32
    values: UPDATE_ATOL + UPDATE_RTOL·|want|; 16-bit values: one step of
    their type at max(|got|, |want|) plus UPDATE_REL·max|want - base|,
    ``base`` the values before the steps (:func:`update_run` at ``steps``
    0)."""
    out = {}
    for k, w in want.items():
        g, w32 = got[k].float(), w.float()
        d = (g - w32).abs()
        row = dict(err=d.max().item(), n=d.numel(), past=0, steps=None,
                   share=None)
        if w.dtype in (torch.bfloat16, torch.float16):
            step = ulp(torch, torch.maximum(g.abs(), w32.abs()), w.dtype)
            move = (w32 - base[k].float()).abs().max()
            over = (d - step).clamp(min=0)
            tol = step + UPDATE_REL * move
            row.update(past=int((over > 0).sum()),
                       steps=(d / step).max().item(),
                       share=(over.max() / move).item() if move > 0
                       else float(over.max() > 0) * math.inf)
        else:
            tol = UPDATE_ATOL + UPDATE_RTOL * w32.abs()
        row["ok"] = got[k].dtype == w.dtype and bool((d <= tol).all())
        out[k] = row
    return out


def update_verdict(torch, got, want, base):
    """(whether ``got`` passes :func:`update_close` against ``want``: every
    value within its tolerance, and at most UPDATE_PAST_SHARE of the
    16-bit elements past one step; the failing keys; the 16-bit share past
    one step; the per-key rows)."""
    rows = update_close(torch, got, want, base)
    bad = [k for k, r in rows.items() if not r["ok"]]
    low = [r for k, r in rows.items() if want[k].dtype != torch.float32]
    past = sum(r["past"] for r in low) / max(sum(r["n"] for r in low), 1)
    return not bad and past <= UPDATE_PAST_SHARE, bad, past, rows


def check_update_kernel(torch, dev, named=None, checks=UPDATE_CHECKS,
                        setups=UPDATE_SETUPS):
    """The fused optimizer update against its plain version on the card:
    every kind of UPDATE_CHECKS in every setup of UPDATE_SETUPS, three
    steps on the GPT's parameter shapes and UPDATE_EXTRA, every parameter,
    slot, power and master held to :func:`update_close`; under masters
    every parameter equal to its master cast to its type; the tensor of
    zeros moved (a trust ratio over a zero norm is 1, not 0/0).  In the
    16-bit setups without masters the two planted mutations of
    :func:`_update_route` must each fail the same check."""
    named = named or update_shapes(torch, GPT_WIDTH, dev) + list(UPDATE_EXTRA)
    elements = sum(math.prod(shape) for _, shape in named)
    rows = []
    for label, make in checks:
        for setup in setups:
            got, tied = update_run(torch, make, named, setup, dev, "kernel")
            want, _ = update_run(torch, make, named, setup, dev, "plain")
            base, _ = update_run(torch, make, named, setup, dev, "plain",
                                 steps=0)
            sync(torch, dev)
            ok, bad, past, errs = update_verdict(torch, got, want, base)
            zero = [v for k, v in got.items() if k.startswith("param zero")]
            moved = all(bool((v != 0).any()) for v in zero)
            del got, zero
            f32 = [e["err"] for k, e in errs.items()
                   if want[k].dtype == torch.float32]
            low = [e for k, e in errs.items()
                   if want[k].dtype != torch.float32]
            caught = {}
            if setup in ("bf16", "fp16"):
                for mutant in ("no_store", "half_lr"):
                    wrong, _ = update_run(torch, make, named, setup, dev,
                                          mutant)
                    m_ok, m_bad, m_past, _ = update_verdict(
                        torch, wrong, want, base)
                    caught[mutant] = dict(failed=not m_ok, values=len(m_bad),
                                          share_past_one_step=m_past)
                    del wrong
            ok = ok and tied is not False and moved and all(
                c["failed"] for c in caught.values())
            row = dict(
                optimizer=label, setup=setup, tensors=len(named),
                elements=elements, steps=UPDATE_STEPS, values=len(errs),
                max_abs_err=max(f32, default=None),
                max_abs_err_16bit=max((e["err"] for e in low), default=None),
                max_steps_16bit=max((e["steps"] for e in low), default=None),
                share_past_one_step=past if low else None,
                max_move_share_past_one_step=max(
                    (e["share"] for e in low), default=None),
                mutants=caught or None, params_tied_to_masters=tied,
                zero_tensor_moved=moved, failed=bad[:8], ok=ok)
            rows.append(row)
            mut = {k: f"{'fails' if c['failed'] else 'PASSES'} "
                      f"({c['share_past_one_step']:.3g} past one step)"
                   for k, c in caught.items()}
            log(f"  update {label:18s} {setup:11s}: {len(errs)} values, "
                f"fp32 max_abs_err {max(f32, default=0.0):.2e}, 16-bit "
                f"{row['max_abs_err_16bit'] or 0.0:.2e} "
                f"({row['max_steps_16bit'] or 0.0:.3g} steps; "
                f"{row['share_past_one_step'] or 0.0:.3g} of the elements "
                f"past one step, by at most "
                f"{row['max_move_share_past_one_step'] or 0.0:.3g} of the "
                f"tensor's move), mutants {mut or '-'}, tied {tied}, "
                f"zero tensor moved {moved} "
                f"{'ok' if ok else 'FAIL ' + str(bad[:4])}")
            del want, base
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} fused-update checks disagree with "
                             f"the plain version, or pass a planted "
                             f"mutation: {bad}")
    return rows


def _same_bits(torch, a, b):
    """Bit for bit, NaN included (the integer view of each value)."""
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    n = a.element_size()
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.view(ints[n]), b.view(ints[n])))


# the unscale pass (mt_unscale) of phase 3: the GPT's gradients and
# UPDATE_EXTRA's numel 1, 3 and 2^20 + 5, in each gradient type, with no
# non-finite value and with one planted at the first element of the first
# tensor, a middle element of a middle one and the last of the last; the
# kernel and its plain version multiply by the same fp32 1/scale rounded to
# the gradient's type, one rounding, so they agree bit for bit
UNSCALE_PLANTS = ((None, None, None), (0, 0, "inf"), ("mid", "mid", "nan"),
                  (-1, -1, "-inf"))
UNSCALE_SCALE = 2.0 ** 12


def check_unscale(torch, dev, named=None):
    """The unscale pass against its plain version on the card: each
    gradient type, each planted value of UNSCALE_PLANTS, the gradients
    bit for bit and found_inf equal to the plant.  Returns the rows."""
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    named = named or update_shapes(torch, GPT_WIDTH, dev) + [
        (n, s_) for n, s_ in UPDATE_EXTRA if not n.startswith("zero")]
    gen = torch.Generator(device=dev).manual_seed(14)
    scale = torch.full((), UNSCALE_SCALE, device=dev)
    rows = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        base = [(UNSCALE_SCALE * 1e-3 * torch.randn(
            shape, generator=gen, device=dev)).to(dtype)
            for _, shape in named]
        for t_i, e_i, value in UNSCALE_PLANTS:
            grads = [g.clone() for g in base]
            if value is not None:
                t = len(grads) // 2 if t_i == "mid" else t_i
                flat = grads[t].view(-1)
                e = flat.numel() // 2 if e_i == "mid" else e_i
                flat[e] = float(value)
            plain = [g.clone() for g in grads]
            found = torch.ones((), dtype=torch.bool, device=dev)
            found_ref = torch.zeros((), dtype=torch.bool, device=dev)
            before = mtu.UNSCALE_LAUNCHES
            mtu.multi_tensor_unscale(grads, scale, found)
            mtu.multi_tensor_unscale_ref(plain, scale, found_ref)
            sync(torch, dev)
            launched = mtu.UNSCALE_LAUNCHES - before
            same = all(_same_bits(torch, a, b) for a, b in zip(grads, plain))
            err = max(((a.float() - b.float()).abs().nan_to_num(0.0).max()
                       .item() for a, b in zip(grads, plain)), default=0.0)
            want = value is not None
            ok = same and bool(found) == want and bool(found_ref) == want \
                and launched == 1
            rows.append(dict(dtype=_dtype_name(dtype), tensors=len(named),
                             elements=sum(g.numel() for g in grads),
                             planted=value, found_inf=bool(found),
                             bit_for_bit=same, max_abs_err=err,
                             launches=launched, ok=ok))
            log(f"  unscale {_dtype_name(dtype):8s} {len(named)} tensors "
                f"({rows[-1]['elements']} elements), planted {value}: "
                f"found_inf {bool(found)} (plain {bool(found_ref)}), bit for "
                f"bit {same} (tolerance: exact), launches {launched} "
                f"{'ok' if ok else 'FAIL'}")
            del grads, plain
        del base
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} unscale checks disagree with the "
                             f"plain version: {bad}")
    return rows


def _skip_state(torch, opt, params):
    out = {}
    for n, p in params:
        out[f"param {n}"] = p.detach().clone()
        for k, v in opt._state[id(p)].items():
            out[f"slot {n}_{k}"] = v.clone()
        if id(p) in opt._master_weights:
            out[f"master {n}"] = opt._master_weights[id(p)].clone()
    return out


def update_skip_run(torch, make, named, setup, dev, route, found):
    """One step of ``make`` by ``route``, then one with ``found`` (None,
    False, True) as ``step(found_inf=...)``: the state before and after
    the second."""
    gen = torch.Generator(device=dev).manual_seed(15)
    params = update_params(torch, named, setup, dev, gen)
    opt = update_optimizer(make, params, setup)
    with _update_route(route):
        update_grads(torch, params, gen)
        opt.step()
        before = _skip_state(torch, opt, params)
        update_grads(torch, params, gen)
        opt.step(found_inf=None if found is None else torch.full(
            (), found, dtype=torch.bool, device=dev))
    return before, _skip_state(torch, opt, params)


def check_update_skip(torch, dev, named=None, checks=UPDATE_CHECKS,
                      setups=UPDATE_SETUPS):
    """The skip flag for every kind of UPDATE_CHECKS in every setup, on the
    kernel and on its plain version on the card: set, every parameter,
    slot, power and master bit for bit as before the step; clear, bit for
    bit what the step gives without the flag.  At the GPT's first six
    shapes and UPDATE_EXTRA."""
    named = named or update_shapes(torch, GPT_WIDTH, dev)[:6] + list(
        UPDATE_EXTRA)
    rows = []
    for label, make in checks:
        for setup in setups:
            row = dict(optimizer=label, setup=setup, tensors=len(named))
            for route in ("kernel", "plain"):
                before, skipped = update_skip_run(torch, make, named, setup,
                                                  dev, route, True)
                _, plain = update_skip_run(torch, make, named, setup, dev,
                                           route, None)
                _, clear = update_skip_run(torch, make, named, setup, dev,
                                           route, False)
                sync(torch, dev)
                kept = [k for k in before
                        if not _same_bits(torch, skipped[k], before[k])]
                differ = [k for k in plain
                          if not _same_bits(torch, clear[k], plain[k])]
                moved = sum(not _same_bits(torch, plain[k], before[k])
                            for k in plain)
                row[route] = dict(values=len(before), set_moved=kept[:4],
                                  clear_differs=differ[:4], step_moved=moved)
                del before, skipped, plain, clear
            row["ok"] = all(not row[r]["set_moved"]
                            and not row[r]["clear_differs"]
                            and row[r]["step_moved"] for r in ("kernel",
                                                               "plain"))
            rows.append(row)
            log(f"  update skip {label:18s} {setup:11s}: set flag moved "
                f"{row['kernel']['set_moved'] or 'nothing'} of "
                f"{row['kernel']['values']} values (plain "
                f"{row['plain']['set_moved'] or 'nothing'}); clear flag "
                f"differs {row['kernel']['clear_differs'] or 'nowhere'} "
                f"(plain {row['plain']['clear_differs'] or 'nowhere'}); "
                f"tolerance: bit for bit {'ok' if row['ok'] else 'FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} skip-flag checks failed: {bad}")
    return rows


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
    rate = (BF16_FLOPS_PER_S if dt in (torch.bfloat16, torch.float16)
            else FP32_FLOPS_PER_S)
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


def timing_split_kernels(torch, fa, dev="cuda", shapes=SPLIT_TIMING,
                         dtype=None):
    """Rows 1 (T <= 512), 2, 6, 7, 8 and 9 at the eager train path's
    shapes (H 12, d 64, causal, head views of one packed projection), in
    ``dtype`` (fp32 by default), each result also held against its plain
    version there.  The streaming rows 8 and 9 are the backward's passes
    timed apart: delta + dQ, and dK/dV.  In a 16-bit type rows 1 and 6
    also in device time (torch.profiler), and the bound at the tensor
    cores' rate."""
    import torch.nn.functional as F
    from paddle_tpu_torch.tools.profile_train import device_ms_per_call
    dtype = dtype or torch.float32
    name = _dtype_name(dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    H, d = 12, 64
    rows = {}
    for B, T in shapes:
        qkv = torch.randn((B, T, 3, H, d), generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv.unbind(2)
        g = torch.randn((B, T, H, d), generator=gen, device=dev).to(dtype)
        route = fa.kernel_route(dtype, d, q, k, v)
        with torch.no_grad():
            out, lse = fa.flash_attn_fwd(q, k, v, causal=True,
                                         return_lse=True)
            grads = fa.flash_attn_bwd(q, k, v, out, lse, g, causal=True)
            ref, ref_lse = fa.flash_attn_fwd_ref(q, k, v, causal=True,
                                                 return_lse=True)
            ref_g = fa.flash_attn_bwd_ref(q, k, v, ref, ref_lse, g,
                                          causal=True)
            err_out = (out.float() - ref.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            err_f = max(err_out, err_lse)
            err_b = max((a.float() - b.float()).abs().max().item()
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
            dev_fwd = dev_bwd = None
            if dtype != torch.float32 and T <= fa.SMALL_BWD_T_MAX:
                dev_fwd = device_ms_per_call(lambda: fa.flash_attn_fwd(
                    q, k, v, causal=True, return_lse=True))
                dev_bwd = device_ms_per_call(lambda: fa.flash_attn_bwd(
                    q, k, v, out, lse, g, causal=True))
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
        el = torch.empty((), dtype=dtype).element_size()
        n_el = 1.0 * el * B * T * H * d       # bytes of one operand
        stats = 4.0 * B * H * T               # bytes of lse (or delta)
        # flops of one causal T x T x d product (half of 2*T*T*d): the
        # forward needs 2 (S, PV), the backward 5 (S, dP, dV, dQ, dK); the
        # dQ pass runs 3 of them, the dK/dV pass 4
        prod = 1.0 * B * H * T * T * d
        shape = f"B {B}, T {T}, H {H}, d {d}, {name}, causal"
        lib_note = "F.scaled_dot_product_attention forward + backward on " \
                   "(B, H, T, d) views"
        kernel = ("flash_attn_sm90" if route == "sm90" else "flash_attn")
        common = dict(shape=shape, dtype=name, route=route, fwd_ms=fwd_ms,
                      bwd_ms=bwd_ms, max_abs_err_fwd=err_f,
                      max_abs_err_bwd=err_b, library_fwd_ms=lib_fwd,
                      library_kernels=names_fb,
                      library_fwd_kernels=names_fwd)
        # the lse is held to SPLIT_LSE_ATOL, a 16-bit output to ATOL
        fwd_atol = SPLIT_LSE_ATOL if dtype == torch.float32 else ATOL[name]
        err_fwd = err_f if dtype == torch.float32 else err_out
        common["max_abs_err_lse"] = err_lse
        mode = fa._pallas_mode(T, T, True)
        if mode == "stream":
            rows[2] = dict(common, kernel=f"{kernel}_fwd (with lse)",
                           ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib_fwd,
                           library="F.scaled_dot_product_attention forward "
                                   "on (B, H, T, d) views",
                           max_abs_err=err_fwd, atol=fwd_atol,
                           flops=2 * prod, bytes=4 * n_el + stats)
            # plain: the whole plain backward (no plain version of one pass)
            rows[8] = dict(common, kernel=f"{kernel}_bwd passes delta + dQ",
                           ms=dq_ms, plain_ms=bwd_plain, library_ms=lib_fb,
                           library=lib_note, max_abs_err=err_b,
                           atol=GRAD_ATOL[name], flops=3 * prod,
                           bytes=6 * n_el + stats)
            rows[9] = dict(common, kernel=f"{kernel}_bwd pass dK/dV",
                           ms=dkv_ms, plain_ms=bwd_plain, library_ms=lib_fb,
                           library=lib_note, max_abs_err=err_b,
                           atol=GRAD_ATOL[name], flops=4 * prod,
                           bytes=6 * n_el + 2 * stats)
        else:
            if T <= fa.SMALL_BWD_T_MAX:
                rows[1] = dict(common, kernel=f"{kernel}_fwd (with lse)",
                               ms=fwd_ms, plain_ms=fwd_plain,
                               library_ms=lib_fwd, device_ms=dev_fwd,
                               library="F.scaled_dot_product_attention "
                                       "forward on (B, H, T, d) views",
                               max_abs_err=err_fwd, atol=fwd_atol,
                               flops=2 * prod, bytes=4 * n_el + stats)
            row = fa.reference_rows("bwd", mode, T)[0]
            rows[row] = dict(common, kernel=f"{kernel}_bwd", ms=bwd_ms,
                             plain_ms=bwd_plain, library_ms=lib_fb,
                             library=lib_note, max_abs_err=err_b,
                             atol=GRAD_ATOL[name], flops=5 * prod,
                             bytes=8 * n_el + stats, dq_pass_ms=dq_ms,
                             dkv_pass_ms=dkv_ms,
                             device_ms=dev_bwd if row == 6 else None)
        del qkv, q, k, v, g, out, lse, dq, dk, dv, delta, qg, kg, vg, gh
    peak = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    for row, r in sorted(rows.items()):
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["bytes"], peak)
        if dtype == torch.float32:
            r["bound_3xtf32_ms"] = bound_3xtf32(r["flops"], r["bytes"])
        r["ok"] = r["max_abs_err"] <= r["atol"] and \
            r["max_abs_err_lse"] <= SPLIT_LSE_ATOL
        device = "" if r.get("device_ms") is None else \
            f" (device {r['device_ms']:.4f} ms)"
        extra = "" if dtype != torch.float32 else \
            f"; 3xTF32 bound {r['bound_3xtf32_ms']:.4f} ms"
        log(f"  row {row} {r['kernel']} ({r['shape']}): kernel "
            f"{r['ms']:.4f} ms{device}, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['flops'] / 1e9:.2f} GFLOP at "
            f"{peak / 1e12:.0f} TFLOP/s {name}, {r['bytes'] / 1e6:.2f} MB at "
            f"3.35 TB/s); forward {r['fwd_ms']:.4f} ms, backward "
            f"{r['bwd_ms']:.4f} ms{extra}; max_abs_err "
            f"vs plain {r['max_abs_err']:.3e} (atol {r['atol']:.0e}) "
            f"{'ok' if r['ok'] else 'FAIL'}; SDPA's kernels "
            f"{kernels_line(r['library_kernels'])}")
    bad = [row for row, r in rows.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"rows {bad} disagree with their plain versions "
                             "at the eager train path's shapes")
    return rows


def timing_fused_ln(torch, fl, p, dev="cuda", N=16384, D=768, types=None):
    """Row 12 at the encoder's shape (N = B 32 x T 512, D 768, fp32) with
    the train path's p 0.1, and p 0 (scoring): CUDA events around one
    call and device time alone (``torch.profiler``, 10 calls), its share
    of the bound in device time.  No PyTorch call computes the function
    (``library_ms`` None); ``F.layer_norm`` on the precomputed
    ``residual + x + bias`` is timed beside it as a smaller function (one
    (N, D) tensor read and one written, against the kernel's two read and
    one written).  ``types``: (x, residual, parameters), fp32 by
    default; the bytes bound counts each in its type."""
    import torch.nn.functional as F
    from paddle_tpu_torch.tools.profile_train import device_ms_per_call
    x_dt, r_dt, p_dt = types or (torch.float32,) * 3
    gen = torch.Generator(device=dev).manual_seed(10)
    x, r = (torch.randn((N, D), generator=gen, device=dev).to(t)
            for t in (x_dt, r_dt))
    b, g, be = (torch.randn(D, generator=gen, device=dev).to(p_dt)
                for _ in range(3))
    with torch.no_grad():
        before = dict(fl.ROUTE_LAUNCHES)
        out = fl.fused_ln(x, r, b, g, be, 3, p=p, eps=1e-5)
        route = next(k for k, v in fl.ROUTE_LAUNCHES.items()
                     if v != before[k])
        ref = fl.fused_ln_ref(x, r, b, g, be, 3, p=p, eps=1e-5)
        err, tol, ok = _fused_ln_err(torch, out, ref)
        del out, ref

        def kernel(p_):
            return lambda: fl.fused_ln(x, r, b, g, be, 3, p=p_, eps=1e-5)

        ms, ms_p0 = time_ms(torch, kernel(p)), time_ms(torch, kernel(0.0))
        dev_ms = device_ms_per_call(kernel(p))
        dev_ms_p0 = device_ms_per_call(kernel(0.0))
        plain = time_ms(torch, lambda: fl.fused_ln_ref(x, r, b, g, be, 3,
                                                       p=p, eps=1e-5),
                        reps=5)
        z = (r.float() + x.float() + b.float()).to(x_dt)
        lib = time_ms(torch, lambda: F.layer_norm(
            z, (D,), g.to(x_dt), be.to(x_dt), 1e-5))
    el = {t: torch.empty((), dtype=t).element_size()
          for t in (x_dt, r_dt, p_dt)}
    nbytes = 1.0 * N * D * (2 * el[x_dt] + el[r_dt]) + 3.0 * D * el[p_dt]
    b_ms, b_by = bound(10.0 * N * D, nbytes, FP32_FLOPS_PER_S)
    names = "/".join(_dtype_name(t) for t in (x_dt, r_dt, p_dt))
    row = dict(ms=ms, ms_p0=ms_p0, device_ms=dev_ms, device_ms_p0=dev_ms_p0,
               share_of_bound=b_ms / dev_ms, share_of_bound_p0=b_ms /
               dev_ms_p0, plain_ms=plain, library_ms=None,
               library="none (no PyTorch call computes LayerNorm(residual "
                       "+ dropout(x + bias)))", layer_norm_ms=lib,
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=err,
               atol=FUSED_LN_ATOL, tolerance=tol, route=route,
               shape=f"N {N}, D {D}, {names} (x/residual/params), p {p}"
               if types else f"N {N}, D {D}, fp32, p {p}")
    row["ok"] = ok
    log(f"  fused_ln ({row['shape']}) on {route}: kernel {ms:.4f} ms events, "
        f"{dev_ms:.4f} ms device ({row['share_of_bound']:.1%} of the bound) "
        f"(p 0: {ms_p0:.4f} events, {dev_ms_p0:.4f} device, "
        f"{row['share_of_bound_p0']:.1%}), plain {plain:.4f} ms, "
        f"F.layer_norm on the precomputed sum (a smaller function) "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB "
        f"at 3.35 TB/s); max_abs_err vs plain {err:.3e} ({tol}) "
        f"{'ok' if row['ok'] else 'FAIL'}")
    if not row["ok"]:
        raise AssertionError("fused_ln disagrees with its plain version at "
                             "the encoder's shape")
    return row


def timing_fused_ln_bwd(torch, fl, p, dev="cuda", N=16384, D=768,
                        types=None):
    """The epilogue's backward kernel (both launches) at the encoder's
    shape, fp32, p 0.1 and p 0: CUDA events, device time, the plain
    version, the bound (g, x, residual read, dx, dres written, the (D,)
    vectors read and written once) and the share of it in device time.
    No PyTorch call computes the function; ATen's LayerNorm backward on
    the precomputed sum (g and z read, dz written, no dropout, no second
    output) is timed beside it as a smaller function.  ``types``: (x,
    residual, parameters), fp32 by default; dx and dres are held to the
    grads atol of their types."""
    from paddle_tpu_torch.tools.profile_train import device_ms_per_call
    x_dt, r_dt, p_dt = types or (torch.float32,) * 3
    gen = torch.Generator(device=dev).manual_seed(13)
    x, r, g = (torch.randn((N, D), generator=gen, device=dev).to(t)
               for t in (x_dt, r_dt, x_dt))
    b, gam, be = (torch.randn(D, generator=gen, device=dev).to(p_dt)
                  for _ in range(3))
    args = (g, x, r, b, gam, be, 3)
    atol = max(GRAD_ATOL[_dtype_name(t)] for t in (x_dt, r_dt))
    with torch.no_grad():
        got = fl.fused_ln_bwd(*args, p=p, eps=1e-5)
        ref = fl.fused_ln_bwd_ref(*args, p=p, eps=1e-5)
        err = max((a.float() - w.float()).abs().max().item() for a, w in
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
        z = (r.float() + x.float() + b.float()).to(x_dt)
        gz, bz = gam.to(x_dt), be.to(x_dt)
        _, mean, rstd = torch.ops.aten.native_layer_norm(z, (D,), gz, bz,
                                                         1e-5)
        lib = time_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
            g, z, (D,), mean, rstd, gz, bz, [True, True, True]))
    el = {t: torch.empty((), dtype=t).element_size()
          for t in (x_dt, r_dt, p_dt)}
    nbytes = 1.0 * N * D * (3 * el[x_dt] + 2 * el[r_dt]) + 6.0 * D * el[p_dt]
    b_ms, b_by = bound(30.0 * N * D, nbytes, FP32_FLOPS_PER_S)
    names = "/".join(_dtype_name(t) for t in (x_dt, r_dt, p_dt))
    row = dict(ms=ms, ms_p0=ms_p0, device_ms=dev_ms, device_ms_p0=dev_ms_p0,
               share_of_bound=b_ms / dev_ms,
               share_of_bound_p0=b_ms / dev_ms_p0, plain_ms=plain,
               library_ms=None,
               library="none (no PyTorch call computes the epilogue's "
                       "backward)", layer_norm_backward_ms=lib,
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=err,
               atol=atol,
               shape=f"N {N}, D {D}, {names} (x/residual/params), p {p}"
               if types else f"N {N}, D {D}, fp32, p {p}")
    row["ok"] = err <= atol
    log(f"  fused_ln_bwd ({row['shape']}): kernel {ms:.4f} ms events, "
        f"{dev_ms:.4f} ms device ({row['share_of_bound']:.1%} of the bound) "
        f"(p 0: {ms_p0:.4f} events, {dev_ms_p0:.4f} device, "
        f"{row['share_of_bound_p0']:.1%}), plain {plain:.4f} ms, ATen's "
        f"LayerNorm backward on the precomputed sum (a smaller function) "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB "
        f"at 3.35 TB/s); max_abs_err vs plain {err:.3e} (atol "
        f"{atol:.0e}) {'ok' if row['ok'] else 'FAIL'}")
    if not row["ok"]:
        raise AssertionError("fused_ln_bwd disagrees with its plain version "
                             "at the encoder's shape")
    return row


def timing_unscale(torch, dev="cuda"):
    """The unscale pass on the GPT's 149 fp32 gradients at full width
    (132,340,224 elements, the O1 step's): CUDA events around one call of
    ``multi_tensor_unscale`` (its device tables cached), device time as a
    replayed CUDA graph of the call, the plain version, and
    ``torch._amp_foreach_non_finite_check_and_unscale_``, PyTorch's own
    call for the same function (timed here, used nowhere in the port) the
    same two ways, the two graphs in alternating rounds (:func:`graphs_ms`),
    beside the bytes bound (each gradient read and written once)."""
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    gen = torch.Generator(device=dev).manual_seed(16)
    grads = [torch.randn(shape, generator=gen, device=dev)
             for _, shape in update_shapes(torch, GPT_WIDTH, dev)]
    plain = [g.clone() for g in grads]
    scale = torch.full((), UNSCALE_SCALE, device=dev)
    found = torch.zeros((), dtype=torch.bool, device=dev)
    found_ref = torch.zeros((), dtype=torch.bool, device=dev)
    cache = {}
    mtu.multi_tensor_unscale(grads, scale, found, cache)
    mtu.multi_tensor_unscale_ref(plain, scale, found_ref)
    sync(torch, dev)
    same = all(_same_bits(torch, a, b) for a, b in zip(grads, plain))
    del plain
    inv = torch.full((1,), 1.0 / UNSCALE_SCALE, device=dev)
    flag = torch.zeros((1,), device=dev)
    library = torch._amp_foreach_non_finite_check_and_unscale_

    def kernel():
        mtu.multi_tensor_unscale(grads, scale, found, cache)

    def lib_call():
        library(grads, flag, inv)

    plain_ms = time_ms(torch, lambda: mtu.multi_tensor_unscale_ref(
        grads, scale, found), reps=5)
    # the two calls' device times in alternating rounds (graphs_ms): timed
    # first, right after phase 6's attention timings, the pass read 15%
    # slow and the library, timed later, did not
    (device_ms, rounds), (lib_device, lib_rounds) = graphs_ms(
        torch, (kernel, lib_call))
    ms, lib = time_ms(torch, kernel), time_ms(torch, lib_call)
    n = sum(g.numel() for g in grads)
    nbytes = 8.0 * n
    b_ms, b_by = bound(2.0 * n, nbytes, FP32_FLOPS_PER_S)
    row = dict(kernel="mt_unscale", tensors=len(grads), elements=n, ms=ms,
               device_ms=device_ms, share_of_bound=b_ms / device_ms,
               plain_ms=plain_ms, library_ms=lib,
               library_device_ms=lib_device, device_ms_rounds=rounds,
               library_device_ms_rounds=lib_rounds,
               library="torch._amp_foreach_non_finite_check_and_unscale_",
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, bit_for_bit=same,
               max_abs_err=0.0 if same else float("nan"),
               shape=f"the GPT's {len(grads)} fp32 gradients, {n} elements",
               ok=same)
    log(f"  unscale ({row['shape']}): kernel {ms:.4f} ms events, "
        f"{device_ms:.4f} ms device (replayed graph, "
        f"{row['share_of_bound']:.1%} of the bound), plain {plain_ms:.4f} ms, "
        f"{row['library']} {lib:.4f} ms events, {lib_device:.4f} ms device "
        f"(replayed graph; the median of {len(rounds)} alternating rounds, "
        f"the pass's first and last {rounds[0]:.4f} / {rounds[-1]:.4f} ms, "
        f"the library's {lib_rounds[0]:.4f} / {lib_rounds[-1]:.4f}), "
        f"bound {b_ms:.4f} ms ({b_by}; "
        f"{nbytes / 1e9:.3f} GB at 3.35 TB/s); bit for bit against the plain "
        f"version: {same} {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the unscale pass disagrees with its plain "
                             "version at the GPT's shapes")
    del grads
    return row


def timing_fp16(torch, fa, fl, p, dev="cuda"):
    """Phase 6's 16-bit rows: attention (rows 1, 2, 6-9, d 64, all on
    flash_attn_sm90) in fp16 and in bf16 at SPLIT_TIMING's shapes, rows 1
    and 6 also in device time; the epilogue and its backward in fp16 (x,
    residual and parameters) and fp16 x beside an fp32 residual and
    parameters, and in bf16 (x, residual and parameters), p ``p``; the
    epilogue's forward also in O1's triples (fp16 or bf16 x and residual,
    fp32 parameters); the unscale pass."""
    f16, f32, b16 = torch.float16, torch.float32, torch.bfloat16
    return dict(
        split=timing_split_kernels(torch, fa, dev, dtype=f16),
        split_bf16=timing_split_kernels(torch, fa, dev,
                                        dtype=torch.bfloat16),
        fused_ln=timing_fused_ln(torch, fl, p, dev, types=(f16, f16, f16)),
        fused_ln_mixed=timing_fused_ln(torch, fl, p, dev,
                                       types=(f16, f32, f32)),
        fused_ln_bwd=timing_fused_ln_bwd(torch, fl, p, dev,
                                         types=(f16, f16, f16)),
        fused_ln_bwd_mixed=timing_fused_ln_bwd(torch, fl, p, dev,
                                               types=(f16, f32, f32)),
        fused_ln_bf16=timing_fused_ln(torch, fl, p, dev,
                                      types=(b16, b16, b16)),
        fused_ln_o1=timing_fused_ln(torch, fl, p, dev,
                                    types=(f16, f16, f32)),
        fused_ln_bf16_o1=timing_fused_ln(torch, fl, p, dev,
                                         types=(b16, b16, f32)),
        fused_ln_bwd_bf16=timing_fused_ln_bwd(torch, fl, p, dev,
                                              types=(b16, b16, b16)),
        unscale=timing_unscale(torch, dev))


def timing_dlogits(torch, sx, cfg, dev="cuda"):
    """Row 11 at one chunk of the compiled step's head backward (C 4096,
    D 768, V 30528, in ``cfg``'s type); library: the chunk's pb as the
    step formed it before the kernel (``matmul_f32``, which is
    ``torch.mm(..., out_dtype=float32)`` for bf16 and fp16 on the card,
    ``exp``, the label index, the scale and the cast).  CUDA events and
    device time."""
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
    rate = (BF16_FLOPS_PER_S if dt in (torch.bfloat16, torch.float16)
            else FP32_FLOPS_PER_S)
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


def _scaled_grads(torch, cfg, params, ids, labels):
    """TRAIN_GRADS of the step's loss with its token count N as the output
    gradient (the step's own backward, only g scaled: g/N = 1)."""
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.models.gpt_spmd import _leaves, _rebuild, loss_fn
    live = {k: v.detach().requires_grad_()
            for k, v in _leaves(params).items()}
    loss = loss_fn(_rebuild(params, live), ids, labels,
                   GPTConfig(**cfg["width"]),
                   compute_dtype=getattr(torch, cfg["dtype"]),
                   remat_policy=cfg["remat"])
    g = torch.full((), float(ids.numel()), device=loss.device)
    grads = torch.autograd.grad(loss, [live[n] for n in TRAIN_GRADS], g)
    return loss.detach(), dict(zip(TRAIN_GRADS, grads))


def _fp16_scaled_grads(torch, fq, sx, cfg, params, ids, labels):
    """The fp16 step's backward through the kernels against the plain
    versions with the loss gradient scaled by the token count N (g/N =
    1), so that fp16 holds the trunk's gradients: relative L2 of
    TRAIN_GRADS within fp16's TRAIN_GRAD_RTOL; the kernels' launches
    counted as in the step."""
    _reset(fq, sx)
    loss_k, grads_k = _scaled_grads(torch, cfg, params, ids, labels)
    launches = _launches(fq, sx)
    with _plain_kernels(fq, sx):
        loss_p, grads_p = _scaled_grads(torch, cfg, params, ids, labels)
    rel = {n: ((grads_k[n] - grads_p[n]).float().norm()
               / grads_p[n].float().norm()).item() for n in TRAIN_GRADS}
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    ok = finite and all(v <= TRAIN_GRAD_RTOL["float16"]
                        for v in rel.values())
    log(f"  the same backward with the loss gradient scaled by "
        f"{ids.numel()} (g/N = 1): grads relative L2 kernels "
        f"against plain {', '.join(f'{k} {v:.3e}' for k, v in rel.items())}"
        f" (limit {TRAIN_GRAD_RTOL['float16']:.0e}), finite {finite}; "
        f"launches {launches}")
    if not ok:
        raise AssertionError("the fp16 step's scaled backward through the "
                             "kernels disagrees with the plain versions")
    return dict(scale=ids.numel(), grad_rel_l2=rel, finite=finite,
                launches=launches, loss=loss_k.item(),
                loss_plain=loss_p.item())


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
    fwd_per_step = L * (2 if cfg["remat"] in ("full", "dots") else 1)
    chunks = B * T // sx._chunk(B * T)
    # bf16 and fp16 at d 64 / 128: every attention launch is
    # flash_attn_sm90's
    sixteen = name in ("bfloat16", "float16")
    sm90 = sixteen and D // w["num_heads"] in fq._fa.SM90_HEAD_DIMS
    want_sm90 = (fwd_per_step, L) if sm90 else (0, 0)
    # the head: 16-bit with D and V multiples of 8 on softmax_xent_sm90.cu,
    # the rest (fp32 here) on the tile kernels; every launch on that route
    head = "sm90" if sixteen and D % 8 == 0 and V % 8 == 0 \
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
    # every leaf's gradient finite (fp16 has no loss scaling here, as in
    # the reference: an overflow shows as a non-finite first moment)
    from paddle_tpu_torch.models.gpt_spmd import _leaves
    nonfinite = {k: int((~torch.isfinite(v)).sum().item())
                 for k, v in _leaves(opt_k["m"]).items()}
    bad_leaves = {k: n for k, n in nonfinite.items() if n}
    log(f"  non-finite gradient elements after step 1: "
        f"{sum(nonfinite.values())} of "
        f"{sum(v.numel() for v in _leaves(opt_k['m']).values())}"
        + (f" in {bad_leaves}" if bad_leaves else ""))
    if bad_leaves:
        raise AssertionError(f"non-finite gradients in {bad_leaves}")
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
    # fp16 with no loss scaling: the trunk's gradients underflow (below)
    # and only the head's is held here; held = every name elsewhere
    held = FP16_UNSCALED_HELD if name == "float16" else TRAIN_GRADS
    grads_ok = all(rel[n] <= TRAIN_GRAD_RTOL[name] for n in held)
    log(f"  same step with the plain versions: loss {loss_p.item():.6f}, "
        f"|difference| {d_loss:.3e} (limit rtol {rtol:.0e}); grads "
        f"relative L2 {', '.join(f'{k} {v:.3e}' for k, v in rel.items())} "
        f"(limit {TRAIN_GRAD_RTOL[name]:.0e} on {', '.join(held)})")
    finite = bool(torch.isfinite(loss_k).item())
    if not (loss_ok and grads_ok and finite):
        raise AssertionError("the step through the kernels disagrees with "
                             "the step through the plain versions")
    del grads_k, grads_p
    out = dict(config=cfg, loss_step1=loss_k.item(),
               loss_step1_plain=loss_p.item(), loss_abs_diff=d_loss,
               grad_rel_l2=rel, grads_held=list(held), launches=launches,
               nonfinite_grad_elements=sum(nonfinite.values()))
    if name == "float16":
        out["scaled"] = _fp16_scaled_grads(torch, fq, sx, cfg, state0[0],
                                           ids, labels)
    if not timed:
        return out

    # two runs of two steps from the same state repeat bit for bit
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
        f"TFLOP/s, the bf16 and fp16 peak); peak memory "
        f"{peak / 2**30:.3f} GiB")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    out.update(losses=losses, step_ms=times, step_ms_p50=step_ms,
               seq_per_s=seq_s, mfu=mfu, flops_per_token=flops_tok,
               peak_memory_bytes=peak, deterministic=same)
    return out


def remat_policies(torch, fq, sx, dev, cfg, policies=REMAT_POLICIES):
    """Phase 7's other remat policies: one step of ``cfg`` under "ctx" and
    under each of ``policies`` from the same state (``init_fn(0)``) and
    batch, each held bit for bit to the "ctx" step, loss and every
    parameter (the kernels repeat bit for bit, and a kept value is the
    result of the same launch on the same inputs, its backward the same
    calls autograd makes); each policy's launches (attention forward L
    under "ctx" and "ctx_ffn", 2 L under "dots", whose kept products leave
    the attention output to the recompute; backward L; the head as in
    phase 7), peak memory over that step (``max_memory_allocated``, the
    state included), and step ms p50 of REMAT_TIMED more steps."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, build_spmd_train_step
    from paddle_tpu_torch.models.gpt_spmd import _leaves
    w = cfg["width"]
    L, V = w["num_layers"], w["vocab_size"]
    B, T = cfg["batch"], cfg["seq"]
    rng = np.random.RandomState(0)                # bench.py:137-139
    ids = torch.from_numpy(rng.randint(0, V, (B, T))).to(dev)
    labels = torch.from_numpy(rng.randint(0, V, (B, T))).to(dev)
    chunks = B * T // sx._chunk(B * T)
    out, ctx_state = {}, None
    for policy in ("ctx",) + tuple(policies):
        step, init_fn = build_spmd_train_step(
            GPTConfig(**w), compute_dtype=getattr(torch, cfg["dtype"]),
            remat_policy=policy, device=dev)
        params, opt = init_fn(0)
        sync(torch, dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset(fq, sx)
        loss, params, opt = step(params, opt, ids, labels)
        sync(torch, dev)
        launches = _launches(fq, sx)
        peak = torch.cuda.max_memory_allocated()
        fwd = L * (2 if policy == "dots" else 1)
        want = dict(flash_qkv_fwd=fwd, flash_qkv_bwd=L,
                    flash_attn_sm90_fwd=fwd, flash_attn_sm90_bwd=L,
                    softmax_xent_sm90_fwd=1, softmax_xent_sm90_dlogits=chunks)
        launched_ok = all(launches[k] == v for k, v in want.items())
        state = (loss.clone(), {k: v.clone()
                                for k, v in _leaves(params).items()})
        if ctx_state is None:
            ctx_state, same = state, True
        else:
            same = bool(torch.equal(state[0], ctx_state[0])) and all(
                torch.equal(v, ctx_state[1][k]) for k, v in state[1].items())
        del state
        times = []
        for _ in range(REMAT_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            _, params, opt = step(params, opt, ids, labels)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[policy] = dict(loss_step1=loss.item(), equals_ctx=same,
                           launches=launches, expected_launches=want,
                           peak_memory_bytes=peak, step_ms=times,
                           step_ms_p50=pct(times, 50))
        log(f"  remat {policy:8s}: step 1 loss {loss.item():.6f}, bit for "
            f"bit the \"ctx\" step: {same}; attention launches "
            f"{launches['flash_qkv_fwd']} + {launches['flash_qkv_bwd']} "
            f"(flash_attn_sm90 {launches['flash_attn_sm90_fwd']} + "
            f"{launches['flash_attn_sm90_bwd']}; expected {fwd} + {L}), "
            f"head sm90 {launches['softmax_xent_sm90_fwd']} + "
            f"{launches['softmax_xent_sm90_dlogits']}; peak memory "
            f"{peak / 2**30:.3f} GiB; step ms p50 {pct(times, 50):.3f} "
            f"({REMAT_TIMED} steps, CUDA events)")
        del step, params, opt, loss
        if not (same and launched_ok):
            raise AssertionError(f"remat {policy!r}: equals ctx {same}, "
                                 f"launches {launches}, expected {want}")
    torch.cuda.empty_cache()
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
                dropout=False, make_opt=None, decorate=False,
                engines=("uncaptured", "captured"), update_ms=False,
                plain_step=True):
    """The train path on ``net``: ``Model(net).prepare(AdamW(1e-3,
    weight_decay=0.01), CrossEntropyLoss(), amp_configs=amp, jit=...)
    .train_batch`` on (ids, labels), or with the optimizer
    ``make_opt(parameters)``; with ``decorate``, net and optimizer go
    through ``amp.decorate(..., level="O2")`` first (bf16 parameters, or
    ``decorate``'s type when it is one, over fp32 masters), and every step
    must leave each parameter equal to its master cast to its type.
    Step 1 (``update=False``, uncaptured in both engines) runs through
    the kernels with the counts ``reset``
    just before and ``launches()`` read just after (they must equal
    ``want``), then again inside ``plain()`` (the plain versions), held to
    the fp32 tolerances, or under AMP to its type's (``TRAIN_*_RTOL``).  With
    ``repeat``: JIT_STEPS steps on rolled batches with ``jit=False``
    (uncaptured), then twice with ``jit=True`` (a step captured in a CUDA
    graph and replayed), from the same state and seeds; the captured runs
    must repeat bit for bit, equal the uncaptured run bit for bit (else
    within the tolerances above, reported), keep the parameters fp32, and
    count ``want`` launches in a replayed step; with ``dropout``, two more
    steps at learning rate 0 on one batch must differ (new masks at every
    replay).  "Bit for bit" covers the parameters, every optimizer slot and
    every master.  With ``timed``, each engine of ``engines`` takes 12
    steps on the batch (the loss must fall): step ms p50, seq/s, peak
    memory; when the captured engine is timed alone without dropout, its
    model is the second captured run's, whose graph is already captured;
    with ``update_ms`` also the device time of the captured engine's
    ``optimizer.step()`` alone on one batch's gradients
    (:func:`update_time`).  Without
    ``plain_step`` step 1 runs through the kernels only.  Every run
    starts from ``paddle_tpu_torch.seed``, so the fused epilogue's seeds
    and the dropout masks repeat.  Returns the report."""
    import gc
    import numpy as np
    import paddle_tpu_torch
    from paddle_tpu_torch import Model
    from paddle_tpu_torch import amp as pamp
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    dev = ids.device
    B = ids.shape[0]
    state0 = {k: v.clone() for k, v in net.state_dict().items()}
    make_opt = make_opt or (lambda params: AdamW(
        1e-3, parameters=params, weight_decay=0.01))
    # decorate: True (bf16) or the low type
    low = decorate if isinstance(decorate, torch.dtype) else torch.bfloat16
    param_dtype = low if decorate else torch.float32

    def fresh(jit=True):
        net.load_state_dict(state0)
        opt = make_opt(net.parameters())
        if decorate:
            pamp.decorate(net, opt, level="O2", dtype=_dtype_name(low))
        return Model(net).prepare(opt, CrossEntropyLoss(), amp_configs=amp,
                                  jit=jit)

    def tied(opt):
        """Each parameter the optimizer stepped has a master and equals it
        cast to its type, exactly (a post-LN encoder's unused pre-LN
        parameters get no gradient and no master)."""
        stepped = [p for p in net.parameters() if id(p) in opt._state]
        return bool(stepped) and all(
            id(p) in opt._master_weights and torch.equal(
                p, opt._master_weights[id(p)].to(p.dtype)) for p in stepped)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    amp_dtype = amp.get("dtype", "bfloat16") if isinstance(amp, dict) \
        else "bfloat16"
    loss_rtol = EAGER_LOSS_RTOL if amp is None else \
        TRAIN_LOSS_RTOL[amp_dtype]
    grad_rtol = EAGER_GRAD_RTOL if amp is None else \
        TRAIN_GRAD_RTOL[amp_dtype]

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

    if not plain_step:
        loss_p, grads_p = loss_k, grads_k
    else:
        with plain():
            loss_p, grads_p = first_step(model)
    d_loss = abs(loss_k - loss_p)
    # in fp32: under fp16 the gradients of update=False are still scaled
    rel = {n: ((grads_k[n].float() - grads_p[n].float()).norm()
               / grads_p[n].float().norm()).item() for n in names}
    if plain_step:
        log(f"  same step with the plain versions and the same seeds: loss "
            f"{loss_p:.6f}, |difference| {d_loss:.3e} (limit rtol "
            f"{loss_rtol:g}); grads relative L2 "
            f"{', '.join(f'{k} {v:.3e}' for k, v in rel.items())} (limit "
            f"{grad_rtol:g})")
    if not (np.isfinite(loss_k) and d_loss <= loss_rtol * abs(loss_p)
            and all(v <= grad_rtol for v in rel.values())):
        raise AssertionError("the step through the kernels disagrees with "
                             "the step through the plain versions")
    opt_name = type(model._optimizer).__name__
    del grads_k, grads_p, model
    out = dict(loss_step1=loss_k, loss_step1_plain=loss_p if plain_step
               else None, loss_abs_diff=d_loss, loss_rtol=loss_rtol,
               grad_rel_l2=rel if plain_step else None, grad_rtol=grad_rtol,
               launches=counts, amp=amp, optimizer=opt_name,
               decorated=decorate)
    continued = None
    if repeat:
        continued, fields = _captured_vs_uncaptured(
            torch, net, ids, labels, fresh, tied if decorate else None,
            reset, launches, want, loss_rtol, grad_rtol, param_dtype,
            dropout)
        out.update(fields)
        # a dropout run ends at learning rate 0: time a fresh one
        if dropout or not (timed and tuple(engines) == ("captured",)):
            continued = None
    if not timed:
        return out

    # per engine: 2 warm-ups (the captured engine's first one captures),
    # then timed steps on one fixed batch; the loss falls
    for engine in engines:
        jit = engine == "captured"
        release()
        model, losses, times, ties, peak, reserved = _timed_steps(
            torch, continued if jit and continued is not None else
            fresh(jit), ids, labels, tied if decorate else None)
        continued = None
        step_ms = pct(times, 50)
        seq_s = B / (step_ms / 1e3)
        memory = f"{peak / 2**30:.3f} GiB, reserved {reserved / 2**30:.3f} GiB"
        log(f"  {engine} (jit={jit}): losses over {len(losses)} steps: "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        log(f"  {engine}: step ms p50 {step_ms:.3f} (min {min(times):.3f}, "
            f"max {max(times):.3f}, {TRAIN_TIMED} steps after "
            f"{TRAIN_WARMUP} warm-ups, CUDA events); {seq_s:.2f} seq/s; "
            f"peak memory {memory}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        if not all(ties):
            raise AssertionError("a step left a parameter that is not its "
                                 "master cast to its type")
        out[engine] = dict(losses=losses, step_ms=times, step_ms_p50=step_ms,
                           seq_per_s=seq_s, peak_memory_bytes=peak,
                           reserved_bytes=reserved)
        if update_ms and jit:
            out["update"] = update_time(torch, net, model, ids, labels)
        del model
    out.update(out[engines[-1]])
    del state0
    release()
    return out


def _timed_steps(torch, model, ids, labels, tied):
    """TRAIN_WARMUP + TRAIN_TIMED steps of ``model`` on one batch, each
    timed with CUDA events: (model, losses, times of the timed steps,
    ties, peak allocated, reserved)."""
    import paddle_tpu_torch
    torch.cuda.reset_peak_memory_stats()
    paddle_tpu_torch.seed(3)
    losses, times, ties = [], [], []
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
        if tied is not None:
            ties.append(tied(model._optimizer))
    return (model, losses, times, ties, torch.cuda.max_memory_allocated(),
            torch.cuda.memory_reserved())


def _train_state(net, opt):
    """Copies of the parameters, every optimizer slot and every master."""
    out = {f"param {n}": p.detach().clone()
           for n, p in net.named_parameters()}
    for n, p in net.named_parameters():
        for k, v in opt._state.get(id(p), {}).items():
            out[f"slot {n}_{k}"] = v.clone()
        if id(p) in opt._master_weights:
            out[f"master {n}"] = opt._master_weights[id(p)].clone()
    return out


def _scaler_state(model):
    """Copies of the fp16 loss scaler's device state (scale, good, bad,
    found_inf), empty without one."""
    sc = model._scaler
    if sc is None:
        return {}
    return {f"scaler {k}": sc[k].clone()
            for k in ("scale", "good", "bad", "found_inf")}


def _captured_vs_uncaptured(torch, net, ids, labels, fresh, tied, reset,
                            launches, want, loss_rtol, grad_rtol,
                            param_dtype, dropout):
    """JIT_STEPS steps with jit=False, then twice with jit=True, from the
    same state, seeds and batches (:func:`model_train`).  Returns the
    second captured run's model and the report's fields."""
    import gc
    import paddle_tpu_torch
    dev = ids.device
    batches = [(ids.roll(i, 0), labels.roll(i, 0)) for i in range(JIT_STEPS)]
    replay_counts, update_counts, update_want = {}, {}, {}
    ties = []

    def run_steps(jit, count=False):
        model = fresh(jit)
        paddle_tpu_torch.seed(2)
        losses = []
        for i, (b_ids, b_labels) in enumerate(batches):
            if count and i == 1:                 # a replay, counted
                sync(torch, dev)
                reset()
                _reset_update()
            losses.append(model.train_batch([b_ids], [b_labels])["loss"])
            if count and i == 1:
                sync(torch, dev)
                replay_counts.update(launches())
                update_counts.update(_update_launches())
                update_want.update(_update_want(
                    model._optimizer, net.parameters(),
                    model._scaler is not None))
            if tied is not None:
                ties.append(tied(model._optimizer))
        state = _train_state(net, model._optimizer)
        state.update(_scaler_state(model))
        if dropout:
            model._optimizer.set_lr(0.0)
            losses += [model.train_batch([ids], [labels])["loss"]
                       for _ in range(2)]
        captured = _all_captured(model._steps.entries().values())
        return torch.stack(losses), state, captured, model

    runs = []
    for jit, count in ((False, False), (True, True), (True, False)):
        runs.append(run_steps(jit, count))
        if len(runs) < 3:
            runs[-1] = runs[-1][:3]              # the model goes
        gc.collect()
        torch.cuda.empty_cache()
    (l_e, s_e, cap_e), (l_j, s_j, cap_j), (l_j2, s_j2, cap_j2, model) = runs
    exact = bool(torch.equal(l_e, l_j)) and s_e.keys() == s_j.keys() and \
        all(torch.equal(v, s_j[k]) for k, v in s_e.items())
    repeats = bool(torch.equal(l_j, l_j2)) and all(
        torch.equal(v, s_j2[k]) for k, v in s_j.items())
    typed = all(v.dtype == param_dtype for k, v in s_j.items()
                if k.startswith("param ") and v.is_floating_point())
    masters = sum(k.startswith("master ") for k in s_j)
    d_losses = ((l_j - l_e).abs() / l_e.abs()).max().item()
    d_params = max(((s_j[k].float() - v.float()).norm()
                    / v.float().norm().clamp_min(1e-30)).item()
                   for k, v in s_e.items() if v.is_floating_point()
                   and k in s_j)
    log(f"  {JIT_STEPS} steps{' (+ 2 at learning rate 0)' if dropout else ''}"
        f", jit=False / jit=True / jit=True: losses "
        f"{l_e.tolist()} / {l_j.tolist()} / {l_j2.tolist()}; captured "
        f"{cap_e} / {cap_j} / {cap_j2}")
    log(f"  captured = uncaptured bit for bit (losses, {len(s_e)} parameters"
        f", slots and masters): {exact} (max loss rel diff {d_losses:.3e}, "
        f"rel L2 {d_params:.3e}); two captured runs bit for bit: {repeats}; "
        f"parameters {param_dtype}: {typed}; fp32 masters {masters}; every "
        f"step's parameters = master cast: "
        f"{all(ties) if ties else 'n/a'}; a replayed step's launches "
        f"{replay_counts} (expected {want}), update {update_counts} "
        f"(expected {update_want})")
    if cap_e or not (cap_j and cap_j2):
        raise AssertionError("jit=True did not capture, or jit=False did")
    if not repeats:
        raise AssertionError("two captured runs differ")
    if not exact and not (d_losses <= loss_rtol and d_params <= grad_rtol):
        raise AssertionError("the captured steps differ from the uncaptured "
                             "ones beyond the tolerances")
    if not typed:
        raise AssertionError(f"the step left parameters that are not "
                             f"{param_dtype}")
    if tied is not None and not (all(ties) and masters and all(
            v.dtype == torch.float32 for k, v in s_j.items()
            if k.startswith("master "))):
        raise AssertionError("the decorated run lacks an fp32 master, or a "
                             "parameter is not its master cast to its "
                             "type")
    if replay_counts != want:
        raise AssertionError(f"a replayed step counted {replay_counts}; "
                             f"expected {want}")
    if update_counts != update_want or not update_counts["update"]:
        raise AssertionError(f"a replayed step launched the update "
                             f"{update_counts}; expected {update_want}")
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
    return model, dict(jit_steps=JIT_STEPS, deterministic=repeats,
                captured_equals_uncaptured=exact,
                captured_vs_uncaptured=dict(loss_rel=d_losses,
                                            params_rel_l2=d_params),
                losses_uncaptured=l_e.tolist(), losses_captured=l_j.tolist(),
                replay_launches=replay_counts,
                replay_update_launches=update_counts, masks_change=masks,
                params_dtype=str(param_dtype), params_typed=typed,
                params_fp32=typed and param_dtype == torch.float32,
                masters=masters, params_tied_to_masters=(
                    all(ties) if ties else None))


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


def _amp_dtype(amp):
    """The low type of an ``amp_configs`` value ("bfloat16" by default,
    as ``Model.prepare`` reads it), None without AMP."""
    if not amp:
        return None
    return amp.get("dtype", "bfloat16") if isinstance(amp, dict) \
        else "bfloat16"


def _attention_want(L, fwd_mode, bwd_mode, amp):
    """L forward and L backward launches in their modes; under AMP (bf16
    or fp16, at d 64) every one of them on flash_attn_sm90.cu, in fp32
    none."""
    sm90 = L if _amp_dtype(amp) in ("bfloat16", "float16") else 0
    return dict(fwd=L, bwd=L, sm90_fwd=sm90, sm90_bwd=sm90,
                modes={f"fwd {fwd_mode}": L, f"bwd {bwd_mode}": L})


def _reset_update():
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    mtu.LAUNCHES.clear()
    mtu.NORM_LAUNCHES = mtu.POW_LAUNCHES = mtu.UNSCALE_LAUNCHES = 0


def _update_launches():
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    return dict(update=dict(mtu.LAUNCHES), update_norms=mtu.NORM_LAUNCHES,
                update_pows=mtu.POW_LAUNCHES,
                update_unscale=mtu.UNSCALE_LAUNCHES)


def _update_want(opt, params, scaled=False):
    """The fused update's launches in one step of ``opt``: one update pass
    in its kind per type setup (type, master or not) among ``params`` with
    a gradient, as many norms passes (LarsMomentum, Lamb) and powers'
    advances (the kinds with powers); with fp16 loss scaling (``scaled``)
    one unscale pass per gradient type."""
    params = [p for p in params if p.grad is not None]
    spec = opt._kernel_spec()
    groups = len({(p.dtype, id(p) in opt._master_weights) for p in params})
    return dict(update={spec.kind: groups},
                update_norms=groups if spec.kind in ("lars", "lamb") else 0,
                update_pows=groups if spec.betas else 0,
                update_unscale=len({p.grad.dtype for p in params})
                if scaled else 0)


# fit_recipe's AdamW on fp32 parameters: one group, one powers' advance
FIT_UPDATE = dict(update={"adamw": 1}, update_norms=0, update_pows=1,
                  update_unscale=0)


def eager_train(torch, fa, dev, cfg, timed=True, amp=None, repeat=True,
                **kw):
    """The eager GPT of one config through :func:`model_train` (``kw``
    passed on); L forward and L backward attention launches in the mode of
    its length (under AMP all on flash_attn_sm90.cu)."""
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
        timed=timed, amp=amp, repeat=repeat, **kw)
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
    for k in fl.ROUTE_LAUNCHES:
        fl.ROUTE_LAUNCHES[k] = 0


def _encoder_launches(fa, fl):
    """The encoder path's launches: attention, the epilogue's forward
    (``fused_ln_tile`` of them on ln_fwd_tile) and backward."""
    return dict(_attention_launches(fa), fused_ln=fl.LAUNCHES,
                fused_ln_tile=fl.ROUTE_LAUNCHES["tile"],
                fused_ln_bwd=fl.BWD_LAUNCHES)


def _epilogue_want(L, amp, backward=True):
    """2L epilogue launches each way (none backward in scoring); under AMP
    (16-bit x) every forward on ln_fwd_tile, in fp32 none."""
    return dict(fused_ln=2 * L,
                fused_ln_tile=2 * L if _amp_dtype(amp) else 0,
                fused_ln_bwd=2 * L if backward else 0)


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
                **_epilogue_want(L, None, backward=False))
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
                  timed=True, amp=None, repeat=True, **kw):
    """The encoder through :func:`model_train` at (batch, max_len), fp32
    or under AMP (``kw`` passed on): per step 2L fused-epilogue launches
    each way and L + L non-causal attention launches (under AMP all on
    flash_attn_sm90.cu)."""
    L, T = cfg["num_layers"], cfg["max_len"]
    ids, labels = _batch(torch, cfg["vocab_size"], batch, T, dev)
    mode = fa._pallas_mode(T, T, False)
    rows = dict(fwd=fa.reference_rows("fwd", mode, T),
                bwd=fa.reference_rows("bwd", mode, T))
    want = dict(_attention_want(L, mode, mode, amp), **_epilogue_want(L, amp))
    out = model_train(
        torch, net, ids, labels,
        ("layers.0.fused_attn.qkv_weight", "layers.0.ffn.ln2_scale",
         f"layers.{L - 1}.fused_attn.ln_scale", "wte.weight"),
        lambda: _reset_encoder(fa, fl), lambda: _encoder_launches(fa, fl),
        want, lambda: _plain_encoder_kernels(fa, fl),
        note=f"; attention rows {rows}, non-causal", timed=timed, amp=amp,
        repeat=repeat, dropout=cfg["dropout_rate"] > 0, **kw)
    return dict(out, config=dict(cfg, batch=batch, seq=T), mode=mode,
                rows=rows)


# -- phase 12 ------------------------------------------------------------------
def _fit_watch(torch, reset, launches, strict_epoch=None):
    """A callback that records, per train step, the loss (unread), the
    batch size, CUDA events at the step's begin and end (read after the
    run), the launch counts (reset at the step's begin) and whether the
    step captured; per epoch the cache's compiles at its start and its
    wall time from a synchronise at its start to one at its end.  In
    ``strict_epoch`` every synchronising call raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    from paddle_tpu_torch.callbacks import Callback

    class Watch(Callback):
        def __init__(self):
            super().__init__()
            self.steps, self.compiles, self.wall_ms = [], [], []

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch
            self.compiles.append(self.model._steps.compiles)
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()
            if epoch == strict_epoch:
                torch.cuda.set_sync_debug_mode("error")

        def on_train_batch_begin(self, step, logs=None):
            reset()
            self._made = self.model._steps.compiles
            self._a = torch.cuda.Event(enable_timing=True)
            self._a.record()

        def on_train_batch_end(self, step, logs=None):
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            self.steps.append(dict(
                epoch=self.epoch, step=step, size=logs["batch_size"],
                loss=logs["loss"], events=(self._a, b), launches=launches(),
                captured=self.model._steps.compiles != self._made))

        def on_epoch_end(self, epoch, logs=None):
            if epoch == strict_epoch:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            self.wall_ms.append((time.perf_counter() - self._t0) * 1e3)

    return Watch()


def _step_ms(steps, epoch, batch):
    """(p50 ms of the epoch's full-size steps, ms of its partial step or
    None), CUDA events from each step's begin to its end."""
    full = [s["events"][0].elapsed_time(s["events"][1]) for s in steps
            if s["epoch"] == epoch and s["size"] == batch]
    part = [s["events"][0].elapsed_time(s["events"][1]) for s in steps
            if s["epoch"] == epoch and s["size"] != batch]
    return pct(full, 50), (part[0] if part else None)


FIT_VARIANTS = ("prefetch0", "uncaptured", "nometric", "nometric_prefetch0")


def fit_path(torch, net, cfg, reset, launches, want, amp=None, epochs=2,
             variants=FIT_VARIANTS, profile=True, accumulate=1):
    """``Model.fit`` on ``net`` as BERT-style fine-tuning runs it
    (``profile_train.fit_recipe``: AdamW under a warmup and a linear
    decay, weight decay 0.01, global-norm clip 1.0, ``Accuracy``), on
    ``cfg["train"]`` sequences of token ids from ``np.random.RandomState(0)``
    in shuffled batches of ``cfg["batch"]`` (the last one partial) and
    ``cfg["eval"]`` more from seed 1 as ``eval_data``, ``verbose=0``,
    ``prefetch_to_device=2``, captured (``jit=True``).  Every run starts
    from the same weights and seeds (``paddle_tpu_torch.seed(0)``,
    ``np.random.seed(0)``).  Checks, failing the run on any miss: ``fit``
    equals a hand loop of captured ``train_batch`` over the same batches,
    bit for bit in losses and parameters; the last epoch captures
    nothing; every replayed step launches ``want``; ``evaluate`` equals
    an ``eval_batch`` loop.  With ``accumulate`` > 1 ``fit`` runs
    ``accumulate_grad_batches``: every step eager, the optimizer stepping
    on each ``accumulate``-th batch of an epoch; the hand loop then calls
    ``train_batch(update=False)`` and an updating ``train_batch`` of an
    uncaptured model (``jit=False``) in the same turns, and a step that
    does not update must launch ``want`` without the update's passes.
    Each of ``variants`` must equal it bit for
    bit too: ``prefetch0`` (``prefetch_to_device=0``), ``uncaptured``
    (``jit=False``), ``nometric`` (no metric, no ``eval_data``, its last
    epoch under ``torch.cuda.set_sync_debug_mode("error")``: no
    synchronising call) and ``nometric_prefetch0``.  Logs each run's step
    ms p50 (CUDA events around each step of the last epoch,
    unsynchronised; the hand loop's synchronised as in phase 9), its
    graphs' pools and its peak memory, and with ``profile`` the idle share
    of ``fit`` without the metric (``profile_train.profile``); returns
    the report."""
    import gc
    import numpy as np
    import paddle_tpu_torch
    from paddle_tpu_torch.io import BatchSampler, TensorDataset
    from paddle_tpu_torch.tools import profile_train as pt
    B, T = cfg["batch"], cfg["seq"]
    vocab = next(m for m in net.modules()
                 if isinstance(m, torch.nn.Embedding)).num_embeddings
    train = pt.fit_data(cfg["train"], 0, vocab, T)
    evald = pt.fit_data(cfg["eval"], 1, vocab, T)
    state0 = {k: v.clone() for k, v in net.state_dict().items()}
    last = epochs - 1

    def updates(step):
        # fit's boundary: the optimizer steps on every accumulate-th batch
        return (step + 1) % accumulate == 0

    def want_at(step):
        return want if updates(step) else dict(
            want, update={}, update_norms=0, update_pows=0,
            update_unscale=0)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def fresh(jit=True, metric=True):
        net.load_state_dict(state0)
        for p in net.parameters():   # an accumulating run leaves its last
            p.grad = None            # batches' gradients unstepped
        paddle_tpu_torch.seed(0)
        np.random.seed(0)
        return pt.fit_recipe(net, amp=amp, jit=jit, metric=metric)

    def state():
        return {k: v.clone() for k, v in net.state_dict().items()}

    def fit(label, jit=True, metric=True, prefetch=2, strict=False,
            keep=False):
        release()
        torch.cuda.reset_peak_memory_stats()
        model = fresh(jit, metric)
        watch = _fit_watch(torch, reset, launches,
                           strict_epoch=last if strict else None)
        try:
            model.fit(TensorDataset(train), eval_data=None if strict else
                      TensorDataset(evald), batch_size=B, epochs=epochs,
                      shuffle=True, verbose=0, prefetch_to_device=prefetch,
                      callbacks=[watch], accumulate_grad_batches=accumulate)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            watch.set_model(None)
        torch.cuda.synchronize()
        ms, part_ms = _step_ms(watch.steps, last, B)
        by_kind = {} if accumulate == 1 else {
            f"step_ms_p50_{kind}": _step_ms(
                [s for s in watch.steps if updates(s["step"]) == upd], last,
                B)[0] for kind, upd in (("updating", True),
                                        ("accumulating", False))}
        run = dict(label=label, losses=torch.stack([s["loss"]
                                                    for s in watch.steps]),
                   state=state(), watch=watch, step_ms_p50=ms,
                   partial_step_ms=part_ms, epoch_wall_ms=watch.wall_ms,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                   compiles=watch.compiles + [model._steps.compiles],
                   pools={f"{k[0]} B {k[1][0][0][0]}": e.pool_bytes
                          for k, e in model._steps.entries().items()},
                   **by_kind)
        log(f"  fit {label}: step ms p50 {ms:.3f} (last epoch, {B} rows; "
            f"partial step {part_ms} ms{'' if not by_kind else '; '}"
            f"{', '.join(f'{k} {v:.3f}' for k, v in by_kind.items())}), "
            f"epoch wall ms "
            f"{[round(w, 3) for w in watch.wall_ms]}, compiles at each "
            f"epoch's start and the end {run['compiles']}, peak memory "
            f"{run['peak_memory_bytes'] / 2**30:.3f} GiB allocated, "
            f"{run['peak_reserved_bytes'] / 2**30:.3f} reserved, graph pools MiB "
            f"{ {k: round(v / 2**20, 1) for k, v in run['pools'].items()} }")
        if keep:
            return run, model
        del model
        return run

    def equal(a, b):
        return bool(torch.equal(a["losses"], b["losses"])) and all(
            torch.equal(v, b["state"][k]) for k, v in a["state"].items())

    out = dict(config=dict(cfg, epochs=epochs, amp=amp,
                           accumulate_grad_batches=accumulate))
    main, model = fit("prefetch 2, metric", keep=True)
    # evaluate against an eval_batch loop on the same model
    got = model.evaluate(TensorDataset(evald), batch_size=B, verbose=0)
    metric = model._metrics[0]
    metric.reset()
    losses = [model.eval_batch([evald[0][i:i + B]], [evald[1][i:i + B]])
              ["loss"] for i in range(0, cfg["eval"], B)]
    loop = {"loss": float(np.mean(losses)), "acc": metric.accumulate()}
    log(f"  evaluate {got}; eval_batch loop {loop}")
    if got != loop:
        raise AssertionError("evaluate differs from an eval_batch loop")
    del model
    # the hand loop: captured train_batch over fit's batch order (with
    # accumulation uncaptured, update=False between the updating steps)
    release()
    model = fresh(jit=accumulate == 1, metric=False)
    sched = model._optimizer._lr_scheduler
    hand_losses, hand_ms = [], []
    ds = TensorDataset(train)
    for epoch in range(epochs):
        for step, idx in enumerate(BatchSampler(ds, shuffle=True,
                                                batch_size=B)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            hand_losses.append(model.train_batch(
                [train[0][idx]], [train[1][idx]],
                update=updates(step))["loss"])
            b.record()
            b.synchronize()
            if epoch == last and len(idx) == B:
                hand_ms.append(a.elapsed_time(b))
            sched.step()
    hand = dict(losses=torch.stack(hand_losses), state=state())
    del model
    watch = main["watch"]
    steps_last = [s for s in watch.steps if s["epoch"] == last]
    replayed = [s for s in watch.steps if not s["captured"]]
    checks = dict(
        equals_hand_loop=equal(main, hand),
        last_epoch_captures_nothing=(
            main["compiles"][-1] == main["compiles"][last] if epochs > 1
            else None),
        last_epoch_steps_all_replays=(not any(
            s["captured"] for s in steps_last) if epochs > 1 else None),
        replayed_launches_as_expected=bool(replayed) and all(
            s["launches"] == want_at(s["step"]) for s in replayed),
        evaluate_equals_eval_batch_loop=True)
    updating = [s["launches"] for s in replayed if updates(s["step"])]
    micro = [s["launches"] for s in replayed if not updates(s["step"])]
    hand_p50 = pct(hand_ms, 50)
    how = "captured " if accumulate == 1 else ""
    log(f"  fit = hand loop of {how}train_batch, bit for bit: "
        f"{checks['equals_hand_loop']}; hand loop step ms p50 "
        f"{hand_p50:.3f} (synchronised per step); last epoch all replays: "
        f"{checks['last_epoch_steps_all_replays']}; {len(updating)} "
        f"{'replayed' if accumulate == 1 else 'updating'} steps launched "
        f"{updating[0] if updating else None} each (expected {want})"
        + (f", {len(micro)} accumulating steps "
           f"{micro[0] if micro else None} (expected {want_at(0)})"
           if accumulate > 1 else ""))
    out.update(main={k: v for k, v in main.items()
                     if k not in ("losses", "state", "watch")},
               losses=main["losses"].tolist(), hand_step_ms_p50=hand_p50,
               launches_per_step=updating[0] if updating else None,
               evaluate=got)
    if accumulate > 1:
        out["launches_per_accumulating_step"] = micro[0] if micro else None
    labels = dict(prefetch0=("prefetch 0, metric", dict(prefetch=0)),
                  uncaptured=("jit=False, metric", dict(jit=False)),
                  nometric=("prefetch 2, no metric, last epoch under "
                            "sync_debug_mode error",
                            dict(metric=False, strict=True)),
                  nometric_prefetch0=("prefetch 0, no metric",
                                      dict(metric=False, prefetch=0)))
    for name in variants:
        label, kw = labels[name]
        run = fit(label, **kw)
        checks[f"equals_{name}"] = equal(main, run)
        out[name] = {k: v for k, v in run.items()
                     if k not in ("losses", "state", "watch")}
        del run
    log(f"  bit for bit against the first run: "
        f"{ {k: v for k, v in checks.items() if k.startswith('equals_')} }")
    if profile:
        # the idle share of fit without the metric, prefetch 2
        release()
        net.load_state_dict(state0)
        prof = pt.profile(*pt._fit_path(net, amp, True, cfg["profile_steps"],
                                        2, False, batch=B, seq=T,
                                        accumulate=accumulate),
                          steps=cfg["profile_steps"])
        out["profile"] = {k: prof[k] for k in (
            "wall_ms_p50", "device_ms_per_step", "idle_share",
            "device_ops_per_step", "kernel_launches_per_step", "by_kind")}
        log(f"  profile_train --fit ({cfg['profile_steps']} steps an epoch, "
            f"no metric): wall {prof['wall_ms_p50']:.3f} ms a step, device "
            f"{prof['device_ms_per_step']:.3f}, idle share "
            f"{prof['idle_share']:.4f}")
    out["checks"] = checks
    failed = [k for k, v in checks.items() if v is False]
    net.load_state_dict(state0)
    del state0
    release()
    if failed:
        raise AssertionError(f"fit failed its checks: {failed}")
    return out


def metric_ms(torch, B, T, V, dev="cuda"):
    """``Accuracy().compute`` (top-1 by ``argmax``) against ``torch.topk(x,
    1)`` on (B, T, V) logits, fp32 and bf16, CUDA events."""
    from paddle_tpu_torch.metric import Accuracy
    gen = torch.Generator(device=dev).manual_seed(0)
    labels = torch.randint(0, V, (B, T, 1), generator=gen, device=dev)
    acc, out = Accuracy(), {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((B, T, V), generator=gen, device=dev).to(dt)
        out[_dtype_name(dt)] = dict(
            compute_ms=time_ms(torch, lambda: acc.compute(x, labels)),
            topk_ms=time_ms(torch, lambda: torch.topk(x, 1, dim=-1)),
            same=bool(torch.equal(acc.compute(x, labels), torch.topk(
                x, 1, dim=-1).indices == labels)))
        del x
    log(f"  Accuracy.compute on ({B}, {T}, {V}) logits against torch.topk "
        f"k 1, ms: {out}")
    return out


def _fit_update(amp):
    """fit_recipe's update launches in an updating step: FIT_UPDATE, and
    under fp16 loss scaling one unscale pass (the fp32 gradients)."""
    return dict(FIT_UPDATE, update_unscale=int(_amp_dtype(amp) == "float16"))


def fit_gpt(torch, fa, dev, cfg, amp=None, accumulate=1, epochs=2,
            variants=FIT_VARIANTS):
    """:func:`fit_path` on the eager GPT of ``cfg["width"]`` (seed 0): L
    forward and L backward attention launches a replayed step; in fp32
    also :func:`metric_ms` at the step's shape."""
    from paddle_tpu_torch.models import GPT, GPTConfig
    w = cfg["width"]
    L, T = w["num_layers"], cfg["seq"]
    net = GPT(GPTConfig(**w), device=dev, seed=0)
    mode = fa._pallas_mode(T, T, True)
    out = fit_path(torch, net, cfg,
                   lambda: (_reset_attention(fa), _reset_update()),
                   lambda: dict(_attention_launches(fa), **_update_launches()),
                   dict(_attention_want(L, mode, mode, amp),
                        **_fit_update(amp)),
                   amp=amp, epochs=epochs, variants=variants,
                   accumulate=accumulate)
    del net
    if amp is None:
        out["metric_ms"] = metric_ms(torch, cfg["batch"], T, w["vocab_size"],
                                     dev)
    return out


def fit_encoder(torch, fa, fl, dev, cfg, encoder_cfg, amp="O1",
                accumulate=1, profile=False):
    """:func:`fit_path` on the fused encoder for one epoch: 2L epilogue
    launches each way (the forward's on ln_fwd_tile) and L + L non-causal
    attention launches a replayed step; the (x, residual, parameters)
    types of the epilogue's launches (:func:`_epilogue_types`)."""
    from paddle_tpu_torch.tools.profile_train import build_encoder
    L, T = encoder_cfg["num_layers"], encoder_cfg["max_len"]
    net = build_encoder(encoder_cfg, dev)
    mode = fa._pallas_mode(T, T, False)
    want = dict(_attention_want(L, mode, mode, amp), **_epilogue_want(L, amp),
                **_fit_update(amp))
    done = {}

    def run():
        done["out"] = fit_path(
            torch, net, dict(cfg, seq=T),
            lambda: (_reset_encoder(fa, fl), _reset_update()),
            lambda: dict(_encoder_launches(fa, fl), **_update_launches()),
            want, amp=amp, epochs=1, profile=profile, accumulate=accumulate,
            variants=("uncaptured",) if accumulate == 1 else ())
    types = _epilogue_types(torch, fl, run)
    log(f"  the epilogue's (x, residual, parameters) types: {types}")
    del net
    return dict(done["out"], epilogue_types=types)


def _o2_gpt(cfg):
    """The eager config cut to AMP_O2_LAYERS layers."""
    w = cfg["width"]
    return dict(cfg, width=dict(w, num_layers=min(AMP_O2_LAYERS,
                                                  w["num_layers"])))


# -- phase 13 ------------------------------------------------------------------
def _captured(torch, fn):
    """``fn`` run once on a side stream, then captured in a CUDA graph,
    replayed once."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(torch, graph, reps):
    """``graph`` replayed ``reps`` times between two CUDA events: ms a
    replay."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, reps=10):
    """Device time of one ``fn()``: ``fn`` captured in a CUDA graph
    (:func:`_captured`) and the graph replayed ``reps`` times between two
    CUDA events: the card's time for the call's kernels and the gaps
    between them, without the host's time to launch them.  (torch.profiler
    recorded only some of the update kernel's launches, or none, once CUDA
    graphs had run in the process: 0.0904 ms for a 0.79 ms bound.)"""
    graph = _captured(torch, fn)
    ms = _replay_ms(torch, graph, reps)
    del graph
    return ms


def graphs_ms(torch, fns, rounds=16, reps=10):
    """Device times of several calls timed alike: each ``fn`` captured as
    in :func:`graph_ms`, then ``rounds`` rounds in which each graph is
    replayed ``reps`` times between two events, the order reversed every
    other round (A B, B A, ...).  Returns, for each ``fn``, the median
    round and the list of its rounds.  A card that has just run other work
    can stream slower for some tens of ms, and a call timed first alone
    would carry all of it."""
    import numpy as np
    graphs = [_captured(torch, fn) for fn in fns]
    times = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for k in order:
            times[k].append(_replay_ms(torch, graphs[k], reps))
    del graphs
    return [(float(np.median(ts)), ts) for ts in times]


def update_bytes(params, opt, two_pass=False) -> int:
    """The bytes one ``opt.step()`` must move for the gradients of
    ``params``, each input read once and each output written once: per
    element the parameter (or its master) and every slot read and
    written, the gradient read, and a decorated parameter written from
    its master.  With ``two_pass``, the bytes of the kernel's two passes
    for the trust-ratio optimizers: LarsMomentum's norms pass reads the
    parameter and the gradient once more; Lamb's norms pass reads the
    parameter, gradient and moments and writes the moments, its update
    pass reads the parameter and the moments again (40 B an element in
    fp32 against the one pass's 28)."""
    spec = opt._kernel_spec()
    total = 0
    for p in params:
        if p.grad is None:
            continue
        master = opt._master_weights.get(id(p))
        target = p if master is None else master
        slots = sum(opt._state[id(p)][k].element_size() for k in spec.slots)
        per = 2 * target.element_size() + p.grad.element_size() + 2 * slots
        if master is not None:
            per += p.element_size()
        if two_pass and spec.kind == "lars":
            per += target.element_size() + p.grad.element_size()
        if two_pass and spec.kind == "lamb":
            per += target.element_size() + slots
        total += per * p.numel()
    return total


def update_time(torch, net, model, ids, labels):
    """Device time of ``optimizer.step()`` alone (:func:`graph_ms`, 10
    replays) on the gradients of one ``train_batch(update=False)``,
    through the kernel and (5 replays) the per-leaf path
    (``FLAGS_fused_optimizer=0``), beside its bound: ``update_bytes`` over
    the memory rate (an update does a few tens of fp32 operations an
    element, under a tenth of that time at 67 TFLOP/s), for LarsMomentum
    and Lamb also at the kernel's two passes."""
    opt = model._optimizer
    model.train_batch([ids], [labels], update=False)
    params = list(net.parameters())
    nbytes = update_bytes(params, opt)
    two = update_bytes(params, opt, two_pass=True)
    n = sum(p.numel() for p in params if p.grad is not None)
    ms = graph_ms(torch, opt.step)
    with _update_route("per_leaf"):
        leaf_ms = graph_ms(torch, opt.step, reps=5)
    torch.cuda.empty_cache()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    opt.clear_grad()
    log(f"  optimizer.step() alone: device {ms:.4f} ms through the kernel, "
        f"{leaf_ms:.4f} per leaf, for {n} parameters "
        f"({len(params)} tensors); bound {bound_ms:.4f} ms "
        f"({nbytes / n:.1f} B an element over 3.35 TB/s; the kernel's "
        f"passes {two / n:.1f} B), {bound_ms / ms:.1%} of it")
    return dict(device_ms=ms, per_leaf_device_ms=leaf_ms, bound_ms=bound_ms,
                bound_by="bytes", bytes=nbytes, bytes_per_element=nbytes / n,
                two_pass_bound_ms=two / HBM_BYTES_PER_S * 1e3,
                two_pass_bytes_per_element=two / n, elements=n,
                share_of_bound=bound_ms / ms)


def _library_adam(torch, opt, params, kind):
    """``torch._fused_adam_`` / ``torch._fused_adamw_`` (never called by the
    port) on copies of ``params`` with their gradients and fresh fp32
    moments, at the optimizer's rate, betas, eps and decay: (ms with CUDA
    events, device ms).  Its eps sits outside the folded bias correction
    of the reference's Adam, so its result is held to nothing."""
    ps = [p.detach().clone() for p in params]
    grads = [p.grad for p in params]
    m1 = [torch.zeros_like(p) for p in ps]
    m2 = [torch.zeros_like(p) for p in ps]
    steps = [torch.ones((), device=p.device) for p in ps]
    fn = torch._fused_adamw_ if kind == "adamw" else torch._fused_adam_
    wd = opt._weight_decay if kind == "adamw" else 0.0

    def call():
        fn(ps, grads, m1, m2, [], steps, lr=opt.get_lr(), beta1=opt._beta1,
           beta2=opt._beta2, weight_decay=wd, eps=opt._epsilon,
           amsgrad=False, maximize=False)
    return time_ms(torch, call, reps=10, warmup=2), graph_ms(torch, call)


def timing_update(torch, dev="cuda", configs=None,
                  setups=("fp32", "bf16 master")):
    """Phase 6's fused optimizer update: ``optimizer.step()`` on the GPT's
    149 parameters at full width (random gradients), for each optimizer of
    phase 13a, fp32 and decorated (bf16 over fp32 masters): the kernel
    (CUDA events around the eager call, host time included, and device
    time from :func:`graph_ms`), its plain version
    (``multi_tensor_update_ref`` on the card, events), the per-leaf path
    (``FLAGS_fused_optimizer=0``, events and device time), and in fp32 for
    Adam and AdamW ``torch._fused_adam(w)_`` (:func:`_library_adam`);
    beside the bound of :func:`update_bytes`, one pass and, for
    LarsMomentum and Lamb, the kernel's two."""
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    named = update_shapes(torch, GPT_WIDTH, dev)
    rows = []
    for setup in setups:
        for label, _, _, make in configs or OPTIMIZERS:
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(0)
            params = update_params(torch, named, setup, dev, gen, attrs=False)
            opt = update_optimizer(make, params, setup)
            update_grads(torch, params, gen)
            P = [p for _, p in params]
            opt.step()                      # slots, masters, tables
            sync(torch, dev)
            before = sum(mtu.LAUNCHES.values())
            opt.step()
            launches = sum(mtu.LAUNCHES.values()) - before
            ms = time_ms(torch, opt.step, reps=10, warmup=1)
            device_ms = graph_ms(torch, opt.step)
            with _update_route("plain"):
                plain_ms = time_ms(torch, opt.step, reps=3, warmup=1)
            with _update_route("per_leaf"):
                leaf_ms = time_ms(torch, opt.step, reps=3, warmup=1)
                leaf_device_ms = graph_ms(torch, opt.step, reps=3)
            kind = opt._kernel_spec().kind
            lib_ms = lib_device_ms = None
            if setup == "fp32" and kind in ("adam", "adamw"):
                lib_ms, lib_device_ms = _library_adam(torch, opt, P, kind)
            nbytes, two = update_bytes(P, opt), update_bytes(P, opt, True)
            n = sum(p.numel() for p in P)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append(dict(
                optimizer=label, kind=kind, setup=setup, tensors=len(P),
                elements=n, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                per_leaf_ms=leaf_ms, per_leaf_device_ms=leaf_device_ms,
                library_ms=lib_ms, library_device_ms=lib_device_ms,
                library=(f"torch._fused_{kind}_" if lib_ms is not None
                         else None),
                bound_ms=b_ms, bound_by="bytes", bytes_per_element=nbytes / n,
                two_pass_bound_ms=two / HBM_BYTES_PER_S * 1e3,
                two_pass_bytes_per_element=two / n,
                share_of_bound=b_ms / device_ms, update_launches=launches))
            log(f"  step() {label:20s} {setup:11s}: kernel {ms:.4f} ms, "
                f"device {device_ms:.4f} ({b_ms / device_ms:.1%} of the "
                f"{b_ms:.4f} ms bound, {nbytes / n:.0f} B an element; two "
                f"passes {two / n:.0f} B); plain {plain_ms:.4f}; per leaf "
                f"{leaf_ms:.4f}, device {leaf_device_ms:.4f}; library "
                f"{lib_ms if lib_ms is None else round(lib_ms, 4)}, device "
                f"{lib_device_ms if lib_device_ms is None else round(lib_device_ms, 4)}"
                f"; {launches} update launch(es) a step")
            del params, opt, P
            torch.cuda.empty_cache()
    return rows


# phase 13a: every optimizer of the port on the eager GPT at full width,
# captured (label, AMP level, decorated, factory of (optimizer module,
# regularizer module, parameters)); each learning rate is one at which the
# loss falls over 12 steps on one batch.  LarsMomentum's tokens match the
# GPT's biases and LayerNorms (blocks.i.ln1, ln2, ln_f)
OPTIMIZERS = (
    ("Momentum", "O1", False, lambda o, r, P: o.Momentum(
        0.01, 0.9, P, use_nesterov=True, weight_decay=r.L2Decay(1e-4))),
    ("LarsMomentum", "O1", False, lambda o, r, P: o.LarsMomentum(
        0.1, parameters=P, exclude_from_weight_decay=["bias", "ln"])),
    ("Adamax", "O1", False, lambda o, r, P: o.Adamax(1e-3, parameters=P)),
    ("Adagrad", "O1", False, lambda o, r, P: o.Adagrad(
        0.01, parameters=P, initial_accumulator_value=0.1)),
    ("Adadelta", "O1", False, lambda o, r, P: o.Adadelta(1.0,
                                                          parameters=P)),
    ("RMSProp", "O1", False, lambda o, r, P: o.RMSProp(
        1e-4, parameters=P, centered=True, momentum=0.9)),
    ("Lamb", "O1", False, lambda o, r, P: o.Lamb(1e-2, parameters=P)),
    ("Ftrl", "O1", False, lambda o, r, P: o.Ftrl(
        1e-5, l1=1e-4, l2=1e-4, parameters=P)),
    ("DecayedAdagrad", "O1", False, lambda o, r, P: o.DecayedAdagrad(
        2e-4, parameters=P)),
    ("SGD", "O1", False, lambda o, r, P: o.SGD(
        0.05, parameters=P, weight_decay=r.L1Decay(1e-5))),
    ("Adam lazy_mode", "O1", False, lambda o, r, P: o.Adam(
        1e-3, parameters=P, lazy_mode=True)),
    ("AdamW decorated O2", "O2", True, lambda o, r, P: o.AdamW(
        1e-3, parameters=P, weight_decay=0.01)))
# phase 13b: LAMB as BERT pretraining runs it (You et al. 2019)
LAMB_LR, LAMB_WD = 1e-2, 0.01


def optimizers_path(torch, fa, dev, cfg, configs=OPTIMIZERS):
    """Phase 13a: each optimizer through :func:`eager_train` (step 1
    through the kernels, counted; captured against uncaptured, launches
    per replay, the loss over 12 captured steps, step ms p50,
    ``optimizer.step()``'s device time)."""
    from paddle_tpu_torch import optimizer, regularizer
    out = {}
    for label, amp, decorate, make in configs:
        torch.cuda.empty_cache()
        how = ", amp.decorate: bf16 parameters, fp32 masters" \
            if decorate else ""
        log(f"== phase 13a: {label} (AMP {amp}{how})")
        out[label] = eager_train(
            torch, fa, dev, cfg, amp=amp, decorate=decorate,
            make_opt=lambda P, make=make: make(optimizer, regularizer, P),
            engines=("captured",), update_ms=True, plain_step=False)
    log("  phase 13a: optimizer, captured step ms p50, step() device ms "
        "(kernel, per leaf), bound ms, share, update launches a replay")
    for label, r in out.items():
        u = r["update"]
        log(f"    {label}: {r['step_ms_p50']:.3f}, {u['device_ms']:.4f}, "
            f"{u['per_leaf_device_ms']:.4f}, {u['bound_ms']:.4f}, "
            f"{u['share_of_bound']:.1%}, {r['replay_update_launches']}")
    return out


def lamb_o2(torch, fa, fl, dev, cfg, batch=ENCODER_BATCH):
    """Phase 13b: the fused encoder trained with LAMB on bf16 parameters
    over fp32 masters (``amp.decorate(net, Lamb(...), level="O2")``,
    ``prepare(amp_configs="O2", jit=True)``) through
    :func:`encoder_train`, then the same undecorated (fp32 parameters,
    bf16 views) for its step time and memory."""
    from paddle_tpu_torch.optimizer import Lamb
    from paddle_tpu_torch.tools.profile_train import build_encoder

    def make(params):
        return Lamb(LAMB_LR, lamb_weight_decay=LAMB_WD, parameters=params)

    out = {}
    for key, decorate in (("decorated", True), ("undecorated", False)):
        torch.cuda.empty_cache()
        log(f"== phase 13b: LAMB O2, {key}")
        out[key] = encoder_train(
            torch, fa, fl, build_encoder(cfg, dev), cfg, dev, batch=batch,
            amp="O2", make_opt=make, decorate=decorate, repeat=decorate,
            engines=("captured",), update_ms=True)
    return out


# -- phase 14 -----------------------------------------------------------------
# AMP in fp16 through Model.prepare, the reference's settings but for the
# initial scale: 2^12 keeps the first steps clear of an overflow at full
# width (the default 2^15 is an option; the planted overflow below is
# where one is tested)
FP16_O1 = {"level": "O1", "dtype": "float16", "init_loss_scaling": 2.0 ** 12}
FP16_O2 = dict(FP16_O1, level="O2")
# the planted overflow: a scale far past fp16's range, cut by 2^-30 at the
# first non-finite step (decr_every_n_nan_or_inf 1) to one far inside it
OVERFLOW = dict(FP16_O1, init_loss_scaling=2.0 ** 40,
                decr_every_n_nan_or_inf=1, decr_ratio=2.0 ** -30)


def _slots_initial(torch, opt, net):
    """Whether every slot of ``opt`` is as AdamW makes it: moments zero,
    powers one (no update has reached them)."""
    for p in net.parameters():
        for k, v in opt._state.get(id(p), {}).items():
            if k.endswith("_pow") and not bool((v == 1).all()):
                return False
            if k.startswith("moment") and bool(v.any()):
                return False
    return bool(opt._state)


def fp16_overflow(torch, fa, dev, cfg):
    """The planted overflow on the full-width GPT under fp16 O1, captured:
    step 1 (the real step before the capture) starts at OVERFLOW's scale
    2^40, where the fp16 gradients are inf: no parameter moves, every
    slot stays as made (moments 0, powers 1), the scale falls to 2^10.
    Step 2 (a replay) updates.  Then the scale is set to 2^40 again in
    place and step 3, a replay, overflows: every parameter, slot and power
    bit for bit as before it, the scale 2^10 again; step 4 updates.  The
    optimizer's step count advances on every step, as the reference's
    does.  Returns the report."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    w = cfg["width"]
    net = GPT(GPTConfig(**w), device=dev, seed=0)
    opt = AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01)
    model = Model(net).prepare(opt, CrossEntropyLoss(),
                               amp_configs=dict(OVERFLOW), jit=True)
    ids, labels = _batch(torch, w["vocab_size"], cfg["batch"], cfg["seq"],
                         dev)
    rows = []

    def step(i):
        before = _train_state(net, opt)
        _reset_update()
        loss = model.train_batch([ids], [labels])["loss"]
        sync(torch, dev)
        after = _train_state(net, opt)
        sc = model._scaler
        kept = [k for k in before if not _same_bits(torch, after[k],
                                                    before[k])]
        row = dict(step=i, loss=loss.item(), found_inf=bool(
            model._amp_found_inf), scale=sc["scale"].item(),
            good=int(sc["good"]), bad=int(sc["bad"]),
            moved=len(kept), values=len(before),
            slots_initial=_slots_initial(torch, opt, net),
            global_step=opt._global_step, launches=_update_launches())
        rows.append(row)
        log(f"  overflow run step {i}: found_inf {row['found_inf']}, scale "
            f"{row['scale']:.6g}, good {row['good']}, bad {row['bad']}, "
            f"values moved {row['moved']} of {row['values']} (before the "
            f"step: {len(before)}), slots as made {row['slots_initial']}, "
            f"loss {row['loss']:.5f}, step count {row['global_step']}, "
            f"launches {row['launches']}")
        return row

    first = step(1)
    second = step(2)
    model._scaler["scale"].fill_(OVERFLOW["init_loss_scaling"])
    third = step(3)
    fourth = step(4)
    want_scale = OVERFLOW["init_loss_scaling"] * OVERFLOW["decr_ratio"]
    ok = (first["found_inf"] and first["moved"] == 0 and
          first["slots_initial"] and first["scale"] == want_scale
          and (first["good"], first["bad"]) == (0, 0)
          and not second["found_inf"] and second["moved"] > 0
          and second["good"] == 1 and third["found_inf"]
          and third["moved"] == 0 and third["scale"] == want_scale
          and (third["good"], third["bad"]) == (0, 0)
          and not fourth["found_inf"] and fourth["moved"] > 0
          and [r["global_step"] for r in rows] == [1, 2, 3, 4]
          and all(math.isfinite(r["loss"]) for r in rows)
          and third["launches"]["update"] == {"adamw": 1}
          and third["launches"]["update_unscale"] == 1
          and _all_captured(model._steps.entries().values()))
    log(f"  the overflow steps (1, and 3, a replay) moved nothing, the scale "
        f"fell to {want_scale:.6g} and the next steps updated: {ok}")
    if not ok:
        raise AssertionError(f"the planted overflow: {rows}")
    del model, net, opt
    return dict(steps=rows, ok=ok, config=OVERFLOW)


def grad_scaler_loop(torch, fa, dev, cfg, steps=3):
    """The eager ``GradScaler`` loop on the full-width GPT: ``auto_cast``
    O1 fp16 forward, ``scaler.scale(loss).backward()``, ``scaler.step``
    (one host read of the flag) and ``clear_grad``, ``steps`` times; each
    step launches L + L attention kernels (all on flash_attn_sm90, d 64),
    one unscale and one update pass, and the loss stays finite."""
    from paddle_tpu_torch import amp as pamp
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    w = cfg["width"]
    L = w["num_layers"]
    net = GPT(GPTConfig(**w), device=dev, seed=0)
    opt = AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01)
    scaler = pamp.GradScaler(init_loss_scaling=FP16_O1["init_loss_scaling"])
    loss_fn = CrossEntropyLoss()
    ids, labels = _batch(torch, w["vocab_size"], cfg["batch"], cfg["seq"],
                         dev)
    mode = fa._pallas_mode(cfg["seq"], cfg["seq"], True)
    want = dict(_attention_want(L, mode, mode, FP16_O1),
                update={"adamw": 1}, update_norms=0, update_pows=1,
                update_unscale=1)
    rows = []
    for i in range(steps):
        sync(torch, dev)
        _reset_attention(fa)
        _reset_update()
        with pamp.auto_cast(level="O1", dtype="float16"):
            out = net(ids)
        loss = loss_fn(out, labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        sync(torch, dev)
        counts = dict(_attention_launches(fa), **_update_launches())
        rows.append(dict(loss=loss.item(), scale=scaler.state_dict()["scale"],
                         launches=counts))
        del out, loss
    ok = all(r["launches"] == want for r in rows) and all(
        math.isfinite(r["loss"]) for r in rows)
    log(f"  GradScaler loop, {steps} eager steps: losses "
        f"{[round(r['loss'], 5) for r in rows]}, scale "
        f"{rows[-1]['scale']}, launches a step {rows[-1]['launches']} "
        f"(expected {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the GradScaler loop: {rows}")
    del net, opt
    return dict(steps=rows, ok=ok)


def _epilogue_types(torch, fl, run):
    """The (x, residual, parameter) types of every fused_ln launch during
    ``run()``, recorded by a wrapper around the kernel's wrapper."""
    seen = set()
    real = fl.fused_ln

    def record(x, residual, bias, gamma, beta, *a, **kw):
        seen.add((_dtype_name(x.dtype), _dtype_name(residual.dtype),
                  _dtype_name(gamma.dtype)))
        return real(x, residual, bias, gamma, beta, *a, **kw)
    with mock.patch.object(fl, "fused_ln", record):
        run()
    return sorted(seen)


def fp16_path(torch, fa, fl, dev, cfg, encoder_cfg, encoder_batch,
              bf16_o1=None):
    """Phase 14: AMP in fp16.  The full-width GPT under FP16_O1 through
    :func:`eager_train` (a step through the kernels against the plain
    versions, 3 captured steps equal to 3 uncaptured bit for bit with the
    scaler's state, L + L attention launches a replay on flash_attn_sm90
    (d 64), one unscale and one update launch, the loss falling over 12
    steps of each engine, step ms, seq/s, peak memory); the planted overflow
    (:func:`fp16_overflow`); the encoder under FP16_O1 (2L + 2L epilogue
    launches a replay, on fp16 x), captured; O2 at AMP_O2_LAYERS through
    ``amp.decorate(level="O2", dtype="float16")``: fp16 parameters equal
    to their fp32 masters cast after every step; the eager GradScaler loop
    (:func:`grad_scaler_loop`)."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools.profile_train import build_encoder
    log("== phase 14: the GPT at full width under AMP O1 in fp16")
    gpt = eager_train(torch, fa, dev, cfg, amp=dict(FP16_O1))
    if bf16_o1 is not None:
        log(f"  phase 14 against phase 9's bf16 O1: captured step ms p50 "
            f"{gpt['captured']['step_ms_p50']:.3f} / "
            f"{bf16_o1['captured']['step_ms_p50']:.3f}, seq/s "
            f"{gpt['captured']['seq_per_s']:.2f} / "
            f"{bf16_o1['captured']['seq_per_s']:.2f}, peak GiB "
            f"{gpt['captured']['peak_memory_bytes'] / 2**30:.3f} / "
            f"{bf16_o1['captured']['peak_memory_bytes'] / 2**30:.3f}")
    torch.cuda.empty_cache()
    log("== phase 14: a planted overflow (fp16 O1, captured)")
    overflow = fp16_overflow(torch, fa, dev, cfg)
    torch.cuda.empty_cache()
    log("== phase 14: the fused encoder under AMP O1 in fp16")
    enc_net = build_encoder(encoder_cfg, dev)
    T = encoder_cfg["max_len"]
    ids, labels = _batch(torch, encoder_cfg["vocab_size"], 2, T, dev)

    def one_step():
        model = Model(enc_net).prepare(
            AdamW(1e-3, parameters=enc_net.parameters()), CrossEntropyLoss(),
            amp_configs=dict(FP16_O1), jit=False)
        model.train_batch([ids], [labels], update=False)
        for p in enc_net.parameters():
            p.grad = None
    types = _epilogue_types(torch, fl, one_step)
    log(f"  the epilogue's (x, residual, parameters) types under fp16 O1: "
        f"{types}")
    if not types or any(x != "float16" for x, _, _ in types):
        raise AssertionError(f"fp16 O1 reached the epilogue with {types}")
    enc = encoder_train(torch, fa, fl, enc_net, encoder_cfg, dev,
                        batch=encoder_batch, amp=dict(FP16_O1),
                        engines=("captured",))
    enc["epilogue_types"] = types
    del enc_net
    torch.cuda.empty_cache()
    log(f"== phase 14: AMP O2 in fp16 through amp.decorate at L "
        f"{AMP_O2_LAYERS}")
    o2 = eager_train(torch, fa, dev, _o2_gpt(cfg), amp=dict(FP16_O2),
                     decorate=torch.float16, engines=("captured",))
    torch.cuda.empty_cache()
    log("== phase 14: the eager GradScaler loop")
    scaler = grad_scaler_loop(torch, fa, dev, cfg)
    torch.cuda.empty_cache()
    return dict(gpt=gpt, overflow=overflow, encoder=enc, o2=o2,
                grad_scaler=scaler)


# -- phase 15 -----------------------------------------------------------------
# the budget remat as a user turns it on (the port has no planner yet, so
# any budget engages it), and the steps each run takes: PHASE15_STEPS
# compared bit for bit (the second one a replay, counted), then
# PHASE15_TIMED timed
REMAT_FLAGS = {"FLAGS_program_remat": True, "FLAGS_remat_budget_mb": 4096}
PHASE15_STEPS, PHASE15_TIMED = 3, 10
# the pinned copies whose rates bound an offloaded update
COPY_BYTES = 1 << 30
# phase 15's LAMB encoder and build_spmd_train_step: L 2
PHASE15_LAYERS = 2


def _host_state(net, opt):
    """Host copies of the parameters, every optimizer slot and master
    (after a synchronise: an offloaded update writes host slots
    asynchronously)."""
    import torch
    torch.cuda.synchronize()
    out = {f"param {n}": p.detach().cpu() for n, p in net.named_parameters()}
    for n, p in net.named_parameters():
        for k, v in opt._state.get(id(p), {}).items():
            out[f"slot {n}_{k}"] = v.clone() if v.device.type == "cpu" \
                else v.cpu()
        if id(p) in opt._master_weights:
            out[f"master {n}"] = opt._master_weights[id(p)].cpu()
    return out


def _same_run(torch, a, b):
    """Whether two phase-15 runs agree bit for bit: losses, parameters,
    slots and masters."""
    return a["losses"] == b["losses"] and a["state"].keys() == \
        b["state"].keys() and all(torch.equal(v, b["state"][k])
                                  for k, v in a["state"].items())


def phase15_run(torch, make_net, make_opt, ids, labels, amp, remat=False,
                offload=False, decorate=False, reset=None, launches=None,
                timed=True, update=False):
    """A fresh ``Model(make_net())`` prepared with ``make_opt``'s optimizer
    (through ``amp.decorate(..., level="O2")`` with ``decorate``),
    ``amp_configs=amp``, ``jit=True`` and ``offload``, trained under
    REMAT_FLAGS with ``remat``: PHASE15_STEPS captured steps on the batch
    rolled by 0, 1, 2 rows from ``paddle_tpu_torch.seed(2)`` (the second,
    a replay, counted with ``reset`` / ``launches`` and the update's
    counters), the state copied to the host, then with ``timed``
    PHASE15_TIMED steps on the batch, each between CUDA events.  Peak
    allocated memory from before the first step (which runs the step and
    captures it); the graph pool's growth at the capture.  With ``update``
    also ``optimizer.step()``'s device time (:func:`update_time`)."""
    import gc
    import warnings
    import paddle_tpu_torch
    from paddle_tpu_torch import Model
    from paddle_tpu_torch import amp as pamp
    from paddle_tpu_torch.nn import CrossEntropyLoss
    gc.collect()
    torch.cuda.empty_cache()
    net = make_net()
    opt = make_opt(net.parameters())
    if decorate:
        pamp.decorate(net, opt, level="O2")
    model = Model(net).prepare(opt, CrossEntropyLoss(), amp_configs=amp,
                               offload=offload)
    dev = ids.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paddle_tpu_torch.seed(2)
    losses, counts, times = [], None, []
    with port_flags(REMAT_FLAGS if remat else {}), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(PHASE15_STEPS):
            if i == 1 and reset is not None:
                sync(torch, dev)
                reset()
                _reset_update()
            losses.append(model.train_batch([ids.roll(i, 0)],
                                            [labels.roll(i, 0)])["loss"])
            if i == 1 and reset is not None:
                sync(torch, dev)
                counts = dict(launches(), **_update_launches())
        state = _host_state(net, opt)
        for _ in range(PHASE15_TIMED if timed else 0):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model.train_batch([ids], [labels])
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
        resident = torch.cuda.memory_allocated()
        upd = update_time(torch, net, model, ids, labels) if update else None
        if update and offload:
            upd["routes_device_ms"] = offload_routes_ms(torch, model, ids,
                                                        labels)
    entries = list(model._steps.entries().values())
    out = dict(losses=[float(v) for v in torch.stack(losses).cpu()],
               state=state, launches=counts, step_ms=times,
               step_ms_p50=pct(times, 50) if times else None,
               peak_memory_bytes=peak, resident_bytes=resident,
               pool_bytes=sum(getattr(e, "pool_bytes", 0) for e in entries),
               captured=_all_captured(entries),
               warnings=sorted({str(w.message) for w in caught}),
               update=upd, remat_active=model._remat_active)
    if offload:
        # the host slots, and the masters on the card (a run's device
        # tensors kept past it would count in the next run's memory);
        # the parameters' sizes, which set the staged route's stages
        out.update(slots=[t for s in opt._state.values() for t in s.values()],
                   masters=list(opt._master_weights.values()),
                   sizes=[p.numel() for _, p in opt._params
                          if p.requires_grad])
    del model, net, opt
    return out


def offload_routes_ms(torch, model, ids, labels):
    """Device times of an offloaded ``optimizer.step()`` on its two routes,
    staged and in place (``mtu._STAGE_OFFLOAD`` patched to False), each
    captured and the two graphs replayed in alternating rounds
    (:func:`graphs_ms`, 6 rounds of 5): ``{"staged": ms, "in_place":
    ms}``."""
    from unittest import mock
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    opt = model._optimizer
    model.train_batch([ids], [labels], update=False)
    tables = {}

    def step(staged):
        def fn():
            with mock.patch.object(mtu, "_STAGE_OFFLOAD", staged):
                opt._fused_tables = tables.get(staged)
                opt.step()
                tables[staged] = opt._fused_tables   # each graph's own
        return fn
    try:
        (staged, _), (in_place, _) = graphs_ms(
            torch, [step(True), step(False)], rounds=6, reps=5)
    finally:
        opt._fused_tables = None
        opt.clear_grad()
        del tables
        torch.cuda.empty_cache()
    return dict(staged=staged, in_place=in_place)


def _remat_want(want):
    """A remat step's launches: each forward kernel twice (the forward and
    the recompute), the backward kernels once."""
    out = dict(want, fwd=2 * want["fwd"], sm90_fwd=2 * want["sm90_fwd"],
               modes={k: 2 * v if k.startswith("fwd") else v
                      for k, v in want["modes"].items()})
    for k in ("fused_ln", "fused_ln_tile"):
        if k in want:
            out[k] = 2 * want[k]
    return out


def _remat_pair(torch, label, base, rem, want, update_want):
    """Phase 15's remat verdict on one model: bit for bit, the launches of
    a replayed remat step, the warning; step ms and peak memory beside the
    run without remat."""
    same = _same_run(torch, base, rem)
    rwant = dict(_remat_want(want), **update_want)
    bwant = dict(want, **update_want)
    warned = any("planner peak unknown" in m for m in rem["warnings"])
    gib = 2 ** 30
    log(f"  {label}: {PHASE15_STEPS} captured steps with remat = without, "
        f"bit for bit (losses, {len(base['state'])} parameters and slots): "
        f"{same}; losses {rem['losses']}")
    log(f"  {label}: a replayed remat step launched {rem['launches']} "
        f"(expected {rwant}); without remat {base['launches']} (expected "
        f"{bwant}); the reference's warning: {warned}")
    log(f"  {label}: step ms p50 {rem['step_ms_p50']:.3f} with remat / "
        f"{base['step_ms_p50']:.3f} without ({PHASE15_TIMED} captured "
        f"steps, CUDA events); peak allocated "
        f"{rem['peak_memory_bytes'] / gib:.3f} / "
        f"{base['peak_memory_bytes'] / gib:.3f} GiB; graph pool "
        f"{rem['pool_bytes'] / gib:.3f} / {base['pool_bytes'] / gib:.3f} "
        f"GiB; {card_line()}")
    if not (same and rem["captured"] and base["captured"]):
        raise AssertionError(f"{label}: the remat steps are not the steps "
                             f"without remat, bit for bit (or not "
                             f"captured)")
    if rem["launches"] != rwant or base["launches"] != bwant:
        raise AssertionError(f"{label}: launches {rem['launches']} / "
                             f"{base['launches']}; expected {rwant} / "
                             f"{bwant}")
    if not (warned and rem["remat_active"]):
        raise AssertionError(f"{label}: the remat did not engage with the "
                             f"reference's warning")
    return dict(bit_for_bit=same, launches=rem["launches"],
                launches_without=base["launches"], losses=rem["losses"],
                step_ms_p50=rem["step_ms_p50"],
                step_ms_p50_without=base["step_ms_p50"],
                step_ms=rem["step_ms"], step_ms_without=base["step_ms"],
                peak_memory_bytes=rem["peak_memory_bytes"],
                peak_memory_bytes_without=base["peak_memory_bytes"],
                pool_bytes=rem["pool_bytes"],
                pool_bytes_without=base["pool_bytes"])


def copy_rates(torch, nbytes=COPY_BYTES, reps=5):
    """Pinned host-to-device and device-to-host copies of ``nbytes``, each
    between CUDA events, and both at once on two streams (``"both"``: GB/s
    each way), the median of ``reps`` after one warm-up: ms and GB/s."""
    host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    card = [torch.empty(nbytes, dtype=torch.uint8, device="cuda")
            for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    pairs = {"h2d": [(card[0], host[0])], "d2h": [(host[0], card[0])],
             "both": [(card[0], host[0]), (host[1], card[1])]}
    out = {}
    for name, copies in pairs.items():
        times = []
        for _ in range(reps + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for stream, (dst, src) in zip(streams, copies):
                stream.wait_event(a)
                with torch.cuda.stream(stream):
                    dst.copy_(src, non_blocking=True)
                torch.cuda.current_stream().wait_stream(stream)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = pct(times[1:], 50)
        out[name] = dict(ms=ms, gb_per_s=nbytes / (ms / 1e3) / 1e9,
                         bytes=nbytes)
    del host, card, pairs
    torch.cuda.empty_cache()
    return out


def _offload_bound(upd, slot_bytes, rates):
    """The offloaded update's bound: the largest of its card bytes over the
    memory rate, its host slots' bytes (read once, written once) over the
    measured pinned copy rate each way alone, and over the rate each way
    with both at once (the update moves both together)."""
    card = upd["bytes"] - 2 * slot_bytes
    times = dict(hbm=card / HBM_BYTES_PER_S * 1e3)
    for k in ("h2d", "d2h", "both"):
        times[k] = slot_bytes / (rates[k]["gb_per_s"] * 1e9) * 1e3
    by = max(times, key=times.get)
    return dict(bound_ms=times[by], bound_by=by, parts_ms=times,
                slot_bytes=slot_bytes, card_bytes=card)


def offload_spmd(torch, dev, layers=PHASE15_LAYERS, batch=8, seq=512,
                 steps=2):
    """``build_spmd_train_step(offload=True)`` on one card against
    ``offload=False``: ``steps`` bf16 steps at L ``layers``, bit for bit
    (the reference's offload acts only under a "sharding" axis)."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, build_spmd_train_step
    from paddle_tpu_torch.models.gpt_spmd import _leaves
    cfg = GPTConfig(**dict(GPT_WIDTH, num_layers=layers))
    rng = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (batch, seq))).to(dev)
                   for _ in range(2))
    runs = []
    for offload in (False, True):
        step, init = build_spmd_train_step(cfg, compute_dtype=torch.bfloat16,
                                           offload=offload,
                                           remat_policy="ctx", device=dev)
        params, opt = init(0)
        losses = []
        for _ in range(steps):
            loss, params, opt = step(params, opt, ids, labels)
            losses.append(float(loss))
        state = {f"p {k}": v.cpu() for k, v in _leaves(params).items()}
        state.update({f"o {k}": v.cpu() for k, v in _leaves(opt).items()})
        runs.append(dict(losses=losses, state=state))
        del params, opt
    same = _same_run(torch, *runs)
    log(f"  build_spmd_train_step(offload=True) at L {layers}, B {batch}, "
        f"T {seq}, bf16: {steps} steps bit for bit those of offload=False: "
        f"{same}; losses {runs[1]['losses']}")
    if not same:
        raise AssertionError("build_spmd_train_step(offload=True) differs "
                             "from offload=False on one device")
    return dict(bit_for_bit=same, losses=runs[1]["losses"], layers=layers,
                batch=batch, seq=seq)


def remat_offload_path(torch, fa, fl, dev, cfg, encoder_cfg, encoder_batch):
    """Phase 15: the budget remat of ``Model``'s captured step on the GPT
    (phase 9's shape) and the dropout encoder (phase 11's) under AMP O1,
    each against the same steps without it; optimizer-state offload on
    that GPT with AdamW (slots pinned, the update reading them in place,
    its device time against the PCIe bound of the measured pinned copy
    rates), on LAMB over the decorated O2 encoder at L 2, and in
    ``build_spmd_train_step`` at L 2."""
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    from paddle_tpu_torch.optimizer import AdamW, Lamb
    from paddle_tpu_torch.tools.profile_train import build_encoder
    t0 = time.perf_counter()
    w = cfg["width"]
    L, T = w["num_layers"], cfg["seq"]
    ids, labels = _batch(torch, w["vocab_size"], cfg["batch"], T, dev)
    mode = fa._pallas_mode(T, T, True)
    gpt_want = _attention_want(L, mode, mode, "O1")

    def gpt():
        return GPT(GPTConfig(**w), device=dev, seed=0)

    def adamw(params):
        return AdamW(1e-3, parameters=params, weight_decay=0.01)
    att = dict(reset=lambda: _reset_attention(fa),
               launches=lambda: _attention_launches(fa))
    upd_want = dict(update={"adamw": 1}, update_norms=0, update_pows=1,
                    update_unscale=0)
    log("== phase 15: remat, the GPT under AMP O1 (without, then with)")
    base = phase15_run(torch, gpt, adamw, ids, labels, "O1", update=True,
                       **att)
    rem = phase15_run(torch, gpt, adamw, ids, labels, "O1", remat=True,
                      **att)
    out = dict(gpt_remat=_remat_pair(torch, "GPT O1", base, rem, gpt_want,
                                     upd_want))
    del rem
    log("== phase 15: remat, the fused encoder under AMP O1 (dropout "
        f"{encoder_cfg['dropout_rate']})")
    EL, ET = encoder_cfg["num_layers"], encoder_cfg["max_len"]
    e_ids, e_labels = _batch(torch, encoder_cfg["vocab_size"], encoder_batch,
                             ET, dev)
    e_mode = fa._pallas_mode(ET, ET, False)
    enc_want = dict(_attention_want(EL, e_mode, e_mode, "O1"),
                    **_epilogue_want(EL, "O1"))
    enc_att = dict(reset=lambda: _reset_encoder(fa, fl),
                   launches=lambda: _encoder_launches(fa, fl))
    runs = [phase15_run(torch, lambda: build_encoder(encoder_cfg, dev), adamw,
                        e_ids, e_labels, "O1", remat=on, **enc_att)
            for on in (False, True)]
    out["encoder_remat"] = _remat_pair(torch, "encoder O1", *runs, enc_want,
                                       upd_want)
    del runs
    log("== phase 15: offload, the GPT under AMP O1 with AdamW")
    rates = copy_rates(torch)
    log(f"  pinned copies of {COPY_BYTES / 2**30:.0f} GiB: host to device "
        f"{rates['h2d']['gb_per_s']:.2f} GB/s ({rates['h2d']['ms']:.3f} ms)"
        f", device to host {rates['d2h']['gb_per_s']:.2f} GB/s "
        f"({rates['d2h']['ms']:.3f} ms), both at once "
        f"{rates['both']['gb_per_s']:.2f} GB/s each way "
        f"({rates['both']['ms']:.3f} ms); {card_line()}")
    off = phase15_run(torch, gpt, adamw, ids, labels, "O1", offload=True,
                      update=True, **att)
    # one fp32 group, staged: one launch of the update pass per stage
    stages = len(mtu.stage_cuts(off["sizes"], mtu.STAGE_ELEMENTS))
    off_want = dict(gpt_want, **dict(upd_want, update={"adamw": stages}))
    same = _same_run(torch, base, off)
    pinned = bool(off["slots"]) and all(
        t.device.type == "cpu" and t.is_pinned() for t in off["slots"])
    mapped = [mtu.device_address(t) for t in off["slots"]]
    at_same = all(m == t.data_ptr() for m, t in zip(mapped, off["slots"]))
    slot_bytes = sum(t.numel() * t.element_size() for t in off["slots"])
    bound = _offload_bound(off["update"], slot_bytes, rates)
    u, ub = off["update"], base["update"]
    routes = u["routes_device_ms"]
    gib = 2 ** 30
    log(f"  offload: {PHASE15_STEPS} captured steps = offload=False, bit "
        f"for bit: {same}; {len(off['slots'])} slots, all pinned host "
        f"memory: {pinned}, read at their own address "
        f"(cudaPointerGetAttributes): {at_same}; a replayed step launched "
        f"{off['launches']} (expected {off_want}: {stages} stages of "
        f"{mtu.STAGE_ELEMENTS} elements)")
    log(f"  offload: step ms p50 {off['step_ms_p50']:.3f} / "
        f"{base['step_ms_p50']:.3f} without; peak allocated "
        f"{off['peak_memory_bytes'] / gib:.3f} / "
        f"{base['peak_memory_bytes'] / gib:.3f} GiB, resident after the "
        f"steps {off['resident_bytes'] / gib:.3f} / "
        f"{base['resident_bytes'] / gib:.3f} GiB, graph pool "
        f"{off['pool_bytes'] / gib:.3f} / {base['pool_bytes'] / gib:.3f} "
        f"GiB (slots {slot_bytes / gib:.3f} GiB); optimizer.step() device "
        f"{u['device_ms']:.4f} ms staged alone; in alternating rounds "
        f"{routes['staged']:.4f} staged, {routes['in_place']:.4f} in place "
        f"({ub['device_ms']:.4f} without offload), bound "
        f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
        f"({bound['bound_ms'] / routes['staged']:.1%} of it staged, "
        f"{bound['bound_ms'] / routes['in_place']:.1%} in place; "
        f"parts {({k: round(v, 4) for k, v in bound['parts_ms'].items()})})"
        f"; {card_line()}")
    if not (same and pinned and off["captured"]):
        raise AssertionError("offload: the steps differ from offload=False, "
                             "or a slot is not pinned host memory")
    if off["launches"] != off_want:
        raise AssertionError(f"offload: launches {off['launches']}")
    out["gpt_offload"] = dict(
        bit_for_bit=same, slots_pinned=pinned, slots=len(off["slots"]),
        slot_bytes=slot_bytes, mapped_at_host_address=at_same,
        launches=off["launches"], stages=stages,
        step_ms_p50=off["step_ms_p50"],
        step_ms_p50_without=base["step_ms_p50"], step_ms=off["step_ms"],
        peak_memory_bytes=off["peak_memory_bytes"],
        peak_memory_bytes_without=base["peak_memory_bytes"],
        resident_bytes=off["resident_bytes"],
        resident_bytes_without=base["resident_bytes"],
        pool_bytes=off["pool_bytes"], pool_bytes_without=base["pool_bytes"],
        update=u, update_without=ub,
        bound=bound, routes_device_ms=routes,
        share_of_bound=bound["bound_ms"] / routes["staged"],
        share_of_bound_in_place=bound["bound_ms"] / routes["in_place"],
        copy_rates=rates)
    del base, off
    log(f"== phase 15: offload, LAMB on the decorated O2 encoder at L "
        f"{PHASE15_LAYERS}")
    small = dict(encoder_cfg, num_layers=PHASE15_LAYERS)

    def lamb(params):
        return Lamb(LAMB_LR, lamb_weight_decay=LAMB_WD, parameters=params)
    runs = [phase15_run(torch, lambda: build_encoder(small, dev), lamb,
                        e_ids, e_labels, "O2", offload=on, decorate=True,
                        timed=False) for on in (False, True)]
    same = _same_run(torch, *runs)
    pinned = all(t.is_pinned() for t in runs[1]["slots"])
    on_card = bool(runs[1]["masters"]) and all(
        m.is_cuda for m in runs[1]["masters"])
    log(f"  LAMB O2 decorated, offloaded: {PHASE15_STEPS} captured steps = "
        f"offload=False bit for bit: {same}; slots pinned: {pinned}; "
        f"{len(runs[1]['masters'])} fp32 masters on the card: {on_card}")
    if not (same and pinned and on_card):
        raise AssertionError("offload: LAMB O2 differs from offload=False, "
                             "or its slots / masters are misplaced")
    out["lamb_o2_offload"] = dict(bit_for_bit=same, slots_pinned=pinned,
                                  masters_on_card=on_card,
                                  losses=runs[1]["losses"])
    del runs
    log(f"== phase 15: build_spmd_train_step(offload=True) at L "
        f"{PHASE15_LAYERS}")
    out["spmd_offload"] = offload_spmd(torch, dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 15 took {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out


# -- phase 16 -----------------------------------------------------------------
# Model.fit's fault-tolerance hooks at full width: the O1 bf16 GPT, AdamW at
# a constant lr (the checkpoint tree holds no scheduler, as the
# reference's), B 32, T 512, seed 0, shuffle off.  16a: U trains ``steps``
# batches; S trains ``save_at`` with a checkpointer that saves every
# ``interval``-th step (the reference's window: steps 1 and 6); R, the
# network re-initialised from seed 1, resumes from S's directory over the
# same batches.  16b: the guard's ``skip`` with step.loss poisoned at
# ``poison`` over ``guard_steps`` batches against a hand loop; ``raise``;
# ``rollback`` at ``rollback_at`` to the newest of ``rollback_interval``-
# spaced saves (1, 3, 5, each written before the next step: the second and
# third reuse the first's pinned block).  16c:
# what each costs, and the guard on an offloaded optimizer over
# ``offload_steps``.
FIT_HOOKS = dict(width=GPT_WIDTH, batch=32, seq=512, lr=1e-4, steps=12,
                 save_at=6, interval=5, keep=2, poison=4, guard_steps=8,
                 rollback_interval=2, rollback_at=6, offload_steps=5)


def _fit_hooks_state(model):
    """Device copies of the parameters and buffers, every slot and master,
    and the step count."""
    fs = model._optimizer.functional_state()
    return dict(params={k: v.clone()
                        for k, v in model.network.state_dict().items()},
                slots={f"{n}.{k}": v.clone() for n, s in fs["slots"].items()
                       for k, v in s.items()},
                master={n: v.clone() for n, v in fs["master"].items()},
                step=fs["step"])


def _fit_hooks_same(torch, a, b):
    """Whether two :func:`_fit_hooks_state` are equal bit for bit."""
    if a["step"] != b["step"]:
        return False
    return all(a[part].keys() == b[part].keys() and all(
        torch.equal(v, b[part][k]) for k, v in a[part].items())
        for part in ("params", "slots", "master"))


def _fit_hooks_put(torch, model, state):
    """Copy a :func:`_fit_hooks_state` back into the live model in place
    (the hand loop's revert)."""
    with torch.no_grad():
        for k, v in model.network.state_dict().items():
            v.copy_(state["params"][k])
        fs = model._optimizer.functional_state()
        for n, s in fs["slots"].items():
            for k, v in s.items():
                v.copy_(state["slots"][f"{n}.{k}"])
        for n, v in fs["master"].items():
            v.copy_(state["master"][n])
    model._optimizer._global_step = state["step"]


def _losses(watch):
    return [float(s["loss"]) for s in watch.steps]


def _ms(watch, idx):
    """CUDA-event ms of the steps at ``idx`` of a run."""
    return [watch.steps[i]["events"][0].elapsed_time(
        watch.steps[i]["events"][1]) for i in idx]


def fit_hooks_path(torch, fa, dev, cfg=FIT_HOOKS):
    """Phase 16 (see FIT_HOOKS): ``fit(checkpointer=...)`` and
    ``FLAGS_anomaly_action`` on the O1 GPT at full width.  Checks, failing
    the run on any miss: S commits steps 1 and ``save_at``; R warns that
    it resumed at ``save_at``, replays that many batches untrained
    (no callback), and its losses, parameters, slots and step count equal
    U's bit for bit; R's newest tree passes ``verify_checkpoint``;
    ``skip`` equals a hand loop of captured ``train_batch`` that copies
    the state before the poisoned batch back after it, bit for bit, with
    ``train.anomaly`` up by 1; ``raise`` raises FloatingPointError naming
    the poisoned step; ``rollback`` leaves the model equal to the newest
    committed tree and says so; every replayed step of U, S, R and the
    guarded run launches rows 1 and 6 L times each and the update once;
    the guard on an offloaded optimizer leaves its pinned slots as before
    a poisoned step.  Records step ms p50 (no hooks, a checkpointer's
    non-saving steps, a saving step, the guard, the guard offloaded), the
    host seconds of ``save``, the bytes, the write's seconds and GB/s, the
    manifest's (sha256s and fsyncs), a ``verify_checkpoint``'s and a
    ``restore``'s seconds; returns the report."""
    import gc
    import shutil
    import tempfile
    import warnings
    import paddle_tpu_torch
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import metrics
    from paddle_tpu_torch.tools import profile_train as pt
    from paddle_tpu_torch.utils import chaos
    t0 = time.perf_counter()
    w, B, T, n = cfg["width"], cfg["batch"], cfg["seq"], cfg["steps"]
    L = w["num_layers"]
    data = pt.fit_data(n * B, 0, w["vocab_size"], T)
    net = GPT(GPTConfig(**w), device=dev, seed=0)
    state0 = {k: v.clone() for k, v in net.state_dict().items()}
    other = GPT(GPTConfig(**w), device=dev, seed=1)
    state1 = {k: v.clone() for k, v in other.state_dict().items()}
    del other
    mode = fa._pallas_mode(T, T, True)
    want = dict(_attention_want(L, mode, mode, "O1"), **FIT_UPDATE)

    def reset():
        _reset_attention(fa)
        _reset_update()

    def launches():
        return dict(_attention_launches(fa), **_update_launches())

    def fresh(state, offload=False):
        gc.collect()
        torch.cuda.empty_cache()
        net.load_state_dict(state)
        for p in net.parameters():
            p.grad = None
        paddle_tpu_torch.seed(0)
        torch.manual_seed(0)
        return Model(net).prepare(
            AdamW(cfg["lr"], parameters=net.parameters(), weight_decay=0.01),
            CrossEntropyLoss(), amp_configs="O1", offload=offload)

    def run(model, steps, checkpointer=None, extra=()):
        watch = _fit_watch(torch, reset, launches)
        try:
            model.fit(TensorDataset([a[:steps * B] for a in data]),
                      batch_size=B, shuffle=False, verbose=0,
                      checkpointer=checkpointer,
                      callbacks=[watch, *extra])
        finally:
            watch.set_model(None)
        torch.cuda.synchronize()
        return watch

    def replays_ok(watch):
        replayed = [s for s in watch.steps if not s["captured"]]
        return bool(replayed) and all(s["launches"] == want
                                      for s in replayed)

    out, checks = dict(config={k: v for k, v in cfg.items()
                               if k != "width"}), {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_hooks_")
    try:
        # -- 16a: resume ---------------------------------------------------
        d = os.path.join(tmp, "resume")
        model = fresh(state0)
        wU = run(model, n)
        U, lossU = _fit_hooks_state(model), _losses(wU)
        del model
        model = fresh(state0)
        cS = ckpt.AsyncCheckpointer(d, max_to_keep=cfg["keep"],
                                    save_interval_steps=cfg["interval"])
        wS = run(model, cfg["save_at"], cS)
        cS.close()
        saved = cS.all_steps()
        del model
        model = fresh(state1)
        cR = ckpt.AsyncCheckpointer(d, max_to_keep=cfg["keep"],
                                    save_interval_steps=cfg["interval"])
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            wR = run(model, n, cR)
        cR.close()
        R, lossR = _fit_hooks_state(model), _losses(wR)
        newest = cR.latest_step()
        tv = time.perf_counter()
        verified = ckpt.verify_checkpoint(os.path.join(d, str(newest)))
        verify_s = time.perf_counter() - tv
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tr = time.perf_counter()
            model._fit_resume(ckpt.AsyncCheckpointer(d))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - tr
        checks.update(
            saved_steps=saved == [1, cfg["save_at"]],
            resume_warned=any(
                f"resumed from checkpoint at step {cfg['save_at']}"
                in str(m.message) for m in rec),
            replayed_batches_untrained=len(lossR) == n - cfg["save_at"],
            resume_losses_equal=lossR == lossU[cfg["save_at"]:],
            resume_state_equal=_fit_hooks_same(torch, U, R),
            newest_tree_verified=verified["step"] == newest == n,
            resume_launches=replays_ok(wU) and replays_ok(wS)
            and replays_ok(wR))
        del model, U, R
        saves = cS.stats + cR.stats
        out["resume"] = dict(
            saved_steps=saved, newest=newest,
            losses_uninterrupted=lossU, losses_resumed=lossR,
            launches_per_step=wR.steps[-1]["launches"], saves=saves,
            verify_s=verify_s, restore_s=restore_s,
            manifest_files=len(verified["files"]))
        # the step ms: U's replays (no hooks); S's and R's replays that did
        # not save, and those that did (S's save_at, R's last)
        saving = {cfg["save_at"] - 1} | {len(wR.steps) - 1}
        out["step_ms_p50_no_hooks"] = pct(_ms(wU, range(1, n)), 50)
        out["step_ms_p50_checkpointer_not_saving"] = pct(
            _ms(wS, [i for i in range(1, len(wS.steps)) if i not in saving])
            + _ms(wR, [i for i in range(1, len(wR.steps))
                       if i not in saving]), 50)
        out["step_ms_saving"] = _ms(wS, [cfg["save_at"] - 1]) + _ms(
            wR, [len(wR.steps) - 1])
        log(f"  16a resume: S committed {saved}; R resumed at "
            f"{cfg['save_at']}, trained {len(lossR)}: losses equal "
            f"{checks['resume_losses_equal']}, parameters, slots and step "
            f"equal {checks['resume_state_equal']}; newest tree {newest} "
            f"verified ({len(verified['files'])} files)")
        for s in saves:
            gbs = s.get('bytes', 0) / max(s.get('write_s', 1e-9), 1e-9) / 1e9
            log(f"    save at step {s['step']}: save() host "
                f"{s['snapshot_s'] * 1e3:.1f} ms, {s.get('bytes', 0)} B, "
                f"write {s.get('write_s', 0):.3f} s ({gbs:.2f}"
                f" GB/s), manifest (sha256 + fsync) "
                f"{s.get('manifest_s', 0):.3f} s, total "
                f"{s.get('total_s', 0):.3f} s")
        log(f"    verify_checkpoint {verify_s:.3f} s, restore into the "
            f"model {restore_s:.3f} s")
        # -- 16b: the guard --------------------------------------------------
        k = cfg["poison"]
        model = fresh(state0)
        before = metrics.counter("train.anomaly").value
        with port_flags({"FLAGS_anomaly_action": "skip"}):
            chaos.configure(f"step.loss:nan@{k}", seed=0)
            try:
                with warnings.catch_warnings(record=True) as rec:
                    warnings.simplefilter("always")
                    wG = run(model, cfg["guard_steps"])
            finally:
                chaos.reset()
        G, lossG = _fit_hooks_state(model), _losses(wG)
        rise = metrics.counter("train.anomaly").value - before
        del model
        model = fresh(state0)
        hand, hand_ms = [], []
        for i in range(cfg["guard_steps"]):
            sl = slice(i * B, (i + 1) * B)
            if i == k - 1:
                keep = _fit_hooks_state(model)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            hand.append(float(model.train_batch([data[0][sl]],
                                                [data[1][sl]])["loss"]))
            b.record()
            b.synchronize()
            hand_ms.append(a.elapsed_time(b))
            if i == k - 1:
                _fit_hooks_put(torch, model, keep)
                del keep
        H = _fit_hooks_state(model)
        # the guard's copy alone: host seconds of _state_refs and the card's
        # ms from before it to after it
        copy_host, copy_ms = [], []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            a.record()
            tc = time.perf_counter()
            model._state_refs()
            copy_host.append((time.perf_counter() - tc) * 1e3)
            b.record()
            b.synchronize()
            copy_ms.append(a.elapsed_time(b))
        model._guard = None
        others = [i for i in range(cfg["guard_steps"]) if i != k - 1]
        checks.update(
            skip_state_equals_hand_loop=_fit_hooks_same(torch, G, H),
            skip_losses_equal=[lossG[i] for i in others] == [
                hand[i] for i in others] and math.isnan(lossG[k - 1]),
            skip_counted=rise == 1,
            skip_warned=any(f"anomalous loss nan at step {k}: step "
                            f"reverted" in str(m.message) for m in rec),
            skip_launches=replays_ok(wG))
        del G, H
        raised = None
        with port_flags({"FLAGS_anomaly_action": "raise"}):
            chaos.configure(f"step.loss:nan@{k}", seed=0)
            try:
                run(model, cfg["guard_steps"])
            except FloatingPointError as e:
                raised = str(e)
            finally:
                chaos.reset()
        checks["raise_names_the_step"] = raised is not None and \
            f"at train step {k} " in raised
        dr = os.path.join(tmp, "rollback")
        cB = ckpt.AsyncCheckpointer(
            dr, save_interval_steps=cfg["rollback_interval"])

        class Landed(Callback):
            # each save lands before the next step, so that the step the
            # rollback restores is the newest save, not the writer's pace
            def on_train_batch_end(self, step, logs=None):
                cB.wait_until_finished()
        with port_flags({"FLAGS_anomaly_action": "rollback"}):
            chaos.configure(f"step.loss:nan@{cfg['rollback_at']}", seed=0)
            try:
                with warnings.catch_warnings(record=True) as rec:
                    warnings.simplefilter("always")
                    wB = run(model, cfg["rollback_at"], cB, (Landed(),))
            finally:
                chaos.reset()
        cB.close()
        top = max(cB.all_steps())
        tree = ckpt.load_state(os.path.join(dr, str(top)))
        fs = model._optimizer.functional_state()
        checks.update(
            rollback_warned=any(f"rolled back to checkpoint step {top}"
                                in str(m.message) for m in rec),
            rollback_state_is_newest_tree=all(
                torch.equal(v.cpu(), tree["params"][n_])
                for n_, v in model.network.named_parameters()) and all(
                torch.equal(v.cpu(), tree["opt"]["slots"][n_][s_])
                for n_, sl in fs["slots"].items()
                for s_, v in sl.items()))
        out["guard"] = dict(losses_skip=lossG, losses_hand=hand,
                            anomaly_rise=rise, raised=raised,
                            rollback_steps=cB.all_steps(),
                            rollback_to=top, rollback_saves=cB.stats,
                            copy_host_ms=copy_host, copy_ms=copy_ms)
        del tree, fs, model
        out["step_ms_p50_guard"] = pct(_ms(wG, others[1:]), 50)
        out["step_ms_p50_hand_synchronised"] = pct(hand_ms[1:], 50)
        # the saves whose pinned block is reused (the rollback run's second
        # and third: each save's write lands before the next step)
        out["step_ms_saving_reused"] = _ms(wB, [r["step"] - 1
                                                for r in cB.stats[1:3]])
        out["save_host_s_reused"] = [r["snapshot_s"] for r in cB.stats[1:3]]
        out["step_ms_saving_allocating_rollback"] = _ms(
            wB, [cB.stats[0]["step"] - 1])
        log(f"    the guard's copy: _state_refs host "
            f"{pct(copy_host, 50):.3f} ms, card {pct(copy_ms, 50):.3f} ms; "
            f"the hand loop synchronised each step "
            f"{out['step_ms_p50_hand_synchronised']:.3f} ms p50; the "
            f"rollback run's saves: the first allocating its pinned block, "
            f"the step {out['step_ms_saving_allocating_rollback'][0]:.3f} "
            f"ms; two reusing it: save() host "
            f"{[round(x * 1e3, 1) for x in out['save_host_s_reused']]} ms, "
            f"the steps "
            f"{[round(x, 3) for x in out['step_ms_saving_reused']]} ms")
        log(f"  16b guard: skip at step {k} = hand-reverted loop, bit for "
            f"bit: {checks['skip_state_equals_hand_loop']} (losses "
            f"{checks['skip_losses_equal']}, train.anomaly +{rise}); raise: "
            f"{raised!r}; rollback to step {top}: "
            f"{checks['rollback_state_is_newest_tree']}")
        # -- 16c: the guard on an offloaded optimizer -------------------------
        model = fresh(state0, offload=True)
        wO = run(model, cfg["offload_steps"])
        with port_flags({"FLAGS_anomaly_action": "skip"}):
            wOG = run(model, cfg["offload_steps"])
            fs = model._optimizer.functional_state()
            slots = [v for s in fs["slots"].values() for v in s.values()]
            torch.cuda.synchronize()
            kept = [v.clone() for v in slots]
            chaos.configure("step.loss:nan@1", seed=0)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    run(model, 1)
            finally:
                chaos.reset()
        torch.cuda.synchronize()
        checks["offload_skip_keeps_pinned_slots"] = all(
            v.is_pinned() and torch.equal(v, c)
            for v, c in zip(slots, kept)) and bool(slots)
        del kept, slots, fs, model
        out["step_ms_p50_offload"] = pct(_ms(wO, range(1, len(wO.steps))),
                                         50)
        out["step_ms_p50_offload_guard"] = pct(_ms(wOG, range(
            len(wOG.steps))), 50)
    finally:
        chaos.reset()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t0
    log(f"  16c step ms p50: no hooks {out['step_ms_p50_no_hooks']:.3f}, "
        f"a checkpointer's non-saving steps "
        f"{out['step_ms_p50_checkpointer_not_saving']:.3f}, saving steps "
        f"{[round(x, 3) for x in out['step_ms_saving']]}, the guard "
        f"{out['step_ms_p50_guard']:.3f}; offloaded "
        f"{out['step_ms_p50_offload']:.3f}, with the guard "
        f"{out['step_ms_p50_offload_guard']:.3f}")
    log(f"  phase 16 checks {checks}; took {out['seconds']:.1f} s")
    failed = [k_ for k_, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 16 failed its checks: {failed}")
    return out


def run(torch, dev, width, train_cfg=TRAIN, long_cfg=TRAIN_LONG,
        eager_cfg=EAGER, eager_long=EAGER_LONG, encoder_cfg=None,
        encoder_batch=ENCODER_BATCH, fp32_cfg=TRAIN_FP32, dryrun_cfg=DRYRUN,
        fit_cfg=FIT, optimizer_cfgs=OPTIMIZERS, update_named=None,
        unscale_named=None, skip_named=None, train_fp16_cfg=TRAIN_FP16,
        long_fp16_cfg=TRAIN_LONG_FP16, fit_hooks_cfg=FIT_HOOKS):
    """Phases 3-16 on ``dev`` with a serving GPT of ``width``, the two
    train configs, the eager train configs, the encoder, the fit config
    and the optimizers of phase 13a (and of phase 6's update timing);
    ``update_named``, ``unscale_named`` and ``skip_named`` the (name,
    shape) pairs of phase 3's update, unscale and skip-flag checks
    (defaults: the GPT's parameters and UPDATE_EXTRA, see each check);
    ``train_fp16_cfg`` and ``long_fp16_cfg`` the fp16 configs of phases 7
    and 8 (phase 7's remat policies run ``train_cfg``), ``fit_hooks_cfg``
    phase 16's; returns the report and the ``kernels`` entries."""
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
    log("== phase 3: split-layout attention, then against float64")
    split_checks = check_split_kernels(torch, fa, dev)
    fp64_checks = check_fp64_truth(torch, fa, dev)
    log("== phase 3: the fused epilogue and its backward")
    ln_checks = check_fused_ln(torch, fl, dev)
    mask_checks = check_fused_ln_mask(torch, fl, dev)
    ln_bwd_checks = check_fused_ln_bwd(torch, fl, dev)
    log("== phase 3: the optimizer update, unscale and skip flag")
    update_checks = check_update_kernel(torch, dev, update_named)
    unscale_checks = check_unscale(torch, dev, unscale_named)
    skip_checks = check_update_skip(torch, dev, skip_named)
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
    log("== phase 6: the compiled step's kernels in fp16")
    # rows 3, 4, 10 and 11 in fp16 at the same shapes, beside the bf16
    # rows above in this call
    train_times_fp16 = timing_train_kernels(torch, fq, sx, train_fp16_cfg,
                                            dev)
    long_times_fp16 = timing_train_kernels(torch, fq, sx, long_fp16_cfg,
                                           dev, head=False)
    log("== phase 6: rows 3 and 5 in bf16 at T 1024 (beside fp16's)")
    long_times_bf16 = timing_train_kernels(torch, fq, sx, TRAIN_LONG_BF16,
                                           dev, head=False)
    dlogits_time_fp16 = timing_dlogits(torch, sx, train_fp16_cfg, dev)
    log("== phase 6: the epilogue, the update, the 16-bit rows")
    ln_time = timing_fused_ln(torch, fl, encoder_cfg["dropout_rate"], dev)
    ln_bwd_time = timing_fused_ln_bwd(torch, fl, encoder_cfg["dropout_rate"],
                                      dev)
    update_times = timing_update(torch, dev, optimizer_cfgs)
    fp16_times = timing_fp16(torch, fa, fl, encoder_cfg["dropout_rate"], dev)
    del net
    torch.cuda.empty_cache()
    log("== phase 7: train at full width")
    trained = train(torch, fq, sx, dev, train_cfg)
    torch.cuda.empty_cache()
    log("== phase 7: the same step in fp16 (compute_dtype=float16)")
    trained_fp16 = train(torch, fq, sx, dev, train_fp16_cfg)
    log(f"  phase 7 fp16 against bf16: step ms p50 "
        f"{trained_fp16['step_ms_p50']:.3f} / {trained['step_ms_p50']:.3f}"
        f", seq/s {trained_fp16['seq_per_s']:.2f} / "
        f"{trained['seq_per_s']:.2f}, peak GiB "
        f"{trained_fp16['peak_memory_bytes'] / 2**30:.3f} / "
        f"{trained['peak_memory_bytes'] / 2**30:.3f}")
    torch.cuda.empty_cache()
    log(f"== phase 7: remat policies {', '.join(REMAT_POLICIES)} against "
        f"\"ctx\" ({train_cfg['dtype']})")
    remat = remat_policies(torch, fq, sx, dev, train_cfg)
    log("== phase 8: train at T 1024, reduced depth")
    trained_long = train(torch, fq, sx, dev, long_cfg, timed=False)
    log("== phase 8: the same in fp16 (row 5 on flash_attn_sm90)")
    trained_long_fp16 = train(torch, fq, sx, dev, long_fp16_cfg,
                              timed=False)
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
    torch.cuda.empty_cache()
    log("== phase 12: Model.fit, the eager GPT at full width (fp32)")
    fit_fp32 = fit_gpt(torch, fa, dev, fit_cfg)
    torch.cuda.empty_cache()
    log("== phase 12: the same under AMP O1 (bf16)")
    fit_o1 = fit_gpt(torch, fa, dev, fit_cfg, amp="O1")
    torch.cuda.empty_cache()
    log("== phase 12: the fused encoder under AMP O1, one epoch")
    fit_enc = fit_encoder(torch, fa, fl, dev, fit_cfg, encoder_cfg)
    torch.cuda.empty_cache()
    log(f"== phase 12: the GPT under AMP O1 in fp16, accumulate_grad_batches "
        f"{FIT_ACCUMULATE}, one epoch")
    fit_fp16 = fit_gpt(torch, fa, dev, fit_cfg, amp=dict(FIT_FP16),
                       accumulate=FIT_ACCUMULATE, epochs=1, variants=())
    torch.cuda.empty_cache()
    log(f"== phase 12: the fused encoder under AMP O1 in fp16, "
        f"accumulate_grad_batches {FIT_ACCUMULATE}, one epoch")
    fit_enc_fp16 = fit_encoder(torch, fa, fl, dev, fit_cfg, encoder_cfg,
                               amp=dict(FIT_FP16), accumulate=FIT_ACCUMULATE,
                               profile=True)
    torch.cuda.empty_cache()
    opts = optimizers_path(torch, fa, dev, eager_cfg, optimizer_cfgs)
    lamb = lamb_o2(torch, fa, fl, dev, encoder_cfg, encoder_batch)
    torch.cuda.empty_cache()
    fp16 = fp16_path(torch, fa, fl, dev, eager_cfg, encoder_cfg,
                     encoder_batch, eager_o1)
    ro = remat_offload_path(torch, fa, fl, dev, eager_cfg, encoder_cfg,
                            encoder_batch)
    log("== phase 16: Model.fit's checkpointer and anomaly guard, the O1 GPT "
        "at full width")
    hooks = fit_hooks_path(torch, fa, dev, fit_hooks_cfg)
    off = ro["gpt_offload"]
    dec, und = lamb["decorated"], lamb["undecorated"]
    log(f"  phase 13b: captured step ms p50 / peak allocated GiB: LAMB O2 "
        f"decorated {dec['step_ms_p50']:.3f} / "
        f"{dec['peak_memory_bytes'] / 2**30:.3f}, undecorated "
        f"{und['step_ms_p50']:.3f} / {und['peak_memory_bytes'] / 2**30:.3f}"
        f"; phase 11's O1 encoder (AdamW) {enc_o1['step_ms_p50']:.3f} / "
        f"{enc_o1['peak_memory_bytes'] / 2**30:.3f}")
    opt_sm90 = {k: {d: r["replay_launches"][f"sm90_{d}"]
                    for d in ("fwd", "bwd")} for k, r in opts.items()}
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
        launches_fit_step=fit_fp32["launches_per_step"]["fwd"],
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

    def t1024_of(times, key):
        # rows 3 / 5 at B 8, T 1024 (phase 8's shape) in one type
        t = times[key]
        return {k: t[k] for k in (
            "shape", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by", "fwd_plus_bwd_ms",
            "fwd_plus_bwd_device_ms", "max_abs_err") if k in t}

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
              t1024_bf16=t1024_of(long_times_bf16, "flash_qkv_fwd"),
              launches_t1024=ll["flash_qkv_fwd"], checks=len(qkv_checks),
              launches_dryrun=dl["flash_qkv_fwd"],
              launches_eager_amp_o1=eager_o1["launches"]["sm90_fwd"],
              launches_encoder_amp_o1=enc_o1["launches"]["sm90_fwd"],
              launches_fit_step_amp_o1=fit_o1["launches_per_step"][
                  "sm90_fwd"],
              launches_optimizers_replay={k: v["fwd"]
                                          for k, v in opt_sm90.items()},
              launches_lamb_o2_replay=dec["replay_launches"]["sm90_fwd"],
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
              t1024_bf16=t1024_of(long_times_bf16, "flash_qkv_bwd"),
              launches_t1024=ll["flash_qkv_bwd"], checks=len(qkv_checks),
              launches_dryrun=dl["flash_qkv_bwd"],
              launches_eager_amp_o1=eager_o1["launches"]["sm90_bwd"],
              launches_encoder_amp_o1=enc_o1["launches"]["sm90_bwd"],
              launches_fit_step_amp_o1=fit_o1["launches_per_step"][
                  "sm90_bwd"],
              launches_optimizers_replay={k: v["bwd"]
                                          for k, v in opt_sm90.items()},
              launches_lamb_o2_replay=dec["replay_launches"]["sm90_bwd"],
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

    s16, b16 = fp16_times["split"], fp16_times["split_bf16"]

    def timing_fields(t):
        return {k: t.get(k) for k in (
            "shape", "kernel", "route", "ms", "device_ms", "plain_ms",
            "library_ms", "library", "bound_ms", "bound_by", "max_abs_err")}

    def split_entry(name, row, source, replaces, launches, key):
        t = split_times[row]
        worst_fp32 = max(c[key] for c in split_checks
                         if row in c["rows"] and c["dtype"] == "float32")
        worst_bf16 = max(c[key] for c in split_checks
                         if row in c["rows"] and c["dtype"] == "bfloat16")
        worst_fp16 = max(c[key] for c in split_checks
                         if row in c["rows"] and c["dtype"] == "float16"
                         and c.get("inputs", "rand") == "rand")
        # d 64's bf16 and fp16 run flash_attn_sm90 (their checks: every
        # built head dim, the 16-bit ones at d 64 / 128 on that source)
        return dict(name=name, route="cuda",
                    max_abs_err_fp16=worst_fp16, fp16=timing_fields(s16[row]),
                    bf16=timing_fields(b16[row]),
                    source_16bit="paddle_tpu_torch/csrc/flash_attn_sm90.cu",
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
        dict(split_entry("flash_attn_bwd_small", 6, "flash_attn_bwd.cu",
                         f"{fa_py}:733",
                         eager["launches"]["modes"]["bwd small"],
                         "max_abs_err_grads"),
             launches_fit_step=fit_fp32["launches_per_step"]["bwd"]),
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
                    launches_fit_step_amp_o1=fit_enc["launches_per_step"][
                        "fused_ln"],
                    launches_lamb_o2_replay=dec["replay_launches"][
                        "fused_ln"],
                    tile_kernel="ln_fwd_tile (16-bit x)",
                    launches_tile_amp_o1=enc_o1["launches"]["fused_ln_tile"],
                    launches_tile_lamb_o2_replay=dec["replay_launches"][
                        "fused_ln_tile"],
                    bf16_o1=timing_fields(fp16_times["fused_ln_bf16_o1"]),
                    mixed_type_checks=sum(r["dtype"] != r["residual_dtype"]
                                          for r in ln_checks),
                    mask_checks_equal=sum(r["equal"] for r in mask_checks),
                    mask_checks=len(mask_checks),
                    bf16=timing_fields(fp16_times["fused_ln_bf16"])),
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
                         launches_fit_step_amp_o1=fit_enc[
                             "launches_per_step"]["fused_ln_bwd"],
                         launches_lamb_o2_replay=dec["replay_launches"][
                             "fused_ln_bwd"],
                         launches_scoring=enc_score["launches"][
                             "fused_ln_bwd"],
                         columns_rel_l2_vs_float64=max(
                             max(r["errors"][k] for k in
                                 ("dbias", "dgamma", "dbeta"))
                             for r in ln_bwd_checks
                             if r["columns_against"] == "float64"),
                         dx_zero_exactly_where_dropped=all(
                             r["dx_zero_exactly_where_dropped"]
                             for r in ln_bwd_checks),
                         bf16=timing_fields(fp16_times[
                             "fused_ln_bwd_bf16"])),
             max_abs_err=max(r["max_abs_err"] for r in ln_bwd_checks
                             if r["dtype"] == r["residual_dtype"] ==
                             "float32"),
             max_abs_err_bf16=max(r["max_abs_err"] for r in ln_bwd_checks
                                  if r["dtype"] == r["residual_dtype"] ==
                                  "bfloat16"))]
    adamw = next(r for r in update_times
                 if r["kind"] == "adamw" and r["setup"] == "fp32")
    kernels.append(dict(
        name="multi_tensor_update", route="cuda",
        source="paddle_tpu_torch/csrc/multi_tensor_update.cu",
        replaces="paddle_tpu/optimizer/fused_update.py:91", tpu_kernel=None,
        note="the optimizer update: the reference's is XLA (a jitted vmap "
             "per group in eager steps, fusions in its jitted step), no "
             "Pallas kernel",
        launches=sum(eager["replay_update_launches"]["update"].values()),
        max_abs_err=max(r["max_abs_err"] for r in update_checks
                        if r["setup"] == "fp32"),
        ms=adamw["ms"], plain_ms=adamw["plain_ms"],
        bound_ms=adamw["bound_ms"], bound_by="bytes",
        library_ms=adamw["library_ms"], library=adamw["library"],
        timed_shape=f"AdamW step() on the GPT's {adamw['tensors']} "
                    f"parameters, {adamw['elements']} elements, fp32",
        device_ms=adamw["device_ms"], share_of_bound=adamw["share_of_bound"],
        per_leaf_ms=adamw["per_leaf_ms"],
        per_leaf_device_ms=adamw["per_leaf_device_ms"],
        library_device_ms=adamw["library_device_ms"],
        max_abs_err_16bit=max(r["max_abs_err_16bit"] for r in update_checks
                              if r["max_abs_err_16bit"] is not None),
        max_steps_16bit=max(r["max_steps_16bit"] for r in update_checks
                            if r["max_steps_16bit"] is not None),
        checks=len(update_checks),
        launches_replay={"eager": eager["replay_update_launches"],
                         "eager_amp_o1": eager_o1["replay_update_launches"],
                         "fit_step": fit_fp32["launches_per_step"]["update"],
                         "optimizers": {k: v["replay_update_launches"]
                                        for k, v in opts.items()},
                         "lamb_o2": dec["replay_update_launches"]},
        launches_offloaded=sum(off["launches"]["update"].values()),
        offload_stages=off["stages"],
        device_ms_offloaded=off["routes_device_ms"]["staged"],
        device_ms_offloaded_in_place=off["routes_device_ms"]["in_place"],
        offload_bound_ms=off["bound"]["bound_ms"],
        offload_bound_by=off["bound"]["bound_by"],
        share_of_offload_bound=off["share_of_bound"],
        offload_copy_rates_gb_per_s={k: v["gb_per_s"] for k, v in
                                     off["copy_rates"].items()}))
    # fp16 rows 3, 4 (and 5 at T 1024), 10 and 11: the compiled
    # step in fp16, on flash_attn_sm90 and softmax_xent_sm90
    t16, tl16 = train_times_fp16, trained_fp16["launches"]
    ll16 = trained_long_fp16["launches"]
    qkv16 = [r for r in qkv_checks if r["dtype"] == "float16"]

    def t1024(key):
        # rows 3 / 5 in fp16 at B 8, T 1024 (phase 8's shape)
        return t1024_of(long_times_fp16, key)

    def fp16_row(name, source, replaces, launches, t, err, checks_,
                 **extra):
        return dict(name=name, route="cuda",
                    source=f"paddle_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], library=t["library"],
                    device_ms=t["device_ms"], timed_shape=t["shape"],
                    max_abs_err_timed_shape=t["max_abs_err"],
                    checks=len(checks_), **extra)

    kernels += [
        fp16_row("flash_qkv_fwd_fp16", "flash_attn_sm90.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:276",
                 tl16["flash_attn_sm90_fwd"], t16["flash_qkv_fwd"],
                 worst(qkv_checks, "max_abs_err", "float16"), qkv16,
                 launches_wrapper=tl16["flash_qkv_fwd"],
                 library_device_ms=t16["flash_qkv_fwd"][
                     "library_device_ms"],
                 max_abs_err_lse=max(r["max_abs_err_lse"] for r in qkv16),
                 tile_source="paddle_tpu_torch/csrc/flash_attn_fwd.cu",
                 launches_t1024=ll16["flash_attn_sm90_fwd"],
                 t1024=t1024("flash_qkv_fwd"),
                 bf16=timing_fields(train_times["flash_qkv_fwd"])),
        fp16_row("flash_qkv_bwd_fp16", "flash_attn_sm90.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:303",
                 tl16["flash_attn_sm90_bwd"], t16["flash_qkv_bwd"],
                 worst(qkv_checks, "max_abs_err_dqkv", "float16"), qkv16,
                 replaces_also="paddle_tpu/ops/pallas/flash_attention.py"
                               ":442",
                 launches_wrapper=tl16["flash_qkv_bwd"],
                 fwd_plus_bwd_ms=t16["flash_qkv_bwd"]["fwd_plus_bwd_ms"],
                 fwd_plus_bwd_device_ms=t16["flash_qkv_bwd"][
                     "fwd_plus_bwd_device_ms"],
                 library_device_ms=t16["flash_qkv_bwd"][
                     "library_device_ms"],
                 tile_source="paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                 launches_t1024=ll16["flash_attn_sm90_bwd"],
                 t1024=t1024("flash_qkv_bwd"),
                 bf16=timing_fields(train_times["flash_qkv_bwd"])),
        fp16_row("softmax_xent_fwd_fp16", "softmax_xent_sm90.cu",
                 "paddle_tpu/ops/pallas/softmax_xent.py:48",
                 tl16["softmax_xent_sm90_fwd"], t16["softmax_xent_fwd"],
                 routed(head_checks, "sm90", "float16"),
                 [r for r in head_checks if r["dtype"] == "float16"],
                 launches_wrapper=tl16["softmax_xent_fwd"],
                 share_of_bound=t16["softmax_xent_fwd"]["share_of_bound"],
                 matmul_ms=t16["softmax_xent_fwd"]["matmul_ms"],
                 tile_source="paddle_tpu_torch/csrc/softmax_xent_fwd.cu",
                 max_abs_err_tile_fp16=routed(head_checks, "tile",
                                              "float16"),
                 launches_t1024=ll16["softmax_xent_sm90_fwd"],
                 bf16=timing_fields(train_times["softmax_xent_fwd"])),
        fp16_row("softmax_xent_dlogits_fp16", "softmax_xent_sm90.cu",
                 "paddle_tpu/ops/pallas/softmax_xent.py:132",
                 tl16["softmax_xent_sm90_dlogits"], dlogits_time_fp16,
                 routed(dlogits_checks, "sm90", "float16"),
                 [r for r in dlogits_checks if r["dtype"] == "float16"],
                 launches_wrapper=tl16["softmax_xent_dlogits"],
                 share_of_bound=dlogits_time_fp16["share_of_bound"],
                 ms_per_step=dlogits_time_fp16["ms_per_step"],
                 bound_per_step_ms=dlogits_time_fp16["bound_per_step_ms"],
                 tile_source="paddle_tpu_torch/csrc/softmax_xent_dlogits.cu",
                 max_abs_err_tile_fp16=routed(dlogits_checks, "tile",
                                              "float16"),
                 subnormal_label_checks=[
                     dict(n=r["n"], v=r["v"], route=r["route"],
                          kept=r["label_subnormal_kept"],
                          label_min_abs=r["label_min_abs"])
                     for r in dlogits_checks
                     if "label_subnormal_kept" in r],
                 launches_t1024=ll16["softmax_xent_sm90_dlogits"],
                 bf16=timing_fields(dlogits_time))]
    # fp16: rows 1 and 6 on flash_attn_sm90 (d 64; the tile kernels at
    # the other head dims), row 12 and its backward, the unscale pass;
    # launches from phase 14's replays
    g16, e16 = fp16["gpt"], fp16["encoder"]
    rand16 = [c for c in checks + split_checks
              if c["dtype"] == "float16"
              and c.get("inputs", "rand") == "rand"]
    range16 = [c for c in checks + split_checks
               if c.get("inputs") == "fp16_range"]

    def fp16_attention(name, replaces, row, direction, err_key):
        t = s16[row]
        return dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/flash_attn_sm90.cu",
            replaces=replaces,
            row=row,
            launches=g16["replay_launches"][f"sm90_{direction}"],
            max_abs_err=max(c[err_key] for c in rand16
                            if err_key in c and c["route"] == "sm90"
                            and row in c.get("rows", fa.reference_rows(
                                "fwd", "small", c["tk"]))),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library=t["library"], device_ms=t["device_ms"],
            timed_shape=t["shape"], max_abs_err_timed_shape=t["max_abs_err"],
            max_abs_err_past_fp16_range=max(c[err_key] for c in range16
                                            if err_key in c),
            launches_wrapper=g16["replay_launches"][direction],
            launches_step1=g16["launches"][f"sm90_{direction}"],
            launches_encoder_replay=e16["replay_launches"][
                f"sm90_{direction}"],
            bf16=timing_fields(b16[row]),
            checks=len(rand16) + len(range16))

    def fp16_epilogue(name, source, replaces, launch_key, t, mixed, rows,
                      **extra):
        return dict(
            name=name, route="cuda",
            source=f"paddle_tpu_torch/csrc/{source}", replaces=replaces,
            launches=e16["replay_launches"][launch_key],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if "float16" in (r["dtype"], r["residual_dtype"])),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library=t["library"], device_ms=t["device_ms"],
            share_of_bound=t["share_of_bound"], timed_shape=t["shape"],
            ms_p0=t["ms_p0"], device_ms_p0=t["device_ms_p0"],
            x_fp16_residual_fp32=timing_fields(mixed),
            checks=sum("float16" in (r["dtype"], r["residual_dtype"])
                       for r in rows),
            launches_step1=e16["launches"][launch_key], **extra)

    u16 = fp16_times["unscale"]
    kernels += [
        fp16_attention("flash_attn_fwd_fp16", f"{fa_py}:205", 1, "fwd",
                       "max_abs_err"),
        fp16_attention("flash_attn_bwd_small_fp16", f"{fa_py}:733", 6, "bwd",
                       "max_abs_err_grads"),
        fp16_epilogue("fused_ln_fp16", "fused_ln.cu",
                      "paddle_tpu/ops/pallas/fused_ln.py:55", "fused_ln",
                      fp16_times["fused_ln"], fp16_times["fused_ln_mixed"],
                      ln_checks, layer_norm_ms=fp16_times["fused_ln"][
                          "layer_norm_ms"],
                      epilogue_types=e16["epilogue_types"],
                      tile_kernel="ln_fwd_tile",
                      launches_tile=e16["replay_launches"]["fused_ln_tile"],
                      o1=timing_fields(fp16_times["fused_ln_o1"]),
                      launches_fit_step_fp16=fit_enc_fp16[
                          "launches_per_step"]["fused_ln"],
                      launches_tile_fit_step_fp16=fit_enc_fp16[
                          "launches_per_step"]["fused_ln_tile"],
                      fit_fp16_epilogue_types=fit_enc_fp16[
                          "epilogue_types"]),
        fp16_epilogue("fused_ln_bwd_fp16", "fused_ln_bwd.cu",
                      "paddle_tpu/ops/fused_ops.py:62", "fused_ln_bwd",
                      fp16_times["fused_ln_bwd"],
                      fp16_times["fused_ln_bwd_mixed"], ln_bwd_checks,
                      tpu_kernel=None,
                      layer_norm_backward_ms=fp16_times["fused_ln_bwd"][
                          "layer_norm_backward_ms"]),
        dict(name="multi_tensor_unscale", route="cuda",
             source="paddle_tpu_torch/csrc/multi_tensor_update.cu",
             replaces="paddle_tpu/ops/amp_ops.py:16", tpu_kernel=None,
             note="check_finite_and_unscale and the jitted step's unscale "
                  "(paddle_tpu/hapi/model.py:301-311) are XLA, no Pallas "
                  "kernel",
             launches=g16["replay_update_launches"]["update_unscale"],
             max_abs_err=max(r["max_abs_err"] for r in unscale_checks),
             ms=u16["ms"], plain_ms=u16["plain_ms"],
             bound_ms=u16["bound_ms"], bound_by=u16["bound_by"],
             library_ms=u16["library_ms"], library=u16["library"],
             device_ms=u16["device_ms"],
             library_device_ms=u16["library_device_ms"],
             share_of_bound=u16["share_of_bound"], timed_shape=u16["shape"],
             checks=len(unscale_checks), skip_checks=len(skip_checks),
             launches_replay={k: fp16[k]["replay_update_launches"]
                              for k in ("gpt", "encoder", "o2")},
             launches_fit_step_fp16={
                 k: r["launches_per_step"]["update_unscale"]
                 for k, r in (("gpt", fit_fp16),
                              ("encoder", fit_enc_fp16))},
             overflow_steps=[dict(found_inf=r["found_inf"],
                                  scale=r["scale"], moved=r["moved"])
                             for r in fp16["overflow"]["steps"]])]
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
                  fused_ln_bwd_timing=ln_bwd_time, fit=fit_fp32,
                  fit_amp_o1=fit_o1, fit_encoder_amp_o1=fit_enc,
                  fit_fp16=fit_fp16, fit_encoder_fp16=fit_enc_fp16,
                  optimizers=opts, lamb_o2=lamb, update_checks=update_checks,
                  update_timing=update_times, unscale_checks=unscale_checks,
                  update_skip_checks=skip_checks, fp16_timing=fp16_times,
                  fp16=fp16, train_fp16=trained_fp16,
                  train_long_fp16=trained_long_fp16, remat=remat,
                  train_fp16_timing=train_times_fp16,
                  train_long_fp16_timing=long_times_fp16,
                  train_long_bf16_timing=long_times_bf16,
                  remat_offload=ro, fit_hooks=hooks,
                  dlogits_fp16_timing=dlogits_time_fp16)
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
    _RUN_START[:] = [t_start]
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
