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
17. paged   PagedGenerationEngine (generation/paged_kv.py) on phase 4's
    serving GPT, fp32, 8 slots, block_size 16: 17a phase 5's 16
            requests (warmup=True, the default 256-block pool) stream
            phase 5's tokens bit for bit, sampled ones too, with no
            capture while serving, 12 row-1 launches a prefill group and
            the pool all free after close, its tokens/s, TTFT and decode
            ms/step beside phase 5's; 17b 16 prompts over one 256-token
            system prompt and the first again (prefix cache 64 blocks):
            at least 15 hits, fewer tokens fed to prefill than the
            prompts hold, a copy-on-write, greedy streams equal the
            contiguous engine's, the chain exported (kv_wire) and
            imported back; 17c a 40-block pool: 4 batch streams, then 4
            interactive ones that preempt them to host memory, every
            stream equal to its run without pressure (greedy and
            sampled), swap ms and bytes, a kv.block_alloc chaos run shed
            typed with no block leaked; 17d speculative decoding (k 4,
            n-gram 2) on repeated 16-token phrases equal to plain
            decoding, greedy and sampled, the accept rate and decode ms
            per committed token; 17e int8 KV: engine streams equal each
            prompt's solo int8 session stream, the arena's int8 bytes and
            scales after a replayed prefill equal quantize_int8 of the
            uncaptured step's keys and values, bytes per token, greedy
            agreement with the fp32 streams; the phase's seconds
18. http   phase 5's GPT behind serving.ServingServer on 127.0.0.1 (a
            warmed GenerationEngine, 8 slots, max_queue 16): 18a phase 5's
            16 requests from 16 client threads, 8 JSON and 8 SSE, every
            stream phase 5's bit for bit, no capture while serving, 12
            row-1 launches a prefill group, the registry's
            request.completed 16, ttft_ms count 16 and inter_token_ms
            count sum(tokens - 1), /metrics parsed as Prometheus text with
            those series, /healthz ready; tokens/s, TTFT (engine clock and
            the SSE client's) and decode ms/step beside phase 5's; 18b a
            tenant whose quota holds one request's tokens answered 429
            tenant_quota with Retry-After in [1, 30] while another tenant
            is served, and under pause() the requests past max_queue 429
            queue_full with Retry-After, every queued request phase 5's
            stream after resume(); 18c swap_weights to a second seed's
            weights while 8 SSE streams decode (none dropped, nothing
            captured), the 16 requests after it equal to an uncaptured
            session on those weights, swapping back phase 5's streams
            again, a tree with one wrong shape refused with the live
            weights unchanged, the swap's ms; 18d FLAGS_request_trace,
            FLAGS_mem_accounting and FLAGS_lock_san 1: every request's
            span chain complete and its traceparent echoed, memscope's
            params and kv_arena tags equal to the computed bytes (288 MiB
            of caches), the capture ledger, no lock-order cycle, the
            long holds, decode ms/step and tokens/s beside 18a's; the
            phase's seconds
19. profiler phase 12's O1 GPT (B 32, T 512, prefetch 2, captured)
            under paddle_tpu_torch.profiler: 19a an 8-step fit under
            ProfilerCallback(Profiler(make_scheduler(closed=1, ready=1,
            record=3, skip_first=1), with_device_trace=True)): windows as
            the state machine gives them, a hapi::train_step span and a
            cudaGraphLaunch a recorded step, each replay's flash_attn_sm90
            forwards, backward passes and fused update in the device
            trace as the launch counters say (up to 3 attempts, CUPTI
            loses records), each launch inside its step's span after the
            clock offset, trace_summary.py --cat kernel on the merged
            export listing the sm90 kernels; 19b FLAGS_mem_accounting:
            goodput fractions summing to 1, params and opt_state tags
            equal to the counted bytes, the step peak, a ledger entry per
            capture, the goodput file; 19c start_profiler / stop_profiler
            around two train_batch calls; 19d step ms p50 with tracing
            and accounting off and on, beside phase 12's
20. eager core the reference's nn.TransformerEncoder at BERT-base width
            written with the eager core as a paddle user writes it
            (nn.Embedding 30528 x 768 and 512 x 768,
            nn.TransformerEncoder(nn.TransformerEncoderLayer(768, 12,
            3072, dropout 0.1, gelu, attn_dropout 0), 12), nn.Linear(768,
            30528); seed 0; B 32, T 512): 20a the dygraph loop in fp32
            (F.cross_entropy, backward, AdamW.step, clear_grad): one step
            through the kernels against the plain versions (loss and
            every gradient at phase 11's fp32 tolerances, all finite), 12
            row-1 and 12 row-6 launches and one update a step, two 3-step
            runs bit for bit, the loss falling over 12 steps; step ms
            p50, host ms, peak memory, the ops dispatched a step and the
            step's idle share (profile_train.profile); 20b the same Layer
            through Model (AdamW, nn.CrossEntropyLoss): jit=False equal
            to 20a's loop bit for bit, jit=True equal to jit=False bit
            for bit, a replay launching 12 + 12 attention kernels and the
            update, one capture; step ms p50 of each; 20c the loop under
            auto_cast (O1, bf16): 12 + 12 flash_attn_sm90 launches, the
            plain versions at O1's tolerances, the loss falling, step ms
            p50; 20d every case of the op table
            (paddle_tpu_torch/tools/eager_ops.py) on CUDA Tensors against
            CPU Tensors, forward and gradients, every creation op with no
            place on the card; 20e one traced step's op:: spans under
            dispatch and eager_phase_profile's shares; the phase's seconds
21. sparse phase 20's encoder with wte = nn.Embedding(30528, 768,
    embedding padding_idx=0, sparse=True), ids from seed 21 with padding:
            21a SGD, Adam and AdamW: a counted step (12 + 12 attention
            launches, one mt_update and one mt_update_rows, two powers'
            advances under Adam and AdamW; wte's gradient a SelectedRows
            of 16384 x 768 values, no dense (V, D) gradient), the rows
            kernel against its plain version on the next step's merged
            gradient and state (update_close's bounds, untouched rows
            kept), two 3-step runs bit for bit, untouched rows unmoved
            under Adam and AdamW, SGD within 1e-6 relative of the dense
            embedding; 21b ClipGradByGlobalNorm(1.0)'s scale on the merged
            rows within 1e-6 of the dense twin's, two clipped Adam steps;
            21c Model(jit=True) on the sparse table = on a dense one bit
            for bit (one capture, no rows launch: the captured step takes
            the dense gradient), Model(jit=False) Adam = 21a's loop bit
            for bit; 21d the loss falling over 12 Adam steps, step ms p50
            sparse against dense (10 each after 2, alternating rounds),
            host ms, peak memory, idle share, unique rows a step; the
            merge, mt_update_rows (events, a replayed graph, its plain
            version, its bytes bound), the dense mt_update on the table,
            torch.optim.SparseAdam.step and SGD's index_add_ after
            torch.unique; the phase's seconds
22. layer  the GPT as an nn.Layer written on Tensors: 22a entry()'s model
    GPT     and ids on the card against the CPU; 22b the full-width GPT
            called with a Tensor and a torch tensor, bit for bit, host
            and CUDA-event ms, the ops a forward dispatches; 22c generate
            twice on one batch bucket, the second making no step
23. numeric the numeric namespaces (linalg, fft, signal, the functional
            transforms, distribution, the sequence ops, the recurrent
            layers): the large PTB model of Zaremba et al. (2014), an
            nn.Embedding(10000, 1500), nn.Dropout(0.65), nn.LSTM(1500,
            1500, num_layers=2, dropout=0.65), nn.Dropout(0.65),
            nn.Linear(1500, 10000) language model, 66,034,000 fp32
            parameters, B 20, T 35, ids from seed 23: 23a the dygraph
            loop (F.cross_entropy, backward, SGD(1.0,
            grad_clip=ClipGradByGlobalNorm(10.0)).step, clear_grad): at
            dropout 0 one step against the same weights on the CPU (loss
            and every gradient at phase 20a's fp32 tolerances, all
            finite) with one mt_update launch; at dropout 0.65 two 3-step
            runs bit for bit and the loss falling over 12 steps; step ms
            p50, host ms, device ms, idle share, the ops dispatched a
            step, peak memory; 23b the same Layer through Model:
            jit=False equal to 23a's loop, jit=True to jit=False, bit for
            bit, one capture, one update launch a replay, step ms p50 of
            each; 23c nn.BeamSearchDecoder over the first layer's
            LSTMCell with the embedding and the projection (beam 4, B 8)
            under nn.dynamic_decode(max_step_num=35) on 23a's weights:
            ids equal to a CPU run's and log-probs within 1e-4, or where
            they differ a tie within 1e-5 at the first differing step; ms
            a step; 23d signal.stft at Whisper's front end (B 8 x 480,000
            samples, n_fft 400, hop 160, periodic Hann, centred) against
            the CPU at 2e-4, istft giving the input back, ms of each; the
            phase's seconds.  Phase 20d's op table carries every new
            case (linalg, fft, signal, sequence, distribution, the
            transforms) on the card

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


def torch_view(net):
    """torch's view of a network: for a port ``nn.Layer`` (the GPT, the
    eager core's layers) its ``parameters`` / ``state_dict`` ... are torch
    tensors, as a ``torch.nn.Module``'s are."""
    from paddle_tpu_torch.nn import torch_view as view
    return view(net)


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
    out = [(n, tuple(p.shape)) for n, p in torch_view(net).named_parameters()]
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


def run_engine(torch, fa, net, reqs, engine_cls=None, **config):
    """Serve ``reqs`` from CLIENTS threads (each submits its share, then
    waits) through an engine (``engine_cls``, by default the contiguous
    one) built with ``warmup=True`` (every prefill bucket and the decode
    step captured before the clients start) and ``config``; returns the
    streams, the engine's counts and step times, its executable cache's,
    and the engine, closed."""
    import gc
    from paddle_tpu_torch.serving import (GenerationEngine,
                                          GenerationEngineConfig)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    config = dict(dict(max_slots=SLOTS, max_new_tokens=NEW_TOKENS,
                       warmup=True), **config)
    engine = (engine_cls or GenerationEngine)(
        net, GenerationEngineConfig(**config))
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
                warmup_compiles=compiles0, engine=engine)


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
    first.pop("engine")                       # its graphs go with it
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
    second.pop("engine")
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
                results=[r.tolist() for r in first["results"]],
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
    state0 = {k: v.clone() for k, v in torch_view(net).state_dict().items()}
    make_opt = make_opt or (lambda params: AdamW(
        1e-3, parameters=params, weight_decay=0.01))
    # decorate: True (bf16) or the low type
    low = decorate if isinstance(decorate, torch.dtype) else torch.bfloat16
    param_dtype = low if decorate else torch.float32

    def fresh(jit=True):
        net.load_state_dict(state0)
        opt = make_opt(torch_view(net).parameters())
        if decorate:
            pamp.decorate(net, opt, level="O2", dtype=_dtype_name(low))
        return Model(net).prepare(opt, CrossEntropyLoss(), amp_configs=amp,
                                  jit=jit)

    def tied(opt):
        """Each parameter the optimizer stepped has a master and equals it
        cast to its type, exactly (a post-LN encoder's unused pre-LN
        parameters get no gradient and no master)."""
        stepped = [p for p in torch_view(net).parameters()
                   if id(p) in opt._state]
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
        params = dict(torch_view(net).named_parameters())
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
           for n, p in torch_view(net).named_parameters()}
    for n, p in torch_view(net).named_parameters():
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
                    model._optimizer, torch_view(net).parameters(),
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
    sync(torch, next(torch_view(net).parameters()).device)
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
    from paddle_tpu_torch import nn as pnn
    vocab = next(m for m in net.modules() if isinstance(
        m, (torch.nn.Embedding, pnn.Embedding))).weight.shape[0]
    train = pt.fit_data(cfg["train"], 0, vocab, T)
    evald = pt.fit_data(cfg["eval"], 1, vocab, T)
    state0 = {k: v.clone() for k, v in torch_view(net).state_dict().items()}
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
        # an accumulating run leaves its last batches' gradients
        # unstepped
        for p in torch_view(net).parameters():
            p.grad = None
        paddle_tpu_torch.seed(0)
        np.random.seed(0)
        return pt.fit_recipe(net, amp=amp, jit=jit, metric=metric)

    def state():
        return {k: v.clone() for k, v in torch_view(net).state_dict().items()}

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
    params = list(torch_view(net).parameters())
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
    for p in torch_view(net).parameters():
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
    opt = AdamW(1e-3, parameters=torch_view(net).parameters(),
                weight_decay=0.01)
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
    opt = AdamW(1e-3, parameters=torch_view(net).parameters(),
                weight_decay=0.01)
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
            AdamW(1e-3, parameters=torch_view(enc_net).parameters()),
            CrossEntropyLoss(),
            amp_configs=dict(FP16_O1), jit=False)
        model.train_batch([ids], [labels], update=False)
        for p in torch_view(enc_net).parameters():
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
    out = {f"param {n}": p.detach().cpu()
           for n, p in torch_view(net).named_parameters()}
    for n, p in torch_view(net).named_parameters():
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
    opt = make_opt(torch_view(net).parameters())
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
                        for k, v in
                        torch_view(model.network).state_dict().items()},
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
        for k, v in torch_view(model.network).state_dict().items():
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
    state0 = {k: v.clone() for k, v in torch_view(net).state_dict().items()}
    other = GPT(GPTConfig(**w), device=dev, seed=1)
    state1 = {k: v.clone() for k, v in torch_view(other).state_dict().items()}
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
        for p in torch_view(net).parameters():
            p.grad = None
        paddle_tpu_torch.seed(0)
        torch.manual_seed(0)
        return Model(net).prepare(
            AdamW(cfg["lr"], parameters=torch_view(net).parameters(),
                  weight_decay=0.01),
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
                for n_, v in
                torch_view(model.network).named_parameters()) and all(
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


# -- phase 17 -----------------------------------------------------------------
# The paged serving engine (PagedGenerationEngine) on phase 4's GPT at full
# width, fp32, 8 slots, block_size 16 (32 blocks a 512-token slot).  17a:
# phase 5's 16 requests with the default pool (256 blocks, the contiguous
# footprint).  17b: PREFIX_REQUESTS prompts sharing a PREFIX_LEN-token
# system prompt (16 full blocks), each with its own suffix of 8-32 tokens,
# then the first prompt again (a whole-prompt hit: its last token is fed
# into a copy of the cached tail block); the prefix cache holds
# PREFIX_CACHE_BLOCKS blocks.  17c: a pool of PRESSURE_BLOCKS blocks: four
# batch streams of PRESSURE_BATCH (prompt, new) tokens, 10 blocks each at
# their end, fill it; four interactive ones of PRESSURE_INTERACTIVE arrive
# once each batch stream has PRESSURE_HEAD tokens, and preempt batch
# streams to host memory.  17d: speculative decoding (SPEC_K drafts,
# SPEC_NGRAM) on prompts of a 16-token phrase repeated SPEC_REPEATS times.
# 17e: int8 KV on phase 5's requests
PAGED_BLOCK = 16
PREFIX_LEN, PREFIX_REQUESTS, PREFIX_CACHE_BLOCKS = 256, 16, 64
PREFIX_NEW_TOKENS = 32
PRESSURE_BLOCKS, PRESSURE_HEAD = 40, 8
PRESSURE_BATCH, PRESSURE_INTERACTIVE = (120, 40), (100, 8)
SPEC_K, SPEC_NGRAM, SPEC_REPEATS, SPEC_NEW_TOKENS = 4, 2, 4, 48


def _paged(torch, net, name, **config):
    """A PagedGenerationEngine over ``net`` (8 slots, block 16, phase 5's
    token budget, no prefix cache unless given)."""
    import gc
    from paddle_tpu_torch.serving import (GenerationEngineConfig,
                                          PagedGenerationEngine)
    gc.collect()
    torch.cuda.empty_cache()
    config = dict(dict(max_slots=SLOTS, max_new_tokens=NEW_TOKENS,
                       block_size=PAGED_BLOCK, prefix_cache_blocks=0,
                       name=name), **config)
    return PagedGenerationEngine(net, GenerationEngineConfig(**config))


def _serve_all(engine, prompts, kws, timeout=600):
    """Submit every prompt at once (from this thread) and wait: the
    streams and their TTFT s."""
    streams = [engine.submit(p, **kw) for p, kw in zip(prompts, kws)]
    return ([s.result(timeout=timeout) for s in streams],
            [s.ttft_s for s in streams])


def _same_streams(a, b):
    import numpy as np
    return [i for i, (x, y) in enumerate(zip(a, b))
            if not np.array_equal(np.asarray(x), np.asarray(y))]


def _all_free(engine):
    return engine.pool.available == engine.pool.num_blocks


def paged_parity(torch, fa, net, reqs, phase5):
    """17a: phase 5's requests through the paged engine: every stream
    phase 5's bit for bit, no capture while serving, L row-1 launches a
    prefill group, the pool all free after close."""
    from paddle_tpu_torch.serving import PagedGenerationEngine, seq_buckets
    run = run_engine(torch, fa, net, reqs, engine_cls=PagedGenerationEngine,
                     block_size=PAGED_BLOCK, prefix_cache_blocks=0,
                     name="phase17a")
    eng = run.pop("engine")
    L = net.cfg.num_layers
    groups = run["prefill_steps"]
    tokens = sum(len(r) for r in run["results"])
    differ = _same_streams(run["results"], phase5["results"])
    want_buckets = len(seq_buckets(net.cfg.max_seq_len, 8)) + 1
    out = dict(
        differ=differ, tokens=tokens, wall_s=run["wall_s"],
        tokens_per_s=tokens / run["wall_s"], prefill_groups=groups,
        decode_steps=run["decode_steps"], launches=run["launches"],
        warmed_buckets=run["warmed_buckets"], captured=run["captured"],
        cache_hits=run["hits"], cache_compiles=run["compiles"],
        ttft_ms_p50=pct(run["ttft"], 50) * 1e3,
        ttft_ms_p99=pct(run["ttft"], 99) * 1e3,
        decode_ms_p50=pct(run["decode_ms"], 50),
        decode_ms_p99=pct(run["decode_ms"], 99),
        prefill_ms_p50=pct(run["prefill_ms"], 50),
        warmup_s=run["warmup_s"],
        graph_pool_bytes=sum(run["graph_pool_bytes"].values()),
        pool_free=_all_free(eng), num_blocks=eng.pool.num_blocks,
        memory=eng.memory_breakdown())
    log(f"  17a: {REQUESTS - len(differ)}/{REQUESTS} streams equal phase "
        f"5's bit for bit ({SAMPLED} sampled); warmup {out['warmed_buckets']}"
        f" steps captured in {out['warmup_s']:.3f} s; serving: compiles "
        f"{out['cache_compiles']}, hits {out['cache_hits']}, prefill groups "
        f"{groups}, row-1 launches {out['launches']} ({L} a group), decode "
        f"steps {out['decode_steps']}; pool {eng.pool.available}/"
        f"{eng.pool.num_blocks} free after close; arenas "
        f"{out['memory']['mem_kv_arena_bytes'] / 2**20:.1f} MiB")
    log(f"  17a against phase 5 (contiguous), this run: tokens/s "
        f"{out['tokens_per_s']:.1f} / {phase5['tokens_per_s']:.1f}, TTFT ms "
        f"p50 {out['ttft_ms_p50']:.3f} / {phase5['ttft_ms_p50']:.3f}, p99 "
        f"{out['ttft_ms_p99']:.3f} / {phase5['ttft_ms_p99']:.3f}, decode "
        f"ms/step p50 {out['decode_ms_p50']:.3f} / "
        f"{phase5['decode_ms_p50']:.3f}, p99 {out['decode_ms_p99']:.3f} / "
        f"{phase5['decode_ms_p99']:.3f}")
    bad = []
    if differ:
        bad.append(f"streams {differ} differ from phase 5's")
    if out["warmed_buckets"] != want_buckets or not out["captured"]:
        bad.append(f"warmup left {out['warmed_buckets']} steps (captured "
                   f"{out['captured']}), expected {want_buckets}")
    if out["cache_compiles"] or \
            out["cache_hits"] != groups + out["decode_steps"]:
        bad.append(f"serving compiled {out['cache_compiles']} steps")
    if out["launches"] != L * groups:
        bad.append(f"{out['launches']} row-1 launches over {groups} groups")
    if not out["pool_free"]:
        bad.append("blocks leaked")
    if bad:
        raise AssertionError(f"17a: {'; '.join(bad)}")
    return out


def paged_prefix(torch, fa, net):
    """17b: PREFIX_REQUESTS prompts over one system prompt, and the first
    again; greedy streams equal the contiguous engine's on the same
    prompts; at least PREFIX_REQUESTS - 1 hits, fewer tokens fed to
    prefill than the prompts hold, a copy-on-write; then the chain's
    export, read back into the cache."""
    import numpy as np
    from paddle_tpu_torch.generation import kv_wire
    from paddle_tpu_torch.profiler import metrics
    from paddle_tpu_torch.serving import (GenerationEngine,
                                          GenerationEngineConfig)
    V = net.cfg.vocab_size
    rng = np.random.RandomState(17)
    system = rng.randint(1, V, PREFIX_LEN).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(
        1, V, rng.randint(8, 33)).astype(np.int32)])
        for _ in range(PREFIX_REQUESTS)]
    prompts.append(prompts[0].copy())
    kws = [dict(max_new_tokens=PREFIX_NEW_TOKENS)] * len(prompts)
    # (its token budget lifted: the 17 requests reserve more than 8 slots
    # of 512 hold, and queue instead)
    ceng = GenerationEngine(net, GenerationEngineConfig(
        max_slots=SLOTS, max_new_tokens=PREFIX_NEW_TOKENS,
        max_tokens_in_flight=1 << 20, name="phase17b_contiguous"))
    try:
        want, _ = _serve_all(ceng, prompts, kws)
    finally:
        ceng.close()
    del ceng
    eng = _paged(torch, net, "phase17b", warmup=True,
                 prefix_cache_blocks=PREFIX_CACHE_BLOCKS,
                 max_new_tokens=PREFIX_NEW_TOKENS)
    fed = []
    prefill = eng.session.prefill

    def counting(arenas, table, ids, starts, feed, *a, **k):
        fed.append(int(np.sum(feed)))
        return prefill(arenas, table, ids, starts, feed, *a, **k)
    eng.session.prefill = counting
    compiles0 = eng.session._cache.compiles
    try:
        t0 = time.perf_counter()
        got0, ttft0 = _serve_all(eng, prompts[:1], kws[:1])
        rest, ttft = _serve_all(eng, prompts[1:], kws[1:])
        wall = time.perf_counter() - t0
        got = got0 + rest
        hits = metrics.get("phase17b.prefix_cache.hit").value
        hit_tokens = metrics.get("phase17b.prefix_cache.hit_tokens").value
        blob = eng.export_prefix_chain(prompts[0])
        doc = kv_wire.deserialize_chain(
            blob, expect_block_size=PAGED_BLOCK,
            expect_spec=eng.session.block_spec(eng._arenas))
        eng.prefix_cache.clear()
        covered = eng.import_prefix_chain(blob)
        hits_before = metrics.get("phase17b.prefix_cache.hit").value
        again = eng.generate(prompts[1], timeout=600,
                             max_new_tokens=PREFIX_NEW_TOKENS)
        import_hit = metrics.get("phase17b.prefix_cache.hit").value \
            > hits_before
    finally:
        eng.close()
    # the rerun over the imported chain is request len(prompts)
    differ = _same_streams(got + [again], want + [want[1]])
    total = int(sum(len(p) for p in prompts))
    out = dict(requests=len(prompts), hits=hits, hit_tokens=hit_tokens,
               prompt_tokens=total, fed_tokens=int(sum(fed)),
               copies=eng.session.blocks_copied, differ=differ,
               wall_s=wall, ttft_ms_miss=ttft0[0] * 1e3,
               ttft_ms_hits_p50=pct(ttft, 50) * 1e3,
               compiles=eng.session._cache.compiles - compiles0,
               warmed_buckets=eng.warmed_buckets, blob_bytes=len(blob),
               blob_covered=doc["covered"], imported=covered,
               import_hit=import_hit, pool_free=_all_free(eng),
               swaps_out=list(eng.session.swaps["out"]),
               swaps_in=list(eng.session.swaps["in"]))
    log(f"  17b: {len(prompts)} requests over a {PREFIX_LEN}-token system "
        f"prompt: hits {hits} ({hit_tokens} tokens), prefill fed "
        f"{out['fed_tokens']} of {total} prompt tokens, copy-on-write "
        f"blocks {out['copies']}; greedy streams equal to the contiguous "
        f"engine's: {len(prompts) + 1 - len(differ)}/{len(prompts) + 1} "
        f"(the last a rerun over the imported chain); "
        f"TTFT ms miss {out['ttft_ms_miss']:.3f}, hits p50 "
        f"{out['ttft_ms_hits_p50']:.3f}; warmup {out['warmed_buckets']} "
        f"steps, serving compiles {out['compiles']}; the chain's export "
        f"{len(blob)} B covering {doc['covered']} tokens, imported back "
        f"and hit: {out['import_hit']}")
    bad = []
    if hits < PREFIX_REQUESTS - 1:
        bad.append(f"{hits} hits")
    if out["fed_tokens"] >= total:
        bad.append("prefill fed every prompt token")
    if out["copies"] < 1:
        bad.append("no copy-on-write")
    if differ:
        bad.append(f"streams {differ} differ from the contiguous engine's")
    if out["compiles"]:
        bad.append(f"{out['compiles']} captures while serving")
    if covered != len(prompts[0]) or not out["import_hit"]:
        bad.append(f"the import covered {covered} tokens")
    if not out["pool_free"]:
        bad.append("blocks leaked")
    if bad:
        raise AssertionError(f"17b: {'; '.join(bad)}")
    return out


def _pressure_requests(V):
    """Four batch and four interactive requests (half of each sampled)."""
    import numpy as np
    rng = np.random.RandomState(23)
    reqs = []
    for cls, (plen, new) in (("batch", PRESSURE_BATCH),
                             ("interactive", PRESSURE_INTERACTIVE)):
        for i in range(4):
            kw = dict(max_new_tokens=new, priority=cls, seed=300 + len(reqs))
            if i % 2:
                kw.update(do_sample=True, temperature=0.8, top_p=0.95)
            reqs.append((rng.randint(1, V, plen).astype(np.int32), kw))
    return reqs


def paged_pressure(torch, fa, net):
    """17c: a PRESSURE_BLOCKS-block pool: batch streams preempted to host
    memory by interactive ones and resumed, every stream equal to its run
    without pressure; then a kv.block_alloc chaos run sheds typed."""
    from paddle_tpu_torch.profiler import metrics
    from paddle_tpu_torch.serving import RequestRejected
    from paddle_tpu_torch.utils import chaos
    reqs = _pressure_requests(net.cfg.vocab_size)
    base = _paged(torch, net, "phase17c_free")
    try:
        want, _ = _serve_all(base, [p for p, _ in reqs],
                             [kw for _, kw in reqs])
    finally:
        base.close()
    del base
    eng = _paged(torch, net, "phase17c", warmup=True,
                 num_blocks=PRESSURE_BLOCKS)
    shed = None
    try:
        t0 = time.perf_counter()
        batch = [eng.submit(p, **kw) for p, kw in reqs[:4]]
        for s in batch:
            it = iter(s)
            for _ in range(PRESSURE_HEAD):
                next(it)
        inter = [eng.submit(p, **kw) for p, kw in reqs[4:]]
        got = [s.result(timeout=600) for s in batch + inter]
        wall = time.perf_counter() - t0
        preempted = metrics.get("phase17c.request.preempted").value
        resumed = metrics.get("phase17c.request.resumed").value
        chaos.configure("kv.block_alloc:fail@1")
        try:
            eng.generate(reqs[4][0], timeout=600, **reqs[4][1])
        except RequestRejected as e:
            shed = e.reason
        finally:
            chaos.configure("")
    finally:
        eng.close()
    differ = _same_streams(got, want)
    outs, ins = list(eng.session.swaps["out"]), list(eng.session.swaps["in"])
    out = dict(preempted=preempted, resumed=resumed, differ=differ,
               wall_s=wall, swap_out_ms=[m for m, _ in outs],
               swap_out_bytes=[b for _, b in outs],
               swap_in_ms=[m for m, _ in ins],
               swap_in_bytes=[b for _, b in ins], chaos_shed=shed,
               shed_kv_blocks=eng.stats().get("shed_kv_blocks", 0),
               pool_free=_all_free(eng))
    log(f"  17c: {PRESSURE_BLOCKS}-block pool, 4 batch then 4 interactive "
        f"streams: preempted {preempted}, resumed {resumed}; every stream "
        f"equal to its run without pressure: {len(reqs) - len(differ)}/"
        f"{len(reqs)} (greedy and sampled); swap-out ms "
        f"{[round(m, 3) for m in out['swap_out_ms']]} of bytes "
        f"{out['swap_out_bytes']}, swap-in ms "
        f"{[round(m, 3) for m in out['swap_in_ms']]}; chaos kv.block_alloc "
        f"shed {shed!r}; pool {eng.pool.available}/{eng.pool.num_blocks} "
        f"free after close")
    bad = []
    if preempted < 1 or resumed < 1:
        bad.append(f"preempted {preempted}, resumed {resumed}")
    if differ:
        bad.append(f"streams {differ} differ from their runs without "
                   "pressure")
    if shed != "kv_blocks":
        bad.append(f"the chaos run shed {shed!r}")
    if not out["pool_free"]:
        bad.append("blocks leaked")
    if bad:
        raise AssertionError(f"17c: {'; '.join(bad)}")
    return out


def paged_speculative(torch, fa, net):
    """17d: speculative decoding (SPEC_K, SPEC_NGRAM) on prompts of a
    repeated 16-token phrase: streams equal the plain engine's, greedy
    and sampled; the accept rate and decode ms per committed token."""
    import numpy as np
    from paddle_tpu_torch.profiler import metrics
    V = net.cfg.vocab_size
    rng = np.random.RandomState(29)
    prompts, kws = [], []
    for i in range(SLOTS):
        phrase = rng.randint(1, V, 16).astype(np.int32)
        prompts.append(np.tile(phrase, SPEC_REPEATS))
        kw = dict(max_new_tokens=SPEC_NEW_TOKENS, seed=500 + i)
        if i % 2:
            kw.update(do_sample=True, temperature=0.8, top_p=0.95)
        kws.append(kw)
    runs = {}
    for label, k in (("plain", 0), ("speculative", SPEC_K)):
        eng = _paged(torch, net, f"phase17d_{label}", warmup=True,
                     speculative_k=k, spec_ngram=SPEC_NGRAM)
        try:
            t0 = time.perf_counter()
            got, _ = _serve_all(eng, prompts, kws)
            wall = time.perf_counter() - t0
        finally:
            eng.close()
        tokens = sum(len(g) for g in got)
        decode_ms = sum(eng.session.step_ms["decode"])
        runs[label] = dict(streams=got, wall_s=wall, tokens=tokens,
                           decode_steps=eng.session.steps["decode"],
                           decode_ms=decode_ms,
                           ms_per_token=decode_ms / (tokens - len(got)),
                           keys=[k[0] for k in eng.session._cache.keys()])
        del eng
    # an oracle drafter that proposes each stream's true continuation:
    # every draft is accepted, so each verify commits up to k + 1 tokens
    # sampled from logits at B·W rows (decode's products run at B)
    from paddle_tpu_torch.generation import speculative
    truth = {tuple(p.tolist()): list(g) for p, g in
             zip(prompts, runs["plain"]["streams"])}

    def oracle(context, k, ngram=2):
        ctx = [int(t) for t in context]
        n = len(prompts[0])
        done = truth[tuple(ctx[:n])]
        return done[len(ctx) - n:len(ctx) - n + int(k)]
    with mock.patch.object(speculative, "propose_drafts", oracle):
        eng = _paged(torch, net, "phase17d_oracle", warmup=True,
                     speculative_k=SPEC_K, spec_ngram=SPEC_NGRAM)
        try:
            oracle_got, _ = _serve_all(eng, prompts, kws)
        finally:
            eng.close()
    oracle_steps = eng.session.steps["decode"]
    oracle_ms = sum(eng.session.step_ms["decode"])
    del eng
    op = metrics.get("phase17d_oracle.spec.proposed").value
    oa = metrics.get("phase17d_oracle.spec.accepted").value
    p = metrics.get("phase17d_speculative.spec.proposed").value
    a = metrics.get("phase17d_speculative.spec.accepted").value
    differ = _same_streams(runs["speculative"]["streams"],
                           runs["plain"]["streams"])
    oracle_differ = _same_streams(oracle_got, runs["plain"]["streams"])
    tokens = runs["plain"]["tokens"]
    out = dict(differ=differ, proposed=p, accepted=a,
               accept_rate=a / p if p else 0.0, oracle_differ=oracle_differ,
               oracle_proposed=op, oracle_accepted=oa,
               oracle_decode_steps=oracle_steps,
               oracle_ms_per_token=oracle_ms / (tokens - len(prompts)),
               **{f"{k}_{f}": v[f] for k, v in runs.items()
                  for f in ("wall_s", "decode_steps", "ms_per_token")})
    log(f"  17d: speculative (k {SPEC_K}, n-gram {SPEC_NGRAM}) streams equal "
        f"plain ones: {SLOTS - len(differ)}/{SLOTS} (half sampled); drafts "
        f"proposed {p}, accepted {a} (rate {out['accept_rate']:.4f}); decode "
        f"steps {out['speculative_decode_steps']} / "
        f"{out['plain_decode_steps']}, decode ms per committed token "
        f"{out['speculative_ms_per_token']:.4f} / "
        f"{out['plain_ms_per_token']:.4f} (speculative / plain)")
    log(f"  17d oracle drafts (each stream's own continuation): streams "
        f"equal plain ones {SLOTS - len(oracle_differ)}/{SLOTS}; proposed "
        f"{op}, accepted {oa}; decode steps {oracle_steps}, ms per committed "
        f"token {out['oracle_ms_per_token']:.4f}")
    if differ or oracle_differ:
        raise AssertionError(f"17d: speculative streams {differ} and with "
                             f"oracle drafts {oracle_differ} differ from "
                             "plain ones")
    if oa != op:
        raise AssertionError(f"17d: {op - oa} oracle drafts rejected")
    if p < 1:
        raise AssertionError("17d: the drafter proposed nothing")
    return out


def _int8_against_plain(torch, net, reqs):
    """After an int8 prefill (a replay), the arena's int8 bytes and scales
    at every written slot against quantize_int8 of the keys and values the
    same step computes uncaptured (forward hooks on each layer's qkv
    projection)."""
    import numpy as np
    from paddle_tpu_torch.generation import PagedGenerationSession
    from paddle_tpu_torch.generation import paged_kv
    from paddle_tpu_torch.quantization import quantize_int8
    cfg, dev = net.cfg, net.device
    S, H = SLOTS, cfg.num_heads
    hd = cfg.hidden_size // H
    sess = PagedGenerationSession(net, batch_capacity=S, kv_dtype="int8")
    arenas = sess.init_arenas()
    table = sess.identity_table()
    prompts = [p for p, _ in reqs[:S]]
    P = sess.prompt_bucket(max(len(p) for p in prompts))
    ids = np.zeros((S, P), np.int32)
    feed = np.zeros((S,), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
        feed[i] = len(p)
    values = (table, ids, np.zeros((S,), np.int32), feed,
              np.arange(S, dtype=np.int64), np.zeros((S,), np.float32),
              np.zeros((S,), np.int32), np.ones((S,), np.float32))
    sess.prefill(arenas, *values)             # captures
    sess.init_arenas()
    sess.prefill(arenas, *values)             # a replay
    replayed = [[f.clone() for f in a] for a in arenas]
    qkv = {}
    # the projection's output as its hook sees it (a Tensor of the GPT's
    # eager core): its torch tensor
    hooks = [blk.attn.qkv.register_forward_hook(
        lambda m, i, o, li=li: qkv.__setitem__(
            li, getattr(o, "_data", o).detach().clone()))
        for li, blk in enumerate(net.blocks)]
    try:
        sess.init_arenas()
        net.eval()
        with torch.inference_mode():
            sess._make_chunk(P, False)(*[
                torch.as_tensor(np.asarray(v)).to(dev, t)
                for v, t in zip(values, paged_kv._CHUNK_TYPES)])
    finally:
        for h in hooks:
            h.remove()
    rows = torch.as_tensor(np.concatenate(
        [np.full(n, i) for i, n in enumerate(feed)]), device=dev)
    pos = torch.as_tensor(np.concatenate([np.arange(n) for n in feed]),
                          device=dev)
    tab = torch.as_tensor(table, dtype=torch.long, device=dev)
    blk = tab[rows, pos // PAGED_BLOCK]
    off = pos % PAGED_BLOCK
    bytes_equal, scales_equal, scale_err = True, True, 0.0
    for li, a in enumerate(replayed):
        x = qkv[li].reshape(S, P, 3, H, hd)
        # the fields are k, v, k_scale, v_scale
        for j, (q_field, s_field) in enumerate(((a[0], a[2]),
                                                (a[1], a[3]))):
            q, sc = quantize_int8(x[:, :, 1 + j], axis=-1)
            bytes_equal &= torch.equal(q_field[blk, off], q[rows, pos])
            scales_equal &= torch.equal(s_field[blk, off], sc[rows, pos])
            scale_err = max(scale_err, float(
                (s_field[blk, off] - sc[rows, pos]).abs().max()))
    # the pool's blocks (the sink, which takes every dropped write, left
    # out: its duplicate writes land in no fixed order)
    same_run = all(torch.equal(f[:-1], g[:-1])
                   for a, b in zip(arenas, replayed) for f, g in zip(a, b))
    return dict(slots=int(len(pos)), bytes_equal=bool(bytes_equal),
                scales_equal=bool(scales_equal), scale_max_abs_err=scale_err,
                replay_equals_uncaptured=same_run)


def paged_int8(torch, fa, net, reqs, phase5):
    """17e: int8 KV: engine streams equal each prompt's solo int8 session
    stream; the arena's bytes against the plain quantization; bytes per
    token; each greedy request's agreement with its fp32 stream."""
    import numpy as np
    from paddle_tpu_torch.generation import PagedGenerationSession
    eng = _paged(torch, net, "phase17e", warmup=True, kv_cache_dtype="int8")
    try:
        t0 = time.perf_counter()
        got, _ = _serve_all(eng, [p for p, _ in reqs],
                            [dict(kw, max_new_tokens=NEW_TOKENS)
                             for _, kw in reqs])
        wall = time.perf_counter() - t0
    finally:
        eng.close()
    bpt8 = eng.session.arena_bytes_per_block() // PAGED_BLOCK
    free = _all_free(eng)
    del eng
    solo = PagedGenerationSession(net, batch_capacity=SLOTS, kv_dtype="int8")
    want = [solo.generate([p], max_new_tokens=NEW_TOKENS, **kw)[0]
            for p, kw in reqs]
    bpt32 = PagedGenerationSession(
        net, batch_capacity=SLOTS).arena_bytes_per_block() // PAGED_BLOCK
    del solo
    differ = _same_streams(got, want)
    agree = []
    for (p, kw), g, f in zip(reqs, got, phase5["results"]):
        if kw.get("do_sample"):
            continue
        f = np.asarray(f)
        n = min(len(g), len(f))
        miss = np.flatnonzero(np.asarray(g[:n]) != f[:n])
        agree.append(int(miss[0]) if miss.size else n)
    quant = _int8_against_plain(torch, net, reqs)
    out = dict(differ=differ, wall_s=wall, bytes_per_token=bpt8,
               bytes_per_token_fp32=bpt32, ratio=bpt32 / bpt8,
               agreement=agree, pool_free=free, **quant)
    log(f"  17e: int8 engine streams equal their solo int8 session streams: "
        f"{len(reqs) - len(differ)}/{len(reqs)}; after a prefill replay the "
        f"arena's int8 bytes at {quant['slots']} slots x "
        f"{net.cfg.num_layers} layers equal "
        f"quantize_int8 of the uncaptured step's keys and values: "
        f"{quant['bytes_equal']}, scales {quant['scales_equal']} (max abs "
        f"err {quant['scale_max_abs_err']:.3e}); bytes per token {bpt8} "
        f"against fp32's {bpt32} ({out['ratio']:.3f}x); greedy agreement "
        f"with the fp32 streams (tokens of {NEW_TOKENS}): {agree}")
    bad = []
    if differ:
        bad.append(f"streams {differ} differ from the solo int8 session's")
    if not (quant["bytes_equal"] and quant["scales_equal"]):
        bad.append("the arena's bytes differ from the plain quantization")
    if not quant["replay_equals_uncaptured"]:
        bad.append("the replayed prefill's arenas differ from the "
                   "uncaptured step's")
    if not free:
        bad.append("blocks leaked")
    if bad:
        raise AssertionError(f"17e: {'; '.join(bad)}")
    return out


def paged_path(torch, fa, dev, width, phase5):
    """Phase 17: the paged engine at full width (17a-17e); the seconds it
    took."""
    import gc
    from paddle_tpu_torch.models import GPT, GPTConfig
    t0 = time.perf_counter()
    net = GPT(GPTConfig(**width), device=dev, seed=0)
    reqs = make_requests(net.cfg.vocab_size)
    log("== phase 17a: phase 5's requests through PagedGenerationEngine")
    parity = paged_parity(torch, fa, net, reqs, phase5)
    log(f"== phase 17b: prefix sharing ({PREFIX_LEN}-token system prompt)")
    prefix = paged_prefix(torch, fa, net)
    log(f"== phase 17c: pool pressure ({PRESSURE_BLOCKS} blocks), preemption "
        "to host memory")
    pressure = paged_pressure(torch, fa, net)
    log(f"== phase 17d: speculative decoding (k {SPEC_K})")
    spec = paged_speculative(torch, fa, net)
    log("== phase 17e: int8 KV")
    int8 = paged_int8(torch, fa, net, reqs, phase5)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(parity=parity, prefix=prefix, pressure=pressure,
               speculative=spec, int8=int8,
               seconds=time.perf_counter() - t0)
    log(f"  phase 17 took {out['seconds']:.1f} s")
    return out


# -- phase 18 ------------------------------------------------------------------
HTTP_QUEUE = 16              # the HTTP engine's max_queue: phase 5's burst
HTTP_SWAP_SEED = 1
HTTP_OVERFLOW = 2            # requests sent past max_queue while paused
_PROM_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                        r'(\S+)$')


def _http_call(port, path, body=None, headers=None, stream=False,
               timeout=600):
    """One HTTP request to 127.0.0.1:port: ``(status, headers, payload,
    times)``; JSON bodies come back parsed, an SSE stream as its events;
    ``times`` the client's clock: ``start`` (perf_counter), then seconds
    from it to the response headers, the first SSE event (None for JSON)
    and the end."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        times = dict(start=t0, first=None)
        if body is None:
            conn.request("GET", path, headers=headers or {})
        else:
            h = {"Content-Type": "application/json"}
            h.update(headers or {})
            conn.request("POST", path, json.dumps(body), h)
        r = conn.getresponse()
        times["headers"] = time.perf_counter() - t0
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        if stream and r.status == 200:
            events = []
            for line in r:
                if line.startswith(b"data: "):
                    if times["first"] is None:
                        times["first"] = time.perf_counter() - t0
                    events.append(json.loads(line[6:]))
            times["done"] = time.perf_counter() - t0
            return r.status, hdrs, events, times
        data = r.read()
        times["done"] = time.perf_counter() - t0
        ctype = hdrs.get("content-type", "")
        return (r.status, hdrs,
                json.loads(data) if "json" in ctype else data.decode(),
                times)
    finally:
        conn.close()


def _request_body(prompt, kw):
    body = dict(prompt_ids=[int(t) for t in prompt],
                max_new_tokens=NEW_TOKENS)
    body.update(kw)
    return body


def _http_tokens(status, payload):
    """The tokens of a JSON or SSE answer (SSE: the streamed events,
    which must equal the terminal event's list)."""
    if status != 200:
        raise AssertionError(f"HTTP {status}: {payload}")
    if isinstance(payload, dict):
        return payload["tokens"]
    streamed = [e["token"] for e in payload if "token" in e]
    final = [e for e in payload if e.get("done")]
    if not final or final[0]["tokens"] != streamed:
        raise AssertionError(f"an SSE stream's events disagree with its "
                             f"terminal event: {payload[-1]}")
    return streamed


def _client_round(port, jobs):
    """Run ``jobs`` (``[(body, headers, stream)]``), each from a thread of
    its own: ``([(status, headers, payload, times)], wall_s)``, each
    ``times`` in seconds from the round's start (``sent``, ``headers``,
    ``first`` SSE event or None, ``done``)."""
    out = [None] * len(jobs)
    errors = []
    t0 = time.perf_counter()

    def client(i):
        try:
            body, hdrs, stream = jobs[i]
            st, h, payload, times = _http_call(port, "/v1/generate", body,
                                               headers=hdrs, stream=stream)
            sent = times["start"] - t0
            out[i] = (st, h, payload, dict(
                sent=sent, headers=sent + times["headers"],
                first=None if times["first"] is None
                else sent + times["first"], done=sent + times["done"]))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("an HTTP client thread did not finish")
    return out, wall


def _client_main():
    """The client process of ``_http_round(..., process=True)``: a round's
    port and jobs as JSON on stdin, its results as one JSON line out."""
    spec = json.load(sys.stdin)
    out, wall = _client_round(spec["port"], spec["jobs"])
    print(json.dumps({"out": out, "wall": wall}))


def _http_round(port, reqs, headers=None, sse=lambda i: i % 2 == 1,
                timings=None, process=False):
    """Every request of ``reqs`` from a client thread of its own (JSON or
    SSE by ``sse(i)``): the token lists, the client's SSE TTFTs, the
    response headers, the wall seconds.  ``process=True`` runs the
    clients in a Python process of their own, so that their work does
    not compete with the server's threads for this interpreter's lock,
    as a remote client's would not; ``timings``, a list, gets each
    request's client clock (ms from the round's start: sent, headers,
    first SSE event, done)."""
    jobs = [(dict(_request_body(*reqs[i]), stream=sse(i)),
             headers(i) if headers else None, sse(i))
            for i in range(len(reqs))]
    if process:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             f"{HERE!r}); import chip_smoke; chip_smoke._client_main()"],
            input=json.dumps({"port": port, "jobs": jobs}),
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"the HTTP client process failed: "
                                 f"{proc.stderr[-2000:]}")
        doc = json.loads(proc.stdout.strip().splitlines()[-1])
        out, wall = doc["out"], doc["wall"]
    else:
        out, wall = _client_round(port, jobs)
    tokens = [_http_tokens(st, payload) for st, _h, payload, _t in out]
    if timings is not None:
        def ms(v):
            return None if v is None else round(v * 1e3, 3)
        timings.extend(dict(i=i, sse=sse(i), sent=ms(t["sent"]),
                            headers=ms(t["headers"]), first=ms(t["first"]),
                            done=ms(t["done"]))
                       for i, (_s, _h, _p, t) in enumerate(out))
    return (tokens, [t["first"] for _s, _h, _p, t in out
                     if t["first"] is not None],
            [h for _s, h, _p, _t in out], wall)


def parse_prometheus(text):
    """Prometheus text (format 0.0.4) to ``{series: value}``; raises on a
    line that is neither a comment nor a sample."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise AssertionError(f"not Prometheus text: {line!r}")
        series[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return series


def _http_engine(torch, net, name, **config):
    """A warmed GenerationEngine (phase 5's config, max_queue
    HTTP_QUEUE) behind a ServingServer on 127.0.0.1, port 0."""
    import gc
    from paddle_tpu_torch.serving import (GenerationEngine,
                                          GenerationEngineConfig,
                                          ServingServer)
    gc.collect()
    if net.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = GenerationEngine(net, GenerationEngineConfig(**dict(dict(
        max_slots=SLOTS, max_new_tokens=NEW_TOKENS, warmup=True,
        max_queue=HTTP_QUEUE, name=name), **config)))
    warmup_s = time.perf_counter() - t0
    return engine, ServingServer(engine).start(), warmup_s


def http_parity(torch, fa, engine, srv, reqs, phase5):
    """18a: phase 5's 16 requests from 16 client threads, 8 JSON and 8
    SSE: every stream phase 5's bit for bit, no capture, L row-1 launches
    a prefill group, the registry's counts, /metrics and /healthz."""
    from paddle_tpu_torch.profiler import metrics
    name, L = engine.metrics_prefix, engine.model.cfg.num_layers
    sess, cache = engine.session, engine.session._cache
    compiles0, groups0 = cache.compiles, sess.steps["prefill"]
    decode0 = sess.steps["decode"]
    fa.FWD_LAUNCHES = 0
    timings = []
    ttft_seen = len(metrics.get(f"{name}.ttft_ms")._ring)
    got, sse_ttft, _hdrs, wall = _http_round(srv.port, reqs,
                                             timings=timings, process=True)
    launches = fa.FWD_LAUNCHES
    groups = sess.steps["prefill"] - groups0
    differ = _same_streams(got, phase5["results"])
    tokens = sum(len(t) for t in got)
    completed = metrics.get(f"{name}.request.completed").value
    ttft_h = metrics.get(f"{name}.ttft_ms")
    itl_h = metrics.get(f"{name}.inter_token_ms")
    want_itl = sum(len(t) - 1 for t in got)
    st, hdrs, text, _ = _http_call(srv.port, "/metrics")
    series = parse_prometheus(text)
    p = name.replace(".", "_")
    want_series = {f"{p}_request_completed": len(reqs),
                   f"{p}_ttft_ms_count": len(reqs),
                   f"{p}_inter_token_ms_count": want_itl}
    st_h, _h, health, _ = _http_call(srv.port, "/healthz")
    decode_ms = list(sess.step_ms["decode"])[-(sess.steps["decode"]
                                               - decode0):]
    out = dict(
        requests=len(reqs), json=len(reqs) - len(sse_ttft),
        sse=len(sse_ttft), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, equal_to_phase5=len(reqs) - len(differ),
        captures_while_serving=cache.compiles - compiles0,
        prefill_groups=groups, launches=launches, completed=completed,
        ttft_count=ttft_h.count, inter_token_count=itl_h.count,
        inter_token_want=want_itl,
        ttft_ms_p50=ttft_h.percentile(50), ttft_ms_p99=ttft_h.percentile(99),
        sse_ttft_ms_p50=pct(sse_ttft, 50) * 1e3,
        sse_ttft_ms_p99=pct(sse_ttft, 99) * 1e3,
        decode_ms_p50=pct(decode_ms, 50), decode_ms_p99=pct(decode_ms, 99),
        metrics_status=st, metrics_type=hdrs.get("content-type"),
        metrics_series=len(series),
        metrics_seen={k: series.get(k) for k in want_series},
        healthz=health, client_ms=timings,
        engine_ttft_ms=sorted(round(v, 3) for v in ttft_h._ring[ttft_seen:]))
    log(f"  16 requests over HTTP (8 JSON, 8 SSE, 16 client threads in a "
        f"process of their own): "
        f"{out['equal_to_phase5']}/16 streams phase 5's bit for bit; "
        f"tokens {tokens}, wall {wall:.3f} s, tokens/s "
        f"{out['tokens_per_s']:.1f} (phase 5 in-process "
        f"{phase5['tokens_per_s']:.1f})")
    log(f"  TTFT ms (engine clock) p50 {out['ttft_ms_p50']:.3f} p99 "
        f"{out['ttft_ms_p99']:.3f} (phase 5 {phase5['ttft_ms_p50']:.3f} / "
        f"{phase5['ttft_ms_p99']:.3f}); SSE first event at the client p50 "
        f"{out['sse_ttft_ms_p50']:.3f} p99 {out['sse_ttft_ms_p99']:.3f}; "
        f"decode ms/step p50 {out['decode_ms_p50']:.3f} p99 "
        f"{out['decode_ms_p99']:.3f} (phase 5 {phase5['decode_ms_p50']:.3f}"
        f" / {phase5['decode_ms_p99']:.3f})")
    for kind, sse in (("JSON", False), ("SSE", True)):
        rows = [t for t in timings if t["sse"] == sse]
        log(f"  {kind} client ms from the round's start (sent / headers / "
            f"first event / done): " + "; ".join(
                f"{t['sent']:.1f}/{t['headers']:.1f}/"
                f"{'-' if t['first'] is None else format(t['first'], '.1f')}"
                f"/{t['done']:.1f}" for t in rows))
    log(f"  engine TTFT ms, sorted: {out['engine_ttft_ms']}")
    log(f"  prefill groups {groups}, row-1 launches {launches}, captures "
        f"while serving {out['captures_while_serving']}; registry: "
        f"completed {completed}, ttft_ms count {ttft_h.count}, "
        f"inter_token_ms count {itl_h.count} (want {want_itl}); /metrics "
        f"{st} {out['metrics_type']!r}, {len(series)} series, "
        f"{out['metrics_seen']}; /healthz ready={health.get('ready')}")
    if differ:
        raise AssertionError(f"HTTP streams {differ} differ from phase 5's")
    if out["captures_while_serving"]:
        raise AssertionError("the HTTP engine captured a step while "
                             "serving")
    if launches != L * groups:
        raise AssertionError(f"{launches} row-1 launches over {groups} "
                             f"prefill groups; expected {L} per group")
    if (completed, ttft_h.count, itl_h.count) != (len(reqs), len(reqs),
                                                  want_itl):
        raise AssertionError(
            f"registry: completed {completed}, ttft_ms count "
            f"{ttft_h.count}, inter_token_ms count {itl_h.count}; expected "
            f"{len(reqs)}, {len(reqs)}, {want_itl}")
    if st != 200 or out["metrics_type"] != "text/plain; version=0.0.4" \
            or any(series.get(k) != v for k, v in want_series.items()):
        raise AssertionError(f"/metrics: {st}, {out['metrics_type']!r}, "
                             f"{out['metrics_seen']} != {want_series}")
    if st_h != 200 or health.get("ready") is not True:
        raise AssertionError(f"/healthz {st_h}: {health}")
    return out


def http_admission(torch, engine, srv, reqs, phase5):
    """18b: a tenant's quota admits one request's tokens, its next gets
    429 tenant_quota with Retry-After while another tenant is served;
    under pause() the requests past max_queue get 429 queue_full with
    Retry-After, and after resume() every admitted request completes,
    phase 5's stream."""
    prompt, kw = reqs[0]
    cost = len(prompt) + NEW_TOKENS
    engine.set_quotas({"q": {"rate": 0.0, "burst": float(cost)}})
    body = _request_body(prompt, kw)
    first = _http_call(srv.port, "/v1/generate", body, {"X-Tenant": "q"})
    second = _http_call(srv.port, "/v1/generate", body, {"X-Tenant": "q"})
    other = _http_call(srv.port, "/v1/generate", body,
                       {"X-Tenant": "r", "X-Priority": "interactive"})
    engine.set_quotas(None)
    quota = dict(cost=cost, first=first[0], second=second[0],
                 reason=second[2].get("reason"),
                 retry_after=second[1].get("retry-after"), other=other[0])
    log(f"  tenant q, burst {cost} tokens (one request): {first[0]}, then "
        f"{second[0]} {quota['reason']} Retry-After {quota['retry_after']}"
        f"; tenant r: {other[0]}")
    if (first[0], second[0], other[0]) != (200, 429, 200) or \
            quota["reason"] != "tenant_quota" or \
            not 1 <= int(quota["retry_after"] or 0) <= 30:
        raise AssertionError(f"tenant quota: {quota}")
    if _http_tokens(200, first[2]) != phase5["results"][0]:
        raise AssertionError("the quota's admitted request differs from "
                             "phase 5's stream")

    engine.pause()
    got, errors = [None] * len(reqs), []

    def client(i):
        try:
            st, _h, payload, _t = _http_call(
                srv.port, "/v1/generate", _request_body(*reqs[i]))
            got[i] = _http_tokens(st, payload)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 120
    while engine._admission.depth < HTTP_QUEUE:
        if time.monotonic() > deadline or errors:
            engine.resume()
            raise AssertionError(f"the paused queue holds "
                                 f"{engine._admission.depth} requests, "
                                 f"expected {HTTP_QUEUE}: {errors}")
        time.sleep(0.005)
    over = [_http_call(srv.port, "/v1/generate", _request_body(*reqs[0]))
            for _ in range(HTTP_OVERFLOW)]
    t0 = time.perf_counter()
    engine.resume()
    for th in threads:
        th.join(timeout=900)
    resume_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    differ = _same_streams(got, phase5["results"])
    pause = dict(queued=HTTP_QUEUE, over=[o[0] for o in over],
                 reasons=[o[2].get("reason") for o in over],
                 retry_after=[o[1].get("retry-after") for o in over],
                 completed_after_resume=sum(g is not None for g in got),
                 equal_to_phase5=len(reqs) - len(differ), resume_s=resume_s)
    log(f"  paused with {HTTP_QUEUE} queued: {HTTP_OVERFLOW} more answered "
        f"{pause['over']} {pause['reasons']} Retry-After "
        f"{pause['retry_after']}; after resume() "
        f"{pause['completed_after_resume']}/{len(reqs)} completed in "
        f"{resume_s:.3f} s, {pause['equal_to_phase5']} equal to phase 5's")
    if any(o[0] != 429 or o[2].get("reason") != "queue_full"
           or not 1 <= int(o[1].get("retry-after") or 0) <= 30
           for o in over):
        raise AssertionError(f"overload past max_queue: {pause}")
    if differ:
        raise AssertionError(f"streams {differ} after resume() differ from "
                             "phase 5's")
    return dict(quota=quota, pause=pause)


def _uncaptured_generate(torch, net, reqs):
    """Each request's stream from a GenerationSession whose steps are
    called directly (no CUDA graph), greedy rows and sampled rows in
    batches of SLOTS (rows never interact)."""
    import numpy as np
    from paddle_tpu_torch.generation import GenerationSession
    sess = GenerationSession(net, batch_capacity=SLOTS)

    def direct(kind, make, types, values):
        return make()(*[torch.as_tensor(np.asarray(v)).to(sess.device, t)
                        for v, t in zip(values, types)])
    sess._compiled = direct
    out = [None] * len(reqs)
    groups = {}
    for i, (_p, kw) in enumerate(reqs):
        key = tuple(sorted((k, v) for k, v in kw.items() if k != "seed"))
        groups.setdefault(key, []).append(i)
    for key, idx in groups.items():
        for j in range(0, len(idx), SLOTS):
            rows = idx[j:j + SLOTS]
            res = sess.generate([reqs[i][0] for i in rows],
                                max_new_tokens=NEW_TOKENS,
                                seeds=[reqs[i][1].get("seed", 0)
                                       for i in rows], **dict(key))
            for i, r in zip(rows, res):
                out[i] = r.tolist()
    return out


def http_swap(torch, engine, srv, reqs, phase5, width):
    """18c: swap_weights to a second seed's weights while 8 SSE streams
    decode (none drops, nothing captured again); requests after it equal
    an uncaptured session on those weights; swapping back gives phase
    5's streams; a tree with one wrong shape raises and leaves the live
    weights as they were."""
    from paddle_tpu_torch.models import GPT, GPTConfig
    net, cache = engine.model, engine.session._cache
    dev = net.device
    first = {k: v.detach().clone()
             for k, v in torch_view(net).state_dict().items()}
    net2 = GPT(GPTConfig(**width), device=dev, seed=HTTP_SWAP_SEED)
    second = {k: v.detach().clone()
              for k, v in torch_view(net2).state_dict().items()}
    compiles0 = cache.compiles
    errors, straddled = [], [None] * SLOTS

    def client(i):
        try:
            st, _h, payload, _t = _http_call(
                srv.port, "/v1/generate",
                dict(_request_body(*reqs[i]), stream=True), stream=True)
            straddled[i] = _http_tokens(st, payload)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SLOTS)]
    tok0 = engine.session.tokens_out
    for th in threads:
        th.start()
    deadline = time.monotonic() + 120
    # every stream in a slot and a few boundaries behind it
    while engine.occupancy < SLOTS or \
            engine.session.tokens_out - tok0 < 4 * SLOTS:
        if time.monotonic() > deadline or errors:
            raise AssertionError(f"8 streams never decoded together: "
                                 f"{errors}")
        time.sleep(0.001)
    at = engine.session.tokens_out - tok0
    from paddle_tpu_torch.profiler import flight

    def swap_event():
        evs = [f for _t, cat, ev, f in flight.events()
               if cat == "serve" and ev == "weights_swap"]
        return {k: round(v, 3) for k, v in evs[-1].items()
                if k.endswith("_ms")} if evs else {}
    t0 = time.perf_counter()
    engine.swap_weights(second)
    swap_ms = (time.perf_counter() - t0) * 1e3
    swap_parts = swap_event()
    for th in threads:
        th.join(timeout=900)
    if errors:
        raise errors[0]
    dropped = [i for i, s in enumerate(straddled)
               if s is None or len(s) != NEW_TOKENS]
    after, _t, _h, _w = _http_round(srv.port, reqs)
    plain = _uncaptured_generate(torch, net2, reqs)
    differ2 = _same_streams(after, plain)
    t0 = time.perf_counter()
    engine.swap_weights(first)
    back_ms = (time.perf_counter() - t0) * 1e3
    back_parts = swap_event()
    back, _t, _h, _w = _http_round(srv.port, reqs)
    differ_back = _same_streams(back, phase5["results"])
    checksum = sum(p.detach().double().sum().item()
                   for p in torch_view(net).parameters())
    bad = dict(first)
    bad["wte.weight"] = first["wte.weight"][:, :-1]
    try:
        engine.swap_weights(bad)
        raised = None
    except ValueError as e:
        raised = str(e)
    same = all(torch.equal(v, first[k])
               for k, v in torch_view(net).state_dict().items())
    checksum_after = sum(p.detach().double().sum().item()
                         for p in torch_view(net).parameters())
    out = dict(swap_ms=swap_ms, swap_back_ms=back_ms,
               swap_parts=swap_parts, swap_back_parts=back_parts,
               tokens_before_swap=at, straddling=SLOTS, dropped=dropped,
               captures=cache.compiles - compiles0,
               equal_to_uncaptured_second=len(reqs) - len(differ2),
               equal_to_phase5_after_swap_back=len(reqs) - len(differ_back),
               bad_tree_error=raised, weights_unchanged=same,
               checksum=checksum, checksum_after_bad_tree=checksum_after)
    log(f"  swap to seed {HTTP_SWAP_SEED}'s weights with {SLOTS} SSE streams"
        f" decoding ({at} tokens out): {swap_ms:.3f} ms from call to "
        f"return ({swap_parts}), {len(dropped)} streams dropped, captures "
        f"{out['captures']}; after it {out['equal_to_uncaptured_second']}/"
        f"{len(reqs)} streams equal an uncaptured session on those "
        f"weights; swap back {back_ms:.3f} ms ({back_parts}), "
        f"{out['equal_to_phase5_after_swap_back']}/{len(reqs)} phase 5's")
    log(f"  one wrong shape: {raised!r}; live weights unchanged {same} "
        f"(checksum {checksum!r} -> {checksum_after!r})")
    del net2, second, first
    if dropped or out["captures"]:
        raise AssertionError(f"the swap dropped streams {dropped} or "
                             f"captured {out['captures']} steps")
    if differ2:
        raise AssertionError(f"streams {differ2} after the swap differ from "
                             "the uncaptured session on the new weights")
    if differ_back:
        raise AssertionError(f"streams {differ_back} after swapping back "
                             "differ from phase 5's")
    if raised is None or "a shape/dtype change" not in raised or not same \
            or checksum != checksum_after:
        raise AssertionError(f"the bad tree: raised {raised!r}, weights "
                             f"unchanged {same}")
    return out


def http_observability(torch, fa, net, reqs, phase5, parity):
    """18d: request tracing, memory accounting and the lock sanitizer
    (level 1) on: every request's span chain complete with its
    traceparent echoed, the params / kv_arena tags equal to the computed
    bytes, no lock-order cycle; decode ms/step and tokens/s beside 18a's
    (all off)."""
    import warnings
    from paddle_tpu_torch.profiler import memscope, rtrace, tracer
    from paddle_tpu_torch.utils import concurrency as cc
    cfg = net.cfg
    L, D, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    with port_flags({"FLAGS_request_trace": True,
                     "FLAGS_mem_accounting": True, "FLAGS_lock_san": 1}), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tracer.clear()
        memscope.reset()
        cc.reset_graph()
        engine, srv, warmup_s = _http_engine(torch, net, "http_obs")
        try:
            tags = memscope.tag_bytes()
            ledger = [e for e in memscope.compile_entries()
                      if e["site"] == "http_obs"]
            tids = ["%032x" % (0xC0DE0000 + i) for i in range(len(reqs))]
            sess = engine.session
            decode0 = sess.steps["decode"]
            got, _sse, hdrs, wall = _http_round(
                srv.port, reqs, headers=lambda i: {
                    "traceparent": f"00-{tids[i]}-{'7a' * 8}-01",
                    "X-Request-Id": f"obs-{i}"}, process=True)
            decode_ms = list(sess.step_ms["decode"])[
                -(sess.steps["decode"] - decode0):]
            health = _http_call(srv.port, "/healthz")[2]
            stats = memscope.device_stats()
            peak = memscope.peak_bytes()
            census = memscope.census()
        finally:
            srv.stop()
            engine.close()
        san = cc.san_stats()
        cycles = cc.cycle_reports()
    params = sum(p.numel() for p in torch_view(net).parameters())
    kv_want = L * 2 * SLOTS * engine.max_length * D * 4
    events = tracer.events()
    tracer.clear()
    incomplete, echo_bad = [], []
    for i, tid in enumerate(tids):
        spans = rtrace.request_spans(events, trace_id=tid)
        names = [s["name"] for s in spans]
        root = [s for s in spans if s["name"] == "ingress"]
        ok = bool(root) and all(n in names for n in (
            "ingress", "admission", "queue_wait", "prefill", "egress")) \
            and names.count("decode") == len(got[i]) - 1 and all(
                s["parent_id"] == root[0]["span_id"] for s in spans
                if s["name"] != "ingress") and \
            root[0]["parent_id"] == "7a" * 8 and all(
                s.get("request_id") == f"obs-{i}" for s in spans)
        if not ok:
            incomplete.append((i, names))
        tp = hdrs[i].get("traceparent", "")
        if tp.split("-")[1:3] != [tid, root[0]["span_id"] if root else ""]:
            echo_bad.append((i, tp))
    differ = _same_streams(got, phase5["results"])
    long_holds = [str(w.message) for w in caught
                  if "held for" in str(w.message)]
    tokens = sum(len(t) for t in got)
    out = dict(
        warmup_s=warmup_s, spans=len(events), incomplete=incomplete,
        traceparent_not_echoed=echo_bad, equal_to_phase5=len(reqs)
        - len(differ), params_tag=tags.get("params"),
        params_want=4 * params, kv_arena_tag=tags.get("kv_arena"),
        kv_arena_want=kv_want, ledger=[dict(signature=e["signature"],
                                            cause=e["cause"],
                                            wall_ms=e["wall_ms"])
                                       for e in ledger],
        device_stats=stats, peak_bytes=peak,
        max_memory_allocated=torch.cuda.max_memory_allocated()
        if net.device.type == "cuda" else 0,
        census_live_bytes=census["live_bytes_total"],
        census_blocks=census["live_arrays"],
        healthz_memory={k: v for k, v in health.items()
                        if k.startswith("mem_")},
        san=san, cycles=cycles, long_holds=long_holds,
        tokens_per_s=tokens / wall, decode_ms_p50=pct(decode_ms, 50),
        decode_ms_p99=pct(decode_ms, 99))
    log(f"  tracing + memory accounting + lock sanitizer 1: {len(events)} "
        f"spans; span chains complete {len(reqs) - len(incomplete)}/"
        f"{len(reqs)}, traceparent echoed {len(reqs) - len(echo_bad)}/"
        f"{len(reqs)}; streams equal phase 5's {out['equal_to_phase5']}/"
        f"{len(reqs)}")
    log(f"  tags: params {out['params_tag']} B (4 x {params} parameters = "
        f"{4 * params}), kv_arena {out['kv_arena_tag']} B ({kv_want} = "
        f"{kv_want / 2**20:.1f} MiB); ledger {len(ledger)} captures "
        f"{[round(e['wall_ms'], 1) for e in ledger]} ms; peak_bytes "
        f"{peak} (max_memory_allocated {out['max_memory_allocated']}); "
        f"device_stats {stats}; census {census['live_arrays']} blocks "
        f"{census['live_bytes_total']} B")
    log(f"  sanitizer: {san}, cycles {len(cycles)}; long holds "
        f"{len(long_holds)}: {long_holds[:4]}")
    log(f"  decode ms/step p50 {out['decode_ms_p50']:.3f} p99 "
        f"{out['decode_ms_p99']:.3f} and tokens/s "
        f"{out['tokens_per_s']:.1f} with all three on; 18a (off) "
        f"{parity['decode_ms_p50']:.3f} / {parity['decode_ms_p99']:.3f}, "
        f"{parity['tokens_per_s']:.1f}")
    if incomplete or echo_bad:
        raise AssertionError(f"span chains incomplete {incomplete[:2]}, "
                             f"traceparent not echoed {echo_bad[:2]}")
    if differ:
        raise AssertionError(f"streams {differ} differ from phase 5's with "
                             "observability on")
    if out["params_tag"] != 4 * params or out["kv_arena_tag"] != kv_want:
        raise AssertionError(f"memory tags {tags}; expected params "
                             f"{4 * params}, kv_arena {kv_want}")
    if cycles or san["cycles"]:
        raise AssertionError(f"the lock sanitizer reported cycles: {cycles}")
    if san["acquires"] == 0:
        raise AssertionError("the sanitizer saw no acquire: the engine's "
                             "locks were not instrumented")
    return out


def http_path(torch, fa, dev, width, phase5):
    """Phase 18: phase 5's serving GPT behind ServingServer (18a-18d); the
    seconds it took."""
    import gc
    from paddle_tpu_torch.models import GPT, GPTConfig
    t0 = time.perf_counter()
    net = GPT(GPTConfig(**width), device=dev, seed=0)
    reqs = make_requests(net.cfg.vocab_size)
    engine, srv, warmup_s = _http_engine(torch, net, "http")
    log(f"  engine warmed in {warmup_s:.3f} s; serving on 127.0.0.1:"
        f"{srv.port}")
    try:
        log("== phase 18a: phase 5's requests over HTTP, JSON and SSE")
        parity = http_parity(torch, fa, engine, srv, reqs, phase5)
        log("== phase 18b: tenant quota and overload, Retry-After")
        admission = http_admission(torch, engine, srv, reqs, phase5)
        log(f"== phase 18c: swap_weights mid-traffic (seed "
            f"{HTTP_SWAP_SEED}), and back")
        swap = http_swap(torch, engine, srv, reqs, phase5, width)
    finally:
        srv.stop()
        engine.close()
    del engine
    gc.collect()
    log("== phase 18d: request tracing, memory accounting, lock sanitizer")
    obs = http_observability(torch, fa, net, reqs, phase5, parity)
    del net
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = dict(warmup_s=warmup_s, parity=parity, admission=admission,
               swap=swap, observability=obs,
               seconds=time.perf_counter() - t0)
    log(f"  phase 18 took {out['seconds']:.1f} s")
    return out


# -- phase 19: the profiler's windows on phase 12's O1 GPT ----------------------
PROFILE_FIT = dict(width=GPT_WIDTH, batch=32, seq=512, steps=8, cost_steps=12,
                   cost_rounds=2)
PROFILE_SCHED = dict(closed=1, ready=1, record=3, skip_first=1)
PROFILE_ATTEMPTS = 3         # CUPTI loses kernel records (PERF.md section 7)
# the kernels of a captured O1 step that the device trace must hold, as
# kineto names them (demangled, csrc/*.cu's anonymous namespace), each with
# the launch counter it is held to: the row 1 forward and the row 6
# backward's three passes on csrc/flash_attn_sm90.cu, the fused update and
# its powers' advance on csrc/multi_tensor_update.cu
TRACE_KERNELS = (("sm90_fwd", "(anonymous namespace)::fwd_kernel<", "sm90_fwd"),
                 ("sm90_delta", "(anonymous namespace)::delta_kernel<",
                  "sm90_bwd"),
                 ("sm90_dkv", "(anonymous namespace)::dkv_kernel<", "sm90_bwd"),
                 ("sm90_dq", "(anonymous namespace)::dq_kernel<", "sm90_bwd"),
                 ("mt_update", "(anonymous namespace)::mt_update_kernel<",
                  "update"),
                 ("mt_pows", "(anonymous namespace)::mt_pows_kernel(",
                  "update_pows"))


def expected_windows(prof, sched, n):
    """The record windows a Profiler driven by ``sched`` closes over a
    ``fit`` of ``n`` steps, each the batch indices it records: batch i runs
    in state ``sched(i)``; a window closes on leaving the record states or
    after RECORD_AND_RETURN, and one open at ``stop()`` (state ``sched(n)``)
    closes there, with no batch."""
    rec = (prof.ProfilerState.RECORD, prof.ProfilerState.RECORD_AND_RETURN)
    windows, cur = [], None
    for i in range(n + 1):
        state = sched(i)
        if state in rec:
            cur = [] if cur is None else cur
            if i < n:
                cur.append(i)
            if state is prof.ProfilerState.RECORD_AND_RETURN and i < n:
                windows.append(cur)
                cur = None
        elif cur is not None:
            windows.append(cur)
            cur = None
    if cur is not None:
        windows.append(cur)
    return windows


def _trace_counts(events, launch):
    """The TRACE_KERNELS kernels of one graph replay (the kernels whose
    correlation id is its cudaGraphLaunch's), and all its kernels."""
    corr = launch["args"]["correlation"]
    out = {name: 0 for name, _, _ in TRACE_KERNELS}
    total = 0
    for e in events:
        if e.get("cat") == "kernel" and \
                e.get("args", {}).get("correlation") == corr:
            total += 1
            for name, pat, _ in TRACE_KERNELS:
                if pat in e["name"]:
                    out[name] += 1
    return out, total


def _counted(launches):
    """The TRACE_KERNELS counts one step's launch counters give."""
    by = dict(sm90_fwd=launches["sm90_fwd"], sm90_bwd=launches["sm90_bwd"],
              update=sum(launches["update"].values()),
              update_pows=launches["update_pows"])
    return {name: by[key] for name, _, key in TRACE_KERNELS}


def check_window(win, steps, watch_steps):
    """One window of 19a against the batches ``steps`` it should record:
    its host spans, its device trace (one cudaGraphLaunch a step, each
    replay's TRACE_KERNELS as the step's counters say) and the clock (each
    launch inside its step's ``hapi::train_step`` span).  Returns the
    verdict; ``whole`` is False when the trace lost records."""
    host = win["events"]
    spans = sorted((e for e in host if e[0] == "hapi::train_step"),
                   key=lambda e: e[1])
    cats = {e[4] for e in host}
    dev = win["device"]
    evs = dev["events"]
    launches = sorted((e for e in evs if e.get("name") == "cudaGraphLaunch"),
                      key=lambda e: e["ts"])
    per = [_trace_counts(evs, ln) for ln in launches]
    want = [_counted(watch_steps[i]["launches"]) for i in steps]
    whole = len(launches) == len(steps) and \
        [c for c, _ in per] == want and len({t for _, t in per}) <= 1
    inside = [s[1] / 1e3 <= ln["ts"] and ln["ts"] + ln["dur"] <= s[2] / 1e3
              for ln, s in zip(launches, spans)]
    return dict(steps=steps, step_num=win["step_num"],
                host_steps=len(spans), host_cats=sorted(cats),
                host_ok=len(spans) == len(steps) and (
                    not steps or {"hapi", "dataloader"} <= cats),
                graph_launches=len(launches), kernels=[c for c, _ in per],
                kernels_per_replay=sorted({t for _, t in per}), want=want,
                whole=whole, launches_inside_steps=inside,
                clock_ok=whole and len(inside) == len(steps) and all(inside),
                offset_us=dev["offset_us"], skew_us=dev["skew_us"],
                path=dev["path"])


def _kernel_table(path, merged):
    """``tools/trace_summary.py --cat kernel`` on ``merged``: (its rows
    naming TRACE_KERNELS' sm90 kernels, its output)."""
    r = subprocess.run([sys.executable, os.path.join(path, "tools",
                                                     "trace_summary.py"),
                        merged, "--cat", "kernel", "-n", "200"],
                       capture_output=True, text=True, timeout=120,
                       check=True)
    named = {name: [ln for ln in r.stdout.splitlines() if pat in ln]
             for name, pat, _ in TRACE_KERNELS if name.startswith("sm90")}
    return named, r.stdout


def profiler_path(torch, fa, dev, cfg=PROFILE_FIT, phase12_ms=None):
    """Phase 19: paddle_tpu_torch.profiler on phase 12's O1 GPT (V 30528,
    D 768, L 12, H 12, T 512, B 32, ``profile_train.fit_recipe``,
    ``prepare(jit=True)``, ``prefetch_to_device=2``), built once.
    19a: ``fit`` of ``cfg["steps"]`` steps under ``ProfilerCallback(
    Profiler(make_scheduler(**PROFILE_SCHED), with_device_trace=True))``:
    the windows and their batches are the state machine's; each window's
    host spans hold a ``hapi::train_step`` a batch (and the ``hapi`` and
    ``dataloader`` categories); its device trace a cudaGraphLaunch a batch
    whose replay holds TRACE_KERNELS as the step's launch counters say
    (else the trace lost records: the fit is traced again, up to
    PROFILE_ATTEMPTS in all, and the phase fails if none is whole); each
    launch inside its step's span after the clock offset; the first
    window's merged export (``export_chrome_tracing`` from
    ``on_trace_ready``) lists the sm90 kernels in ``trace_summary.py --cat
    kernel``.  19b: one epoch of a fresh model under
    ``FLAGS_mem_accounting``: goodput fractions sum to 1 within 0.01; the
    ``params`` and ``opt_state`` tags equal the bytes of the parameters
    and of the slots and masters counted here; the ``step`` peak no more
    than ``max_memory_allocated``; a ``hapi.train_step`` ledger entry per
    capture; the goodput file.  19c: two ``train_batch`` calls between
    ``start_profiler`` and ``stop_profiler``: the file holds their sm90
    kernels.  19d: step ms p50 (CUDA events at each step's begin and end,
    unsynchronised) with everything off, the host tracer, a recording
    window with its device trace, memory accounting, in
    ``cfg["cost_rounds"]`` rounds of alternating order; printed beside
    ``phase12_ms``, phase 12's O1 step ms p50 with and without its
    metric, not gated.  Returns the report."""
    import gc
    import shutil
    import tempfile
    from paddle_tpu_torch import profiler as prof
    from paddle_tpu_torch.callbacks import ProfilerCallback
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.profiler import memscope
    from paddle_tpu_torch.tools import profile_train as pt
    t_phase = time.perf_counter()
    w, B, T = cfg["width"], cfg["batch"], cfg["seq"]
    net = GPT(GPTConfig(**w), device=dev, seed=0)
    data = TensorDataset(pt.fit_data(cfg["steps"] * B, 0, w["vocab_size"],
                                     T))
    cost_data = TensorDataset(pt.fit_data(cfg["cost_steps"] * B, 0,
                                          w["vocab_size"], T))

    def reset():
        _reset_attention(fa)
        _reset_update()

    def launches():
        return dict(_attention_launches(fa), **_update_launches())

    def fit(model, callbacks, ds=data):
        watch = _fit_watch(torch, reset, launches)
        try:
            model.fit(ds, batch_size=B, epochs=1, shuffle=False, verbose=0,
                      prefetch_to_device=2, callbacks=[watch] + callbacks)
        finally:
            watch.set_model(None)
        torch.cuda.synchronize()
        return watch

    out, checks = dict(config={k: v for k, v in cfg.items()
                               if k != "width"}, schedule=PROFILE_SCHED), {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profiler_")
    try:
        log(f"== phase 19a: fit of {cfg['steps']} steps under "
            f"ProfilerCallback, make_scheduler({PROFILE_SCHED}), device "
            f"trace")
        model = pt.fit_recipe(net, amp="O1")
        sched = prof.make_scheduler(**PROFILE_SCHED)
        want = expected_windows(prof, sched, cfg["steps"])
        attempts, verdicts = [], None
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            windows = []
            d = os.path.join(tmp, f"19a_{attempt}")

            def ready(p, d=d, windows=windows):
                merged = None
                if p.events:
                    merged = prof.export_chrome_tracing(os.path.join(
                        d, f"merged.{len(windows)}.json"), events=p.events)
                windows.append(dict(step_num=p.step_num, events=p.events,
                                    device=p.device_trace, merged=merged))
            p = prof.Profiler(scheduler=sched, with_device_trace=True,
                              log_dir=d, on_trace_ready=ready)
            watch = fit(model, [ProfilerCallback(profiler=p, summary=False)])
            captured = [s["step"] for s in watch.steps if s["captured"]]
            if [win["step_num"] for win in windows] != \
                    [(s[-1] + 1 if s else cfg["steps"]) for s in want]:
                raise AssertionError(
                    f"19a: windows closed at steps "
                    f"{[win['step_num'] for win in windows]}, the state "
                    f"machine closes {want}")
            verdicts = [check_window(win, s, watch.steps)
                        for win, s in zip(windows, want)]
            attempts.append(dict(
                attempt=attempt, captured=captured,
                whole=[v["whole"] for v in verdicts],
                graph_launches=[v["graph_launches"] for v in verdicts],
                kernels=[v["kernels"] for v in verdicts]))
            log(f"  19a attempt {attempt}: captures at batches {captured}; "
                f"windows {[v['steps'] for v in verdicts]} (closing at "
                f"steps {[v['step_num'] for v in verdicts]}); graph "
                f"launches {[v['graph_launches'] for v in verdicts]}; "
                f"kernels a replay {[v['kernels_per_replay'] for v in verdicts]}"
                f"; whole {[v['whole'] for v in verdicts]}")
            if all(v["whole"] for v in verdicts):
                break
        out["attempts"] = attempts
        out["windows"] = verdicts
        checks["windows_as_state_machine"] = True
        checks["a_whole_attempt"] = all(v["whole"] for v in verdicts)
        checks["host_spans"] = all(v["host_ok"] for v in verdicts)
        checks["launches_inside_steps"] = all(
            v["clock_ok"] for v in verdicts if v["steps"])
        checks["capture_outside_windows"] = not any(
            i in s for s in want for i in attempts[0]["captured"])
        for v in verdicts:
            log(f"  window {v['steps']}: host hapi::train_step "
                f"{v['host_steps']}, categories {v['host_cats']}; per "
                f"replay {v['kernels'][:1]} (counters {v['want'][:1]}); "
                f"launch inside its step {v['launches_inside_steps']}; "
                f"offset {v['offset_us']:.3f} us, anchors' skew "
                f"{v['skew_us']:.3f} us; {v['path']}")
        first = next(win for win in windows if win["merged"])
        named, table = _kernel_table(HERE, first["merged"])
        out["kernel_table_rows"] = {k: len(v) for k, v in named.items()}
        checks["trace_summary_lists_sm90"] = all(named.values())
        log("  trace_summary.py --cat kernel, the sm90 rows:")
        for rows in named.values():
            for ln in rows:
                log("    " + " ".join(ln.split()))
        del model
        gc.collect()
        torch.cuda.empty_cache()

        log("== phase 19b: one epoch of a fresh model under "
            "FLAGS_mem_accounting")
        flight_dir = os.path.join(tmp, "flight")
        env0 = {k: os.environ.get(k) for k in (
            "PADDLE_FLIGHT_DIR", "PADDLE_TRAINER_ID",
            "PADDLE_RESTART_GENERATION")}
        os.environ.update(PADDLE_FLIGHT_DIR=flight_dir, PADDLE_TRAINER_ID="0",
                          PADDLE_RESTART_GENERATION="0")
        memscope.reset()
        try:
            model = pt.fit_recipe(net, amp="O1")
            with port_flags({"FLAGS_mem_accounting": True}):
                fit(model, [])
        finally:
            for k, v in env0.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        opt = model._optimizer
        params = list(torch_view(net).parameters())
        param_bytes = sum(t.numel() * t.element_size() for t in params)
        slot_bytes = sum(t.numel() * t.element_size()
                         for st in opt._state.values() for t in st.values())
        slot_bytes += sum(t.numel() * t.element_size()
                          for t in opt._master_weights.values())
        tags = memscope.tag_bytes()
        peaks = memscope.phase_peaks()
        max_alloc = torch.cuda.max_memory_allocated()
        ledger = [e for e in memscope.compile_entries()
                  if e["site"] == "hapi.train_step"]
        gp = model._last_goodput
        with open(os.path.join(flight_dir, "goodput.r0.g0.json")) as f:
            gp_file = json.load(f)
        out["memory"] = dict(
            goodput=gp, tags=tags, param_bytes=param_bytes,
            opt_state_bytes=slot_bytes, phase_peaks=peaks,
            max_memory_allocated=max_alloc, ledger=ledger,
            captures=model._steps.compiles)
        checks.update(
            goodput_sums_to_1=abs(sum(gp["fractions"].values()) - 1) <= 0.01,
            params_tag=tags.get("params") == param_bytes,
            opt_state_tag=tags.get("opt_state") == slot_bytes,
            step_peak=0 < peaks.get("step", 0) <= max_alloc,
            ledger_per_capture=len(ledger) == model._steps.compiles == 1,
            goodput_file=gp_file["fractions"] == gp["fractions"])
        log(f"  19b: goodput {gp['fractions']} (sum "
            f"{sum(gp['fractions'].values()):.6f}), {gp['compiles']} "
            f"compile(s), {gp['steps']} steps; tags params "
            f"{tags.get('params')} (counted {param_bytes}), opt_state "
            f"{tags.get('opt_state')} (counted {slot_bytes}); step peak "
            f"{peaks.get('step')} <= max_memory_allocated {max_alloc}; "
            f"ledger {[(e['site'], e['cause'], e['wall_ms']) for e in ledger]}"
            f" for {model._steps.compiles} capture(s); goodput file "
            f"{checks['goodput_file']}")
        memscope.reset()

        log("== phase 19c: start_profiler, two train_batch calls, "
            "stop_profiler")
        ids, labels = pt.fit_data(B, 0, w["vocab_size"], T)
        model.train_batch([ids], [labels])      # a replay before the session
        legacy = []
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            d = os.path.join(tmp, f"19c_{attempt}")
            reset()
            prof.start_profiler(log_dir=d)
            for _ in range(2):
                model.train_batch([ids], [labels])
            prof.stop_profiler()
            counted = _counted(launches())
            files = os.listdir(d)
            with open(os.path.join(d, files[0])) as f:
                evs = json.load(f)["traceEvents"]
            got = {name: sum(1 for e in evs if e.get("cat") == "kernel"
                             and pat in e["name"])
                   for name, pat, _ in TRACE_KERNELS}
            legacy.append(dict(attempt=attempt, files=files, kernels=got,
                               counted=counted))
            log(f"  19c attempt {attempt}: {files}: kernels {got} (counters "
                f"{counted})")
            if got == counted:
                break
        out["legacy"] = legacy
        checks["legacy_file_holds_sm90"] = len(legacy[-1]["files"]) == 1 and \
            legacy[-1]["kernels"] == legacy[-1]["counted"]

        log("== phase 19d: step ms with tracing and accounting off and on")
        def cost(setting):
            cbs, flags = [], {}
            if setting == "tracer":
                prof.enable_host_tracer()
            elif setting == "window":
                cbs = [ProfilerCallback(profiler=prof.Profiler(
                    with_device_trace=True, log_dir=os.path.join(tmp, "19d")),
                    summary=False)]
            elif setting == "mem_accounting":
                flags = {"FLAGS_mem_accounting": True}
            try:
                with port_flags(flags):
                    watch = fit(model, cbs, cost_data)
            finally:
                prof.disable_host_tracer()
                prof.tracer.clear()
                memscope.reset()
            return _step_ms(watch.steps[1:], 0, B)[0]

        settings = ("off", "tracer", "window", "mem_accounting")
        ms = {k: [] for k in settings}
        for r in range(cfg["cost_rounds"]):
            for k in (settings if r % 2 == 0 else settings[::-1]):
                ms[k].append(cost(k))
        out["cost_step_ms_p50"] = ms
        out["phase12_step_ms_p50"] = phase12_ms
        log(f"  19d: step ms p50 over steps 2-{cfg['cost_steps']} of a fit, "
            f"rounds {cfg['cost_rounds']}: "
            + ", ".join(f"{k} {[round(v, 3) for v in vs]}"
                        for k, vs in ms.items())
            + f"; phase 12's O1 fit with and without its metric "
            f"{phase12_ms} ({card_line()})")
        del model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t_phase
    failed = [k for k, v in checks.items() if v is not True]
    log(f"  phase 19 checks {checks}; {out['seconds']:.1f} s "
        f"({card_line()})")
    if failed:
        raise AssertionError(f"phase 19 failed its checks: {failed}")
    return out


# -- phase 20 ------------------------------------------------------------------
# the eager core: the reference's nn.TransformerEncoder at BERT-base width,
# written as a paddle user writes it (phase 11's encoder on the eager core)
EAGER_CORE = dict(vocab_size=30528, max_len=512, d_model=768, nhead=12,
                  dim_feedforward=3072, num_layers=12, dropout=0.1,
                  batch=32, seq=512)
EAGER_CORE_STEPS = 3      # runs compared bit for bit (20a, 20b)
EAGER_CORE_FALL = 12      # 20a: the loss falls over these steps, timed
EAGER_CORE_TIMED = 4      # 20b: Model steps timed per engine
EAGER_CORE_AMP = 6        # 20c: O1 steps, timed


def eager_core_net(paddle, cfg, sparse=False, padding_idx=None):
    """The encoder of :data:`EAGER_CORE` as a ``paddle.nn.Layer``: token
    and position embeddings, ``nn.TransformerEncoder`` (post-LN, GELU,
    hidden dropout, no attention dropout) and an untied head; the token
    embedding with ``sparse`` and ``padding_idx`` as given."""
    nn = paddle.nn

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            D = cfg["d_model"]
            self.wte = nn.Embedding(cfg["vocab_size"], D,
                                    padding_idx=padding_idx, sparse=sparse)
            self.wpe = nn.Embedding(cfg["max_len"], D)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                D, cfg["nhead"], cfg["dim_feedforward"],
                dropout=cfg["dropout"], activation="gelu", attn_dropout=0.0),
                cfg["num_layers"])
            self.head = nn.Linear(D, cfg["vocab_size"])

        def forward(self, ids):
            pos = paddle.arange(ids.shape[1])
            return self.head(self.encoder(self.wte(ids) + self.wpe(pos)))
    return Encoder()


def _core_grads(view):
    return {n: p.grad.detach().clone() for n, p in view.named_parameters()
            if p.grad is not None}


def _core_compare(torch, a, b):
    """(relative L2 of each gradient, of all of them together, every
    gradient finite).  Each gradient's error is taken relative to its own
    norm, or to 1e-3 of the norm of all gradients where its own is
    smaller: the keys' bias gets a gradient of exactly 0 (softmax ignores
    a constant along a row), so both runs hold only roundings there."""
    total = torch.sqrt(sum(g.float().norm() ** 2 for g in b.values()))
    err = {n: (a[n].float() - b[n].float()).norm() for n in b}
    rel = {n: (err[n] / torch.maximum(b[n].float().norm(),
                                      1e-3 * total)).item() for n in b}
    whole = (torch.sqrt(sum(e ** 2 for e in err.values())) / total).item()
    return rel, whole, all(bool(torch.isfinite(g).all())
                           for g in a.values())


def _core_step(paddle, net, opt, ids, labels, amp=None):
    """One dygraph step: forward and loss (under ``amp`` when given),
    backward, ``opt.step()``, ``opt.clear_grad()``; returns the loss,
    detached: a loss kept with its graph keeps the parameters' gradient
    accumulators, whose stream a later capture cannot take."""
    F = paddle.nn.functional
    if amp:
        with paddle.amp.auto_cast(level=amp):
            loss = F.cross_entropy(net(ids), labels)
    else:
        loss = F.cross_entropy(net(ids), labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _core_case(paddle, np, case, place, cot_seed=0):
    """One op-table case on ``place``: its outputs as (dtype name, numpy),
    the gradients of its ``grad`` inputs, and whether every output lies on
    the card."""
    from paddle_tpu_torch.core.dtype import canonical_dtype
    paddle.set_device(place)
    ts = [paddle.to_tensor(a, stop_gradient=i not in case.grad)
          if isinstance(a, np.ndarray) else a
          for i, a in enumerate(case.args)]
    out = case.fn(paddle)(*ts, **case.kw)
    flat, todo = [], [out]
    while todo:
        o = todo.pop(0)
        if isinstance(o, (tuple, list)):
            todo[:0] = list(o)
        elif hasattr(o, "_data"):
            flat.append(o)
    rs = np.random.RandomState(cot_seed)
    loss = None
    for o in flat:
        if o.stop_gradient or not o._data.is_floating_point():
            continue
        cot = paddle.to_tensor(np.asarray(rs.randn(*o.shape), np.float32)
                               ).astype(canonical_dtype(o.dtype))
        term = (o * cot).sum()
        loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    grads = [ts[i].grad.numpy() for i in case.grad
             if ts[i].grad is not None]
    return ([(canonical_dtype(o.dtype), o.numpy()) for o in flat], grads,
            all(o._data.is_cuda for o in flat))


def eager_op_table(torch, dev):
    """20d: every op-table case on ``dev``'s place against the CPU place,
    forward and gradients at the CPU tests' tolerances; a creation op made
    with no place lands on the card.  Returns the report."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import creation
    from paddle_tpu_torch.tools.eager_ops import CASES
    tols = {"ew": dict(rtol=1e-5, atol=1e-6),
            "red": dict(rtol=1e-4, atol=1e-5),
            "fft": dict(rtol=2e-4, atol=2e-4),
            "dec": dict(rtol=1e-3, atol=1e-5)}
    place = f"gpu:{dev.index or 0}" if dev.type == "cuda" else "cpu"
    bad, on_card, t0 = [], 0, time.perf_counter()
    for case in CASES:
        try:
            ref_out, ref_g, _ = _core_case(paddle, np, case, "cpu")
            out, grads, cuda = _core_case(paddle, np, case, place)
            assert [d for d, _ in out] == [d for d, _ in ref_out], "dtypes"
            for (d, a), (_, b) in zip(out, ref_out):
                assert a.shape == b.shape, "shapes"
                if d.startswith(("float", "bfloat", "complex")):
                    np.testing.assert_allclose(a, b, **tols[case.tol])
                else:
                    np.testing.assert_array_equal(a, b)
            assert len(grads) == len(ref_g), "gradients"
            for a, b in zip(grads, ref_g):
                np.testing.assert_allclose(a, b, **tols[case.tol])
            if case.kind == "fn" and case.name in creation.__all__ and \
                    dev.type == "cuda":
                assert cuda, "not on the card"
                on_card += 1
        except Exception as e:          # noqa: BLE001 -- each case reported
            bad.append(f"{case.id}: {type(e).__name__}: "
                       f"{str(e).splitlines()[0][:160] if str(e) else ''}")
    paddle.set_device(place)
    seconds = time.perf_counter() - t0
    log(f"  20d: {len(CASES)} op-table cases (functions, methods, operators)"
        f" on {place} against the CPU, forward and gradients: "
        f"{len(CASES) - len(bad)} within the CPU tests' tolerances; "
        f"{on_card} creation ops with no place on the card; {seconds:.1f} s")
    if bad:
        raise AssertionError(f"{len(bad)} op-table cases differ on the "
                             f"card: " + "; ".join(bad[:20]))
    return dict(cases=len(CASES), creation_on_card=on_card, seconds=seconds)


def eager_core_path(torch, fa, dev, cfg=EAGER_CORE):
    """Phase 20 (the module docstring) on ``dev``; returns the report."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import torch_view
    from paddle_tpu_torch.profiler import metrics, tracer
    from paddle_tpu_torch.tools import profile_train
    t_phase = time.perf_counter()
    F = paddle.nn.functional
    dev = torch.device(dev)
    paddle.set_device(f"gpu:{dev.index or 0}" if dev.type == "cuda"
                      else "cpu")
    L, B, T, V = cfg["num_layers"], cfg["batch"], cfg["seq"], \
        cfg["vocab_size"]
    paddle.seed(0)
    net = eager_core_net(paddle, cfg)
    view = torch_view(net)
    state0 = {k: v.detach().clone() for k, v in view.state_dict().items()}
    ids_np = np.random.RandomState(0).randint(0, V, (B, T))
    labels_np = np.roll(ids_np, -1, 1).reshape(B, T, 1)
    ids, labels = paddle.to_tensor(ids_np), paddle.to_tensor(labels_np)
    batches = [(paddle.roll(ids, i, 0), paddle.roll(labels, i, 0))
               for i in range(EAGER_CORE_STEPS)]
    mode = fa._pallas_mode(T, T, False)
    rows = dict(fwd=fa.reference_rows("fwd", mode, T),
                bwd=fa.reference_rows("bwd", mode, T))

    def adamw():
        return paddle.optimizer.AdamW(1e-3, parameters=net.parameters(),
                                      weight_decay=0.01)

    def restore():
        net.set_state_dict(state0)
        net.clear_gradients()

    def counts():
        return dict(_attention_launches(fa), **_update_launches())

    def reset():
        _reset_attention(fa)
        _reset_update()

    # -- 20a: the main path, counted, against the plain versions ----------
    log("  20a: the dygraph loop in fp32")
    restore()
    opt = adamw()
    sync(torch, dev)
    reset()
    paddle.seed(1)
    loss = F.cross_entropy(net(ids), labels)
    loss.backward()
    loss_k = loss.item()
    del loss
    grads_k = _core_grads(view)
    want = dict(_attention_want(L, mode, mode, None),
                **_update_want(opt, list(view.parameters())))
    opt.step()
    opt.clear_grad()
    sync(torch, dev)
    launched = counts()
    restore()
    paddle.seed(1)
    with _plain_attention(fa):
        loss = F.cross_entropy(net(ids), labels)
        loss.backward()
    loss_p = loss.item()
    del loss
    grads_p = _core_grads(view)
    rels, whole, finite = _core_compare(torch, grads_k, grads_p)
    worst = max(rels, key=rels.get)
    rel = rels[worst]
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    del grads_k, grads_p
    net.clear_gradients()
    log(f"  20a: step through the kernels: loss {loss_k:.6f}, launches "
        f"{launched} (expected {want}; rows {rows}, non-causal); the plain "
        f"versions: loss {loss_p:.6f} (rel diff {d_loss:.3e}, limit "
        f"{EAGER_LOSS_RTOL:g}), gradient rel L2 of each of {len(rels)} "
        f"parameters at most {rel:.3e} ({worst}; limit "
        f"{EAGER_GRAD_RTOL:g}), of all together {whole:.3e}, all finite "
        f"{finite}")
    if launched != want:
        raise AssertionError(f"the dygraph step launched {launched}; "
                             f"expected {want}")
    if not (finite and np.isfinite(loss_k) and d_loss <= EAGER_LOSS_RTOL
            and rel <= EAGER_GRAD_RTOL):
        raise AssertionError("the dygraph step through the kernels "
                             "disagrees with the plain versions")

    def loop(steps_batches, seed, amp=None):
        restore()
        opt = adamw()
        paddle.seed(seed)
        losses = [_core_step(paddle, net, opt, b_ids, b_labels,
                             amp)._data.detach()
                  for b_ids, b_labels in steps_batches]
        return torch.stack(losses), _train_state(view, opt)

    l1, s1 = loop(batches, 2)
    l2, s2 = loop(batches, 2)
    repeats = bool(torch.equal(l1, l2)) and all(
        torch.equal(v, s2[k]) for k, v in s1.items())
    del s2
    log(f"  20a: two {EAGER_CORE_STEPS}-step runs from seed 0 "
        f"({len(s1)} parameters and slots): losses {l1.tolist()}, bit for "
        f"bit {repeats}")
    if not repeats:
        raise AssertionError("two dygraph runs from one seed differ")

    restore()
    opt = adamw()
    paddle.seed(3)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times, host = [], [], []
    for i in range(EAGER_CORE_FALL):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        h0 = time.perf_counter()
        loss = _core_step(paddle, net, opt, ids, labels)
        host.append((time.perf_counter() - h0) * 1e3)
        b.record()
        b.synchronize()
        losses.append(loss.item())
        if i >= TRAIN_WARMUP:
            times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    step_ms = pct(times, 50)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the dygraph loss did not fall: {losses}")

    # -- 20e: the dispatch's spans, on one step of the same loop ----------
    tracer.enable()
    tracer.clear()
    before = metrics.counter("dispatch.count").value
    _core_step(paddle, net, opt, ids, labels)
    sync(torch, dev)
    dispatched = metrics.counter("dispatch.count").value - before
    evs = tracer.events()
    tracer.clear()
    tracer.disable()
    spans = [e for e in evs if e[4] == "dispatch"]
    cats = sorted({e[4] for e in evs})
    model = paddle.Model(net).prepare(opt, paddle.nn.CrossEntropyLoss(),
                                      jit=False)
    table, shares, wall = tracer.eager_phase_profile(
        model, opt, ids, labels, net.head.weight, steps=2)
    need = {"matmul", "norm", "elementwise", "loss", "optimizer"}
    total = sum(v["time_frac"] for v in shares.values())
    log(f"  20e: one traced step: {len(spans)} op:: spans under cats {cats}"
        f", dispatch.count +{dispatched}; eager_phase_profile over 2 steps "
        f"({wall:.2f} s): " + ", ".join(
            f"{k} {v['time_frac']:.4f} ({v['calls']} calls)"
            for k, v in shares.items()) + f"; sum {total:.6f}")
    if not spans or cats != ["dispatch"] or len(spans) != dispatched or \
            not all(e[0].startswith("op::") for e in spans):
        raise AssertionError("the traced step's dispatch spans are wrong")
    if not need <= set(shares) or abs(total - 1.0) > 1e-9:
        raise AssertionError(f"eager_phase_profile's shares {shares}")
    del model

    prof = profile_train.profile(
        lambda: _core_step(paddle, net, opt, ids, labels),
        lambda: _reset_attention(fa),
        lambda: dict(fwd=fa.FWD_LAUNCHES, bwd=fa.BWD_LAUNCHES),
        dict(path="eager core: the dygraph loop", batch=B, seq=T), 2)
    log(f"  20a: step ms p50 {step_ms:.3f} (min {min(times):.3f}, "
        f"{len(times)} steps after {TRAIN_WARMUP} warm-ups, CUDA events); "
        f"host ms p50 {pct(host, 50):.3f}; peak memory "
        f"{peak / 2**30:.3f} GiB; {dispatched} ops dispatched a step; idle "
        f"share {prof['idle_share']:.4f} (device busy "
        f"{prof['device_busy_ms_per_step']:.3f} of "
        f"{prof['wall_ms_p50']:.3f} ms); losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    core = dict(config=cfg, rows=rows, launches=launched, expected=want,
                loss_step1=loss_k, loss_step1_plain=loss_p,
                loss_rel_diff=d_loss, grad_rel_l2_max=rel,
                grad_rel_l2_whole=whole, deterministic=repeats, losses=losses, step_ms=times,
                step_ms_p50=step_ms, host_ms=host,
                host_ms_p50=pct(host, 50), peak_memory_bytes=peak,
                ops_dispatched_per_step=dispatched,
                idle_share=prof["idle_share"], profile=prof,
                phase_shares=shares, phase_table_ops=len(table))

    # -- 20b: the same Layer through Model --------------------------------
    log("  20b: the same Layer through Model (AdamW, nn.CrossEntropyLoss)")

    def model_run(jit):
        restore()
        opt = adamw()
        model = paddle.Model(net).prepare(
            opt, paddle.nn.CrossEntropyLoss(), jit=jit)
        paddle.seed(2)
        out, replay, upd_want = [], {}, {}
        for i, (b_ids, b_labels) in enumerate(batches):
            if jit and i == 1:
                sync(torch, dev)
                reset()
            out.append(model.train_batch([b_ids], [b_labels])["loss"])
            if jit and i == 1:
                sync(torch, dev)
                replay = counts()
                upd_want = _update_want(opt, list(view.parameters()))
        state = _train_state(view, opt)
        captured = _all_captured(model._steps.entries().values())
        times = []
        for _ in range(EAGER_CORE_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model.train_batch([ids], [labels])
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return (torch.stack(out), state, captured, model._steps.compiles,
                replay, upd_want, times)

    l_e, s_e, cap_e, _, _, _, t_e = model_run(False)
    eager_equal = bool(torch.equal(l_e, l1)) and all(
        torch.equal(v, s_e[k]) for k, v in s1.items())
    del s1
    l_j, s_j, cap_j, captures, replay, upd_want, t_j = model_run(True)
    exact = bool(torch.equal(l_j, l_e)) and all(
        torch.equal(v, s_j[k]) for k, v in s_e.items())
    del s_e, s_j
    want_replay = dict(_attention_want(L, mode, mode, None), **upd_want)
    log(f"  20b: jit=False = 20a's loop bit for bit: {eager_equal}; "
        f"jit=True = jit=False bit for bit: {exact} (losses {l_j.tolist()})"
        f"; captured {cap_j} (jit=False {cap_e}), captures {captures}; a "
        f"replay's launches {replay} (expected {want_replay}); step ms p50 "
        f"captured {pct(t_j, 50):.3f}, uncaptured {pct(t_e, 50):.3f} "
        f"(gap {pct(t_e, 50) - pct(t_j, 50):.3f}: the dispatch's host cost)")
    if not (eager_equal and exact):
        raise AssertionError("Model on the Layer differs from the dygraph "
                             "loop, or captured from uncaptured")
    if cap_e or not cap_j or captures != 1:
        raise AssertionError("jit=True did not capture once, or jit=False "
                             "captured")
    if replay != want_replay:
        raise AssertionError(f"a replayed step launched {replay}; "
                             f"expected {want_replay}")
    core["model"] = dict(uncaptured_equals_loop=eager_equal,
                         captured_equals_uncaptured=exact, captures=captures,
                         replay_launches=replay, step_ms_captured=t_j,
                         step_ms_uncaptured=t_e,
                         step_ms_p50_captured=pct(t_j, 50),
                         step_ms_p50_uncaptured=pct(t_e, 50))

    # -- 20c: AMP O1 in bf16 ----------------------------------------------
    log("  20c: the dygraph loop under auto_cast (O1, bf16)")
    restore()
    opt = adamw()
    sync(torch, dev)
    reset()
    paddle.seed(4)
    with paddle.amp.auto_cast(level="O1"):
        loss = F.cross_entropy(net(ids), labels)
    loss.backward()
    sync(torch, dev)
    amp_launched = _attention_launches(fa)
    loss_k = loss.item()
    del loss
    grads_k = _core_grads(view)
    restore()
    paddle.seed(4)
    with _plain_attention(fa):
        with paddle.amp.auto_cast(level="O1"):
            loss = F.cross_entropy(net(ids), labels)
        loss.backward()
    loss_p = loss.item()
    del loss
    grads_p = _core_grads(view)
    rels, whole, finite = _core_compare(torch, grads_k, grads_p)
    worst = max(rels, key=rels.get)
    # phase 9's O1 check holds these by name: a projection of the first
    # block, the embedding, the last block's output product; here also
    # all the gradients together
    held = ("encoder.layers.0.self_attn.q_proj.weight", "wte.weight",
            f"encoder.layers.{L - 1}.linear2.weight", "head.weight")
    rel = max(rels[n] for n in held)
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    del grads_k, grads_p
    restore()
    amp_want = _attention_want(L, mode, mode, "O1")
    paddle.seed(5)
    amp_losses, amp_times = [], []
    for i in range(EAGER_CORE_AMP):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = _core_step(paddle, net, opt, ids, labels, amp="O1")
        b.record()
        b.synchronize()
        amp_losses.append(loss.item())
        if i >= TRAIN_WARMUP:
            amp_times.append(a.elapsed_time(b))
    log(f"  20c: launches {amp_launched} (expected {amp_want}); the plain "
        f"versions: loss rel diff {d_loss:.3e} (limit "
        f"{TRAIN_LOSS_RTOL['bfloat16']:g}), gradient rel L2 of {held} at "
        f"most {rel:.3e} and of all together {whole:.3e} (limit "
        f"{TRAIN_GRAD_RTOL['bfloat16']:g}; the worst single parameter "
        f"{worst} {rels[worst]:.3e}), finite {finite}; losses "
        f"{amp_losses[0]:.4f} -> {amp_losses[-1]:.4f}; step ms p50 "
        f"{pct(amp_times, 50):.3f}")
    if amp_launched != amp_want:
        raise AssertionError(f"the O1 step launched {amp_launched}; "
                             f"expected {amp_want}")
    if not (finite and d_loss <= TRAIN_LOSS_RTOL["bfloat16"]
            and max(rel, whole) <= TRAIN_GRAD_RTOL["bfloat16"]):
        raise AssertionError("the O1 step through the kernels disagrees "
                             "with the plain versions")
    if not amp_losses[-1] < amp_losses[0]:
        raise AssertionError(f"the O1 loss did not fall: {amp_losses}")
    core["amp_o1"] = dict(launches=amp_launched, loss_rel_diff=d_loss,
                          grad_rel_l2_held=rel, grad_rel_l2_whole=whole,
                          grad_rel_l2_worst=(worst, rels[worst]),
                          losses=amp_losses,
                          step_ms=amp_times,
                          step_ms_p50=pct(amp_times, 50))
    del net, view, state0, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- 20d: the op table on the card ------------------------------------
    core["op_table"] = eager_op_table(torch, dev)
    core["seconds"] = time.perf_counter() - t_phase
    log(f"  20: {core['seconds']:.1f} s ({card_line()})")
    return core


SPARSE_STEPS = 3       # 21a / 21c: runs compared bit for bit
SPARSE_FALL = 12       # 21d: the loss falls over these Adam steps
SPARSE_ROUND = 6       # 21d: steps a round (one warm-up), two rounds a mode
SPARSE_LR = {"sgd": 1e-2, "adam": 1e-4, "adamw": 1e-4}
SPARSE_REL = 1e-6      # 21a SGD sparse against dense; 21b the clip scale


def sparse_ids(np, V, B, T, seed=21):
    """Token ids from ``seed``, uniform over 1 ... V - 1, row i's last
    (7·i mod 64) positions the padding id 0."""
    ids = np.random.RandomState(seed).randint(1, V, (B, T))
    for i in range(B):
        k = (7 * i) % 64
        if k:
            ids[i, T - k:] = 0
    return ids


def _state_rel_l2(torch, a, b):
    """max over keys of ‖a - b‖ / ‖b‖ (‖b‖ 0: ‖a - b‖)."""
    out = 0.0
    for k, v in b.items():
        d = (a[k].double() - v.double()).norm().item()
        n = v.double().norm().item()
        out = max(out, d / n if n else d)
    return out


def _rows_records(torch, mtu, opt, p, merged, name):
    """Two records of the row-sparse update of ``p`` from ``opt``'s state
    (clones: one for the kernel, one for the plain version)."""
    spec = opt._kernel_spec()
    slot = opt._state.get(id(p), {})
    out = []
    for _ in range(2):
        out.append(mtu.Record(
            name=name, param=p.detach().clone(),
            grad=merged._values.contiguous(), master=None,
            slots=tuple(slot[k].clone() for k in spec.slots),
            pows=tuple(slot[k].clone() for k in ("beta1_pow", "beta2_pow")[
                :len(spec.betas)]), rows=merged._rows,
            **opt._kernel_record(name)))
    return spec, out


def _record_state(spec, r):
    return dict({"param": r.param}, **dict(zip(spec.slots, r.slots)),
                **{f"pow{i}": t for i, t in enumerate(r.pows)})


def sparse_embedding_path(torch, fa, dev, cfg=EAGER_CORE):
    """Phase 21 (the module docstring) on ``dev``; returns the report."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.selected_rows import SelectedRows, merged_grad
    from paddle_tpu_torch.nn import torch_view
    from paddle_tpu_torch.nn.clip import _clippable
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    from paddle_tpu_torch.tools import profile_train
    t_phase = time.perf_counter()
    F = paddle.nn.functional
    dev = torch.device(dev)
    paddle.set_device(f"gpu:{dev.index or 0}" if dev.type == "cuda"
                      else "cpu")
    L, B, T, V, D = cfg["num_layers"], cfg["batch"], cfg["seq"], \
        cfg["vocab_size"], cfg["d_model"]
    paddle.seed(0)
    net = eager_core_net(paddle, cfg, sparse=True, padding_idx=0)
    view = torch_view(net)
    wte = dict(view.named_parameters())["wte.weight"]
    state0 = {k: v.detach().clone() for k, v in view.state_dict().items()}
    ids_np = sparse_ids(np, V, B, T)
    labels_np = np.roll(ids_np, -1, 1).reshape(B, T, 1)
    ids, labels = paddle.to_tensor(ids_np), paddle.to_tensor(labels_np)
    batches = [(paddle.roll(ids, i, 0), paddle.roll(labels, i, 0))
               for i in range(SPARSE_STEPS)]
    touched_np = np.unique(ids_np)
    untouched = torch.ones(V, dtype=torch.bool, device=dev)
    untouched[torch.as_tensor(touched_np, device=dev)] = False
    mode = fa._pallas_mode(T, T, False)
    attn_want = _attention_want(L, mode, mode, None)
    opts = {
        "sgd": lambda **k: paddle.optimizer.SGD(
            SPARSE_LR["sgd"], parameters=net.parameters(), **k),
        "adam": lambda **k: paddle.optimizer.Adam(
            SPARSE_LR["adam"], parameters=net.parameters(), **k),
        "adamw": lambda **k: paddle.optimizer.AdamW(
            SPARSE_LR["adamw"], parameters=net.parameters(),
            weight_decay=0.01, **k)}

    def set_sparse(on):
        net.wte._sparse = on

    def restore(sparse=True):
        net.set_state_dict(state0)
        net.clear_gradients()
        set_sparse(sparse)

    def reset():
        _reset_attention(fa)
        _reset_update()
        mtu.ROWS_LAUNCHES = 0

    def counts():
        return dict(_attention_launches(fa), **_update_launches(),
                    update_rows=mtu.ROWS_LAUNCHES)

    def loop(kind, sparse, seed=2, **kw):
        restore(sparse)
        opt = opts[kind](**kw)
        paddle.seed(seed)
        losses = [_core_step(paddle, net, opt, b_ids, b_labels)._data.detach()
                  for b_ids, b_labels in batches]
        return torch.stack(losses), _train_state(view, opt)

    report = dict(config=dict(cfg, padding_idx=0, ids_seed=21),
                  occurrences=B * T, unique_ids=int(touched_np.size))

    # -- 21a: SGD, Adam and AdamW on the sparse table ----------------------
    log(f"  21a: SGD, Adam and AdamW with wte = nn.Embedding({V}, {D}, "
        f"padding_idx=0, sparse=True); {B * T} ids, {touched_np.size} "
        f"distinct")
    runs, errs = {}, []
    for kind in ("sgd", "adam", "adamw"):
        restore()
        opt = opts[kind]()
        sync(torch, dev)
        reset()
        paddle.seed(1)
        loss = F.cross_entropy(net(ids), labels)
        loss.backward()
        del loss
        g = net.wte.weight.grad
        sparse_ok = (isinstance(g, SelectedRows) and wte.grad.is_sparse
                     and tuple(g.values.shape) == (B * T, D)
                     and g.dense_shape == (V, D))
        spec = opt._kernel_spec()
        want = dict(attn_want, update={spec.kind: 1}, update_norms=0,
                    update_pows=2 if spec.betas else 0, update_unscale=0,
                    update_rows=1)
        opt.step()
        opt.clear_grad()
        sync(torch, dev)
        launched = counts()
        unique_rows = None
        # the kernel against its plain version on the second step's
        # merged gradient and state (launches made here are not counted)
        paddle.seed(5)
        loss = F.cross_entropy(net(ids), labels)
        loss.backward()
        del loss
        merged = SelectedRows.of(wte.grad).merged()
        unique_rows = int(merged._rows.numel())
        spec, (k_rec, p_rec) = _rows_records(torch, mtu, opt, wte, merged,
                                             "wte.weight")
        base = {k: v.clone() for k, v in _record_state(spec, k_rec).items()}
        lr = opt._lr(dev)
        mtu.multi_tensor_update_rows(spec, mtu.RowsTable(spec, [k_rec]), lr,
                                     opt._update)
        mtu.multi_tensor_update_rows_ref(spec, [p_rec], lr, opt._update)
        sync(torch, dev)
        got, wantv = _record_state(spec, k_rec), _record_state(spec, p_rec)
        ok, bad, _, rows = update_verdict(torch, got, wantv, base)
        err = max(r["err"] for r in rows.values())
        kept = all(torch.equal(got[k][untouched], base[k][untouched])
                   for k in got if got[k].dim() > 0)
        errs.append(err)
        del merged, k_rec, p_rec, got, wantv, base
        net.clear_gradients()
        l1, s1 = loop(kind, True)
        l2, s2 = loop(kind, True)
        repeats = bool(torch.equal(l1, l2)) and all(
            torch.equal(v, s2[k]) for k, v in s1.items())
        del s2
        still = torch.equal(s1["param wte.weight"][untouched],
                            state0["wte.weight"][untouched])
        row = dict(launches=launched, expected=want, selected_rows=sparse_ok,
                   unique_rows=unique_rows, kernel_vs_plain_ok=ok,
                   kernel_vs_plain_bad=bad, max_abs_err=err,
                   kernel_kept_untouched=kept, deterministic=repeats,
                   losses=l1.tolist(), untouched_rows_unmoved=still)
        if kind == "sgd":
            l_d, s_d = loop(kind, False)
            row["sgd_vs_dense_rel_l2"] = _state_rel_l2(torch, s1, s_d)
            row["sgd_vs_dense_loss_rel"] = (
                (l1 - l_d).abs().max() / l_d.abs().max()).item()
            del s_d
        if kind == "adam":
            runs["adam"] = (l1, s1)
        else:
            del s1
        log(f"  21a {kind}: launches {launched} (expected {want}); grad a "
            f"SelectedRows of values {tuple(g.values.shape)}, dense shape "
            f"{g.dense_shape}, no dense (V, D) gradient: {sparse_ok}; "
            f"{unique_rows} unique rows; kernel vs plain {ok} (max abs err "
            f"{err:.3e}{', bad ' + str(bad) if bad else ''}), untouched rows "
            f"kept by the kernel {kept}; two {SPARSE_STEPS}-step runs bit for "
            f"bit {repeats}, losses {l1.tolist()}; untouched rows unmoved "
            f"{still}" + (f"; sparse vs dense twin rel L2 "
                          f"{row['sgd_vs_dense_rel_l2']:.3e} (loss "
                          f"{row['sgd_vs_dense_loss_rel']:.3e}, limit "
                          f"{SPARSE_REL:g})" if kind == "sgd" else ""))
        if launched != want or not sparse_ok:
            raise AssertionError(f"21a {kind}: launches {launched}, expected "
                                 f"{want}; SelectedRows {sparse_ok}")
        if not (ok and kept and repeats):
            raise AssertionError(f"21a {kind}: kernel vs plain {ok} {bad}, "
                                 f"untouched kept {kept}, bit for bit "
                                 f"{repeats}")
        if kind != "sgd" and not still:
            raise AssertionError(f"21a {kind}: untouched rows moved")
        if kind == "sgd" and max(row["sgd_vs_dense_rel_l2"],
                                 row["sgd_vs_dense_loss_rel"]) > SPARSE_REL:
            raise AssertionError("21a: SGD sparse differs from its dense twin")
        report[kind] = row

    # -- 21b: the global-norm clip on the merged rows ----------------------
    clip = paddle.nn.ClipGradByGlobalNorm(1.0)
    scales = {}
    for sparse in (True, False):
        restore(sparse)
        paddle.seed(4)
        loss = F.cross_entropy(net(ids), labels)
        loss.backward()
        del loss
        pairs = []
        for p in view.parameters():
            if p.grad is not None:
                if p.grad.is_sparse:
                    p.grad = merged_grad(p.grad)
                pairs.append((p, p.grad))
        scales[sparse] = clip._scale(_clippable(pairs)).item()
        del pairs
    restore()
    opt = opts["adam"](grad_clip=clip)
    paddle.seed(4)
    reset()
    clip_losses = [_core_step(paddle, net, opt, ids, labels).item()
                   for _ in range(2)]
    sync(torch, dev)
    clip_counts = counts()
    clip_rel = abs(scales[True] - scales[False]) / abs(scales[False])
    log(f"  21b: ClipGradByGlobalNorm(1.0): scale sparse {scales[True]!r} "
        f"dense {scales[False]!r} (rel {clip_rel:.3e}, limit "
        f"{SPARSE_REL:g}); 2 clipped Adam steps, losses {clip_losses}, "
        f"launches {clip_counts}")
    if clip_rel > SPARSE_REL or not all(np.isfinite(clip_losses)) or \
            clip_counts["update_rows"] != 2:
        raise AssertionError("21b: the clip on the sparse table is wrong")
    report["clip"] = dict(scale_sparse=scales[True], scale_dense=scales[False],
                          rel=clip_rel, losses=clip_losses,
                          launches=clip_counts)

    # -- 21c: Model, captured (dense) and eager (lazy rows) ----------------
    def model_run(sparse, jit):
        restore(sparse)
        opt = opts["adam"]()
        model = paddle.Model(net).prepare(opt, paddle.nn.CrossEntropyLoss(),
                                          jit=jit)
        paddle.seed(2)
        reset()
        losses = [model.train_batch([b_ids], [b_labels])["loss"]
                  for b_ids, b_labels in batches]
        sync(torch, dev)
        launched = counts()
        return (torch.stack(losses), _train_state(view, opt),
                model._steps.compiles,
                _all_captured(model._steps.entries().values()), launched)

    l_js, s_js, cap_s, all_s, n_js = model_run(True, True)
    l_jd, s_jd, cap_d, all_d, _ = model_run(False, True)
    jit_equal = bool(torch.equal(l_js, l_jd)) and all(
        torch.equal(v, s_jd[k]) for k, v in s_js.items())
    del s_js, s_jd
    l_e, s_e, _, _, n_e = model_run(True, False)
    l_a, s_a = runs.pop("adam")
    eager_equal = bool(torch.equal(l_e, l_a)) and all(
        torch.equal(v, s_a[k]) for k, v in s_e.items())
    del s_e, s_a
    log(f"  21c: Model(jit=True) sparse = dense bit for bit: {jit_equal} "
        f"(captures {cap_s} / {cap_d}, captured {all_s} / {all_d}; rows "
        f"launches {n_js['update_rows']}); Model(jit=False) Adam = 21a's "
        f"loop bit for bit: {eager_equal} (rows launches "
        f"{n_e['update_rows']})")
    if not (jit_equal and eager_equal) or cap_s != 1 or not all_s or \
            n_js["update_rows"] != 0 or n_e["update_rows"] != SPARSE_STEPS:
        raise AssertionError("21c: Model on the sparse table is wrong")
    report["model"] = dict(captured_sparse_equals_dense=jit_equal,
                           captures=cap_s, eager_equals_loop=eager_equal,
                           rows_launches_captured=n_js["update_rows"],
                           rows_launches_eager=n_e["update_rows"])

    # -- 21d: step time, sparse against dense, and the pieces --------------
    def timed_run(sparse, steps, seed, warm=1):
        restore(sparse)
        opt = opts["adam"]()
        paddle.seed(seed)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        losses, times, host = [], [], []
        for i in range(steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            h0 = time.perf_counter()
            loss = _core_step(paddle, net, opt, ids, labels)
            host.append((time.perf_counter() - h0) * 1e3)
            b.record()
            b.synchronize()
            losses.append(loss.item())
            if i >= warm:
                times.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
            else 0
        return losses, times, host[warm:], peak, opt

    fall, _, _, peak_fall, opt = timed_run(True, SPARSE_FALL, 6)
    if not fall[-1] < fall[0]:
        raise AssertionError(f"21d: the loss did not fall: {fall}")
    prof = profile_train.profile(
        lambda: _core_step(paddle, net, opt, ids, labels),
        lambda: _reset_attention(fa),
        lambda: dict(fwd=fa.FWD_LAUNCHES, bwd=fa.BWD_LAUNCHES),
        dict(path="phase 21: the sparse table, Adam", batch=B, seq=T), 2)
    set_sparse(False)
    prof_dense = profile_train.profile(
        lambda: _core_step(paddle, net, opt, ids, labels),
        lambda: _reset_attention(fa),
        lambda: dict(fwd=fa.FWD_LAUNCHES, bwd=fa.BWD_LAUNCHES),
        dict(path="phase 21: the table dense, Adam", batch=B, seq=T), 2)
    del opt
    timing = {True: dict(times=[], host=[], peak=0),
              False: dict(times=[], host=[], peak=0)}
    for rnd in range(2):
        for sparse in ((True, False) if rnd == 0 else (False, True)):
            _, times, host, peak, opt = timed_run(sparse, SPARSE_ROUND, 7)
            del opt
            t = timing[sparse]
            t["times"] += times
            t["host"] += host
            t["peak"] = max(t["peak"], peak)
    p50 = {k: pct(v["times"], 50) for k, v in timing.items()}

    # the pieces on one step's gradient: the merge, the rows pass against
    # its plain version and bound, the dense pass on the table, and the
    # library calls (timed here, used nowhere)
    restore()
    opt = opts["adam"]()
    paddle.seed(8)
    _core_step(paddle, net, opt, ids, labels)
    loss = F.cross_entropy(net(ids), labels)
    loss.backward()
    del loss
    raw = wte.grad.detach().clone()
    net.clear_gradients()
    merge_ms = time_ms(torch, lambda: SelectedRows.of(raw).merged(), reps=10)
    merged = SelectedRows.of(raw).merged()
    R = int(merged._rows.numel())
    spec, (k_rec, p_rec) = _rows_records(torch, mtu, opt, wte, merged,
                                         "wte.weight")
    lr = opt._lr(dev)
    table = mtu.RowsTable(spec, [k_rec])

    def rows_fn():
        mtu.multi_tensor_update_rows(spec, table, lr, opt._update)
    slot = opt._state[id(wte)]
    dense_grad = merged.to_dense()._data
    d_rec = mtu.Record(name="wte.weight", param=wte.detach().clone(),
                       grad=dense_grad, master=None,
                       slots=tuple(slot[k].clone() for k in spec.slots),
                       pows=tuple(slot[k].clone() for k in (
                           "beta1_pow", "beta2_pow")),
                       **opt._kernel_record("wte.weight"))
    d_table = mtu.Table(spec, [d_rec])

    def dense_fn():
        mtu.multi_tensor_update(spec, d_table, lr, opt._update)
    ms = time_ms(torch, rows_fn)
    plain_ms = time_ms(torch, lambda: mtu.multi_tensor_update_rows_ref(
        spec, [p_rec], lr, opt._update), reps=5, warmup=1)
    dense_ms = time_ms(torch, dense_fn)
    (rows_dev, _), (dense_dev, _) = graphs_ms(torch, [rows_fn, dense_fn],
                                              rounds=8)
    w_lib = wte.detach().clone().requires_grad_(True)
    w_lib.grad = raw
    sparse_adam = torch.optim.SparseAdam([w_lib], lr=SPARSE_LR["adam"])
    library_ms = time_ms(torch, sparse_adam.step, reps=10)
    w_sgd = wte.detach().clone()
    rows_raw, vals_raw = raw._indices()[0], raw._values()

    def sgd_index_add():
        uniq, inv = torch.unique(rows_raw, return_inverse=True)
        acc = torch.zeros((uniq.numel(), D), dtype=vals_raw.dtype,
                          device=dev).index_add_(0, inv, vals_raw)
        w_sgd.index_add_(0, uniq, acc, alpha=-SPARSE_LR["sgd"])
    sgd_library_ms = time_ms(torch, sgd_index_add, reps=10)
    nbytes = R * D * 28 + R * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_with_merge_ms = (R * D * 28 + B * T * D * 4) / HBM_BYTES_PER_S * 1e3
    dense_bound_ms = V * D * 28 / HBM_BYTES_PER_S * 1e3
    del raw, merged, k_rec, p_rec, table, d_rec, d_table, dense_grad, w_lib
    del sparse_adam, w_sgd, opt
    log(f"  21d: the loss falls over {SPARSE_FALL} Adam steps: "
        f"{fall[0]:.4f} -> {fall[-1]:.4f}; step ms p50 sparse "
        f"{p50[True]:.3f}, dense {p50[False]:.3f} (10 each after 2 "
        f"warm-ups, alternating rounds); host ms p50 sparse "
        f"{pct(timing[True]['host'], 50):.3f}, dense "
        f"{pct(timing[False]['host'], 50):.3f}; peak memory sparse "
        f"{timing[True]['peak'] / 2**30:.3f} GiB, dense "
        f"{timing[False]['peak'] / 2**30:.3f} GiB; idle share sparse "
        f"{prof['idle_share']:.4f} (device busy "
        f"{prof['device_busy_ms_per_step']:.3f} of {prof['wall_ms_p50']:.3f}"
        f" ms), dense {prof_dense['idle_share']:.4f} (busy "
        f"{prof_dense['device_busy_ms_per_step']:.3f} of "
        f"{prof_dense['wall_ms_p50']:.3f}); {R} unique rows a step")
    log(f"  21d: merge {merge_ms:.4f} ms (events, its host read included); "
        f"mt_update_rows {ms:.4f} ms, device {rows_dev:.4f} against its "
        f"bound {bound_ms:.4f} ({R} x {D} x 28 B + rows; with the "
        f"occurrences' read {bound_with_merge_ms:.4f}), plain {plain_ms:.4f};"
        f" the dense mt_update on the table {dense_ms:.4f}, device "
        f"{dense_dev:.4f} (bound {dense_bound_ms:.4f}); SparseAdam.step "
        f"{library_ms:.4f}; SGD index_add_ after unique "
        f"{sgd_library_ms:.4f} ({card_line()})")
    report["timing"] = dict(
        loss_fall=fall, peak_memory_fall=peak_fall,
        step_ms_sparse=timing[True]["times"],
        step_ms_dense=timing[False]["times"], step_ms_p50_sparse=p50[True],
        step_ms_p50_dense=p50[False],
        host_ms_p50_sparse=pct(timing[True]["host"], 50),
        host_ms_p50_dense=pct(timing[False]["host"], 50),
        peak_memory_sparse=timing[True]["peak"],
        peak_memory_dense=timing[False]["peak"],
        idle_share_sparse=prof["idle_share"], profile=prof,
        idle_share_dense=prof_dense["idle_share"], profile_dense=prof_dense,
        unique_rows=R,
        merge_ms=merge_ms, rows_ms=ms, rows_device_ms=rows_dev,
        rows_plain_ms=plain_ms, rows_bound_ms=bound_ms,
        rows_bound_with_merge_ms=bound_with_merge_ms,
        dense_update_ms=dense_ms, dense_update_device_ms=dense_dev,
        dense_update_bound_ms=dense_bound_ms, sparse_adam_ms=library_ms,
        sgd_index_add_ms=sgd_library_ms)
    report["max_abs_err"] = max(errs)
    report["launches"] = sum(report[k]["launches"]["update_rows"]
                             for k in ("sgd", "adam", "adamw"))
    del net, view, state0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  21: {report['seconds']:.1f} s ({card_line()})")
    return report


# -- phase 22: the flagship GPT on the eager core -----------------------------
ENTRY = dict(vocab_size=8192, hidden_size=256, num_layers=4, num_heads=4,
             max_seq_len=256)        # __graft_entry__.py entry()'s model
ENTRY_IDS = (4, 128)                  # and its example ids
ENTRY_BATCH = 8                       # 22b's batch at full width
ENTRY_HOST_REPS = 10
ENTRY_NEW_TOKENS = 16                 # 22c's generate calls


def entry_forward(net):
    """entry()'s forward on the port: the functional state taken once,
    then at each call, under ``autograd.no_grad``, loaded back and the
    model called with a ``Tensor``; returns the torch logits."""
    import paddle_tpu_torch
    from paddle_tpu_torch.core import autograd
    params, buffers = net.functional_state()

    def forward(ids):
        with autograd.no_grad():
            net.load_functional_state(params, buffers)
            out = net(paddle_tpu_torch.Tensor(ids))
        return out._data
    return forward


def _host_and_event_ms(torch, fn, dev, reps=ENTRY_HOST_REPS):
    """(host ms p50, CUDA-event ms p50) of ``fn()``: the call's wall time
    until it returns (its launches queued, not waited for), and the
    events around it (the device's time unless the host is slower)."""
    host = []
    for _ in range(reps):
        sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    sync(torch, dev)
    return pct(host, 50), time_ms(torch, fn, reps=reps)


def entry_path(torch, fa, dev, width=GPT_WIDTH, entry_cfg=ENTRY,
               batch=ENTRY_BATCH):
    """Phase 22: the GPT as an ``nn.Layer`` written on Tensors.  22a:
    ``__graft_entry__.entry()`` written against the port:
    ``set_device``, ``seed(0)``, ``GPT(GPTConfig(**ENTRY))`` on the card,
    ``eval()``, then :func:`entry_forward` on entry()'s ids (seed 0,
    ENTRY_IDS), through the kernel (one row-1 launch a layer), held
    against the same weights run on the CPU (the plain versions) within
    SCORING_ATOL.  22b: the full-width GPT (``width``, fp32) on (batch,
    max_seq_len) ids, called with a ``Tensor`` and with a torch tensor
    under ``no_grad``: the logits equal bit for bit, one row-1 launch a
    layer each; host ms and CUDA-event ms of each call, and the ops one
    call dispatches (the tracer's ``dispatch.count``).  22c:
    ``generate`` twice on the same model and batch bucket: the second
    call makes no step (no capture), hits the executable cache of the one
    session kept on the model, and gives the same greedy tokens."""
    import numpy as np
    import paddle_tpu_torch
    from paddle_tpu_torch.core import place as pplace
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.profiler import metrics, tracer
    t_phase = time.perf_counter()
    out = {}
    log("== phase 22a: entry() on the card against the CPU")
    was = pplace._place
    paddle_tpu_torch.set_device(dev)
    try:
        paddle_tpu_torch.seed(0)
        net = GPT(GPTConfig(**entry_cfg))
        net.eval()
        ids = np.random.RandomState(0).randint(
            0, entry_cfg["vocab_size"], ENTRY_IDS).astype(np.int32)
        forward = entry_forward(net)
        forward(ids)                                  # warm-up
        sync(torch, dev)
        fa.FWD_LAUNCHES = 0
        logits = forward(ids)
        sync(torch, dev)
        launches = fa.FWD_LAUNCHES
    finally:
        pplace._place = was
    plain = GPT(GPTConfig(**entry_cfg), device="cpu")
    plain.set_state_dict(net.state_dict())
    plain.eval()
    with pplace.place_guard("cpu"):
        want = entry_forward(plain)(ids)
    err = (logits.cpu() - want).abs().max().item()
    finite = bool(torch.isfinite(logits).all().item())
    shape = tuple(logits.shape)
    out["entry"] = dict(config=entry_cfg, ids=list(ENTRY_IDS), shape=shape,
                        launches=launches, max_abs_err=err,
                        atol=SCORING_ATOL, finite=finite,
                        max_abs_logit=want.abs().max().item(),
                        device=str(logits.device))
    log(f"  entry() forward on {logits.device}: logits {shape} "
        f"finite={finite}, row-1 launches {launches} (expected "
        f"{entry_cfg['num_layers']}), max |card - CPU plain| {err:.3e} "
        f"(atol {SCORING_ATOL:.0e}, max |logit| "
        f"{out['entry']['max_abs_logit']:.3f})")
    if shape != ENTRY_IDS + (entry_cfg["vocab_size"],) or not finite:
        raise AssertionError("entry() logits have the wrong shape or are "
                             "not finite")
    if logits.device.type != torch.device(dev).type:
        raise AssertionError(f"entry() ran on {logits.device}, not {dev}")
    if launches != entry_cfg["num_layers"]:
        raise AssertionError(f"entry() launched the kernel {launches} "
                             f"times, expected {entry_cfg['num_layers']}")
    if err > SCORING_ATOL:
        raise AssertionError(f"entry() on the card differs from the CPU by "
                             f"{err} > {SCORING_ATOL}")
    del net, plain, forward, logits, want

    log(f"== phase 22b: the full-width Layer GPT, B {batch}, a Tensor and "
        "a torch tensor")
    big = GPT(GPTConfig(**width), device=dev, seed=0)
    big.eval()
    V, T, L = width["vocab_size"], width["max_seq_len"], width["num_layers"]
    gen = torch.Generator(device=dev).manual_seed(2)
    ids_t = torch.randint(0, V, (batch, T), generator=gen, device=dev)
    ids_p = paddle_tpu_torch.Tensor(ids_t)
    n_params = sum(p.numel() for p in torch_view(big).parameters())

    def call_tensor():
        with torch.no_grad():
            return big(ids_p)._data

    def call_torch():
        with torch.no_grad():
            return big(ids_t)

    calls = {}
    for name, fn in (("tensor", call_tensor), ("torch", call_torch)):
        fn()                                          # warm-up
        sync(torch, dev)
        fa.FWD_LAUNCHES = 0
        got = fn()
        sync(torch, dev)
        calls[name] = dict(logits=got, launches=fa.FWD_LAUNCHES)
    same = torch.equal(calls["tensor"]["logits"], calls["torch"]["logits"])
    finite = bool(torch.isfinite(calls["torch"]["logits"]).all().item())
    del calls["tensor"]["logits"], calls["torch"]["logits"]
    for name, fn in (("tensor", call_tensor), ("torch", call_torch)):
        host_ms, event_ms = _host_and_event_ms(torch, fn, dev)
        calls[name].update(host_ms=host_ms, event_ms=event_ms)
    c0 = metrics.get("dispatch.count")
    c0 = c0.value if c0 is not None else 0
    tracer.enable()
    tracer.clear()
    try:
        call_torch()
        sync(torch, dev)
        ops = {op: row["calls"] for op, row in tracer.op_table().items()}
    finally:
        tracer.disable()
        tracer.clear()
    dispatched = metrics.get("dispatch.count").value - c0
    out["layer_gpt"] = dict(
        width=width, batch=batch, params=n_params, logits_equal=same,
        finite=finite, calls=calls, ops_dispatched=dispatched, ops=ops)
    for name, c in calls.items():
        log(f"  called with a {'Tensor' if name == 'tensor' else 'torch tensor'}"
            f": row-1 launches {c['launches']} "
            f"(expected {L}), host ms p50 {c['host_ms']:.3f}, CUDA-event "
            f"ms p50 {c['event_ms']:.3f}")
    log(f"  logits equal bit for bit: {same}; finite: {finite}; "
        f"{dispatched} ops dispatched a call ({len(ops)} kinds: "
        f"{dict(sorted(ops.items()))}); {n_params:,} parameters")
    if not same or not finite:
        raise AssertionError("the Layer GPT's logits differ between a "
                             "Tensor and a torch tensor, or are not finite")
    if any(c["launches"] != L for c in calls.values()):
        raise AssertionError(f"a full-width call launched "
                             f"{[c['launches'] for c in calls.values()]} "
                             f"row-1 kernels, expected {L} each")
    if dispatched != sum(ops.values()) or dispatched <= 0:
        raise AssertionError(f"dispatch.count {dispatched} against the "
                             f"trace's {sum(ops.values())} op spans")

    log("== phase 22c: generate twice on one batch bucket")
    rs = np.random.RandomState(22)
    prompts = [rs.randint(1, V, n).astype(np.int32) for n in (5, 9, 17)]
    first = big.generate(prompts, max_new_tokens=ENTRY_NEW_TOKENS)
    (key, sess), = big._gen_sessions.items()
    entries = {k: id(e) for k, e in sess._cache.entries().items()}
    before = dict(compiles=sess._cache.compiles, hits=sess._cache.hits,
                  captured=_all_captured(sess._cache.entries().values()))
    second = big.generate(prompts, max_new_tokens=ENTRY_NEW_TOKENS)
    after = dict(compiles=sess._cache.compiles, hits=sess._cache.hits,
                 sessions=len(big._gen_sessions))
    kept = entries == {k: id(e) for k, e in sess._cache.entries().items()}
    streams_equal = all(np.array_equal(a, b) for a, b in zip(first, second))
    out["generate"] = dict(session_key=list(key), first=before,
                           second=after, entries_kept=kept,
                           streams_equal=streams_equal,
                           tokens=[len(a) for a in first])
    log(f"  session {key}: first call {before['compiles']} steps made "
        f"(captured: {before['captured']}), hits {before['hits']}; second "
        f"call {after['compiles']} made, hits {after['hits']}; sessions on "
        f"the model {after['sessions']}; same entries {kept}; same greedy "
        f"tokens {streams_equal}")
    if not (after["compiles"] == before["compiles"] and after["hits"] >
            before["hits"] and after["sessions"] == 1 and kept
            and before["captured"] and streams_equal):
        raise AssertionError(f"the second generate made steps again or "
                             f"left another session: {out['generate']}")
    del big
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 22 in {out['seconds']:.1f} s")
    return out


# Zaremba, Sutskever and Vinyals (2014) §4.1, the large PTB model: 2 LSTM
# layers of 1500 units unrolled 35 steps, batch 20, vocabulary 10000,
# dropout 0.65, gradients clipped at norm 10, SGD at lr 1 (66,034,000
# fp32 parameters); ids synthetic, from seed 23
NUMERIC = dict(vocab=10000, hidden=1500, layers=2, steps=35, batch=20,
               dropout=0.65, clip=10.0, lr=1.0, seed=23)
NUMERIC_STEPS = 3        # 23a / 23b: runs compared bit for bit
NUMERIC_FALL = 12        # 23a: the loss falls over these steps, timed
NUMERIC_TIMED = 4        # 23b: Model steps timed per engine
NUMERIC_BEAM = dict(batch=8, beam=4, max_steps=35, start=0, end=1)
NUMERIC_BEAM_ATOL = 1e-4     # 23c: log-probs, card against the CPU
NUMERIC_TIE = 1e-5           # 23c: a tie that may order beams either way
# 23d: Whisper's log-mel front end (whisper/audio.py): 16 kHz, N_FFT 400,
# HOP_LENGTH 160, 30 s chunks, a periodic Hann window, centred
WHISPER = dict(batch=8, samples=480000, n_fft=400, hop=160)
WHISPER_ATOL = 2e-4          # stft, card against the CPU (rtol the same)
WHISPER_ISTFT = dict(rtol=1e-3, atol=1e-4)   # tests/test_linalg_fft_signal:145


def ptb_lm(paddle, cfg):
    """The language model of :data:`NUMERIC` as a paddle user writes it:
    ``nn.Embedding``, ``nn.Dropout``, a 2-layer ``nn.LSTM`` (dropout
    between its layers), ``nn.Dropout``, ``nn.Linear`` to the vocabulary."""
    nn = paddle.nn

    class PTBLM(nn.Layer):
        def __init__(self):
            super().__init__()
            V, Hd, p = cfg["vocab"], cfg["hidden"], cfg["dropout"]
            self.embedding = nn.Embedding(V, Hd)
            self.drop_in = nn.Dropout(p)
            self.lstm = nn.LSTM(Hd, Hd, num_layers=cfg["layers"], dropout=p)
            self.drop_out = nn.Dropout(p)
            self.head = nn.Linear(Hd, V)

        def forward(self, ids):
            out, _ = self.lstm(self.drop_in(self.embedding(ids)))
            return self.head(self.drop_out(out))
    return PTBLM()


def _lm_dropout(net, p):
    net.drop_in.p = net.drop_out.p = net.lstm.dropout = p


def _beam_totals(torch, dec, inputs, states, log_probs, finished, k):
    """The ``k + 1`` best totals of each batch row at one beam step,
    recomputed from the step's inputs as ``BeamSearchDecoder.step`` forms
    them."""
    out, _ = dec.cell(dec.embedding_fn(inputs), states)
    lp = torch.log_softmax(dec.output_fn(out)._data.detach(), -1)
    fin = torch.full((lp.shape[-1],), -1e9, device=lp.device)
    fin[dec.end_token] = 0.0
    lp = torch.where(finished[:, None], fin[None, :], lp)
    total = (log_probs[:, None] + lp).reshape(-1, dec.beam_size *
                                               lp.shape[-1])
    return torch.topk(total, k + 1, dim=-1).values


def _beam_decode(torch, paddle, net, cfg, place):
    """23c's decode on ``place``: ``nn.BeamSearchDecoder`` over the LSTM's
    first-layer cell with the embedding and the projection, under
    ``nn.dynamic_decode``; returns (ids, log-probs, each step's inputs and
    outputs, seconds)."""
    import numpy as np
    paddle.set_device(place)
    cell = net.lstm.rnns[0].cell
    dec = paddle.nn.BeamSearchDecoder(
        cell, start_token=cfg["start"], end_token=cfg["end"],
        beam_size=cfg["beam"], embedding_fn=net.embedding,
        output_fn=net.head)
    steps = []
    plain_step = dec.step

    def step(inputs, states, log_probs, finished):
        got = plain_step(inputs, states, log_probs, finished)
        steps.append(dict(given=(inputs, states, log_probs, finished),
                          tokens=got[0]._data, parents=got[1]))
        return got
    dec.step = step
    zeros = paddle.to_tensor(np.zeros((cfg["batch"], cell.hidden_size),
                                      np.float32))
    with paddle.no_grad():
        inits = cell.get_initial_states(zeros)
        if place != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, lp = paddle.nn.dynamic_decode(dec, inits,
                                           max_step_num=cfg["max_steps"])
        if place != "cpu":
            torch.cuda.synchronize()
    return ids, lp, steps, time.perf_counter() - t0, dec


def numeric_path(torch, dev, cfg=NUMERIC, beam_cfg=NUMERIC_BEAM,
                 audio=WHISPER):
    """Phase 23 (the module docstring) on ``dev``; returns the report."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.profiler import metrics, tracer
    from paddle_tpu_torch.tools import profile_train
    t_phase = time.perf_counter()
    dev = torch.device(dev)
    place = f"gpu:{dev.index or 0}" if dev.type == "cuda" else "cpu"
    paddle.set_device(place)
    V, B, T = cfg["vocab"], cfg["batch"], cfg["steps"]
    paddle.seed(cfg["seed"])
    net = ptb_lm(paddle, cfg)
    view = torch_view(net)
    n_params = sum(p.numel() for p in view.parameters())
    state0 = {k: v.detach().clone() for k, v in view.state_dict().items()}
    rs = np.random.RandomState(cfg["seed"])
    ids_np = rs.randint(0, V, (B, T + 1))
    ids = paddle.to_tensor(ids_np[:, :T])
    labels = paddle.to_tensor(ids_np[:, 1:].reshape(B, T, 1))
    batches = [(paddle.roll(ids, i, 0), paddle.roll(labels, i, 0))
               for i in range(NUMERIC_STEPS)]

    def sgd():
        return paddle.optimizer.SGD(
            learning_rate=cfg["lr"], parameters=net.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(cfg["clip"]))

    def restore():
        net.set_state_dict(state0)
        net.clear_gradients()

    out = dict(config=cfg, params=n_params)
    log(f"  23a: the PTB-large LSTM LM ({n_params:,} parameters), the "
        "dygraph loop in fp32, dropout 0 against the CPU")
    _lm_dropout(net, 0.0)
    restore()
    opt = sgd()
    sync(torch, dev)
    _reset_update()
    loss = paddle.nn.functional.cross_entropy(net(ids), labels)
    loss.backward()
    loss_card = loss.item()
    del loss
    grads_card = {k: g.cpu() for k, g in _core_grads(view).items()}
    want = _update_want(opt, list(view.parameters()))
    opt.step()
    opt.clear_grad()
    sync(torch, dev)
    launched = _update_launches()
    paddle.set_device("cpu")
    cpu_net = ptb_lm(paddle, cfg)
    _lm_dropout(cpu_net, 0.0)
    cpu_net.set_state_dict(state0)
    loss = paddle.nn.functional.cross_entropy(
        cpu_net(paddle.to_tensor(ids_np[:, :T])),
        paddle.to_tensor(ids_np[:, 1:].reshape(B, T, 1)))
    loss.backward()
    loss_cpu = loss.item()
    del loss
    grads_cpu = _core_grads(torch_view(cpu_net))
    paddle.set_device(place)
    rels, whole, finite = _core_compare(torch, grads_card, grads_cpu)
    worst = max(rels, key=rels.get)
    d_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)
    del grads_card, grads_cpu
    cpu_net.clear_gradients()
    log(f"  23a: card loss {loss_card:.6f}, CPU {loss_cpu:.6f} (rel diff "
        f"{d_loss:.3e}, limit {EAGER_LOSS_RTOL:g}); gradient rel L2 of "
        f"each of {len(rels)} parameters at most {rels[worst]:.3e} "
        f"({worst}; limit {EAGER_GRAD_RTOL:g}), all together {whole:.3e}, "
        f"finite {finite}; update launches {launched} (expected {want})")
    if launched != want:
        raise AssertionError(f"the LSTM step launched {launched}; "
                             f"expected {want}")
    if not (finite and np.isfinite(loss_card) and d_loss <= EAGER_LOSS_RTOL
            and rels[worst] <= EAGER_GRAD_RTOL):
        raise AssertionError("the LSTM step on the card disagrees with the "
                             "CPU")
    out.update(launches=launched, expected=want, loss_card=loss_card,
               loss_cpu=loss_cpu, loss_rel_diff=d_loss,
               grad_rel_l2_max=rels[worst], grad_rel_l2_whole=whole)

    _lm_dropout(net, cfg["dropout"])

    def loop(steps_batches, seed):
        restore()
        opt = sgd()
        paddle.seed(seed)
        losses = [_core_step(paddle, net, opt, b_ids, b_labels)._data
                  for b_ids, b_labels in steps_batches]
        return torch.stack(losses), _train_state(view, opt)

    l1, s1 = loop(batches, 2)
    l2, s2 = loop(batches, 2)
    repeats = bool(torch.equal(l1, l2)) and all(
        torch.equal(v, s2[k]) for k, v in s1.items())
    del s2
    log(f"  23a: two {NUMERIC_STEPS}-step runs at dropout {cfg['dropout']}:"
        f" losses {l1.tolist()}, bit for bit {repeats}")
    if not repeats:
        raise AssertionError("two LSTM runs from one seed differ")

    restore()
    opt = sgd()
    paddle.seed(3)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times, host = [], [], []
    for i in range(NUMERIC_FALL):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        h0 = time.perf_counter()
        loss = _core_step(paddle, net, opt, ids, labels)
        host.append((time.perf_counter() - h0) * 1e3)
        b.record()
        b.synchronize()
        losses.append(loss.item())
        if i >= TRAIN_WARMUP:
            times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the LSTM loss did not fall: {losses}")
    c0 = metrics.get("dispatch.count")
    c0 = c0.value if c0 is not None else 0
    tracer.enable()
    tracer.clear()
    try:
        _core_step(paddle, net, opt, ids, labels)
        sync(torch, dev)
        ops = {k: r["calls"] for k, r in tracer.op_table().items()}
    finally:
        tracer.disable()
        tracer.clear()
    dispatched = metrics.get("dispatch.count").value - c0
    prof = profile_train.profile(
        lambda: _core_step(paddle, net, opt, ids, labels), _reset_update,
        lambda: dict(update=sum(_update_launches()["update"].values())),
        dict(path="numeric: the PTB-large LSTM loop", batch=B, seq=T), 2)
    log(f"  23a: step ms p50 {pct(times, 50):.3f} (min {min(times):.3f}, "
        f"{len(times)} steps after {TRAIN_WARMUP} warm-ups, CUDA events); "
        f"host ms p50 {pct(host, 50):.3f}; device busy "
        f"{prof['device_busy_ms_per_step']:.3f} ms of "
        f"{prof['wall_ms_p50']:.3f}, idle share {prof['idle_share']:.4f}; "
        f"{dispatched} ops dispatched a step ({len(ops)} kinds); peak "
        f"memory {peak / 2**30:.3f} GiB; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    out.update(deterministic=repeats, losses=losses, step_ms=times,
               step_ms_p50=pct(times, 50), host_ms=host,
               host_ms_p50=pct(host, 50), peak_memory_bytes=peak,
               ops_dispatched_per_step=dispatched, ops=ops,
               idle_share=prof["idle_share"],
               device_ms_per_step=prof["device_busy_ms_per_step"],
               profile=prof)

    log("  23b: the same Layer through Model (SGD, nn.CrossEntropyLoss, "
        "the clip)")

    def model_run(jit):
        restore()
        opt = sgd()
        model = paddle.Model(net).prepare(
            opt, paddle.nn.CrossEntropyLoss(), jit=jit)
        paddle.seed(2)
        got, replay = [], {}
        for i, (b_ids, b_labels) in enumerate(batches):
            if jit and i == 1:
                sync(torch, dev)
                _reset_update()
            got.append(model.train_batch([b_ids], [b_labels])["loss"])
            if jit and i == 1:
                sync(torch, dev)
                replay = _update_launches()
        state = _train_state(view, opt)
        captured = _all_captured(model._steps.entries().values())
        t = []
        for _ in range(NUMERIC_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model.train_batch([ids], [labels])
            b.record()
            b.synchronize()
            t.append(a.elapsed_time(b))
        return (torch.stack(got), state, captured, model._steps.compiles,
                replay, t)

    l_e, s_e, cap_e, _, _, t_e = model_run(False)
    eager_equal = bool(torch.equal(l_e, l1)) and all(
        torch.equal(v, s_e[k]) for k, v in s1.items())
    del s1
    l_j, s_j, cap_j, captures, replay, t_j = model_run(True)
    exact = bool(torch.equal(l_j, l_e)) and all(
        torch.equal(v, s_j[k]) for k, v in s_e.items())
    del s_e, s_j
    log(f"  23b: jit=False = 23a's loop bit for bit: {eager_equal}; "
        f"jit=True = jit=False bit for bit: {exact}; captured {cap_j} "
        f"(jit=False {cap_e}), captures {captures}; a replay's update "
        f"launches {replay} (expected {want}); step ms p50 captured "
        f"{pct(t_j, 50):.3f}, uncaptured {pct(t_e, 50):.3f}")
    if not (eager_equal and exact):
        raise AssertionError("Model on the LSTM differs from the loop, or "
                             "captured from uncaptured")
    if cap_e or not cap_j or captures != 1 or replay != want:
        raise AssertionError(f"jit=True captured {captures} times, or a "
                             f"replay launched {replay}")
    out["model"] = dict(uncaptured_equals_loop=eager_equal,
                        captured_equals_uncaptured=exact, captures=captures,
                        replay_launches=replay, step_ms_captured=t_j,
                        step_ms_uncaptured=t_e,
                        step_ms_p50_captured=pct(t_j, 50),
                        step_ms_p50_uncaptured=pct(t_e, 50))

    log(f"  23c: beam search (beam {beam_cfg['beam']}, B "
        f"{beam_cfg['batch']}, up to {beam_cfg['max_steps']} steps) on 23a's"
        " weights, card against the CPU")
    cpu_net.set_state_dict(view.state_dict())
    ids_c, lp_c, steps_c, secs, dec_c = _beam_decode(
        torch, paddle, net, beam_cfg, place)
    ids_h, lp_h, steps_h, _, dec_h = _beam_decode(
        torch, paddle, cpu_net, beam_cfg, "cpu")
    paddle.set_device(place)
    same_ids = ids_c.shape == ids_h.shape and bool(
        (ids_c._data.cpu() == ids_h._data).all())
    lp_err = (lp_c._data.cpu() - lp_h._data).abs().max().item()
    beam = dict(shape=list(ids_c.shape), steps=len(steps_c),
                ids_equal=same_ids, log_prob_max_abs_err=lp_err,
                ms_per_step=secs * 1e3 / len(steps_c))
    if not same_ids:
        first = next((i for i, (a, b) in enumerate(zip(steps_c, steps_h))
                      if not (torch.equal(a["tokens"].cpu(), b["tokens"])
                              and torch.equal(a["parents"].cpu(),
                                              b["parents"]))), None)
        if first is None:
            raise AssertionError(f"the card's beam search ran "
                                 f"{len(steps_c)} steps, the CPU's "
                                 f"{len(steps_h)}, every common step equal")
        k = beam_cfg["beam"]
        with paddle.no_grad():
            tops = [_beam_totals(torch, d, *s[first]["given"], k).cpu()
                    for d, s in ((dec_c, steps_c), (dec_h, steps_h))]
        rows = [r for r in range(tops[0].shape[0])
                if not torch.equal(steps_c[first]["tokens"].cpu().reshape(
                    -1, k)[r], steps_h[first]["tokens"].reshape(-1, k)[r])]
        gaps = [min(float((t[r, :-1] - t[r, 1:]).min()) for t in tops)
                for r in rows]
        beam.update(first_differing_step=first, rows=rows, tie_gaps=gaps)
        log(f"  23c: ids differ from step {first} in rows {rows}; the "
            f"closest of the {k + 1} best totals there lie {gaps} apart "
            f"(a tie within {NUMERIC_TIE:g} may order the beams either way)")
        if max(gaps) > NUMERIC_TIE:
            raise AssertionError("the card's beam search differs from the "
                                 "CPU's where no tie explains it")
    elif lp_err > NUMERIC_BEAM_ATOL:
        raise AssertionError(f"the beams' log-probs differ by {lp_err} > "
                             f"{NUMERIC_BEAM_ATOL}")
    log(f"  23c: ids {beam['shape']} equal to the CPU's: {same_ids}; "
        f"log-probs max |card - CPU| {lp_err:.3e} (limit "
        f"{NUMERIC_BEAM_ATOL:g}); {len(steps_c)} steps, "
        f"{beam['ms_per_step']:.3f} ms a step")
    out["beam"] = beam
    del cpu_net, steps_c, steps_h, dec_c, dec_h

    log(f"  23d: stft / istft at Whisper's front end (B {audio['batch']} x "
        f"{audio['samples']} samples, n_fft {audio['n_fft']}, hop "
        f"{audio['hop']}, periodic Hann, centred)")
    n_fft, hop = audio["n_fft"], audio["hop"]
    wave = np.random.RandomState(cfg["seed"]).uniform(
        -1, 1, (audio["batch"], audio["samples"])).astype(np.float32)
    hann = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
            ).astype(np.float32)
    x, w = paddle.to_tensor(wave), paddle.to_tensor(hann)

    def stft():
        return paddle.signal.stft(x, n_fft, hop, window=w)
    spec = stft()
    paddle.set_device("cpu")
    spec_cpu = paddle.signal.stft(paddle.to_tensor(wave), n_fft, hop,
                                  window=paddle.to_tensor(hann))
    paddle.set_device(place)
    stft_err = (spec._data.cpu() - spec_cpu._data).abs().max().item()
    stft_ok = bool(torch.allclose(spec._data.cpu(), spec_cpu._data,
                                  rtol=WHISPER_ATOL, atol=WHISPER_ATOL))

    def istft():
        return paddle.signal.istft(spec, n_fft, hop, window=w,
                                   length=audio["samples"])
    back = istft()
    istft_err = (back._data.cpu() - torch.from_numpy(wave)).abs().max().item()
    istft_ok = bool(torch.allclose(back._data.cpu(), torch.from_numpy(wave),
                                   **WHISPER_ISTFT))
    stft_ms, istft_ms = time_ms(torch, stft, reps=5), \
        time_ms(torch, istft, reps=5)
    out["signal"] = dict(shape=list(spec.shape), dtype=str(spec.dtype),
                         stft_max_abs_err=stft_err,
                         istft_max_abs_err=istft_err,
                         stft_ms=stft_ms, istft_ms=istft_ms)
    log(f"  23d: stft {list(spec.shape)} {spec.dtype}: max |card - CPU| "
        f"{stft_err:.3e} (rtol = atol = {WHISPER_ATOL:g}: {stft_ok}), "
        f"{stft_ms:.3f} ms; istft gives the input back within "
        f"{istft_err:.3e} ({WHISPER_ISTFT}: {istft_ok}), {istft_ms:.3f} ms")
    if not (stft_ok and istft_ok):
        raise AssertionError("stft or istft at Whisper's size is off")
    del spec, spec_cpu, back, net, view, state0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 23 in {out['seconds']:.1f} s ({card_line()})")
    return out


def run(torch, dev, width, train_cfg=TRAIN, long_cfg=TRAIN_LONG,
        eager_cfg=EAGER, eager_long=EAGER_LONG, encoder_cfg=None,
        encoder_batch=ENCODER_BATCH, fp32_cfg=TRAIN_FP32, dryrun_cfg=DRYRUN,
        fit_cfg=FIT, optimizer_cfgs=OPTIMIZERS, update_named=None,
        unscale_named=None, skip_named=None, train_fp16_cfg=TRAIN_FP16,
        long_fp16_cfg=TRAIN_LONG_FP16, fit_hooks_cfg=FIT_HOOKS,
        profile_cfg=PROFILE_FIT, eager_core_cfg=EAGER_CORE,
        numeric_cfg=NUMERIC, numeric_beam=NUMERIC_BEAM, numeric_audio=WHISPER):
    """Phases 3-23 on ``dev`` with a serving GPT of ``width``, the two
    train configs, the eager train configs, the encoder, the fit config
    and the optimizers of phase 13a (and of phase 6's update timing);
    ``update_named``, ``unscale_named`` and ``skip_named`` the (name,
    shape) pairs of phase 3's update, unscale and skip-flag checks
    (defaults: the GPT's parameters and UPDATE_EXTRA, see each check);
    ``train_fp16_cfg`` and ``long_fp16_cfg`` the fp16 configs of phases 7
    and 8 (phase 7's remat policies run ``train_cfg``), ``fit_hooks_cfg``
    phase 16's, ``profile_cfg`` phase 19's, ``eager_core_cfg`` phases 20
    and 21's, ``numeric_cfg``, ``numeric_beam`` and ``numeric_audio``
    phase 23's;
    returns the report and the ``kernels`` entries."""
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
    torch.cuda.empty_cache()
    log("== phase 17: the paged serving engine at full width (fp32, 8 slots,"
        f" block {PAGED_BLOCK})")
    paged = paged_path(torch, fa, dev, width, serve)
    torch.cuda.empty_cache()
    log("== phase 18: HTTP serving at full width (fp32, 8 slots, "
        "ServingServer on 127.0.0.1)")
    http = http_path(torch, fa, dev, width, serve)
    log("== phase 19: the profiler's windows, device traces and memory "
        "accounting on phase 12's O1 GPT")
    profiled = profiler_path(torch, fa, dev, profile_cfg, tuple(
        fit_o1[k]["step_ms_p50"] for k in ("main", "nometric")))
    torch.cuda.empty_cache()
    log("== phase 20: the eager core: the reference's nn.TransformerEncoder "
        "at full width, trained eagerly")
    core = eager_core_path(torch, fa, dev, eager_core_cfg)
    torch.cuda.empty_cache()
    log("== phase 21: the sparse embedding and its rows-only update on "
        "phase 20's encoder")
    sparse = sparse_embedding_path(torch, fa, dev, eager_core_cfg)
    torch.cuda.empty_cache()
    log("== phase 22: the flagship GPT on the eager core: entry(), the "
        "Layer GPT at full width, generate's session")
    layer_gpt = entry_path(torch, fa, dev, width)
    torch.cuda.empty_cache()
    log("== phase 23: the numeric namespaces: the PTB-large LSTM language "
        "model trained eagerly and through Model, beam search, stft")
    numeric = numeric_path(torch, dev, numeric_cfg, numeric_beam,
                           numeric_audio)
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
        launches_paged_serving=paged["parity"]["launches"],
        launches_http_serving=http["parity"]["launches"],
        max_abs_err=max(c["max_abs_err"] for c in checks
                        if c["dtype"] == "float32"),
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"],
        library_kernels=main_shape["library_kernels"],
        timed_shape="bh 96, T 512, d 64, fp32, causal",
        launches_scoring=score["launches"], checks=len(checks),
        launches_eager_forward=eager["launches"]["fwd"],
        launches_eager_core=core["launches"]["fwd"],
        launches_entry_forward=layer_gpt["entry"]["launches"],
        launches_layer_gpt_forward=layer_gpt["layer_gpt"]["calls"][
            "tensor"]["launches"],
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
             launches_fit_step=fit_fp32["launches_per_step"]["bwd"],
             launches_eager_core=core["launches"]["bwd"]),
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
        launches_eager_core=sum(core["launches"]["update"].values()),
        launches_numeric_path=sum(numeric["launches"]["update"].values()),
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
    st = sparse["timing"]
    kernels.append(dict(
        name="mt_update_rows", route="cuda",
        source="paddle_tpu_torch/csrc/multi_tensor_update.cu",
        replaces="paddle_tpu/optimizer/optimizers.py:455", tpu_kernel=None,
        note="the row-sparse update (_update_sparse: SGD :350, Adam :455, "
             "AdamW :499) is XLA scatters in the reference, no Pallas "
             "kernel",
        launches=sparse["launches"], launches_per_step=1,
        max_abs_err=sparse["max_abs_err"], ms=st["rows_ms"],
        plain_ms=st["rows_plain_ms"], bound_ms=st["rows_bound_ms"],
        bound_by="bytes", library_ms=st["sparse_adam_ms"],
        library="torch.optim.SparseAdam.step (its own coalesce included)",
        device_ms=st["rows_device_ms"],
        share_of_bound=st["rows_bound_ms"] / st["rows_device_ms"],
        bound_with_merge_input_ms=st["rows_bound_with_merge_ms"],
        merge_ms=st["merge_ms"], sgd_index_add_ms=st["sgd_index_add_ms"],
        dense_update_ms=st["dense_update_ms"],
        dense_update_device_ms=st["dense_update_device_ms"],
        timed_shape=f"Adam on wte (30528 x 768, fp32), {st['unique_rows']} "
                    f"unique rows of {sparse['occurrences']} ids"))
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
                  remat_offload=ro, fit_hooks=hooks, paged=paged, http=http,
                  profiler=profiled, eager_core=core,
                  sparse_embedding=sparse, entry_path=layer_gpt,
                  numeric_path=numeric,
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
