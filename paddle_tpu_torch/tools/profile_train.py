"""Where a train step's time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_train [--eager | --encoder]
                                                    [--amp O1|O2]
                                                    [--uncaptured]
                                                    [--steps 5] [--json PATH]

Without a path option it builds the flagship compiled train step (V 30528,
D 768, L 12, H 12, T 512, B 128, bf16 compute over fp32 masters, remat
``"ctx"``) from ``init_fn(0)`` with ids and labels from
``np.random.RandomState(0)``.  With ``--eager`` it builds the eager train
path at the same width: ``Model(GPT).prepare(AdamW(1e-3,
weight_decay=0.01), CrossEntropyLoss()).train_batch`` at B 32, T 512,
fp32, on ids from ``np.random.RandomState(0)`` and labels rolled by one.
With ``--encoder`` it trains the same way the encoder of
:func:`build_encoder` at :data:`ENCODER` (``chip_smoke.py`` phase 11
builds the same model).  ``--amp`` (with ``--eager`` or ``--encoder``)
prepares the model with ``amp_configs`` at that level in bf16.  Those
two paths run ``prepare(jit=True)``'s step, captured in a CUDA graph and
replayed, unless ``--uncaptured`` asks for ``jit=False``.  Either
way it takes two warm-up steps, then
``--steps`` steps unprofiled
(host wall per step, ending in a synchronise) and ``--steps`` steps under
``torch.profiler`` (CPU and CUDA activities).  Reports the device time
per step (the sum of the kernels' and copies' durations on the card),
the device's idle share of an unprofiled step (1 - device time /
unprofiled wall), device ops and the port's kernel launches per step, the
device time by kind of op, and the top ops by device time.  With
``--json PATH`` it also writes the summary to PATH.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ..hapi import Model
from ..incubate.nn import FusedTransformerEncoderLayer
from ..models import GPT, GPTConfig
from ..models.gpt_spmd import build_spmd_train_step
from ..nn import CrossEntropyLoss
from ..ops import flash_attention as fa
from ..ops import flash_attention_qkv as fq
from ..ops import fused_ln as fl
from ..ops import softmax_xent as sx
from ..device import resolve_device
from ..optimizer import AdamW
from ..random import default_generator, seed

WIDTH = dict(vocab_size=30528, hidden_size=768, num_layers=12,
             num_heads=12, max_seq_len=512)
BATCH, SEQ = 128, 512
EAGER_BATCH = 32
# the fused post-LN encoder: BERT-base (bert-base-uncased: L 12, hidden
# 768, 12 heads, intermediate 3072, hidden dropout 0.1, GELU, post-LN) at
# the flagship vocabulary
ENCODER = dict(vocab_size=30528, d_model=768, num_layers=12, nhead=12,
               dim_feedforward=3072, max_len=SEQ, dropout_rate=0.1)

# device-op name fragments by kind, first match wins
KINDS = (("flash attention forward (rows 1-3)", ("flash_fwd_kernel",
                                                  "::fwd_kernel<")),
         ("flash attention backward (rows 4-9)",
          ("attn_dkv_kernel", "attn_dq_kernel", "attn_delta_kernel",
           "::dkv_kernel<", "::dq_kernel<", "::delta_kernel<")),
         ("softmax_xent_fwd (row 10)", ("sxent_fwd_kernel",)),
         ("softmax_xent_dlogits (row 11)", ("sxent_dlogits_kernel",)),
         ("fused_ln (row 12)", ("fused_ln_warp", "fused_ln_row")),
         ("fused_ln_bwd (the epilogue's backward)",
          ("ln_bwd_warp", "ln_bwd_row", "ln_bwd_fold")),
         ("matrix products (cuBLAS)", ("gemm", "Gemm", "cutlass", "sm90_",
                                       "xmma", "nvjet")),
         ("copies and casts", ("copy", "Copy", "Memcpy", "Memset")),
         ("reductions", ("reduce", "Reduce")))


def _kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other elementwise"


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms_per_call(fn, reps: int = 10, warmup: int = 3) -> float:
    """Device time of one ``fn()``: every kernel it launches, summed from
    a ``torch.profiler`` trace of ``reps`` calls (host time between the
    launches is not counted, unlike CUDA events around a call)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device time")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps


def _compiled_path():
    """The compiled train step: (one step, counter reset, counts, setup)."""
    cfg = GPTConfig(**WIDTH)
    step, init_fn = build_spmd_train_step(
        cfg, compute_dtype=torch.bfloat16, remat_policy="ctx")
    state = list(init_fn(0))
    rng = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (BATCH, SEQ))).cuda()
                   for _ in range(2))

    def one():
        _, state[0], state[1] = step(state[0], state[1], ids, labels)

    def reset():
        fq.FWD_LAUNCHES = fq.BWD_LAUNCHES = sx.LAUNCHES = 0
        sx.DLOGITS_LAUNCHES = 0
        fa.SM90_FWD_LAUNCHES = fa.SM90_BWD_LAUNCHES = 0

    def counts():
        return dict(flash_qkv_fwd=fq.FWD_LAUNCHES,
                    flash_qkv_bwd=fq.BWD_LAUNCHES,
                    flash_attn_sm90_fwd=fa.SM90_FWD_LAUNCHES,
                    flash_attn_sm90_bwd=fa.SM90_BWD_LAUNCHES,
                    softmax_xent_fwd=sx.LAUNCHES,
                    softmax_xent_dlogits=sx.DLOGITS_LAUNCHES)

    return one, reset, counts, dict(path="compiled", batch=BATCH, seq=SEQ,
                                    dtype="bfloat16", remat="ctx")


class _Encoder(torch.nn.Module):
    """Token and position embeddings, fused post-LN encoder layers, an
    untied head."""

    def __init__(self, cfg, device):
        super().__init__()
        V, D = cfg["vocab_size"], cfg["d_model"]
        self.wte = torch.nn.Embedding(V, D, device=device)
        self.wpe = torch.nn.Embedding(cfg["max_len"], D, device=device)
        self.layers = torch.nn.ModuleList([FusedTransformerEncoderLayer(
            D, cfg["nhead"], cfg["dim_feedforward"],
            dropout_rate=cfg["dropout_rate"], activation="gelu",
            attn_dropout_rate=0.0, normalize_before=False, device=device)
            for _ in range(cfg["num_layers"])])
        self.head = torch.nn.Linear(D, V, device=device)

    def forward(self, ids):
        ids = ids.long()
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = self.wte(ids) + self.wpe(pos)[None]
        for layer in self.layers:
            x = layer(x)
        return self.head(x)


def build_encoder(cfg=ENCODER, device=None, seed_val: int = 0):
    """The encoder composed around the fused stack: ``num_layers`` post-LN
    ``FusedTransformerEncoderLayer``s (GELU, hidden dropout
    ``dropout_rate``, no attention dropout, activation dropout at its
    default, the hidden rate) between token and position embeddings and an
    untied head, on ``device`` (the card unless ``"cpu"``).  Weights come
    from the port's random state reseeded with ``seed_val``: the layers'
    Xavier-normal weights, embeddings N(0, 1), the head Xavier-normal with
    a zero bias."""
    seed(seed_val)
    dev = resolve_device(device)
    net = _Encoder(cfg, dev)
    gen = default_generator.device(dev)
    D, V = cfg["d_model"], cfg["vocab_size"]
    with torch.no_grad():
        net.wte.weight.normal_(0.0, 1.0, generator=gen)
        net.wpe.weight.normal_(0.0, 1.0, generator=gen)
        net.head.weight.normal_(0.0, math.sqrt(2.0 / (D + V)), generator=gen)
        net.head.bias.zero_()
    return net


def _eager_path(encoder: bool = False, amp=None, jit: bool = True):
    """Model.train_batch on the eager GPT (or the fused encoder), with
    ``amp_configs=amp`` and ``jit``: the same four callables."""
    if encoder:
        net = build_encoder()
    else:
        net = GPT(GPTConfig(**WIDTH), seed=0)
    model = Model(net).prepare(
        AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01),
        CrossEntropyLoss(), amp_configs=amp, jit=jit)
    ids = np.random.RandomState(0).randint(0, WIDTH["vocab_size"],
                                           (EAGER_BATCH, SEQ))
    labels = np.roll(ids, -1, 1).reshape(EAGER_BATCH, SEQ, 1)
    ids, labels = (torch.from_numpy(a).cuda() for a in (ids, labels))

    def one():
        model.train_batch([ids], [labels])

    def reset():
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = fl.LAUNCHES = 0
        fa.SM90_FWD_LAUNCHES = fa.SM90_BWD_LAUNCHES = fl.BWD_LAUNCHES = 0

    def counts():
        return dict(flash_attn_fwd=fa.FWD_LAUNCHES,
                    flash_attn_bwd=fa.BWD_LAUNCHES,
                    flash_attn_sm90_fwd=fa.SM90_FWD_LAUNCHES,
                    flash_attn_sm90_bwd=fa.SM90_BWD_LAUNCHES,
                    fused_ln=fl.LAUNCHES, fused_ln_bwd=fl.BWD_LAUNCHES)

    return one, reset, counts, dict(
        path="encoder" if encoder else "eager", batch=EAGER_BATCH, seq=SEQ,
        dtype="float32" if amp is None else f"float32, AMP {amp} bfloat16",
        remat="none", captured=jit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--eager", action="store_true",
                      help="profile Model.train_batch on the eager GPT")
    path.add_argument("--encoder", action="store_true",
                      help="profile Model.train_batch on the fused "
                           "post-LN encoder")
    ap.add_argument("--amp", choices=("O1", "O2"),
                    help="with --eager or --encoder: prepare the model with "
                         "amp_configs at this level (bf16)")
    ap.add_argument("--uncaptured", action="store_true",
                    help="with --eager or --encoder: prepare(jit=False), "
                         "the step run op by op")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", metavar="PATH",
                    help="also write the summary to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    if (args.amp or args.uncaptured) and not (args.eager or args.encoder):
        ap.error("--amp and --uncaptured take --eager or --encoder")
    if args.eager or args.encoder:
        one, reset, counts, setup = _eager_path(encoder=args.encoder,
                                                amp=args.amp,
                                                jit=not args.uncaptured)
    else:
        one, reset, counts, setup = _compiled_path()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        run()                                         # warm-up
    reset()
    wall = [run() for _ in range(args.steps)]
    launches = {k: v / args.steps for k, v in counts().items()}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = [run() for _ in range(args.steps)]
    events = _device_events(prof)
    by_name = defaultdict(lambda: [0.0, 0])
    by_kind = defaultdict(float)
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name][0] += ms
        by_name[e.name][1] += 1
        by_kind[_kind(e.name)] += ms
    n = args.steps
    device_ms = sum(v[0] for v in by_name.values()) / n
    prof_mean = statistics.fmean(prof_wall)
    if device_ms > prof_mean:
        raise RuntimeError(f"summed device time {device_ms:.3f} ms/step "
                           f"exceeds the profiled steps' mean wall "
                           f"{prof_mean:.3f} ms: the events are miscounted")
    wall_p50 = statistics.median(wall)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    report = dict(
        card=card, width=WIDTH, **setup, steps=n, wall_ms_p50=wall_p50,
        profiled_wall_ms_p50=statistics.median(prof_wall),
        device_ms_per_step=device_ms,
        idle_share=1.0 - device_ms / wall_p50,
        device_ops_per_step=len(events) / n, kernel_launches_per_step=launches,
        by_kind=[dict(kind=k, ms_per_step=v / n, share=v / n / device_ms)
                 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])],
        top=[dict(name=k[:120], ms_per_step=v[0] / n, calls_per_step=v[1] / n)
             for k, v in top])
    captured = {True: " (captured)", False: " (uncaptured)"}.get(
        setup.get("captured"), "")
    print(f"{card}: {setup['path']}{captured} train step wall "
          f"{wall_p50:.3f} ms p50 "
          f"unprofiled "
          f"({report['profiled_wall_ms_p50']:.3f} profiled); device "
          f"{device_ms:.3f} ms/step; idle share {report['idle_share']:.4f}; "
          f"{report['device_ops_per_step']:.0f} device ops/step; kernel "
          f"launches/step {launches}", flush=True)
    for k in report["by_kind"]:
        print(f"   {k['ms_per_step']:9.3f} ms  {k['share']:6.1%}  {k['kind']}")
    for t in report["top"]:
        print(f"   {t['ms_per_step']:9.3f} ms  x{t['calls_per_step']:6.1f}  "
              f"{t['name']}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
