"""Where a train step's time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_train [--steps 5] [--json PATH]

Builds the flagship train step (V 30528, D 768, L 12, H 12, T 512, B 128,
bf16 compute over fp32 masters, remat ``"ctx"``) from ``init_fn(0)`` with
ids and labels from ``np.random.RandomState(0)``, takes two warm-up steps,
then ``--steps`` steps unprofiled (host wall per step, ending in a
synchronise) and ``--steps`` steps under ``torch.profiler`` (CPU and CUDA
activities).  Reports the device time per step (the sum of the kernels'
and copies' durations on the card), the device's idle share of an
unprofiled step (1 - device time / unprofiled wall), device ops and the
port's kernel launches per step, the device time by kind of op, and the
top ops by device time.  With ``--json PATH`` it also writes the summary
to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ..models import GPTConfig
from ..models.gpt_spmd import build_spmd_train_step
from ..ops import flash_attention_qkv as fq
from ..ops import softmax_xent as sx

WIDTH = dict(vocab_size=30528, hidden_size=768, num_layers=12,
             num_heads=12, max_seq_len=512)
BATCH, SEQ = 128, 512

# device-op name fragments by kind, first match wins
KINDS = (("flash_attn_qkv forward (row 3)", ("qkv_fwd_kernel",)),
         ("flash_attn_qkv backward (rows 4/5)",
          ("qkv_dkv_kernel", "qkv_dq_kernel", "qkv_delta_kernel")),
         ("softmax_xent_fwd (row 10)", ("sxent_fwd_kernel",)),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", metavar="PATH",
                    help="also write the summary to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    cfg = GPTConfig(**WIDTH)
    step, init_fn = build_spmd_train_step(
        cfg, compute_dtype=torch.bfloat16, remat_policy="ctx")
    params, opt = init_fn(0)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (BATCH, SEQ))
                           ).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (BATCH, SEQ))
                              ).cuda()

    def run():
        nonlocal params, opt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, params, opt = step(params, opt, ids, labels)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        run()                                         # warm-up
    fq.FWD_LAUNCHES = fq.BWD_LAUNCHES = sx.LAUNCHES = 0
    wall = [run() for _ in range(args.steps)]
    launches = dict(flash_qkv_fwd=fq.FWD_LAUNCHES / args.steps,
                    flash_qkv_bwd=fq.BWD_LAUNCHES / args.steps,
                    softmax_xent_fwd=sx.LAUNCHES / args.steps)
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
        card=card, width=WIDTH, batch=BATCH, seq=SEQ, dtype="bfloat16",
        remat="ctx", steps=n, wall_ms_p50=wall_p50,
        profiled_wall_ms_p50=statistics.median(prof_wall),
        device_ms_per_step=device_ms,
        idle_share=1.0 - device_ms / wall_p50,
        device_ops_per_step=len(events) / n, kernel_launches_per_step=launches,
        by_kind=[dict(kind=k, ms_per_step=v / n, share=v / n / device_ms)
                 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])],
        top=[dict(name=k[:120], ms_per_step=v[0] / n, calls_per_step=v[1] / n)
             for k, v in top])
    print(f"{card}: train step wall {wall_p50:.3f} ms p50 unprofiled "
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
