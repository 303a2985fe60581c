"""Where a serving step's time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_serving [--steps 32] [--json PATH]

Builds the full-width GPT (V 30528, D 768, L 12, H 12, max_seq_len 512)
from seed 0, fills a :class:`GenerationSession` of 8 rows with 32-token
prompts, and runs prefill and decode steps (replays of the session's
captured CUDA graphs) twice: first unprofiled, for
the host wall time per step, then under ``torch.profiler`` (CPU and CUDA
activities), for the device time per step (the sum of the kernels' and
copies' durations on the card), the device's idle share of an
unprofiled step (1 - device time / unprofiled wall), launches per step
and the top kernels by device time.  Prints a
summary, and with ``--json PATH`` writes it to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from collections import defaultdict

import numpy as np
import torch

from ..generation.session import GenerationSession
from ..models import GPT, GPTConfig

WIDTH = dict(vocab_size=30528, hidden_size=768, num_layers=12,
             num_heads=12, max_seq_len=512)


def _device_events(prof):
    kinds = (torch.autograd.DeviceType.CUDA,)
    return [e for e in prof.events() if e.device_type in kinds]


def _phase(name, run, steps):
    """``run()`` ``steps`` times unprofiled, then ``steps`` times under the
    profiler; returns the phase's summary."""
    wall = []
    for _ in range(steps):
        wall.append(run())
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = [run() for _ in range(steps)]
    events = _device_events(prof)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    device_ms = sum(v[0] for v in by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    wall_p50, prof_p50 = statistics.median(wall), statistics.median(prof_wall)
    # the profiler slows the host, not the device: the share of an
    # unprofiled step the device is idle is 1 - device time / its wall.
    # Each profiled step's device work ends inside its wall (the step
    # ends in the token's copy to the host), so more device time than
    # profiled wall means the events are miscounted
    prof_mean = statistics.fmean(prof_wall)
    if device_ms > prof_mean:
        raise RuntimeError(
            f"{name}: summed device time {device_ms:.3f} ms/step exceeds "
            f"the profiled steps' mean wall {prof_mean:.3f} ms: the device "
            "events are miscounted")
    out = dict(
        phase=name, steps=steps,
        wall_ms_p50=wall_p50, profiled_wall_ms_p50=prof_p50,
        device_ms_per_step=device_ms,
        idle_share=1.0 - device_ms / wall_p50,
        idle_share_profiled=1.0 - device_ms / prof_p50,
        launches_per_step=len(events) / steps,
        top=[dict(name=n[:120], ms_per_step=v[0] / steps,
                  calls_per_step=v[1] / steps) for n, v in top])
    print(f"== {name}: wall {out['wall_ms_p50']:.3f} ms/step unprofiled "
          f"({out['profiled_wall_ms_p50']:.3f} profiled); device "
          f"{device_ms:.3f} ms/step; idle share {out['idle_share']:.3f} "
          f"({out['idle_share_profiled']:.3f} of the profiled step); "
          f"{out['launches_per_step']:.0f} device ops/step", flush=True)
    for t in out["top"]:
        print(f"   {t['ms_per_step']:8.4f} ms  x{t['calls_per_step']:6.1f}"
              f"  {t['name']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--json", metavar="PATH",
                    help="also write the summary to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    net = GPT(GPTConfig(**WIDTH), device="cuda", seed=0)
    B, P = 8, 32
    sess = GenerationSession(net, batch_capacity=B)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, WIDTH["vocab_size"], (B, P)).astype(np.int32)
    plens = np.full((B,), P, np.int32)
    mask = np.ones((B,), bool)
    seeds = np.arange(B, dtype=np.int64)
    temps = np.zeros((B,), np.float32)
    tks = np.zeros((B,), np.int32)
    tps = np.ones((B,), np.float32)
    caches = sess.init_caches()
    state = {}

    def prefill():
        tok, _ = sess.prefill(caches, ids, plens, mask, seeds, temps, tks,
                              tps)
        state["tok"], state["pos"] = tok, plens.copy()
        return sess.step_ms["prefill"][-1]

    def decode():
        tok, _ = sess.decode(caches, state["tok"], state["pos"], seeds,
                             temps, tks, tps)
        state["tok"], state["pos"] = tok, state["pos"] + 1
        return sess.step_ms["decode"][-1]

    prefill()
    for _ in range(3):
        decode()                                      # warm-up
    report = dict(card=card, batch=B, prompt=P, width=WIDTH,
                  phases=[_phase("prefill", prefill, args.steps)])
    prefill()
    report["phases"].append(_phase("decode", decode, args.steps))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
