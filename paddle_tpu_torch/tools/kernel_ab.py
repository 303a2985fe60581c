"""Time the attention kernels of one checkout, to compare two on one card.

    python3 paddle_tpu_torch/tools/kernel_ab.py --root DIR [--label NAME]
                                                [--json PATH]

Imports ``paddle_tpu_torch`` from the checkout at ``DIR`` (its kernels
build into that checkout's ``_build/``) and times, with CUDA events (median
of 25 launches after 3 warm-ups), the kernel calls that every slice of the
port since the train step has had, at the shapes of the main paths:

- ``flash_attn_fwd`` on ``(BH, T, d)``: bh 96, T 512, d 64, fp32, causal
  (the serving shape, row 1);
- ``flash_qkv_fwd`` and ``flash_qkv_bwd`` on a packed ``(B, T, 3F)``
  projection: B 128, T 512, H 12, d 64, bf16, causal (rows 3 and 4), and
  ``flash_qkv_bwd`` at B 8, T 1024, fp32 (row 5).

Run it on two checkouts in turns (A, B, B, A) inside one call to compare
them; each run prints one JSON line and, with ``--json``, writes it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def _time_ms(torch, fn, reps=25, warmup=3):
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
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_attention_qkv as fq
    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = dict(label=args.label or root, root=root,
               card=torch.cuda.get_device_name(0))
    with torch.no_grad():
        q, k, v = (torch.rand((96, 512, 64), generator=gen, device="cuda")
                   for _ in range(3))
        out["row1_flash_attn_fwd_ms"] = _time_ms(
            torch, lambda: fa.flash_attn_fwd(q, k, v, causal=True))
        for key, B, T, dt in (("bf16_b128_t512", 128, 512, torch.bfloat16),
                              ("fp32_b8_t1024", 8, 1024, torch.float32)):
            qkv = torch.randn((B, T, 3 * 768), generator=gen,
                              device="cuda").to(dt)
            g = torch.randn((B, T, 768), generator=gen, device="cuda").to(dt)
            o, lse = fq.flash_qkv_fwd(qkv, 12, causal=True)
            out[f"flash_qkv_fwd_{key}_ms"] = _time_ms(
                torch, lambda: fq.flash_qkv_fwd(qkv, 12, causal=True))
            out[f"flash_qkv_bwd_{key}_ms"] = _time_ms(
                torch, lambda: fq.flash_qkv_bwd(qkv, o, lse, g, 12,
                                                causal=True))
    print(json.dumps(out), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
