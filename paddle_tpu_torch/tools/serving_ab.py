"""Phase 5 of ``chip_smoke.py`` — the serving engine at full width — from
one checkout, to compare two on one card.

    python3 paddle_tpu_torch/tools/serving_ab.py --root DIR [--label NAME]
                                                 [--runs 2] [--json PATH]

Imports ``chip_smoke`` and ``paddle_tpu_torch`` from the checkout at
``DIR``, builds the served GPT there (``chip_smoke.GPT_WIDTH``, seed 0)
and serves ``chip_smoke.make_requests`` ``--runs`` times through that
checkout's ``run_engine`` (16 requests from 4 client threads, 8 slots, 64
new tokens), each time with a new engine: the first run in the process
pays what the checkout pays before its first request is answered (a
checkout without warmup pays its first-use costs inside the run), the
later ones run warm.  Prints one JSON line per run (tokens/s, decode
ms/step and TTFT p50 and p99, prefill ms p50), and with ``--json`` writes
them.  Run it on two checkouts in turns (A, B, B, A) inside one call.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="the checkout whose chip_smoke.py and "
                         "paddle_tpu_torch to run")
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.json) if args.json else None
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.ops import flash_attention as fa
    net = GPT(GPTConfig(**cs.GPT_WIDTH), device="cuda", seed=0)
    reqs = cs.make_requests(net.cfg.vocab_size)
    # newer checkouts pass torch to the engine runner first
    takes_torch = next(iter(inspect.signature(
        cs.run_engine).parameters)) == "torch"
    runs = []
    for i in range(args.runs):
        r = cs.run_engine(*((torch,) if takes_torch else ()), fa, net, reqs)
        tokens = sum(len(x) for x in r["results"])
        row = dict(label=args.label, run=i + 1, card=cs.card_line(),
                   tokens=tokens, wall_s=r["wall_s"],
                   tokens_per_s=tokens / r["wall_s"],
                   decode_ms_p50=cs.pct(r["decode_ms"], 50),
                   decode_ms_p99=cs.pct(r["decode_ms"], 99),
                   ttft_ms_p50=cs.pct(r["ttft"], 50) * 1e3,
                   ttft_ms_p99=cs.pct(r["ttft"], 99) * 1e3,
                   prefill_ms_p50=cs.pct(r["prefill_ms"], 50),
                   decode_steps=r["decode_steps"],
                   prefill_steps=r["prefill_steps"])
        print(json.dumps(row), flush=True)
        runs.append(row)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
