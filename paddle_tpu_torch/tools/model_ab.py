"""Phases 4, 5 and 9 of ``chip_smoke.py`` — the flagship GPT's scoring,
serving and eager training at full width — from one checkout, to compare
two on one card.

    python3 paddle_tpu_torch/tools/model_ab.py --root DIR [--label NAME]
                                               [--json PATH]

Imports ``chip_smoke`` and ``paddle_tpu_torch`` from the checkout at
``DIR``, builds its kernels, then runs that checkout's own phase
functions: ``scoring`` (B 8, T 512, fp32: the forward's ms through the
kernels and through the plain versions, one warm-up first),
``run_engine`` twice on the served GPT (16 requests from 4 client
threads, 8 slots, 64 new tokens; the first run pays the checkout's
first-use costs, the second is warm: tokens/s, decode ms/step and TTFT
p50), and ``eager_train`` on ``chip_smoke.EAGER`` in fp32 and under AMP
O1 (``Model.train_batch`` uncaptured and captured: step ms p50 over 10
timed steps, CUDA events).  Prints one JSON line, and with ``--json``
writes it.  Run it on two checkouts in turns (A, B, B, A) inside one
call, each in its own process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="the checkout whose chip_smoke.py and "
                         "paddle_tpu_torch to run")
    ap.add_argument("--label", default="")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.json) if args.json else None
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("model_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    cs._RUN_START[:] = [t0]
    _build.build()
    dev = torch.device("cuda")
    row = dict(label=args.label, root=root, card=cs.card_line())
    net = GPT(GPTConfig(**cs.GPT_WIDTH), device=dev, seed=0)
    score = cs.scoring(torch, fa, net)
    row["phase4"] = dict(forward_ms=score["forward_ms"],
                         plain_forward_ms=score["plain_forward_ms"],
                         launches=score["launches"])
    reqs = cs.make_requests(net.cfg.vocab_size)
    row["phase5"] = []
    for i in range(2):
        r = cs.run_engine(torch, fa, net, reqs)
        tokens = sum(len(x) for x in r["results"])
        row["phase5"].append(dict(
            run=i + 1, tokens_per_s=tokens / r["wall_s"],
            decode_ms_p50=cs.pct(r["decode_ms"], 50),
            ttft_ms_p50=cs.pct(r["ttft"], 50) * 1e3,
            prefill_ms_p50=cs.pct(r["prefill_ms"], 50)))
    del net
    torch.cuda.empty_cache()
    row["phase9"] = {}
    for amp in (None, "O1"):
        r = cs.eager_train(torch, fa, dev, cs.EAGER, amp=amp)
        row["phase9"][amp or "fp32"] = {
            engine: r[engine]["step_ms_p50"]
            for engine in ("uncaptured", "captured")}
        torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps(row), flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
