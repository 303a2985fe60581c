#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, each of which fails the run (non-zero exit, no result line):

1. card     name and power limit, torch and CUDA versions; exit 1 with no
            card, or with no ``paddle_tpu_torch/`` beside this script
2. build    nvcc builds every kernel source in paddle_tpu_torch/csrc
3. kernels  each kernel against its plain PyTorch version on the card,
            at every shape the serving and scoring paths give it
4. scoring  the full-width GPT (V 30528, D 768, L 12, H 12) scores
            (8, 512) through the kernel: 12 launches, logits against the
            same model with the plain attention swapped in
5. serving  GenerationEngine (8 slots, 64 new tokens) answers 16 requests
            from 4 client threads; every stream equals its solo-session
            stream, and a second run repeats every stream exactly
6. timing   kernel, plain and library times with CUDA events beside the
            card's bound

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  With ``--json PATH`` everything
measured is also written to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit); the
# kernel computes with fp32 FMAs, so its operation bound is the fp32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

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


# -- phase 3 -------------------------------------------------------------------
def check_kernels(torch, fa, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(96, tq, tk, 64, causal, dtype)
             for tq, tk in KERNEL_SHAPES for causal in (False, True)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(96, 128, 128, d, True, dtype) for d in (32, 128)
              for dtype in (torch.float32, torch.bfloat16)]
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


# -- phase 4 -------------------------------------------------------------------
def scoring(torch, fa, net, batch=8):
    cfg, dev = net.cfg, net.device
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                        generator=gen, device=dev)
    with torch.inference_mode():
        net(ids)                                      # warm-up
        sync(torch, dev)
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        logits = net(ids)
        sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = fa.LAUNCHES
        with mock.patch.object(fa, "flash_attn_fwd", fa.flash_attention_ref):
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


def run_engine(fa, net, reqs):
    """Serve ``reqs`` from CLIENTS threads (each submits its share, then
    waits); returns the streams and the engine's counts and step times."""
    from paddle_tpu_torch.serving import (GenerationEngine,
                                          GenerationEngineConfig)
    engine = GenerationEngine(net, GenerationEngineConfig(
        max_slots=SLOTS, max_new_tokens=NEW_TOKENS))
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
    try:
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = fa.LAUNCHES
    finally:
        engine.close()
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("a client thread did not finish")
    sess = engine.session
    return dict(results=results, ttft=ttft, wall_s=wall, launches=launches,
                prefill_steps=sess.steps["prefill"],
                decode_steps=sess.steps["decode"],
                prefill_ms=list(sess.step_ms["prefill"]),
                decode_ms=list(sess.step_ms["decode"]),
                stats=engine.stats())


def serving(torch, fa, net):
    import numpy as np
    from paddle_tpu_torch.generation import GenerationSession
    reqs = make_requests(net.cfg.vocab_size)
    first = run_engine(fa, net, reqs)
    answered = sum(r is not None and len(r) > 0 for r in first["results"])
    tokens = sum(len(r) for r in first["results"] if r is not None)
    groups = first["prefill_steps"]
    log(f"  requests answered {answered}/{REQUESTS}, tokens {tokens}, "
        f"wall {first['wall_s']:.3f} s, tokens/s "
        f"{tokens / first['wall_s']:.1f}")
    log(f"  prefill groups {groups}, kernel launches {first['launches']}, "
        f"decode steps {first['decode_steps']}")
    log(f"  prefill ms p50 {pct(first['prefill_ms'], 50):.3f}; decode "
        f"ms/step p50 {pct(first['decode_ms'], 50):.3f} p99 "
        f"{pct(first['decode_ms'], 99):.3f}; ttft ms p50 "
        f"{pct(first['ttft'], 50) * 1e3:.3f} p99 "
        f"{pct(first['ttft'], 99) * 1e3:.3f}")
    if answered != REQUESTS:
        raise AssertionError(f"only {answered} of {REQUESTS} requests "
                             "answered")
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

    second = run_engine(fa, net, reqs)
    changed = [i for i in range(REQUESTS) if not np.array_equal(
        first["results"][i], second["results"][i])]
    log(f"  a second engine run repeats {REQUESTS - len(changed)}/"
        f"{REQUESTS} streams ({SAMPLED} of them sampled)")
    if changed:
        raise AssertionError(f"streams {changed} changed between two runs "
                             "with the same seeds")
    return dict(requests=REQUESTS, answered=answered, tokens=tokens,
                wall_s=first["wall_s"], tokens_per_s=tokens / first["wall_s"],
                prefill_groups=groups, decode_steps=first["decode_steps"],
                launches=first["launches"],
                prefill_ms_p50=pct(first["prefill_ms"], 50),
                decode_ms_p50=pct(first["decode_ms"], 50),
                decode_ms_p99=pct(first["decode_ms"], 99),
                ttft_ms_p50=pct(first["ttft"], 50) * 1e3,
                ttft_ms_p99=pct(first["ttft"], 99) * 1e3,
                stats=first["stats"])


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


def bound(bh, tq, tk, d, causal, elem_bytes):
    """Least time for the work on an H100: each input read once, the
    output written once, against the fp32 operation rate."""
    flops = 4.0 * bh * tq * tk * d / (2.0 if causal else 1.0)
    nbytes = float(elem_bytes * bh * d * (2 * tq + 2 * tk))
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
        b_ms, b_by = bound(bh, T, T, d, True, 4)
        rows.append(dict(bh=bh, t=T, d=d, dtype="float32", causal=True,
                         ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by))
        log(f"  T={T:4d} bh={bh} d={d} fp32 causal: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, F.scaled_dot_product_attention "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; fp32 67 TFLOP/s, "
            "3.35 TB/s)")
    return rows


def run(torch, dev, width):
    """Phases 3-6 on ``dev`` with a GPT of ``width``; returns the report
    and the ``kernels`` entries."""
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.ops import flash_attention as fa

    log("== phase 3: kernels against their plain versions")
    checks = check_kernels(torch, fa, dev)
    log("== phase 4: full-width scoring")
    net = GPT(GPTConfig(**width), device=dev, seed=0)
    score = scoring(torch, fa, net)
    log("== phase 5: serving")
    serve = serving(torch, fa, net)
    log("== phase 6: kernel times")
    times = timing(torch, fa)
    main_shape = times[-1]                            # T = 512
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
        timed_shape="bh 96, T 512, d 64, fp32, causal",
        launches_scoring=score["launches"], checks=len(checks),
        max_abs_err_bf16=max(c["max_abs_err"] for c in checks
                             if c["dtype"] == "bfloat16"
                             and c["inputs"] == "rand"),
        max_abs_err_bf16_sharp=max(c["max_abs_err"] for c in checks
                                   if c["inputs"] == "sharp"))]
    report = dict(checks=checks, scoring=score, serving=serve, timing=times)
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
        for line in info["report"].splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"    {line.strip()}")

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
