"""Where a train step's time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_train [--eager | --encoder]
                                                    [--amp O1|O2
                                                     [--amp-dtype float16]]
                                                    [--uncaptured]
                                                    [--remat] [--offload]
                                                    [--fit [--prefetch N]
                                                     [--metric]]
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
prepares the model with ``amp_configs`` at that level in bf16, or in
fp16 with ``--amp-dtype float16`` (the default loss scaling).  Those
two paths run ``prepare(jit=True)``'s step, captured in a CUDA graph and
replayed, unless ``--uncaptured`` asks for ``jit=False``.  On the
captured step ``--remat`` sets ``FLAGS_program_remat`` and
``FLAGS_remat_budget_mb`` (``set_flags``: the budget remat, products
kept and the rest recomputed in the backward) and ``--offload`` prepares
the model with ``offload=True`` (the optimizer's slots in pinned host
memory, read by the update kernel over PCIe).  Either
way it takes two warm-up steps, then
``--steps`` steps unprofiled
(host wall per step, ending in a synchronise) and ``--steps`` steps under
``torch.profiler`` (CPU and CUDA activities).

``--fit`` (the GPT, or with ``--encoder`` the encoder) runs ``Model.fit``
instead of single steps: the model prepared with :func:`fit_recipe`
(AdamW under ``LinearWarmup(PolynomialDecay(1e-4, 40), 4, 0, 1e-4)``,
weight decay 0.01, ``ClipGradByGlobalNorm(1.0)``; ``--metric`` adds
``Accuracy``), one epoch of ``--steps`` batches of 32 (:func:`fit_data`)
per call, ``verbose=0``, ``prefetch_to_device=--prefetch`` (default 2):
a warm-up epoch (it captures), two epochs unprofiled (wall from the
epoch's start to a synchronise after it) and one under the profiler,
every number per step.

Reports the device time per step (the sum of the kernels' and copies'
durations on the card), the device's busy time (the union of their
intervals: copies on side streams overlap kernels) and its idle share of
an unprofiled step (1 - busy time / unprofiled wall), device ops and the
port's kernel
launches per step, the device time by kind of op, and the top ops by
device time.  With ``--json PATH`` it also writes the summary to PATH.
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
from ..io import TensorDataset
from ..metric import Accuracy
from ..nn import ClipGradByGlobalNorm
from ..optimizer import AdamW, lr
from ..random import default_generator, seed
from .device_time import device_ms_per_call
from ..utils.flags import set_flags

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
         ("fused_ln (row 12)", ("fused_ln_warp", "fused_ln_row",
                                "ln_fwd_tile")),
         ("fused_ln_bwd (the epilogue's backward)",
          ("ln_bwd_warp", "ln_bwd_row", "ln_bwd_fold", "ln_bwd_tile")),
         ("optimizer update (multi_tensor_update.cu)",
          ("mt_update_kernel", "mt_norms_kernel", "mt_fold_kernel",
           "mt_pows_kernel", "mt_unscale_kernel")),
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


def _eager_reset():
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = fl.LAUNCHES = 0
    fa.SM90_FWD_LAUNCHES = fa.SM90_BWD_LAUNCHES = fl.BWD_LAUNCHES = 0


def _eager_counts():
    return dict(flash_attn_fwd=fa.FWD_LAUNCHES,
                flash_attn_bwd=fa.BWD_LAUNCHES,
                flash_attn_sm90_fwd=fa.SM90_FWD_LAUNCHES,
                flash_attn_sm90_bwd=fa.SM90_BWD_LAUNCHES,
                fused_ln=fl.LAUNCHES, fused_ln_bwd=fl.BWD_LAUNCHES)


def _eager_path(encoder: bool = False, amp=None, jit: bool = True,
                offload: bool = False, remat: bool = False):
    """Model.train_batch on the eager GPT (or the fused encoder), with
    ``amp_configs=amp``, ``jit`` and ``offload`` (the step's remat is the
    flags', ``remat`` only labels it): the same four callables."""
    if encoder:
        net = build_encoder()
    else:
        net = GPT(GPTConfig(**WIDTH), seed=0)
    model = Model(net).prepare(
        AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01),
        CrossEntropyLoss(), amp_configs=amp, jit=jit, offload=offload)
    ids = np.random.RandomState(0).randint(0, WIDTH["vocab_size"],
                                           (EAGER_BATCH, SEQ))
    labels = np.roll(ids, -1, 1).reshape(EAGER_BATCH, SEQ, 1)
    ids, labels = (torch.from_numpy(a).cuda() for a in (ids, labels))

    def one():
        model.train_batch([ids], [labels])

    return one, _eager_reset, _eager_counts, dict(
        path="encoder" if encoder else "eager", batch=EAGER_BATCH, seq=SEQ,
        dtype=_amp_label(amp), remat="budget" if remat else "none",
        offload=offload, captured=jit)


def _amp_label(amp) -> str:
    """The types of a run prepared with ``amp_configs=amp`` (a level, or a
    dict with the level and the type; bf16 by default)."""
    if amp is None:
        return "float32"
    level, low = (amp["level"], amp.get("dtype", "bfloat16")) \
        if isinstance(amp, dict) else (amp, "bfloat16")
    return f"float32, AMP {level} {low}"


def fit_recipe(net, amp=None, jit: bool = True, metric: bool = False):
    """``Model(net)`` prepared as BERT-style fine-tuning is:
    ``AdamW(LinearWarmup(PolynomialDecay(1e-4, 40), 4, 0, 1e-4),
    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))``,
    ``CrossEntropyLoss()``, ``Accuracy()`` with ``metric``."""
    sched = lr.LinearWarmup(lr.PolynomialDecay(1e-4, 40), 4, 0, 1e-4)
    return Model(net).prepare(
        AdamW(sched, parameters=net.parameters(), weight_decay=0.01,
              grad_clip=ClipGradByGlobalNorm(1.0)), CrossEntropyLoss(),
        metrics=Accuracy() if metric else None, amp_configs=amp, jit=jit)


def fit_data(n: int, seed_val: int = 0, vocab: int = WIDTH["vocab_size"],
             seq: int = SEQ):
    """``[ids, labels]``: ``n`` rows of ``seq`` token ids from
    ``np.random.RandomState(seed_val)``, labels the ids rolled by one,
    shaped (n, seq, 1)."""
    ids = np.random.RandomState(seed_val).randint(0, vocab, (n, seq))
    return [ids, np.roll(ids, -1, 1).reshape(n, seq, 1)]


def _fit_path(net, amp, jit: bool, steps: int, prefetch: int, metric: bool,
              batch: int = EAGER_BATCH, seq: int = SEQ,
              accumulate: int = 1):
    """One epoch of ``Model.fit`` on ``net`` per call, ``steps`` full
    batches of ``batch`` rows (:func:`fit_data` at the net's vocabulary),
    ``accumulate_grad_batches=accumulate``.  ``amp``: an ``amp_configs``
    value (a level, or a dict with the level and the type)."""
    model = fit_recipe(net, amp=amp, jit=jit, metric=metric)
    vocab = next(m for m in net.modules()
                 if isinstance(m, torch.nn.Embedding)).num_embeddings
    data = TensorDataset(fit_data(steps * batch, vocab=vocab, seq=seq))

    def one():
        model.fit(data, batch_size=batch, epochs=1, shuffle=True, verbose=0,
                  prefetch_to_device=prefetch,
                  accumulate_grad_batches=accumulate)

    return one, _eager_reset, _eager_counts, dict(
        path=f"fit ({type(net).__name__})", batch=batch, seq=seq,
        dtype=_amp_label(amp), remat="none", captured=jit, prefetch_to_device=prefetch,
        metric=metric, steps_per_call=steps,
        accumulate_grad_batches=accumulate)


def _busy_us(events) -> float:
    """Microseconds in which some device event ran: the union of their
    intervals (an offloaded update's copies on side streams overlap the
    kernels, so the summed durations can pass the wall)."""
    total, end = 0.0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def profile(one, reset, counts, setup, steps: int) -> dict:
    """Time and profile ``one()`` as ``main`` does (a call is one step, or
    with ``setup["steps_per_call"]`` that many: ``Model.fit``'s epoch) and
    return the report, every number per step."""
    card = torch.cuda.get_device_name(0)
    per_call = setup.get("steps_per_call", 1)
    fit = per_call > 1
    calls = 2 if fit else steps

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / per_call

    for _ in range(1 if fit else 2):
        run()                                         # warm-up
    reset()
    wall = [run() for _ in range(calls)]
    launches = {k: v / (calls * per_call) for k, v in counts().items()}
    from torch.profiler import ProfilerActivity, profile as trace
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        prof_wall = [run() for _ in range(1 if fit else steps)]
    events = _device_events(prof)
    by_name = defaultdict(lambda: [0.0, 0])
    by_kind = defaultdict(float)
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name][0] += ms
        by_name[e.name][1] += 1
        by_kind[_kind(e.name)] += ms
    n = len(prof_wall) * per_call
    device_ms = sum(v[0] for v in by_name.values()) / n
    busy_ms = _busy_us(events) / 1e3 / n
    prof_mean = statistics.fmean(prof_wall)
    if busy_ms > prof_mean:
        raise RuntimeError(f"device busy time {busy_ms:.3f} ms/step "
                           f"exceeds the profiled steps' mean wall "
                           f"{prof_mean:.3f} ms: the events are miscounted")
    wall_p50 = statistics.median(wall)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return dict(
        card=card, width=WIDTH, **setup, steps=n, wall_ms_p50=wall_p50,
        profiled_wall_ms_p50=statistics.median(prof_wall),
        device_ms_per_step=device_ms, device_busy_ms_per_step=busy_ms,
        idle_share=1.0 - busy_ms / wall_p50,
        device_ops_per_step=len(events) / n, kernel_launches_per_step=launches,
        by_kind=[dict(kind=k, ms_per_step=v / n, share=v / n / device_ms)
                 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])],
        top=[dict(name=k[:120], ms_per_step=v[0] / n, calls_per_step=v[1] / n)
             for k, v in top])


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
    ap.add_argument("--amp-dtype", choices=("bfloat16", "float16"),
                    default="bfloat16",
                    help="with --amp: the low type (float16: with the "
                         "default loss scaling)")
    ap.add_argument("--uncaptured", action="store_true",
                    help="with --eager or --encoder: prepare(jit=False), "
                         "the step run op by op")
    ap.add_argument("--remat", action="store_true",
                    help="with --eager or --encoder: the budget remat "
                         "(FLAGS_program_remat, FLAGS_remat_budget_mb)")
    ap.add_argument("--offload", action="store_true",
                    help="with --eager or --encoder: prepare(offload=True)")
    ap.add_argument("--fit", action="store_true",
                    help="profile Model.fit epochs of --steps batches (the "
                         "GPT, or the encoder with --encoder)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="with --fit: prefetch_to_device")
    ap.add_argument("--metric", action="store_true",
                    help="with --fit: prepare with metrics=Accuracy()")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", metavar="PATH",
                    help="also write the summary to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    if (args.amp or args.uncaptured) and not (args.eager or args.encoder
                                              or args.fit):
        ap.error("--amp and --uncaptured take --eager, --encoder or --fit")
    if (args.metric or args.prefetch != 2) and not args.fit:
        ap.error("--metric and --prefetch take --fit")
    if args.amp_dtype != "bfloat16" and not args.amp:
        ap.error("--amp-dtype takes --amp")
    if (args.remat or args.offload) and not (
            (args.eager or args.encoder) and not args.fit
            and not args.uncaptured):
        ap.error("--remat and --offload take --eager or --encoder, "
                 "captured (they act on the captured update step)")
    if args.remat:
        set_flags({"FLAGS_program_remat": True,
                   "FLAGS_remat_budget_mb": 4096})
    amp = args.amp if args.amp_dtype == "bfloat16" else dict(
        level=args.amp, dtype=args.amp_dtype)
    if args.fit:
        net = build_encoder() if args.encoder else GPT(GPTConfig(**WIDTH),
                                                       seed=0)
        one, reset, counts, setup = _fit_path(
            net, amp, not args.uncaptured, args.steps, args.prefetch,
            args.metric)
    elif args.eager or args.encoder:
        one, reset, counts, setup = _eager_path(
            encoder=args.encoder, amp=amp, jit=not args.uncaptured,
            offload=args.offload, remat=args.remat)
    else:
        one, reset, counts, setup = _compiled_path()
    report = profile(one, reset, counts, setup, args.steps)
    wall_p50, device_ms = report["wall_ms_p50"], report["device_ms_per_step"]
    launches = report["kernel_launches_per_step"]
    captured = {True: " (captured)", False: " (uncaptured)"}.get(
        setup.get("captured"), "")
    print(f"{card}: {setup['path']}{captured} train step wall "
          f"{wall_p50:.3f} ms p50 "
          f"unprofiled "
          f"({report['profiled_wall_ms_p50']:.3f} profiled); device "
          f"{device_ms:.3f} ms/step summed, busy "
          f"{report['device_busy_ms_per_step']:.3f}; idle share "
          f"{report['idle_share']:.4f}; "
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
