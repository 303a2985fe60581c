"""Time the attention and LM-head kernels of one checkout, to compare two
on one card.

    python3 paddle_tpu_torch/tools/kernel_ab.py --root DIR [--label NAME]
                                                [--head | --epilogue]
                                                [--json PATH]

Imports ``paddle_tpu_torch`` from the checkout at ``DIR`` (its kernels
build into that checkout's ``_build/``) and times, with CUDA events (median
of 25 launches after 3 warm-ups; the host's time to issue a call counts
where the card waits for it) and in device time (``*_device_ms``: the
kernels' durations in a ``torch.profiler`` trace of 10 calls), the
attention kernel calls of the serving and train paths, at their shapes:

- ``flash_attn_fwd`` on ``(BH, T, d)``: bh 96, T 512, d 64, fp32, causal
  (the serving shape, row 1);
- ``flash_qkv_fwd`` and ``flash_qkv_bwd`` on a packed ``(B, T, 3F)``
  projection: B 128, T 512, H 12, d 64, bf16, causal (rows 3 and 4), at
  B 8, T 1024, fp32 (row 5), and bf16 at B 16, T 2048 with d 64 (H 16)
  and d 128 (H 8), causal (the bf16 head dims of ``flash_attn_sm90``);
- ``flash_attn_fwd`` with lse and ``flash_attn_bwd`` on head views of one
  ``(B, T, 3, H, d)`` fp32 tensor, H 12, d 64, causal, at the split-layout
  timing shapes of ``chip_smoke.py`` (``SPLIT_TIMING``): B 32, T 512
  (backward row 6), B 32, T 1024 (row 7) and B 1, T 8192 (forward row 2,
  backward rows 8 + 9), and at B 4, T 2048, H 12 with the other head
  dims of the tile kernels, fp32 at 16, 80, 96 and 128 and bf16 at 16,
  32, 80 and 96, whose shared-memory tiles differ from d 64's; the same
  three split shapes in bf16 and fp16 and B 4, T 2048 at d 128 in both
  (``flash_attn_sm90``'s types and head dims; a checkout that routes fp16
  elsewhere times its own route, named in ``*_route``);
- the LM head at the compiled step's shapes, bf16: ``softmax_xent_fwd``
  at N 65536, D 768, V 30528 (row 10) and ``softmax_xent_dlogits`` on one
  4096-row chunk (row 11), with the route each took where the checkout
  has one.  ``--head`` times these two rows alone;
- with ``--epilogue`` instead, the fused epilogue alone at the encoder's
  shape, N 16384, D 768: ``fused_ln`` (row 12) at p 0.1 and p 0 with x,
  residual and parameters fp32, bf16 or fp16 each alike, AMP O1's
  triples (bf16 or fp16 x and residual, fp32 parameters) and bf16 or
  fp16 x over an fp32 residual and parameters (the encoder's first
  layer under O1), with the kernel it ran (``*_route``, where the
  checkout reports one); its backward ``fused_ln_bwd`` at p 0.1 with x
  and the residual fp32, bf16, fp16, and bf16 or fp16 over an fp32
  residual, the parameters in x's type where the residual shares it,
  else fp32; each call held against its plain version
  (``*_max_abs_err``; the backward's dx and dres), and the SHA-256 of
  its outputs' bytes (``*_sha256``: two checkouts' equal digests are
  equal bits, the inputs being the same from the same seed); and the
  unscale pass
  (``multi_tensor_unscale``) on the GPT's 149 gradients in fp32, bf16
  and fp16, beside ``torch._amp_foreach_non_finite_check_and_unscale_``
  where it takes the type, both also as a replayed CUDA graph
  (``*_graph_ms``: the card's time without the host's).

Run it on two checkouts in turns (A, B, B, A) inside one call to compare
them; each run prints one JSON line and, with ``--json``, writes it.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
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


def _device_ms(torch, fn, reps=10):
    # this tool's own timer (tools/device_time.py, torch alone), loaded by
    # path: the checkout under test may lack it or hold an older one
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "device_time.py")
    spec = importlib.util.spec_from_file_location("_kernel_ab_timer", path)
    timer = sys.modules.get(spec.name)
    if timer is None:
        timer = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(timer)
    return timer.device_ms_per_call(fn, reps=reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--head", action="store_true",
                      help="time the LM head's rows 10 and 11 only")
    only.add_argument("--epilogue", action="store_true",
                      help="time the fused epilogue's forward and "
                           "backward only")
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
    if args.epilogue:
        _time_epilogue(torch, gen, out)
    else:
        _time_head(torch, gen, out)
    if not (args.head or args.epilogue):
        _time_attention(torch, fa, fq, gen, out)
    print(json.dumps(out), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def _digest(torch, tensors):
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _time_epilogue(torch, gen, out):
    from paddle_tpu_torch.ops import fused_ln as fl
    N, D = 16384, 768
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    b, gam, be = (torch.randn(D, generator=gen, device="cuda")
                  for _ in range(3))
    routes = getattr(fl, "ROUTE_LAUNCHES", None)
    with torch.no_grad():
        # the forward: (name, x, residual, parameters)
        for name, x_dt, r_dt, p_dt in (
                ("fp32", f32, f32, f32), ("bf16", bf16, bf16, bf16),
                ("bf16_o1", bf16, bf16, f32),
                ("bf16_x_fp32_res", bf16, f32, f32),
                ("fp16", f16, f16, f16), ("fp16_o1", f16, f16, f32),
                ("fp16_x_fp32_res", f16, f32, f32)):
            x, r = (torch.randn((N, D), generator=gen, device="cuda")
                    for _ in range(2))
            args = (x.to(x_dt), r.to(r_dt), b.to(p_dt), gam.to(p_dt),
                    be.to(p_dt), 3)
            for p in (0.1, 0.0):
                key = f"fused_ln_{name}_p{p:g}"

                def fwd():
                    return fl.fused_ln(*args, p=p, eps=1e-5)

                before = dict(routes) if routes is not None else None
                got = fwd()
                if routes is not None:
                    out[f"{key}_route"] = next(
                        k for k, v in routes.items() if v != before[k])
                ref = fl.fused_ln_ref(*args, p=p, eps=1e-5)
                out[f"{key}_max_abs_err"] = (
                    got.float() - ref.float()).abs().max().item()
                out[f"{key}_sha256"] = _digest(torch, (got,))
                del got, ref
                out[f"{key}_ms"] = _time_ms(torch, fwd)
                out[f"{key}_device_ms"] = _device_ms(torch, fwd)
        p = 0.1
        for name, x_dt, r_dt in (("fp32", f32, f32), ("bf16", bf16, bf16),
                                 ("bf16_x_fp32_res", bf16, f32),
                                 ("fp16", f16, f16),
                                 ("fp16_x_fp32_res", f16, f32)):
            g, x, r = (torch.randn((N, D), generator=gen, device="cuda")
                       for _ in range(3))
            p_dt = x_dt if r_dt == x_dt else f32
            args = (g.to(x_dt), x.to(x_dt), r.to(r_dt), b.to(p_dt),
                    gam.to(p_dt), be.to(p_dt), 3)

            def bwd():
                return fl.fused_ln_bwd(*args, p=p, eps=1e-5)

            key = f"fused_ln_bwd_{name}"
            got = bwd()
            ref = fl.fused_ln_bwd_ref(*args, p=p, eps=1e-5)
            out[f"{key}_max_abs_err"] = max(
                (a.float() - w.float()).abs().max().item()
                for a, w in zip(got[:2], ref[:2]))
            out[f"{key}_sha256"] = _digest(torch, got)
            del got, ref
            out[f"{key}_ms"] = _time_ms(torch, bwd)
            out[f"{key}_device_ms"] = _device_ms(torch, bwd)
    _time_unscale(torch, gen, out)


def _time_unscale(torch, gen, out):
    import chip_smoke
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    shapes = [s for _, s in chip_smoke.update_shapes(
        torch, chip_smoke.GPT_WIDTH, "cuda")]
    library = torch._amp_foreach_non_finite_check_and_unscale_
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                     ("fp16", torch.float16)):
        grads = [torch.randn(s, generator=gen, device="cuda").to(dt)
                 for s in shapes]
        scale = torch.full((), 4096.0, device="cuda")
        found = torch.zeros((), dtype=torch.bool, device="cuda")
        cache = {}

        def kernel():
            mtu.multi_tensor_unscale(grads, scale, found, cache)

        key = f"unscale_{name}"
        out[f"{key}_ms"] = _time_ms(torch, kernel)
        out[f"{key}_graph_ms"] = chip_smoke.graph_ms(torch, kernel, reps=20)
        inv = torch.full((1,), 1.0 / 4096.0, device="cuda")
        flag = torch.zeros((1,), device="cuda")

        def lib():
            library(grads, flag, inv)

        try:
            lib()
        except (NotImplementedError, RuntimeError) as e:
            out[f"{key}_library_error"] = str(e).splitlines()[0]
        else:
            out[f"{key}_library_ms"] = _time_ms(torch, lib)
            out[f"{key}_library_graph_ms"] = chip_smoke.graph_ms(
                torch, lib, reps=20)
        del grads


def _time_head(torch, gen, out):
    from paddle_tpu_torch.ops import softmax_xent as sx
    N, D, V, C = 65536, 768, 30528, 4096
    x = torch.randn((N, D), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((D, V), generator=gen, device="cuda") * 0.01).bfloat16()
    lab = torch.randint(0, V, (N,), generator=gen, device="cuda")
    g = torch.tensor(1.0 / N, device="cuda")
    with torch.no_grad():
        lse, _ = sx.softmax_xent_fwd(x, w, lab)
        xc, lc, lsec = x[:C], lab[:C].int(), lse[:C]

        def fwd():
            sx.softmax_xent_fwd(x, w, lab)

        def dlogits():
            sx.softmax_xent_dlogits(xc, w, lc, lsec, g)

        for key, fn in (("row10_softmax_xent_fwd_n65536", fwd),
                        ("row11_softmax_xent_dlogits_c4096", dlogits)):
            out[f"{key}_ms"] = _time_ms(torch, fn)
            out[f"{key}_device_ms"] = _device_ms(torch, fn)
    route = getattr(sx, "_route", None)
    out["head_route"] = route(x, w) if route else "tile"


def _time_attention(torch, fa, fq, gen, out):
    with torch.no_grad():
        q, k, v = (torch.rand((96, 512, 64), generator=gen, device="cuda")
                   for _ in range(3))
        out["row1_flash_attn_fwd_ms"] = _time_ms(
            torch, lambda: fa.flash_attn_fwd(q, k, v, causal=True))
        out["row1_flash_attn_fwd_device_ms"] = _device_ms(
            torch, lambda: fa.flash_attn_fwd(q, k, v, causal=True))
        del q, k, v
        f32, b16, f16 = torch.float32, torch.bfloat16, torch.float16
        names = {f32: "fp32", b16: "bf16", f16: "fp16"}
        for B, T, d, dt in ((32, 512, 64, f32), (32, 1024, 64, f32),
                            (1, 8192, 64, f32), *((4, 2048, d, f32) for d in
                                                  (16, 80, 96, 128)),
                            *((4, 2048, d, b16) for d in (16, 32, 80, 96)),
                            *((B, T, d, dt) for dt in (b16, f16)
                              for B, T, d in ((32, 512, 64), (32, 1024, 64),
                                              (1, 8192, 64),
                                              (4, 2048, 128)))):
            q, k, v = torch.randn((B, T, 3, 12, d), generator=gen,
                                  device="cuda").to(dt).unbind(2)
            g = torch.randn((B, T, 12, d), generator=gen,
                            device="cuda").to(dt)
            try:
                o, lse = fa.flash_attn_fwd(q, k, v, causal=True,
                                           return_lse=True)
            except ValueError as e:   # a checkout without this head dim
                out[f"split_{d}_{dt}_error"] = str(e)
                continue

            def split_fwd():
                fa.flash_attn_fwd(q, k, v, causal=True, return_lse=True)

            def split_bwd():
                fa.flash_attn_bwd(q, k, v, o, lse, g, causal=True)

            for name, fn in (("fwd", split_fwd), ("bwd", split_bwd)):
                key = (f"split_{name}_{names[dt]}_b{B}_t{T}"
                       + (f"_d{d}" if d != 64 else ""))
                out[f"{key}_ms"] = _time_ms(torch, fn)
                out[f"{key}_device_ms"] = _device_ms(torch, fn)
                if hasattr(fa, "kernel_route"):
                    out[f"{key}_route"] = fa.kernel_route(dt, d, q, k, v)
            del q, k, v, g, o, lse
        for key, B, T, H, d, dt in (
                ("bf16_b128_t512", 128, 512, 12, 64, torch.bfloat16),
                ("fp32_b8_t1024", 8, 1024, 12, 64, torch.float32),
                ("bf16_b16_t2048_d64", 16, 2048, 16, 64, torch.bfloat16),
                ("bf16_b16_t2048_d128", 16, 2048, 8, 128, torch.bfloat16)):
            F = H * d
            qkv = torch.randn((B, T, 3 * F), generator=gen,
                              device="cuda").to(dt)
            g = torch.randn((B, T, F), generator=gen, device="cuda").to(dt)
            o, lse = fq.flash_qkv_fwd(qkv, H, causal=True)

            def fwd():
                fq.flash_qkv_fwd(qkv, H, causal=True)

            def bwd():
                fq.flash_qkv_bwd(qkv, o, lse, g, H, causal=True)

            for name, fn in (("fwd", fwd), ("bwd", bwd)):
                out[f"flash_qkv_{name}_{key}_ms"] = _time_ms(torch, fn)
                out[f"flash_qkv_{name}_{key}_device_ms"] = _device_ms(
                    torch, fn)


if __name__ == "__main__":
    sys.exit(main())
