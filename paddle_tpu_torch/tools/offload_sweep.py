"""Time the offloaded optimizer update's two routes, and the pinned copies
that bound them, on one card.

    python3 -m paddle_tpu_torch.tools.offload_sweep [--json PATH]

Run from the root of a checkout (it reads ``chip_smoke.py``'s shapes and
timers).  The GPT at full width (``chip_smoke.GPT_WIDTH``, 132,340,224
parameters, one fp32 group) under AMP O1 with AdamW and
``prepare(offload=True)``: one captured step, one ``update=False`` step
for the gradients, then ``optimizer.step()`` captured once for each route
setting and the graphs replayed in alternating rounds
(``chip_smoke.graphs_ms``, 6 rounds of 5): the staged route at stages of
1M, 4M and 16M elements with rings of 2, 3 and 4 buffers, and the
in-place route.  Beside them the pinned 1 GiB copy rates
(``chip_smoke.copy_rates``: each way alone and both at once), before the
model is made and after the routes, and where the host memory lies: the
card's NUMA node, the process's CPUs and their nodes, and the nodes of
the slots' pages (``/proc/self/numa_maps``), since a copy to or from
memory on another node than the card's crosses the sockets' link.
Prints one line per reading and, last, one JSON object.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
ELEMENTS = (1 << 20, 1 << 22, 1 << 24)
RINGS = (2, 3, 4)


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return ""


def _cpulist(text: str):
    out = set()
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


def numa(torch, tensors=()):
    """The card's NUMA node, this process's CPUs by node, and the pages of
    ``tensors`` (host memory) by node."""
    props = torch.cuda.get_device_properties(0)
    bus = "%04x:%02x:%02x.0" % (getattr(props, "pci_domain_id", 0),
                                getattr(props, "pci_bus_id", 0),
                                getattr(props, "pci_device_id", 0))
    nodes = {}
    for d in sorted(os.listdir("/sys/devices/system/node")
                    if os.path.isdir("/sys/devices/system/node") else ()):
        if re.fullmatch(r"node\d+", d):
            nodes[int(d[4:])] = _cpulist(_read(
                f"/sys/devices/system/node/{d}/cpulist"))
    mine = os.sched_getaffinity(0)
    return dict(card_bus=bus,
                card_node=_read(f"/sys/bus/pci/devices/{bus}/numa_node"),
                nodes=len(nodes), cpus=sorted(mine),
                cpus_by_node={n: len(c & mine) for n, c in nodes.items()},
                pages_by_node=_pages_by_node(tensors))


def _pages_by_node(tensors):
    """Pages of the mappings holding ``tensors``, by NUMA node, from
    ``/proc/self/numa_maps`` (each mapping counted once)."""
    ranges = []
    for line in _read("/proc/self/maps").splitlines():
        lo, hi = (int(x, 16) for x in line.split()[0].split("-"))
        ranges.append((lo, hi))
    starts = set()
    for t in tensors:
        p = t.data_ptr()
        starts.update(lo for lo, hi in ranges if lo <= p < hi)
    out = {}
    for line in _read("/proc/self/numa_maps").splitlines():
        fields = line.split()
        if fields and int(fields[0], 16) in starts:
            for f in fields:
                m = re.fullmatch(r"N(\d+)=(\d+)", f)
                if m:
                    out[int(m[1])] = out.get(int(m[1]), 0) + int(m[2])
    return out


def routes(torch, cs, mtu, opt):
    """``optimizer.step()``'s device ms at each route setting."""
    settings = [("in place", dict(_STAGE_OFFLOAD=False))] + [
        (f"staged E {e >> 20}M ring {r}",
         dict(STAGE_ELEMENTS=e, STAGE_RING=r))
        for e, r in itertools.product(ELEMENTS, RINGS)]
    tables = {}

    def step(label, patch):
        def fn():
            with mock.patch.multiple(mtu, **patch):
                opt._fused_tables = tables.get(label)
                opt.step()
                tables[label] = opt._fused_tables
        return fn
    timed = cs.graphs_ms(torch, [step(*s) for s in settings], rounds=6,
                         reps=5)
    opt._fused_tables = None
    del tables
    torch.cuda.empty_cache()
    return {label: ms for (label, _), (ms, _) in zip(settings, timed)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write the readings to PATH")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("offload_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.models import GPT, GPTConfig
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops import multi_tensor_update as mtu
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    out = dict(card=cs.card_line())
    print(out["card"], flush=True)
    out["copies_before"] = cs.copy_rates(torch)
    dev = torch.device("cuda")
    net = GPT(GPTConfig(**cs.GPT_WIDTH), device=dev, seed=0)
    opt = AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01)
    model = Model(net).prepare(opt, CrossEntropyLoss(), amp_configs="O1",
                               offload=True)
    ids, labels = cs._batch(torch, cs.GPT_WIDTH["vocab_size"],
                            cs.EAGER["batch"], cs.EAGER["seq"], dev)
    model.train_batch([ids], [labels])
    model.train_batch([ids], [labels], update=False)
    slots = [t for s in opt._state.values() for t in s.values()]
    out.update(slot_bytes=sum(t.numel() * t.element_size() for t in slots),
               numa=numa(torch, slots))
    print(f"numa: {out['numa']}", flush=True)
    out["routes_ms"] = routes(torch, cs, mtu, opt)
    for label, ms in out["routes_ms"].items():
        print(f"{label}: {ms:.4f} ms", flush=True)
    out["copies_after"] = cs.copy_rates(torch)
    for when in ("copies_before", "copies_after"):
        print(f"{when}: " + ", ".join(
            f"{k} {v['gb_per_s']:.2f} GB/s" for k, v in out[when].items()),
            flush=True)
    out["seconds"] = time.perf_counter() - t0
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
