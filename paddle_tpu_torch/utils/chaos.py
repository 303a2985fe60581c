"""Deterministic fault-injection registry ("chaos layer") — the port's copy
of ``paddle_tpu/utils/chaos.py``.

Named sites call :func:`hit` behind the module-level ``active``
predicate; a spec armed via ``FLAGS_chaos_spec`` (the port's flag
registry, :func:`paddle_tpu_torch.set_flags`) decides which calls fail,
stall, or poison a value.  Schedules are fully deterministic: occurrence
selectors count per-site calls, and probabilistic selectors draw from a
per-site ``random.Random(FLAGS_chaos_seed ^ crc32(site))`` — so a spec
and a seed give the reference's schedule exactly.

Spec grammar (sites separated by ``;``)::

    site:action[@selector]

    action    := fail | delay=<seconds> | nan
    selector  := <n>         exactly the n-th call (1-based)
               | <n>-<m>     calls n..m inclusive
               | <n>-        every call from n on
               | p=<prob>    each call independently, seeded RNG
               | (absent)    every call

Example: ``"ckpt.write:fail@3;host.slow:delay=0.5@2-4"`` fails the 3rd
checkpoint write and delays steps 2-4 of the fit loop by 500 ms.

The port's sites so far (each costs ONE predicate read when no spec is
set)::

    ckpt.write       distributed/checkpoint.py commit path
    step.loss        hapi Model train step (``nan`` poisons the loss)
    host.slow        hapi Model.fit step loop (``delay`` stretches the
                     step's wall time)

:data:`SITES` lists every site of the reference; the others arrive with
their modules.  Injections are counted in the metrics registry:
``chaos.injected`` (total) and ``chaos.injected.<site>``.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, Optional

from . import flags as _flags

__all__ = ["active", "ChaosError", "SITES", "parse_spec", "configure",
           "refresh", "hit", "call_count", "reset"]

SITES = ("ckpt.write", "store.rpc", "store.partition", "fs.rename",
         "loader.worker", "step.loss", "host.slow", "serve.request",
         "kv.block_alloc", "router.dispatch", "fleet.lease",
         "ps.pull", "ps.push", "ps.shard_down", "serve.preempt",
         "kv.transfer")

# module-level fast predicate — the single read hot paths gate on
active = False


class ChaosError(RuntimeError):
    """Default exception for an injected ``fail`` action."""


class _Rule:
    __slots__ = ("kind", "value", "lo", "hi", "prob")

    def __init__(self, kind, value=None, lo=None, hi=None, prob=None):
        self.kind = kind      # 'fail' | 'delay' | 'nan'
        self.value = value    # delay seconds
        self.lo = lo          # 1-based inclusive call range
        self.hi = hi
        self.prob = prob      # independent per-call probability

    def matches_count(self, n: int) -> bool:
        if self.lo is not None and n < self.lo:
            return False
        if self.hi is not None and n > self.hi:
            return False
        return True


def _parse_selector(sel: str, rule: _Rule, part: str):
    if not sel:
        return
    if sel.startswith("p="):
        rule.prob = float(sel[2:])
        if not 0.0 <= rule.prob <= 1.0:
            raise ValueError(f"chaos spec {part!r}: p must be in [0,1]")
        return
    if "-" in sel:
        lo, _, hi = sel.partition("-")
        rule.lo = int(lo)
        rule.hi = int(hi) if hi else None
        return
    rule.lo = rule.hi = int(sel)


def parse_spec(spec: str) -> Dict[str, List[_Rule]]:
    """Parse a chaos spec string; raises ValueError naming the bad part
    and the grammar."""
    rules: Dict[str, List[_Rule]] = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        site, sep, action = part.partition(":")
        if not sep or not site or not action:
            raise ValueError(
                f"chaos spec part {part!r}: expected site:action[@sel] "
                f"(grammar: fail | delay=<s> | nan, sel: n | n-m | n- | "
                f"p=<prob>)")
        act, _, sel = action.partition("@")
        if act == "fail":
            rule = _Rule("fail")
        elif act.startswith("delay="):
            rule = _Rule("delay", value=float(act[len("delay="):]))
        elif act == "nan":
            rule = _Rule("nan")
        else:
            raise ValueError(
                f"chaos spec part {part!r}: unknown action {act!r} "
                f"(expected fail | delay=<seconds> | nan)")
        _parse_selector(sel, rule, part)
        rules.setdefault(site.strip(), []).append(rule)
    return rules


_lock = threading.Lock()
_rules: Dict[str, List[_Rule]] = {}
_counts: Dict[str, int] = {}
_rngs: Dict[str, "random.Random"] = {}
_seed = 0
_spec = ""


def _site_rng(site: str):
    import random
    rng = _rngs.get(site)
    if rng is None:
        # crc32 keeps the per-site stream stable across processes
        # (hash() is salted per interpreter)
        rng = random.Random(_seed ^ zlib.crc32(site.encode()))
        _rngs[site] = rng
    return rng


def configure(spec: Optional[str] = None, seed: Optional[int] = None):
    """(Re)arm the registry.  ``None`` reads the flags.  Resets call
    counters and per-site RNGs so a schedule replays from the start."""
    global active, _rules, _seed, _spec
    if spec is None:
        spec = _flags.get_flag("FLAGS_chaos_spec")
    if seed is None:
        seed = _flags.get_flag("FLAGS_chaos_seed")
    with _lock:
        _spec = spec or ""
        _seed = int(seed)
        _rules = parse_spec(_spec)
        _counts.clear()
        _rngs.clear()
        active = bool(_rules)


def refresh():
    """Flags-change hook: reconfigure only when the spec/seed actually
    changed (unrelated set_flags must not reset injection schedules)."""
    spec = _flags.get_flag("FLAGS_chaos_spec")
    seed = int(_flags.get_flag("FLAGS_chaos_seed"))
    if (spec or "") != _spec or seed != _seed:
        configure(spec, seed)


def reset():
    """Disarm everything and zero counters (test teardown)."""
    global active, _rules, _spec
    with _lock:
        _rules = {}
        _spec = ""
        _counts.clear()
        _rngs.clear()
        active = False


def call_count(site: str) -> int:
    return _counts.get(site, 0)


def hit(site: str, exc=None) -> Optional[str]:
    """One visit to ``site``.  Applies the first matching rule:
    ``fail`` raises ``exc`` (or :class:`ChaosError`), ``delay`` sleeps
    and returns ``"delay"``, ``nan`` returns ``"nan"`` for the caller
    to poison its value.  Returns None when nothing fires.

    Callers must gate on the module predicate so a disarmed registry
    costs one read::

        if _chaos.active:
            _chaos.hit("store.rpc", exc=ConnectionRefusedError)
    """
    with _lock:
        n = _counts.get(site, 0) + 1
        _counts[site] = n
        rules = _rules.get(site)
        if not rules:
            return None
        fired = None
        for r in rules:
            if not r.matches_count(n):
                continue
            if r.prob is not None and _site_rng(site).random() >= r.prob:
                continue
            fired = r
            break
    if fired is None:
        return None
    from ..profiler import metrics as _metrics
    _metrics.counter("chaos.injected",
                     "total chaos-layer fault injections").inc()
    _metrics.counter(f"chaos.injected.{site}").inc()
    from ..profiler import flight as _flight
    if _flight.active:
        # injected faults are exactly what a post-mortem needs to see
        # in sequence with the admission/slot/ckpt events around them
        _flight.note("chaos", site, kind=fired.kind, call=n)
    if fired.kind == "fail":
        cls = exc or ChaosError
        raise cls(f"chaos: injected failure at {site} (call {n})")
    if fired.kind == "delay":
        time.sleep(fired.value)
        return "delay"
    return fired.kind


# arm from env/flags at import so launcher-spawned workers inherit the
# spec without any call-site setup; set_flags re-arms via the observer
_flags.on_change(refresh)
configure()
