"""Device time of one call on the card, from ``torch.profiler`` traces that
are checked for lost records.

CUPTI, under ``torch.profiler``, at times delivers only part of a
session's kernel records, more so once CUDA graphs have run in the
process.  Seen on the H100: a trace at ~60% of the others, an empty one,
and, late in ``chip_smoke.py`` runs, sessions that lost the records of
the kernels that ran in their first milliseconds (a single call's trace
held none of its one kernel, ten calls' nine of ten; with a 5 ms
sentinel and two calls ahead, every record up to the call after them).
So :func:`device_ms_per_call` traces one session of a ~20 ms sentinel
kernel (``torch.cuda._sleep``), a short one, two calls it does not
count, a sentinel, one call, a sentinel, ``reps`` calls and two
sentinels.  It sums the last two runs of kernels that sentinels bound
on both sides, the one call and the ``reps`` calls, only when the
second holds ``reps`` times the kernels of the first; otherwise it
traces again, up to ``attempts`` times, and then raises.

This module imports torch alone, so ``tools/kernel_ab.py`` loads it by
path beside whichever checkout it times.
"""
from __future__ import annotations

import torch

__all__ = ["device_ms_per_call"]

SENTINEL_CYCLES = 2000
LEAD_CYCLES = 40_000_000        # ~20 ms at the H100's clock
_sentinel_names: set = set()


def _traced(calls):
    """The device events of one profiled session around ``calls()``,
    padded with two sentinel kernels at each end (the first a long one),
    in start order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda._sleep(SENTINEL_CYCLES)
        calls()
        for _ in range(2):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def _learn_sentinel(attempts: int = 4) -> None:
    """The sentinel kernel's name, from a session of sentinels only, with
    a second long one before the last five (past a lost first window)."""
    def sentinels():
        torch.cuda._sleep(LEAD_CYCLES)
        for _ in range(3):
            torch.cuda._sleep(SENTINEL_CYCLES)

    for _ in range(attempts):
        names = {e.name for e in _traced(sentinels)}
        if names:
            _sentinel_names.update(names)
            return
    raise RuntimeError("the profiler recorded no sentinel kernel")


def _runs(events):
    """The runs of kernels between consecutive sentinels of a session
    (kernels with no sentinel before or after them are in none), without
    the empty ones at either end (where a session's doubled sentinels
    meet, or lost one)."""
    runs, run, opened = [], [], False
    for e in events:
        if e.name in _sentinel_names:
            if opened:
                runs.append(run)
            run, opened = [], True
        else:
            run.append(e)
    while runs and not runs[0]:
        runs.pop(0)
    while runs and not runs[-1]:
        runs.pop()
    return runs


def device_ms_per_call(fn, reps: int = 10, warmup: int = 3,
                       attempts: int = 4) -> float:
    """Device time of one ``fn()``: every kernel it launches, summed over
    ``reps`` calls and divided by ``reps`` (host time between the launches
    is not counted, unlike CUDA events around a call).  ``fn`` must launch
    the same kernels at every call."""
    if not _sentinel_names:
        _learn_sentinel()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def session():
        for _ in range(2):
            fn()
        torch.cuda._sleep(SENTINEL_CYCLES)
        fn()
        torch.cuda._sleep(SENTINEL_CYCLES)
        for _ in range(reps):
            fn()

    counts = []
    for _ in range(attempts):
        runs = _runs(_traced(session))
        counts.append([len(r) for r in runs])
        if len(runs) < 2:
            continue
        one, many = runs[-2:]
        if one and len(many) == reps * len(one):
            return sum(e.time_range.elapsed_us() for e in many) / 1e3 / reps
    raise RuntimeError(f"the profiler's traces lost device records in "
                       f"{attempts} attempts (kernels between the "
                       f"sentinels, two calls, one, then {reps}: {counts})")
