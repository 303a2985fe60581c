"""paddle_tpu_torch.tools.device_time, the device timer of chip_smoke.py's
phase 6 and tools/kernel_ab.py, against a stand-in profiler on the CPU.

CUPTI drops kernel records at times (the first measured kernel of a
session, a record at its boundary, or a share of it).  The timer traces
sentinels, two calls it does not count, a sentinel, one call, a
sentinel, N calls and sentinels in one session and counts it only when
the N calls hold N times the one call's kernels; these tests hold that a
trace that lost records is never summed.
"""
import types

import pytest
import torch

from paddle_tpu_torch.tools import device_time as dt

CUDA = torch.autograd.DeviceType.CUDA
KERNEL_US = 5.0


class Card:
    """Kernels launched so far, and a profiler that hands back the records
    of its session after ``drop(records, session)`` took some away."""

    def __init__(self, drop):
        self.launched, self.sessions, self.drop = [], 0, drop

    def kernels(self, k):
        def fn():
            self.launched += [("attn", KERNEL_US)] * k
        return fn

    def sleep(self, cycles):
        # ~2 GHz: the sentinel's cycles as microseconds
        self.launched.append(("spin_kernel", cycles / 2000.0))

    def profile(self, **kw):
        card = self

        class Session:
            def __enter__(self):
                self.start = len(card.launched)
                return self

            def __exit__(self, *exc):
                records = card.launched[self.start:]
                card.sessions += 1
                self.records = card.drop(records, card.sessions)

            def events(self):
                return [types.SimpleNamespace(
                    name=n, device_type=CUDA,
                    time_range=types.SimpleNamespace(
                        start=i, elapsed_us=lambda us=us: us))
                    for i, (n, us) in enumerate(self.records)]
        return Session()


@pytest.fixture
def card(monkeypatch, request):
    c = Card(request.param)
    monkeypatch.setattr(torch.profiler, "profile", c.profile)
    monkeypatch.setattr(torch.cuda, "_sleep", c.sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(dt, "_sentinel_names", set())
    return c


def _first_lost(records, session):
    return records[1:]


def _share_lost_once(records, session):
    # the second session (the first measurement) keeps its first 60%
    return records[:int(0.6 * len(records))] if session == 2 else records


def _middle_lost_once(records, session):
    # the first measurement loses a kernel of its ten calls
    return records[:-3] + records[-2:] if session == 2 else records


def _first_kernel_lost(records, session):
    # as seen on the card: the session's first kernel that is no sentinel
    first = next((i for i, (n, _) in enumerate(records)
                  if n != "spin_kernel"), None)
    return records if first is None else records[:first] + records[first + 1:]


def _first_of_each_name_lost(records, session):
    seen, kept = set(), []
    for r in records:
        if r[0] in seen or r[0] == "spin_kernel":
            kept.append(r)
        seen.add(r[0])
    return kept


def _early_lost(records, session):
    # as seen on the card: the records of the kernels that ran in the
    # session's first 200 us (here, those that started then)
    kept, t = [], 0.0
    for name, us in records:
        if t >= 200.0:
            kept.append((name, us))
        t += us
    return kept


def _up_to_the_third_sentinel_lost(records, session):
    # as seen on the card: every record up to the one call's sentinel
    seen = 0
    for i, (name, _) in enumerate(records):
        seen += name == "spin_kernel"
        if seen == 3:
            return records[i:]
    return records


def _always_short(records, session):
    # both end sentinels and the last kernel of the N calls
    return records[:-3] if len(records) > 5 else records


@pytest.mark.parametrize("card", [_first_lost, _share_lost_once,
                                  _middle_lost_once, _first_kernel_lost,
                                  _first_of_each_name_lost, _early_lost,
                                  _up_to_the_third_sentinel_lost],
                         indirect=True)
@pytest.mark.parametrize("k", [1, 3])
def test_a_lost_record_is_never_summed(card, k):
    # one call launches k kernels of 5 us: 5k us a call, whatever is lost
    assert dt.device_ms_per_call(card.kernels(k), reps=10) == \
        pytest.approx(k * KERNEL_US / 1e3)
    assert dt._sentinel_names == {"spin_kernel"}


@pytest.mark.parametrize("card", [_always_short], indirect=True)
def test_traces_that_keep_losing_records_raise(card):
    with pytest.raises(RuntimeError, match="lost device records"):
        dt.device_ms_per_call(card.kernels(3), reps=10)
