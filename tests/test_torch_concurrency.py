"""The port's runtime lock sanitizer (paddle_tpu_torch/utils/concurrency.py,
FLAGS_lock_san), held to the cases of the reference's
tests/test_lock_san.py: plain primitives when off, a two-lock inversion
caught at run time (warned at level 1, raised at level 2), no false
positives (RLock reentrancy, Condition wait and notify, try-locks,
cross-thread release), the wait and hold histograms and the long-hold
warning, and the thread registry and dumps.  The reference's static
LK01 case (its lint tool over the port) and its supervisor-signal case
(the distributed launcher) wait for those pieces of the port.
"""
import os
import signal
import threading
import time
import warnings

import pytest

from paddle_tpu_torch.profiler import metrics
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils import flags as _flags

@pytest.fixture()
def san_level():
    """Arm the sanitizer for one test; restore + clear the graph."""
    prev = _flags.get_flag("FLAGS_lock_san")
    prev_warn = _flags.get_flag("FLAGS_lock_hold_warn_ms")

    def arm(level, hold_warn_ms=0.0):
        _flags.set_flags({"FLAGS_lock_san": level,
                          "FLAGS_lock_hold_warn_ms": hold_warn_ms})
    cc.reset_graph()
    yield arm
    _flags.set_flags({"FLAGS_lock_san": prev,
                      "FLAGS_lock_hold_warn_ms": prev_warn})
    cc.reset_graph()


# ---------------------------------------------------------------------------
# off mode: plain primitives, no wrapper in the type
# ---------------------------------------------------------------------------
class TestOffMode:
    def test_plain_lock_types(self, san_level):
        san_level(0)
        assert type(cc.Lock()) is type(threading.Lock())  # noqa: E721
        assert type(cc.RLock()) is type(threading.RLock())  # noqa: E721
        assert type(cc.Condition()) is threading.Condition

    def test_condition_wraps_given_plain_lock(self, san_level):
        san_level(0)
        lk = threading.Lock()
        c = cc.Condition(lk)
        assert type(c) is threading.Condition
        with c:
            c.notify_all()

    def test_off_mode_records_nothing(self, san_level):
        san_level(0)
        a, b = cc.Lock(), cc.Lock()
        with a:
            with b:
                pass
        assert cc.order_graph() == {}
        assert cc.san_stats()["acquires"] == 0

    def test_lazy_lock_arms_after_construction(self, san_level):
        # module-level locks are built at import, before set_flags can
        # run: lazy mode re-reads the level per acquire, so arming the
        # sanitizer later still pulls them into the order graph
        san_level(0)
        a = cc.Lock(name="lazyA", lazy=True)
        b = cc.Lock(name="lazyB", lazy=True)
        with a:
            with b:
                pass
        assert cc.san_stats()["acquires"] == 0   # off: pure passthrough
        san_level(1)
        with a:
            with b:
                pass
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with b:
                with a:
                    pass
        assert any("lock-order cycle" in str(x.message) for x in w)
        assert "lazyB" in cc.order_graph()["lazyA"]


# ---------------------------------------------------------------------------
# the seeded two-lock inversion, caught at run time
# ---------------------------------------------------------------------------
INVERSION_SRC = '''
import threading

class Inverted:
    """Seeded defect: m1 orders A then B, m2 orders B then A."""
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
    def m1(self):
        with self._a:
            with self._b:
                pass
    def m2(self):
        with self._b:
            with self._a:
                pass
'''


class TestInversion:
    def test_runtime_catches_same_inversion_live(self, san_level):
        san_level(1)
        ns: dict = {}
        exec(compile(INVERSION_SRC, "seeded.py", "exec"),
             {"threading": _FactoryShim()}, ns)
        obj = ns["Inverted"]()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            obj.m1()
            obj.m2()
        msgs = [str(x.message) for x in w
                if "lock-order cycle" in str(x.message)]
        assert msgs, [str(x.message) for x in w]
        reports = cc.cycle_reports()
        assert len(reports) == 1
        assert set(reports[0]["cycle"]) >= {"Inverted._a", "Inverted._b"}
        assert cc.san_stats()["cycles"] == 1

    def test_level2_raises_at_the_closing_acquire(self, san_level):
        san_level(2)
        a = cc.Lock(name="L2A")
        b = cc.Lock(name="L2B")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(cc.LockOrderError,
                               match="lock-order cycle"):
                a.acquire()
        # graph recorded the edge even though the acquire never ran
        assert "L2A" in cc.order_graph()["L2B"]

    def test_warn_once_per_closing_edge(self, san_level):
        san_level(1)
        a = cc.Lock(name="W1")
        b = cc.Lock(name="W2")
        with a:
            with b:
                pass
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(3):
                with b:
                    with a:
                        pass
        msgs = [x for x in w if "lock-order cycle" in str(x.message)]
        assert len(msgs) == 1


class _FactoryShim:
    """Stands in for ``threading`` inside the seeded module so it runs on
    sanitizer locks, named after the attribute the class stores them
    under."""

    def __init__(self):
        self._n = {"Lock": 0}

    def Lock(self):
        name = ["Inverted._a", "Inverted._b"][self._n["Lock"] % 2]
        self._n["Lock"] += 1
        return cc.Lock(name=name)


# ---------------------------------------------------------------------------
# no false positives
# ---------------------------------------------------------------------------
class TestNoFalsePositives:
    def test_rlock_reentrancy(self, san_level):
        san_level(2)   # raise mode: any false report would fail loudly
        r = cc.RLock(name="RL")
        with r:
            with r:
                with r:
                    pass
        assert cc.san_stats()["cycles"] == 0
        assert cc.order_graph() == {}

    def test_consistent_order_never_reports(self, san_level):
        san_level(2)
        a, b, c = (cc.Lock(name=f"ord{i}") for i in range(3))
        for _ in range(5):
            with a:
                with b:
                    with c:
                        pass
        assert cc.san_stats()["cycles"] == 0

    def test_condition_wait_drops_held_entry(self, san_level):
        san_level(2)
        cond = cc.Condition(name="CV")
        other = cc.Lock(name="CVother")
        hits = []

        def waiter():
            with cond:
                cond.wait(timeout=5)
                hits.append(1)

        t = cc.spawn(waiter, name="cv-waiter")
        time.sleep(0.1)
        # while the waiter is parked it must NOT appear to hold CV
        assert not any("CV" in " ".join(v)
                       for v in cc.held_locks().values())
        # ordering CVother -> CV from this thread is fine (no inverse)
        with other:
            with cond:
                cond.notify_all()
        t.join(timeout=5)
        assert hits == [1]
        assert cc.san_stats()["cycles"] == 0

    def test_reentrant_condition_wait_fully_releases(self, san_level):
        # stdlib semantics: cond.wait under a reentrantly-held (depth
        # 2) RLock-backed condition releases ALL levels while parked —
        # the notifier must be able to get in
        san_level(2)
        cond = cc.Condition(name="CVre")
        woke = []

        def waiter():
            with cond:
                with cond:
                    cond.wait(timeout=10)
                    woke.append(1)

        t = cc.spawn(waiter, name="cv-re-waiter")
        time.sleep(0.1)
        acquired = cond.acquire(timeout=2)   # parked waiter must not own it
        assert acquired
        try:
            cond.notify_all()
        finally:
            cond.release()
        t.join(timeout=10)
        assert woke == [1]
        assert cc.san_stats()["cycles"] == 0

    def test_trylock_probe_on_owned_lock_returns_false(self, san_level):
        # plain threading semantics: acquire(False)/timed acquire on a
        # lock you own returns False — never a LockOrderError
        san_level(2)
        lk = cc.Lock(name="probe")
        lk.acquire()
        try:
            assert lk.acquire(False) is False
            assert lk.acquire(True, 0.01) is False
        finally:
            lk.release()

    def test_cross_thread_release_handoff(self, san_level):
        # threading.Lock may legally be released by a different thread
        # (hand-off/signal pattern): the acquirer's next acquire must
        # not read as a self-deadlock, and no bogus edges may appear
        san_level(2)
        lk = cc.Lock(name="handoff")
        other = cc.Lock(name="handoff.other")
        lk.acquire()

        def releaser():
            lk.release()

        t = cc.spawn(releaser, name="releaser")
        t.join(timeout=5)
        with other:     # no fabricated 'handoff -> handoff.other' edge
            pass
        assert "handoff.other" not in cc.order_graph().get("handoff", {})
        lk.acquire()    # would raise self-deadlock before the fix
        lk.release()
        assert cc.san_stats()["cycles"] == 0

    def test_trylock_never_trips_the_cycle_check(self, san_level):
        # try-lock/timed acquires cannot deadlock (they're the
        # deadlock-AVOIDANCE idiom): no edges, no raise, even when the
        # blocking path would close a cycle
        san_level(2)
        a = cc.Lock(name="TLA")
        b = cc.Lock(name="TLB")
        with a:
            with b:
                pass
        with b:
            assert a.acquire(False) is True   # inverse order, trylock
            a.release()
            assert a.acquire(True, 0.05) is True
            a.release()
        assert cc.san_stats()["cycles"] == 0
        assert "TLA" not in cc.order_graph().get("TLB", {})

    def test_wait_holding_other_lock_closes_cycle_at_park(self,
                                                          san_level):
        # waiter parks holding M; its wake re-acquire of the cond lock
        # is the M->cond edge — recorded at PARK time, so the classic
        # waiter-holds-M / notifier-needs-M deadlock is reported even
        # though the actual wake acquire happens inside stdlib wait()
        san_level(1)
        cond = cc.Condition(name="PC")
        m = cc.Lock(name="PM")
        with cond:
            with m:            # records PC -> PM
                pass
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with cond:
                with m:
                    cond.wait(timeout=0.05)   # parks holding PM
        assert any("lock-order cycle" in str(x.message) for x in w), \
            [str(x.message) for x in w]
        assert "PC" in cc.order_graph().get("PM", {})

    @pytest.mark.parametrize("lvl", [1, 2])
    def test_self_deadlock_detected_before_blocking(self, san_level,
                                                    lvl):
        # raises at BOTH levels: unlike an order cycle, this acquire
        # could never return — hanging would be strictly worse
        san_level(lvl)
        lk = cc.Lock(name=f"SD{lvl}")
        lk.acquire()
        try:
            with pytest.raises(cc.LockOrderError,
                               match="self-deadlock"):
                lk.acquire()   # would hang forever without the check
        finally:
            lk.release()


# ---------------------------------------------------------------------------
# contention + hold accounting
# ---------------------------------------------------------------------------
class TestAccounting:
    def test_wait_and_hold_histograms_recorded(self, san_level):
        san_level(1)
        lk = cc.Lock(name="contended.site")
        n_threads, n_iter = 4, 25

        def worker():
            for _ in range(n_iter):
                with lk:
                    pass

        ts = [cc.spawn(worker, name=f"c{i}") for i in range(n_threads)]
        for t in ts:
            t.join(timeout=30)
        wait_h = metrics.get("lock.wait_ms.contended.site")
        hold_h = metrics.get("lock.hold_ms.contended.site")
        assert wait_h is not None and hold_h is not None
        assert wait_h.count == n_threads * n_iter
        assert hold_h.count == n_threads * n_iter
        assert cc.san_stats()["acquires"] >= n_threads * n_iter

    def test_long_hold_warns_and_counts(self, san_level):
        san_level(1, hold_warn_ms=5.0)
        lk = cc.Lock(name="slow.site")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with lk:
                time.sleep(0.02)
        assert any("held for" in str(x.message) for x in w)
        assert cc.san_stats()["long_holds"] == 1

    def test_report_roundtrip(self, san_level, tmp_path):
        import json
        san_level(1)
        a, b = cc.Lock(name="RA"), cc.Lock(name="RB")
        with a:
            with b:
                pass
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            with b:
                with a:
                    pass
        path = str(tmp_path / "san.json")
        cc.write_report(path)
        rep = json.load(open(path))
        assert rep["cycles"] == 1
        assert rep["cycle_reports"][0]["cycle"]
        assert "RB" in rep["edges"]["RA"]


# ---------------------------------------------------------------------------
# thread registry + dumps
# ---------------------------------------------------------------------------
class TestDumps:
    def test_spawn_records_site_and_daemon(self):
        done = threading.Event()
        t = cc.spawn(done.wait, name="site-test", args=(5,))
        try:
            site = cc.thread_site(t)
            assert site and "test_torch_concurrency.py" in site
            assert t.daemon
        finally:
            done.set()
            t.join(timeout=5)

    def test_install_thread_registry_names_plain_threads(self,
                                                         monkeypatch):
        # the registry wraps threading.Thread.start process-wide: undo it
        # after the test, so that no later test of this process (the
        # reference's own registry among them) starts threads through it
        monkeypatch.setattr(threading.Thread, "start",
                            threading.Thread.start)
        monkeypatch.setattr(cc, "_registry_installed", False)
        cc.install_thread_registry()
        done = threading.Event()
        t = threading.Thread(target=done.wait, args=(5,), daemon=True)
        t.start()
        try:
            site = cc.thread_site(t)
            assert site and "test_torch_concurrency.py" in site
        finally:
            done.set()
            t.join(timeout=5)

    def test_held_locks_distinguishes_same_named_threads(self,
                                                         san_level):
        san_level(1)
        a, b = cc.Lock(name="twinA"), cc.Lock(name="twinB")
        release = threading.Event()
        started = []

        def holder(lock):
            with lock:
                started.append(1)
                release.wait(10)

        t1 = cc.spawn(holder, name="twin", args=(a,))
        t2 = cc.spawn(holder, name="twin", args=(b,))
        try:
            deadline = time.time() + 5
            while len(started) < 2 and time.time() < deadline:
                time.sleep(0.01)
            held = cc.held_locks()
            twin_lists = [v for k, v in held.items()
                          if k.startswith("twin#")]
            flat = " ".join(s for v in twin_lists for s in v)
            # both holders visible, not collapsed onto one name key
            assert len(twin_lists) == 2, held
            assert "twinA" in flat and "twinB" in flat
        finally:
            release.set()
            t1.join(timeout=5)
            t2.join(timeout=5)

    def test_dump_threads_lists_held_locks(self, san_level, capsys):
        import io
        san_level(1)
        lk = cc.Lock(name="dumped.lock")
        buf = io.StringIO()
        with lk:
            cc.dump_threads(buf)
        out = buf.getvalue()
        assert "lock-san thread dump" in out
        assert "dumped.lock" in out
        assert "MainThread" in out

    @pytest.mark.skipif(not hasattr(signal, "SIGUSR1"),
                        reason="no SIGUSR1 on this platform")
    def test_sigusr1_dump(self, san_level, capfd, monkeypatch):
        # the handler is process-wide: give the signal back afterwards
        prev = signal.getsignal(signal.SIGUSR1)
        monkeypatch.setattr(cc, "_installed_signals", set())
        try:
            san_level(1)
            assert cc.install_signal_dump()
            lk = cc.Lock(name="sig.lock")
            with lk:
                os.kill(os.getpid(), signal.SIGUSR1)
                time.sleep(0.1)
        finally:
            signal.signal(signal.SIGUSR1, prev)
        err = capfd.readouterr().err
        assert "lock-san thread dump" in err
        assert "sig.lock" in err
