"""Test harness config: run on a virtual 8-device CPU mesh.

Mirrors the reference's TestDistBase strategy (test_dist_base.py:778) of
simulating multi-device on one host — here via XLA's host-platform device
count instead of multi-process NCCL.
"""
import os
import sys

# Must happen before jax backend init.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if repo_root not in sys.path:
    sys.path.insert(0, repo_root)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def free_port():
    """Unused TCP port (shared test helper)."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def free_launch_port():
    """A master_port whose coordinator neighbor (port-1) is also free —
    the launcher binds hosts[0]:(master_port - 1) for jax.distributed."""
    import socket
    for _ in range(64):
        p = free_port()
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", p - 1))
            s.close()
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair found")


# ---------------------------------------------------------------------------
# slow tier (reference gates CI on runtime, tools/check_ctest_hung.py):
# tests marked @pytest.mark.slow are skipped unless --runslow (or
# PADDLE_RUN_SLOW=1).  Keeps `pytest tests -q` under the 10-minute
# single-core budget; the slow tier still runs opt-in.
# ---------------------------------------------------------------------------
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running (launcher/multi-process/big-model) "
        "tests; opt in with --runslow or PADDLE_RUN_SLOW=1")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (paddle_tpu_torch kernels); "
        "skips inside the test when torch.cuda.is_available() is false")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("PADDLE_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


# ---------------------------------------------------------------------------
# thread-leak canary (conc-san): every test module must clean up its
# non-daemon threads.  A leaked non-daemon thread wedges interpreter
# shutdown (the exact close()-hang bug class the concurrency sanitizer
# exists for), and the leaking module is usually NOT the one that
# times out in CI — so name the culprit at the moment of the leak.
# Creation sites come from the sanitizer thread registry.  Disable
# with PADDLE_THREAD_CANARY=0 when bisecting.
# ---------------------------------------------------------------------------
import threading  # noqa: E402

from paddle_tpu.utils import concurrency as _conc  # noqa: E402

_conc.install_thread_registry()


@pytest.fixture(autouse=True, scope="module")
def _thread_leak_canary(request):
    if os.environ.get("PADDLE_THREAD_CANARY", "1") == "0":
        yield
        return
    before = set(threading.enumerate())
    yield
    # grace: servers/executors shut down asynchronously — give their
    # threads a moment to finish before calling them leaked
    deadline = 2.0
    step = 0.05
    import time
    leaked = []
    while deadline > 0:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive() and not t.daemon]
        if not leaked:
            break
        time.sleep(step)
        deadline -= step
    if leaked:
        names = []
        for t in leaked:
            site = _conc.thread_site(t)
            names.append(f"'{t.name}'"
                         + (f" (started at {site})" if site else ""))
        pytest.fail(
            f"{request.node.name} leaked {len(leaked)} non-daemon "
            f"thread(s): {', '.join(names)} — join them (or mark them "
            "daemon) on the module's teardown path; a leaked "
            "non-daemon thread blocks interpreter shutdown",
            pytrace=False)
