"""The repository's static gates over the port: ``tools/conc_lint.py``
(lock order, blocking under a lock, unguarded attributes, unjoined
threads) and ``tools/framework_lint.py`` each report no finding in
``paddle_tpu_torch/``, and the lock-order gate sees the locks the port
makes through its own factories (``paddle_tpu_torch/utils/concurrency.py``):
the seeded two-lock inversion of ``tests/test_lock_san.py``, written with
them, is one LK01."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")

INVERSION_SRC = '''
from paddle_tpu_torch.utils import concurrency as _conc

class Inverted:
    """Seeded defect: m1 orders A then B, m2 orders B then A."""
    def __init__(self):
        self._a = _conc.Lock(name="seeded.a")
        self._b = _conc.Lock(name="seeded.b")
    def m1(self):
        with self._a:
            with self._b:
                pass
    def m2(self):
        with self._b:
            with self._a:
                pass
'''


@pytest.mark.parametrize("tool, args", [
    ("conc_lint.py", ["--no-baseline"]),
    ("framework_lint.py", []),
])
def test_the_port_passes_the_gate(tool, args):
    r = subprocess.run([sys.executable, os.path.join(TOOLS, tool), *args,
                        os.path.join(ROOT, "paddle_tpu_torch")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "0 finding(s)" in r.stdout.splitlines()[-1]


def test_static_lk01_sees_the_port_lock_factories():
    sys.path.insert(0, TOOLS)
    try:
        from conc_lint import lint_source
    finally:
        sys.path.remove(TOOLS)
    findings = lint_source(INVERSION_SRC, "seeded.py")
    lk01 = [f for f in findings if f.code == "LK01"]
    assert len(lk01) == 1, findings
    assert "seeded.Inverted._a" in lk01[0].detail
    assert "seeded.Inverted._b" in lk01[0].detail
