"""paddle_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless the caller asks for
the CPU by name."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import NoCudaDevice, resolve_device
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as pfa

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.models, "
            "paddle_tpu_torch.generation, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.ops.nn_misc\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_the_card_or_an_explicit_cpu(no_card):
    cfg = GPTConfig(vocab_size=11, hidden_size=8, num_layers=1,
                    num_heads=2, max_seq_len=8)
    with pytest.raises(NoCudaDevice):
        resolve_device()
    with pytest.raises(NoCudaDevice):
        resolve_device("cuda:0")
    with pytest.raises(NoCudaDevice):
        GPT(cfg)
    with pytest.raises(NoCudaDevice):
        gpt_state_from_paddle_tpu({"wte.weight": np.zeros((11, 8))})
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
    net = GPT(cfg, device="cpu")
    assert net.device.type == "cpu"
    assert gpt_state_from_paddle_tpu({"wte.weight": np.zeros((11, 8))},
                                     device="cpu")["wte.weight"].is_cpu


def test_wrapper_runs_only_on_cuda_or_cpu():
    q = torch.empty((2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pfa.flash_attn_fwd(q, q, q)


def test_build_is_keyed_by_source_and_refuses_without_nvcc(monkeypatch):
    path = _build.library_path("flash_attn_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("flash_attn_fwd-") and path.suffix == ".so"
    assert "flash_attn_fwd" in _build.SOURCES
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.nvcc()


def _run_smoke(script, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(REPO / "chip_smoke.py", REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    res = _run_smoke(alone, tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
