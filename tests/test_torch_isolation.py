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
from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.incubate.nn import (FusedBiasDropoutResidualLayerNorm,
                                          FusedTransformerEncoderLayer)
from paddle_tpu_torch.models import (GPT, GPTConfig, build_spmd_train_step,
                                     fused_transformer_state_from_paddle_tpu,
                                     gpt_spmd_state_from_paddle_tpu,
                                     gpt_state_from_paddle_tpu)
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
            "paddle_tpu_torch.ops.nn_misc, "
            "paddle_tpu_torch.ops.flash_attention_qkv, "
            "paddle_tpu_torch.ops.softmax_xent, "
            "paddle_tpu_torch.models.gpt_spmd, "
            "paddle_tpu_torch.tools.profile_train, paddle_tpu_torch.hapi, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.nn, "
            "paddle_tpu_torch.ops.loss, paddle_tpu_torch.incubate.nn, "
            "paddle_tpu_torch.incubate.nn.functional, "
            "paddle_tpu_torch.ops.fused_ops, paddle_tpu_torch.ops.fused_ln, "
            "paddle_tpu_torch.random, paddle_tpu_torch.io, "
            "paddle_tpu_torch.io.prefetch, paddle_tpu_torch.metric, "
            "paddle_tpu_torch.callbacks, paddle_tpu_torch.hapi.callbacks, "
            "paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.nn.clip, "
            "paddle_tpu_torch.optimizer.fused_update, "
            "paddle_tpu_torch.ops.multi_tensor_update, "
            "paddle_tpu_torch.framework_io, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.distributed.checkpoint, "
            "paddle_tpu_torch.profiler, paddle_tpu_torch.profiler.metrics, "
            "paddle_tpu_torch.profiler.flight, paddle_tpu_torch.utils.chaos, "
            "paddle_tpu_torch.utils.resilience\n"
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
    with pytest.raises(NoCudaDevice):
        build_spmd_train_step(cfg)
    with pytest.raises(NoCudaDevice):
        gpt_spmd_state_from_paddle_tpu({"wte": np.zeros((11, 8))})
    with pytest.raises(NoCudaDevice):
        FusedTransformerEncoderLayer(8, 2, 16)
    with pytest.raises(NoCudaDevice):
        FusedBiasDropoutResidualLayerNorm(8)
    with pytest.raises(NoCudaDevice):
        fused_transformer_state_from_paddle_tpu({"ln_bias": np.zeros(8)})
    with pytest.raises(NoCudaDevice):
        DevicePrefetcher(iter([]), depth=2)
    assert DevicePrefetcher(iter([]), device="cpu").device.type == "cpu"
    assert FusedTransformerEncoderLayer(
        8, 2, 16, device="cpu").ffn.linear1_weight.is_cpu
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


def test_build_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert before == {name: _build.library_path(name)
                      for name in _build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(after[name] != before[name] for name in _build.SOURCES)
    assert {"flash_attn_fwd", "flash_attn_bwd", "softmax_xent_fwd",
            "softmax_xent_dlogits", "fused_ln"} <= set(_build.SOURCES)


def test_a_failing_source_leaves_the_others_built(tmp_path, monkeypatch):
    # a stand-in for nvcc: fails on csrc/bad.cu, else writes its output
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n" + (
        "import sys\n"
        "args = sys.argv[1:]\n"
        "if any(a.endswith('bad.cu') for a in args):\n"
        "    sys.exit('bad.cu: error')\n"
        "open(args[args.index('-o') + 1], 'w').close()\n"))
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("bad", "fused_ln_bwd", "good"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    with pytest.raises(_build.BuildError, match="bad.cu"):
        _build.build(["bad", "fused_ln_bwd", "good"])
    assert not _build.library_path("bad").exists()
    # the parted source linked its objects, and none is left behind
    assert _build.library_path("fused_ln_bwd").exists()
    assert _build.library_path("good").exists()
    assert not list((tmp_path / "build").glob("*.o"))


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
