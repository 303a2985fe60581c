"""Build the package's CUDA sources and load them through ctypes.

Every ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, placed in
``paddle_tpu_torch/_build/`` at first use and loaded with ``ctypes``.
The library's file name carries a digest of its source, of every shared
header (``csrc/*.cuh``) and of the flags, so an edited source or header
builds anew and an unchanged one is reused by later processes of the same
checkout.  Nothing is prebuilt or checked in.

A source named in :data:`PARTS` compiles in parts, each with
``-DBUILD_PART=<k>`` into an object of its own, all at once, and the
objects link into its library: nvcc compiles one translation unit on one
core, and ``csrc/fused_ln_bwd.cu``'s seven type pairs took it ~67 s in
one unit, the longest build of all (on the H100 machine's CPU).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["NVCC_FLAGS", "SOURCES", "PARTS", "BuildError", "nvcc",
           "library_path", "build", "load"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel sources by name (csrc/<name>.cu)
SOURCES = tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))
# sources compiled in parts (BUILD_PART 0 .. n - 1), then linked
PARTS = {"fused_ln_bwd": 3}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its stderr."""


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels build only where the toolkit is")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, the shared
    headers it may include and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode() + b"\0%d" % PARTS.get(name, 0))
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source (per part of a source of :data:`PARTS`, whose
    objects then link into its library), all started together.  Returns,
    per name, the library path, the seconds its build took (0.0 when it
    was already built) and the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills).  Raises :class:`BuildError` with
    nvcc's stderr; the sources that built keep their libraries."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0, "report": ""}
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        src = str(CSRC_DIR / f"{name}.cu")
        if name in PARTS:
            objs = [lib.with_name(f"{lib.stem}.{os.getpid()}.{k}.o")
                    for k in range(PARTS[name])]
            cmds = [[nvcc(), *(f for f in NVCC_FLAGS if f != "-shared"),
                     f"-DBUILD_PART={k}", "-c", "-o", str(obj), src]
                    for k, obj in enumerate(objs)]
        else:
            objs, cmds = [], [[nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]]
        procs[name] = (lib, tmp, objs, [subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd in cmds])
    failures = []
    for name, (lib, tmp, objs, running) in procs.items():
        reports, errors = [], []
        for proc in running:
            stdout, stderr = proc.communicate()
            reports.append((stdout + stderr).strip())
            if proc.returncode != 0:
                errors.append(f"nvcc failed on csrc/{name}.cu "
                              f"(exit {proc.returncode}):\n{stderr}")
        if objs and not errors:
            link = subprocess.run(
                [nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            if link.returncode != 0:
                errors.append(f"nvcc failed to link csrc/{name}.cu "
                              f"(exit {link.returncode}):\n{link.stderr}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        if errors:
            failures += errors
            continue
        os.replace(tmp, lib)       # atomic: a concurrent reader sees all
        out[name] = {"path": str(lib),
                     "seconds": time.perf_counter() - t0,
                     "report": "\n".join(reports)}
    if failures:
        raise BuildError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
