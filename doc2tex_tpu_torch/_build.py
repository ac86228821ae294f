"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Each kernel source exposes a plain ``extern "C"`` launcher, so the build
needs only nvcc (no PyTorch headers, no ninja) and takes seconds.  The
shared library goes to ``build/`` at the repository root, named by the hash
of the source and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  Nothing is built at import: the first launch, or
an explicit ``load_library`` call, builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_ROOT, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_loaded: dict[str, tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load_library(source: str) -> tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load ``csrc/<source>``.

    Returns ``(library, info)``; ``info`` holds the library path, whether
    this call compiled it, the seconds the build took and nvcc's ``-Xptxas
    -v`` report (registers, shared memory, spills per kernel)."""
    if source in _loaded:
        return _loaded[source]
    src_path = os.path.join(CSRC, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")
    info = {"path": lib_path, "built": False, "seconds": 0.0, "ptxas": ""}
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        info["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src_path}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
        info["built"] = True
        info["ptxas"] = proc.stderr
    lib = ctypes.CDLL(lib_path)
    _loaded[source] = (lib, info)
    return lib, info
