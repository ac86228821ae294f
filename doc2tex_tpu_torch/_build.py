"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Each kernel source exposes a plain ``extern "C"`` launcher, so the build
needs only nvcc (no PyTorch headers, no ninja) and takes seconds.  The
shared library goes to ``build/`` at the repository root, named by the hash
of the source, flags and macros, so an edited source is rebuilt and an
unchanged one is loaded as it is.  A build holds a file lock beside the
library (``build_lock``), so processes that load at once (a mesh's ranks)
build it once: the others wait, then load it.  One source may be built more than once
with different macros (``defines``), each build its own library.  Nothing is built at import: the first launch, or
an explicit ``load_library`` call, builds.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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

_loaded: dict[tuple[str, tuple[str, ...]], tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@contextlib.contextmanager
def build_lock(lib_path: str):
    """Hold an exclusive lock on ``lib_path + ".lock"`` while the block
    runs (released when the process ends, so a killed build leaves none
    behind)."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    with open(lib_path + ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def load_library(source: str, defines: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load ``csrc/<source>``, with each macro of
    ``defines`` set (``-D``).

    Returns ``(library, info)``; ``info`` holds the library path, whether
    this call compiled it, the seconds the build took and nvcc's ``-Xptxas
    -v`` report (registers, shared memory, spills per kernel)."""
    key = (source, tuple(defines))
    if key in _loaded:
        return _loaded[key]
    src_path = os.path.join(CSRC, source)
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    stem = os.path.splitext(source)[0] + "".join(f"-{d.lower()}" for d in defines)
    lib_path = os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")
    info = {"path": lib_path, "built": False, "seconds": 0.0, "ptxas": ""}
    if not os.path.exists(lib_path):
        with build_lock(lib_path):
            if not os.path.exists(lib_path):   # another process may have built it meanwhile
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *flags, "-o", tmp, src_path]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=NVCC_TIMEOUT_S)
                info["seconds"] = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) on {src_path}:\n"
                        f"{proc.stdout}\n{proc.stderr}"
                    )
                os.replace(tmp, lib_path)  # atomic: a loader never sees half a file
                info["built"] = True
                info["ptxas"] = proc.stderr
    lib = ctypes.CDLL(lib_path)
    _loaded[key] = (lib, info)
    return lib, info
