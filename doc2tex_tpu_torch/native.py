"""ctypes bindings for the repository's native C++ host code (counterpart of
``doc2tex_tpu.native``): the edit distance, the LaTeX tokenizer, normalizer
and validator, and the PNG row unfilter of ``utils.png``.

The first three are the shared sources at the repository root (``native/
levenshtein.cpp``, ``native/latex_tokenizer.cpp`` and its table
``native/katex_tables.h``); the unfilter is the port's own
``csrc/png_unfilter.cpp``.  The first call builds them with ``g++ -O3
-shared -fPIC -std=c++17`` into one library in ``build/`` at the repository
root, named by the hash of the sources and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is; the JAX package's own
library in ``native/`` is never read or written.  This is host code, not a
kernel.  A failed build raises: callers get no silent Python stand-in (the
plain versions, ``eval.metrics._lev_py``, ``latex.pytok``,
``latex.validate`` and ``utils.png._unfilter_py``, are what the tests hold
this library to).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHARED = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build")
SOURCES = (os.path.join(_SHARED, "levenshtein.cpp"), os.path.join(_SHARED, "latex_tokenizer.cpp"),
           os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "png_unfilter.cpp"))
HEADERS = (os.path.join(_SHARED, "katex_tables.h"),)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in SOURCES + HEADERS:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"doc2tex_native-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) on PATH to build {', '.join(SOURCES)}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, *SOURCES, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file


def load():
    """Build (if needed) and load the library; one load per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        for name, item in (("d2t_lev_u8", ctypes.c_char_p), ("d2t_lev_u32", ctypes.c_uint32),
                           ("d2t_lev_u64", ctypes.c_uint64)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            ptr = item if item is ctypes.c_char_p else ctypes.POINTER(item)
            fn.argtypes = [ptr, ctypes.c_int, ptr, ctypes.c_int]
        for name in ("d2t_latex_normalize", "d2t_latex_validate"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.d2t_png_unfilter.restype = ctypes.c_int
        lib.d2t_png_unfilter.argtypes = [u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8]
        _lib = lib
        return lib


def _lev_u32(a: np.ndarray, b: np.ndarray) -> int:
    ptr = ctypes.POINTER(ctypes.c_uint32)
    return load().d2t_lev_u32(a.ctypes.data_as(ptr), len(a), b.ctypes.data_as(ptr), len(b))


def levenshtein(a, b) -> int:
    """Edit distance between two strings (by code point) or two sequences
    of hashables."""
    if isinstance(a, str) and isinstance(b, str):
        return _lev_u32(np.frombuffer(a.encode("utf-32-le"), dtype=np.uint32),
                        np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32))
    ids: dict = {}

    def to_ids(seq):
        return np.fromiter((ids.setdefault(x, len(ids)) for x in seq), np.uint32)

    return _lev_u32(to_ids(a), to_ids(b))


def levenshtein_u64(a: np.ndarray, b: np.ndarray) -> int:
    """Edit distance between two uint64 arrays (image column hashes)."""
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    ptr = ctypes.POINTER(ctypes.c_uint64)
    return load().d2t_lev_u64(a.ctypes.data_as(ptr), len(a), b.ctypes.data_as(ptr), len(b))


def _call(fn, raw: bytes, arg: int, cap: int) -> tuple[int, ctypes.Array]:
    """Call a string function; a negative return asks for that capacity."""
    buf = ctypes.create_string_buffer(cap)
    n = fn(raw, arg, buf, cap)
    if n < 0:
        buf = ctypes.create_string_buffer(-n)
        n = fn(raw, arg, buf, -n)
    return n, buf


def latex_validate(line: str, strict: bool = True):
    """KaTeX-grade parse validation: None if the formula parses, else the
    error message (the strings of ``latex.validate``)."""
    raw = line.encode("utf-8")
    n, buf = _call(load().d2t_latex_validate, raw, 1 if strict else 0,
                   max(len(raw) + 256, 1024))
    return None if n == 0 else buf.value.decode("utf-8")


def latex_normalize(line: str, mode: str = "normalize") -> str:
    """Canonical tokenization (``tokenize``) or normalization
    (``normalize``), as ``latex.pytok.normalize_string``."""
    raw = line.encode("utf-8")
    _, buf = _call(load().d2t_latex_normalize, raw, 0 if mode == "tokenize" else 1,
                   max(4 * len(raw) + 64, 1024))
    return buf.value.decode("utf-8")


def png_unfilter(raw: bytes, start: int, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``h`` PNG rows of ``stride`` bytes (each after
    its filter byte) from ``raw[start:]``: (h, stride) uint8.  ``raw`` must
    hold them all; an unknown filter type raises ``ValueError``."""
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1), start)
    out = np.empty((h, stride), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    err = load().d2t_png_unfilter(rows.ctypes.data_as(u8), h, stride, bpp, out.ctypes.data_as(u8))
    if err:
        raise ValueError(f"unknown PNG row filter {rows[(-1 - err) * (stride + 1)]}")
    return out
