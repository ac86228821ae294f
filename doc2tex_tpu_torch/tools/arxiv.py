"""arXiv LaTeX-source collection (copied from ``doc2tex_tpu.tools.arxiv``).

Parity target: reference ``doc2tex/tools/build_data/collect_latex/
arxiv.py:39-334``: thread-pooled download of e-print tarballs, .tex
extraction, math-environment mining via ``find_math``, optional demacro.

Only ``download_eprint`` (and ``collect``, through it) opens a network
connection; the extraction and mining functions work on local tarballs
and documents.
"""

from __future__ import annotations

import io
import os
import re
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

from ..latex.demacro import pydemacro
from ..latex.extract import find_math

ARXIV_SRC_URL = "https://arxiv.org/e-print/{id}"
_ID_PTN = re.compile(r"\d{4}\.\d{4,5}(v\d+)?|[a-z-]+/\d{7}")


def extract_tex_sources(tar_bytes: bytes) -> list[str]:
    """All .tex file contents from an e-print tarball (or a bare .tex)."""
    out = []
    try:
        with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tf:
            for member in tf.getmembers():
                if member.isfile() and member.name.endswith(".tex"):
                    f = tf.extractfile(member)
                    if f is not None:
                        out.append(f.read().decode("utf-8", errors="ignore"))
    except tarfile.TarError:
        # single uncompressed .tex source
        try:
            out.append(tar_bytes.decode("utf-8", errors="ignore"))
        except Exception:
            pass
    return out


def mine_document(tex: str, demacro: bool = True) -> list[str]:
    """Math expressions from one document (demacro -> find_math)."""
    if demacro:
        try:
            tex = pydemacro(tex)
        except Exception:
            pass
    return find_math(tex)


def mine_tarball(tar_bytes: bytes, demacro: bool = True) -> list[str]:
    found: list[str] = []
    for tex in extract_tex_sources(tar_bytes):
        found.extend(mine_document(tex, demacro=demacro))
    return sorted(set(found))


def download_eprint(arxiv_id: str, timeout: float = 30.0) -> bytes:
    """Fetch one e-print tarball (requires network)."""
    import urllib.request

    url = ARXIV_SRC_URL.format(id=arxiv_id)
    req = urllib.request.Request(url, headers={"User-Agent": "doc2tex-tpu"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def collect(
    arxiv_ids: Iterable[str],
    out_file: Optional[str] = None,
    workers: int = 8,
    demacro: bool = True,
) -> Iterator[str]:
    """Threaded collection (reference arxiv.py ThreadPool at :24,249)."""
    ids = [i for i in arxiv_ids if _ID_PTN.fullmatch(i)]

    def one(aid: str) -> list[str]:
        try:
            return mine_tarball(download_eprint(aid), demacro=demacro)
        except Exception:
            return []

    seen: set[str] = set()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for formulas in pool.map(one, ids):
            for f in formulas:
                if f not in seen:
                    seen.add(f)
                    yield f
    if out_file:
        with open(out_file, "w") as fh:
            for f in sorted(seen):
                fh.write(f + "\n")
