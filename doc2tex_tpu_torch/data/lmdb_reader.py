"""LMDB dataset stores with the reference key schema (counterpart of
``doc2tex_tpu.data.lmdb_reader``).

Keys (``doc2tex/data/lmdb_dataset.py:12-101``, writer
``doc2tex/tools/lmdb_builders/create_lmdb_dataset.py:36-98``):
``image-%09d`` (encoded image bytes), ``label-%09d`` (utf-8),
``name-%09d`` (utf-8), ``height-%09d``/``width-%09d`` (int32 bytes) and
``num-samples``; indices start at 1.

The store is read and written by the pure-Python MDB code of
``pylmdb.py`` (the ``lmdb`` package is not used), and images are decoded
by ``utils.png.decode_png``, which gives PIL's ``convert("L")`` (or
``convert("RGB")``) bytes.  An image that PIL could not open either
becomes the JAX package's 32x32 dummy; JPEG bytes (and GIF, BMP,
TIFF or WebP bytes), which PIL reads, raise instead (ROADMAP A11).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils.png import decode_png, encode_png
from .pylmdb import PyLmdbReader, write_pylmdb

KEY_IMAGE = "image-%09d"
KEY_LABEL = "label-%09d"
KEY_NAME = "name-%09d"
KEY_HEIGHT = "height-%09d"
KEY_WIDTH = "width-%09d"
KEY_NUM_SAMPLES = "num-samples"

# formats PIL opens that decode_png does not: (magic, offset, name)
_OTHER_FORMATS = ((b"\xff\xd8\xff", 0, "JPEG"), (b"GIF8", 0, "GIF"), (b"BM", 0, "BMP"),
                  (b"II*\x00", 0, "TIFF"), (b"MM\x00*", 0, "TIFF"), (b"WEBP", 8, "WebP"))


def decode_image(raw: bytes, rgb: bool = False, what: str = "image") -> np.ndarray:
    """Encoded image bytes -> (H, W) or (H, W, 3) uint8.  A JPEG (or
    another format PIL reads) raises ``NotImplementedError``; anything
    else ``decode_png`` refuses raises its ``ValueError``."""
    for magic, at, fmt in _OTHER_FORMATS:
        if raw[at:at + len(magic)] == magic:
            raise NotImplementedError(f"{what} is a {fmt}; only PNG is decoded, {fmt} "
                                      "decoding is not ported yet (ROADMAP A11)")
    return decode_png(raw, rgb=rgb)


class LmdbReader:
    """Read-only store with the reference key schema; 1-based indices."""

    def __init__(self, root: str, rgb: bool = False):
        self.root = root
        self.rgb = rgb
        self.txn = PyLmdbReader(root)
        self.num_samples = int(self.txn.get(KEY_NUM_SAMPLES.encode()))

    def __len__(self) -> int:
        return self.num_samples

    def label(self, idx: int) -> str:
        return self.txn.get((KEY_LABEL % idx).encode()).decode("utf-8")

    def name(self, idx: int) -> str:
        raw = self.txn.get((KEY_NAME % idx).encode())
        return raw.decode("utf-8") if raw is not None else str(idx)

    def size(self, idx: int) -> tuple[int, int]:
        """(h, w) from the int32 sidecar keys, without decoding the image."""
        h = np.frombuffer(self.txn.get((KEY_HEIGHT % idx).encode()), dtype=np.int32)
        w = np.frombuffer(self.txn.get((KEY_WIDTH % idx).encode()), dtype=np.int32)
        return int(h[0]), int(w[0])

    def image(self, idx: int) -> np.ndarray:
        """(H, W) grayscale or, with ``rgb``, (H, W, 3) uint8.  Bytes that
        do not decode give the reference's corrupted-image fallback
        (``lmdb_dataset.py:62-74``): 32x32 of PIL's ``Image.new(mode, (32,
        32), color=255)``, white in gray, (255, 0, 0) in RGB."""
        raw = self.txn.get((KEY_IMAGE % idx).encode())
        try:
            return decode_image(raw, self.rgb, f"{self.root} image {idx}")
        except ValueError:
            if not self.rgb:
                return np.full((32, 32), 255, np.uint8)
            dummy = np.zeros((32, 32, 3), np.uint8)
            dummy[..., 0] = 255
            return dummy

    def all_sizes(self) -> list[tuple[int, int]]:
        return [self.size(i + 1) for i in range(self.num_samples)]


def write_lmdb(out_path: str, images: Sequence[np.ndarray], labels: Sequence[str],
               names: Sequence[str] | None = None, map_size: int = 1 << 32) -> None:
    """Create a store with the reference schema: PNG image bytes
    (``encode_png``), label, name (``sample-<index>`` when ``names`` is
    None), int32 h/w and ``num-samples``, in one transaction."""
    pairs: list[tuple[bytes, bytes]] = []
    n = 0
    for i, (img, label) in enumerate(zip(images, labels)):
        idx = i + 1
        h, w = img.shape[:2]
        name = names[i] if names is not None else f"sample-{idx}"
        pairs += [((KEY_IMAGE % idx).encode(), encode_png(img)),
                  ((KEY_LABEL % idx).encode(), label.encode("utf-8")),
                  ((KEY_NAME % idx).encode(), name.encode("utf-8")),
                  ((KEY_HEIGHT % idx).encode(), np.int32(h).tobytes()),
                  ((KEY_WIDTH % idx).encode(), np.int32(w).tobytes())]
        n += 1
    pairs.append((KEY_NUM_SAMPLES.encode(), str(n).encode()))
    write_pylmdb(out_path, pairs, map_size=map_size)
