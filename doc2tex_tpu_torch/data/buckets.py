"""The static bucket-shape ladder and top-left white padding.

Copied from ``doc2tex_tpu.data.buckets``: crops are padded with background
pixels up to a bucket shape drawn from a small (H, W) ladder derived from
the config's min/max dimensions, so a decode batch always has one of a
bounded set of shapes.  The ladder must equal the one the weights were
trained in (``bucket_growth`` of the model's version block).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class BucketTable:
    """The static set of (H, W) image shapes, ``lookup`` by smallest area."""

    shapes: tuple[tuple[int, int], ...]
    _by_area: tuple[tuple[int, int], ...] = field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(
            self, "_by_area", tuple(sorted(self.shapes, key=lambda s: (s[0] * s[1], s)))
        )

    def lookup(self, h: int, w: int) -> tuple[int, int] | None:
        """The smallest bucket that contains (h, w), or None."""
        for bh, bw in self._by_area:
            if h <= bh and w <= bw:
                return (bh, bw)
        return None

    def __len__(self) -> int:
        return len(self.shapes)


def make_ladder(
    min_dimension: Sequence[int],
    max_dimension: Sequence[int],
    scale_factor: int = 32,
    growth: float = 1.5,
) -> BucketTable:
    """Geometric (H, W) ladder: each axis grows by ~``growth`` per rung,
    snapped up to ``scale_factor`` and capped at the max dimension."""

    def axis(lo: int, hi: int) -> list[int]:
        vals = [lo]
        v = float(lo)
        while vals[-1] < hi:
            v = v * growth
            snapped = min(int(math.ceil(v / scale_factor) * scale_factor), hi)
            if snapped > vals[-1]:
                vals.append(snapped)
        return vals

    hs = axis(min_dimension[0], max_dimension[0])
    ws = axis(min_dimension[1], max_dimension[1])
    return BucketTable(tuple((h, w) for h in hs for w in ws))


def pad_to_bucket(
    img: np.ndarray, bucket: tuple[int, int], pad_value: int = 255
) -> np.ndarray:
    """Pad an (H, W) or (H, W, C) uint8 image with background up to the
    bucket shape, top-left anchored."""
    h, w = img.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        raise ValueError(f"image {img.shape} exceeds bucket {bucket}")
    pad = [(0, bh - h), (0, bw - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="constant", constant_values=pad_value)
