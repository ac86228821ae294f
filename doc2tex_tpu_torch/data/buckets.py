"""The static bucket-shape ladder, top-left white padding, and the eval
side of bucket planning.

Copied from ``doc2tex_tpu.data.buckets``: crops are padded with background
pixels up to a bucket shape drawn from a small (H, W) ladder derived from
the config's min/max dimensions, so a decode batch always has one of a
bounded set of shapes.  The ladder must equal the one the weights were
trained in (``bucket_growth`` of the model's version block).
``plan_buckets`` and ``batch_plan`` give a loader's clusters and batches,
with the training side: over-padding promotion (``overpad_prob``) and the
shuffles, drawn from numpy generators in the JAX package's order.
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


def get_divisible_size(ori_h: float, ori_w: float, max_dimension: Sequence[int] | None = None,
                       scale_factor: int = 32) -> tuple[int, int]:
    """Snap (h, w) up to multiples of scale_factor; snap down if that would
    exceed max_dimension."""

    def snap(dim: float, limit: int | None) -> int:
        up = math.ceil(dim / scale_factor) * scale_factor
        if limit is not None and up > limit:
            down = math.floor(dim / scale_factor) * scale_factor
            return max(down, scale_factor)
        return max(up, scale_factor)

    new_h = snap(ori_h, max_dimension[0] if max_dimension else None)
    new_w = snap(ori_w, max_dimension[1] if max_dimension else None)
    return int(new_h), int(new_w)


def get_size(ori_h: float, ori_w: float, config) -> tuple[int, int]:
    """Target (h, w) for a raw image under the config's downsample and
    clamp rules (the raw size when ``downsample`` is 1)."""
    if config.get("downsample", 1) is None or config.get("downsample", 1) <= 1:
        return int(ori_h), int(ori_w)
    ds = config["downsample"]
    h, w = ori_h / ds, ori_w / ds
    min_dim, max_dim = config["min_dimension"], config["max_dimension"]
    sf = config.get("scale_factor", 32)
    new_h, new_w = get_divisible_size(h, w, scale_factor=sf)
    ratios = [new_h / max_dim[0], new_w / max_dim[1]]
    if any(r > 1 for r in ratios):
        scale = max(ratios)
        new_h, new_w = get_divisible_size(new_h / scale, new_w / scale, max_dim, sf)
    ratios = [new_h / min_dim[0], new_w / min_dim[1]]
    if any(r < 1 for r in ratios):
        scale = max(ratios)
        new_h, new_w = get_divisible_size(new_h / scale, new_w / scale, scale_factor=sf)
    return int(new_h), int(new_w)


def make_exact_table(sizes) -> BucketTable:
    """A BucketTable of exactly the given (h, w) sizes (``bucket_mode:
    exact``, the reference's clustering by equal size)."""
    return BucketTable(tuple(sorted(set(sizes))))


def plan_buckets(sizes: Sequence[tuple[int, int]], config,
                 overpad_rng: np.random.Generator | None = None
                 ) -> tuple[BucketTable, dict[tuple[int, int], list[int]], list[int]]:
    """Assign each sample (by target size) to the smallest bucket that
    holds it: of the ladder (``bucket_mode: ladder``, the default) or of
    the samples' own target sizes (any other ``bucket_mode``, as in the
    JAX package).  Returns (table, {bucket: [sample index, ...]} in order
    of each bucket's first sample, excluded indices: samples larger than
    every bucket).

    With ``overpad_rng`` (training) and ``overpad_prob`` > 0, each sample
    is, with that probability, promoted to a random larger bucket of at
    most ``overpad_ratio`` times its bucket's area (drawn once, when the
    loader is built: the promotion is fixed for a run, as in the JAX
    package)."""
    overpad_prob = float(config.get("overpad_prob", 0.0) or 0.0)
    overpad_ratio = float(config.get("overpad_ratio", 4.0) or 4.0)
    if config.get("bucket_mode", "ladder") == "ladder":
        table = make_ladder(config["min_dimension"], config["max_dimension"],
                            config.get("scale_factor", 32),
                            growth=config.get("bucket_growth", 1.5))
    else:
        table = make_exact_table(get_size(h, w, config) for h, w in sizes)
    clusters: dict[tuple[int, int], list[int]] = {}
    excluded: list[int] = []
    for i, (h, w) in enumerate(sizes):
        bucket = table.lookup(*get_size(h, w, config))
        if bucket is None:
            excluded.append(i)
            continue
        if (overpad_rng is not None and overpad_prob > 0.0
                and overpad_rng.random() < overpad_prob):
            area = bucket[0] * bucket[1]
            bigger = [b for b in table.shapes
                      if b != bucket and b[0] >= bucket[0] and b[1] >= bucket[1]
                      and b[0] * b[1] <= overpad_ratio * area]
            if bigger:
                bucket = bigger[int(overpad_rng.integers(len(bigger)))]
        clusters.setdefault(bucket, []).append(i)
    return table, clusters, excluded


def batch_plan(clusters: dict[tuple[int, int], list[int]], batch_size: int,
               keep_smaller_batches: bool = True, rng: np.random.Generator | None = None,
               shuffle: bool = False) -> list[tuple[tuple[int, int], list[int]]]:
    """(bucket, sample indices) batches: each cluster in turn (shuffled
    inside with ``shuffle``), chunked into ``batch_size``; a ragged tail is
    dropped unless ``keep_smaller_batches``; with ``shuffle`` the batch
    order is shuffled too, all from ``rng``."""
    rng = rng or np.random.default_rng()
    batches = []
    for bucket, idxs in clusters.items():
        idxs = list(idxs)
        if shuffle:
            rng.shuffle(idxs)
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s : s + batch_size]
            if len(chunk) < batch_size and not keep_smaller_batches:
                continue
            batches.append((bucket, chunk))
    if shuffle:
        rng.shuffle(batches)
    return batches
