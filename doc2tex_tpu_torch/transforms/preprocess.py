"""Inference-time image preprocessing (host side, numpy).

Copied from ``doc2tex_tpu.transforms.preprocess``: grayscale, optional
downsample, clamp into [min_dimension, max_dimension] keeping the aspect
ratio, white pad up to a multiple of ``scale_factor``.  Output is uint8;
normalization happens on the device (``transforms.augment.normalize``).

The JAX package resizes with PIL (LANCZOS when either side shrinks,
BILINEAR when both grow).  This port has no PIL, so ``_resize_area``
carries its own copy of Pillow's separable resampler for 8-bit
single-channel images (``ImagingResample`` in Pillow's
``libImaging/Resample.c``), which gives the same bytes:

- per output pixel, float64 weights over the window
  ``[int(center - support + 0.5), int(center + support + 0.5))`` clipped
  to the image, with ``support = filter support * max(scale, 1)``,
  normalised by their sum (summed in order);
- weights in fixed point with 22 fraction bits, rounded half away from
  zero; each sum starts at ``1 << 21`` and is shifted down by 22 and
  clipped to [0, 255];
- the horizontal pass first, then the vertical one, each rounding to
  uint8 and skipped when its size does not change.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

PRECISION_BITS = 22      # Pillow's fixed point for 8-bit images


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_bilinear, 1.0)}


@lru_cache(maxsize=256)
def _coefficients(in_size: int, out_size: int, filt: str) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: (first
    input index (out,), fixed-point weights (out, taps)) int64, with taps
    past the clipped window weighted 0."""
    fn, filter_support = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int64)
    one = float(1 << PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for w in ws:
            total += w
        for x, w in enumerate(ws):
            if total != 0.0:
                w /= total
            weights[xx, x] = int(w * one - 0.5) if w < 0 else int(w * one + 0.5)
        first[xx] = xmin
    return first, weights


def _resample_rows(img: np.ndarray, out_w: int, filt: str) -> np.ndarray:
    """One horizontal pass of Pillow's resampler over (H, W) uint8."""
    first, weights = _coefficients(img.shape[1], out_w, filt)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]), img.shape[1] - 1)
    acc = (img[:, idx].astype(np.int64) * weights).sum(axis=-1) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize a uint8 (H, W) image to (h, w), byte for byte as PIL's
    ``Image.resize`` does for mode L (see the module docstring)."""
    ih, iw = img.shape[:2]
    if h == ih and w == iw:
        return img
    filt = "lanczos" if (h < ih or w < iw) else "bilinear"
    out = np.ascontiguousarray(img, dtype=np.uint8)
    if w != iw:
        out = _resample_rows(out, w, filt)
    if h != ih:
        out = np.ascontiguousarray(_resample_rows(out.T, h, filt).T)
    return out


PAGE_WIDTH = 1280  # the page width detection runs at (the reference demo's)


def detect_preprocess(page: np.ndarray) -> tuple[np.ndarray, float]:
    """Resize a page to width 1280 with LANCZOS in both directions, as the
    JAX package's ``demo/app.py`` does with PIL (equal bytes); returns
    (resized page, scale).  A page already at the size comes back as it
    is.  An (H, W, C) page is resized channel by channel, as PIL resizes
    each band."""
    h, w = page.shape[:2]
    scale = PAGE_WIDTH / w
    new_h = int(round(h * scale))
    if (new_h, PAGE_WIDTH) == (h, w):
        return page, scale
    if page.ndim == 3:
        resized = np.stack([detect_preprocess(page[..., c])[0] for c in range(page.shape[2])], -1)
        return resized, scale
    out = np.ascontiguousarray(page, dtype=np.uint8)
    if PAGE_WIDTH != w:
        out = _resample_rows(out, PAGE_WIDTH, "lanczos")
    if new_h != h:
        out = np.ascontiguousarray(_resample_rows(out.T, new_h, "lanczos").T)
    return out, scale


def minmax_size(
    h: int,
    w: int,
    max_dimension: tuple[int, int],
    min_dimension: tuple[int, int],
) -> tuple[int, int]:
    """Clamp (h, w) into [min, max] preserving the aspect ratio."""
    ratios = [h / max_dimension[0], w / max_dimension[1]]
    if any(r > 1 for r in ratios):
        s = max(ratios)
        h, w = int(h / s), int(w / s)
    ratios = [h / min_dimension[0], w / min_dimension[1]]
    if any(r < 1 for r in ratios):
        s = min(ratios)
        h, w = int(np.ceil(h / s)), int(np.ceil(w / s))
    return h, w


def resize_for_inference(img: np.ndarray, config) -> np.ndarray:
    """Grayscale uint8 (H, W) -> preprocessed uint8 at a divisible size."""
    if img.ndim == 3:
        img = np.round(img.astype(np.float32).mean(axis=-1)).astype(np.uint8)
    ds = config.get("downsample", 1) or 1
    h, w = img.shape
    if ds > 1 and h / ds >= config["min_dimension"][0] and w / ds >= config["min_dimension"][1]:
        img = _resize_area(img, int(h / ds), int(w / ds))
        h, w = img.shape
    h, w = minmax_size(h, w, tuple(config["max_dimension"]), tuple(config["min_dimension"]))
    img = _resize_area(img, h, w)
    sf = config.get("scale_factor", 32)
    ph = -(-h // sf) * sf - h
    pw = -(-w // sf) * sf - w
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw)), constant_values=255)
    return img
