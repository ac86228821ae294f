"""Inference-time image preprocessing (host side, numpy).

Copied from ``doc2tex_tpu.transforms.preprocess``: grayscale, optional
downsample, clamp into [min_dimension, max_dimension] keeping the aspect
ratio, white pad up to a multiple of ``scale_factor``.  Output is uint8;
normalization happens on the device (``transforms.augment.normalize``).
``clahe`` is the JAX package's numpy CLAHE, copied as it is.

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


def learned_resize(img: np.ndarray, predict_width_bucket, bucket_px: int = 32,
                   max_iters: int = 10, tol_px: int = 16) -> np.ndarray:
    """The learned resizer's loop (``doc2tex_tpu.transforms.preprocess.
    learned_resize``): a width-bucket classifier
    (``models.extras.LearnedResizer``) names the best target width, (idx +
    1) * ``bucket_px``; resize to it (the height in proportion) and ask
    again, until the width is within ``tol_px`` or ``max_iters`` rounds.
    ``predict_width_bucket(img_u8) -> int``."""
    for _ in range(max_iters):
        target_w = (int(predict_width_bucket(img)) + 1) * bucket_px
        h, w = img.shape[:2]
        if abs(target_w - w) <= tol_px:
            break
        img = _resize_area(img, max(int(round(h * target_w / w)), 1), target_w)
    return img


def clahe(img: np.ndarray, clip_limit: float = 2.0, grid: tuple[int, int] = (2, 2)) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization (OpenCV-compatible),
    as the demo recognizer applies it before normalization (``clip_limit``
    2, a 2x2 tile grid): per-tile clip-limited histogram equalization with
    bilinear interpolation between the four neighbouring tile mappings.
    Same bytes as ``doc2tex_tpu.transforms.preprocess.clahe``."""
    if img.ndim != 2:
        raise ValueError(f"clahe expects a grayscale HxW image, got shape {img.shape}")
    h, w = img.shape
    gh, gw = grid
    th, tw = -(-h // gh), -(-w // gw)  # ceil tile size (OpenCV pads)
    pad_h, pad_w = th * gh - h, tw * gw - w
    padded = np.pad(img, ((0, pad_h), (0, pad_w)), mode="reflect")

    # per-tile clipped-CDF mapping tables (gh, gw, 256)
    maps = np.empty((gh, gw, 256), np.float32)
    n_tile = th * tw
    clip = max(int(clip_limit * n_tile / 256.0), 1)
    for i in range(gh):
        for j in range(gw):
            tile = padded[i * th:(i + 1) * th, j * tw:(j + 1) * tw]
            hist = np.bincount(tile.ravel(), minlength=256).astype(np.int64)
            excess = np.maximum(hist - clip, 0).sum()
            hist = np.minimum(hist, clip) + excess // 256
            # OpenCV distributes the residual over the leading bins
            hist[: int(excess % 256)] += 1
            cdf = np.cumsum(hist)
            maps[i, j] = cdf * (255.0 / n_tile)

    # bilinear interpolation of the mapping between tile centres
    ys, xs = np.arange(h), np.arange(w)
    fy = (ys + 0.5) / th - 0.5
    fx = (xs + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, gh - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, gw - 1)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    wy = np.clip(fy - y0, 0.0, 1.0)[:, None].astype(np.float32)
    wx = np.clip(fx - x0, 0.0, 1.0)[None, :].astype(np.float32)

    v = img.astype(int)
    m00 = maps[y0[:, None], x0[None, :], v]
    m01 = maps[y0[:, None], x1[None, :], v]
    m10 = maps[y1[:, None], x0[None, :], v]
    m11 = maps[y1[:, None], x1[None, :], v]
    out = (1 - wy) * ((1 - wx) * m00 + wx * m01) + wy * ((1 - wx) * m10 + wx * m11)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
