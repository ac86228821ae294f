"""Host-side geometric augmentation (numpy, applied at batch assembly).

Copied from ``doc2tex_tpu.transforms.geometry`` (numpy only), so the same
seed gives the same bytes.  Parity target: reference ``geometry_transform``
(``doc2tex/transform/geo_transform.py:44-78``): whitespace-trim the glyph
box, randomly re-scale it inside the original canvas, paste at a random
offset, then a small random rotation (<=2 deg, white fill).  Applied per
image with p=0.5 in the collate (``collate_fn.py:22-24``).

Pure numpy (nearest/bilinear resampling) — runs in the host data pipeline
threads, never on device.
"""

from __future__ import annotations

import numpy as np


def _trim_whitespace(img: np.ndarray, thresh: int = 255) -> np.ndarray:
    """Crop all-white border rows/cols (reference geo_transform.py:47-56)."""
    rows = np.where((img < thresh).any(axis=1))[0]
    cols = np.where((img < thresh).any(axis=0))[0]
    if len(rows) == 0 or len(cols) == 0:
        return img
    return img[rows[0] : rows[-1] + 1, cols[0] : cols[-1] + 1]


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


def _rotate_small(img: np.ndarray, deg: float, fill: int = 255) -> np.ndarray:
    """Small-angle rotation via inverse mapping, nearest sampling."""
    rad = np.deg2rad(deg)
    c, s = np.cos(rad), np.sin(rad)
    h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ys = c * (yy - cy) + s * (xx - cx) + cy
    xs = -s * (yy - cy) + c * (xx - cx) + cx
    yi = np.round(ys).astype(np.int64)
    xi = np.round(xs).astype(np.int64)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.full_like(img, fill)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def geometry_transform(
    img: np.ndarray, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Random trim/re-scale/offset/rotate of a grayscale uint8 image."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    glyph = _trim_whitespace(img)
    gh, gw = glyph.shape[:2]
    if gh < 2 or gw < 2:
        return img

    # random re-scale within [0.75, 1.0] of the available canvas
    scale = rng.uniform(0.75, 1.0)
    nh = max(int(min(gh * scale * h / max(gh, 1), h)), 2)
    nw = max(int(min(gw * scale * w / max(gw, 1), w)), 2)
    nh, nw = min(nh, h), min(nw, w)
    glyph = _resize_nearest(glyph, nh, nw)

    canvas = np.full((h, w), 255, dtype=img.dtype)
    oy = int(rng.integers(0, h - nh + 1))
    ox = int(rng.integers(0, w - nw + 1))
    canvas[oy : oy + nh, ox : ox + nw] = glyph

    deg = float(rng.uniform(-2.0, 2.0))
    return _rotate_small(canvas, deg)
