"""Inference-time image preprocessing (host side, numpy + torch).

Copied from ``doc2tex_tpu.transforms.preprocess``: grayscale, optional
downsample, clamp into [min_dimension, max_dimension] keeping the aspect
ratio, white pad up to a multiple of ``scale_factor``.  Output is uint8;
normalization happens on the device (``transforms.augment.normalize``).

The one change: the JAX package resizes with PIL (LANCZOS down, BILINEAR
up).  This port has no PIL, so ``_resize_area`` uses
``torch.nn.functional.interpolate`` — bilinear with ``antialias=True`` when
either side shrinks, plain bilinear when both grow.  It is NOT bit-equal to
PIL; crops already inside [min_dimension, max_dimension] never reach it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize a uint8 (H, W) image to (h, w) (see the module docstring)."""
    ih, iw = img.shape[:2]
    if h == ih and w == iw:
        return img
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))[None, None]
    down = h < ih or w < iw
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=down)
    return y[0, 0].round().clamp(0, 255).to(torch.uint8).numpy()


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
