"""Sliding windows over a page and their detections back in page pixels (a
copy of ``doc2tex_tpu.detection.windows``, numpy only).

512x512 windows at stride 128, center-padded with white where the page
ends; detections un-mapped from window to page coordinates; the 5 % box
expansion before cropping.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def rolling_windows(
    image: np.ndarray, stride: tuple[int, int] = (128, 128), window: int = 512
) -> tuple[np.ndarray, list[tuple[int, int, int, int]]]:
    """Gray/RGB page -> (windows (N, window, window, C) uint8,
    [(x_start, y_start, width, height), ...])."""
    if image.ndim == 2:
        image = image[..., None]
    H, W, C = image.shape
    ny = max(math.ceil((H - window) / stride[0]) + 1, 1)
    nx = max(math.ceil((W - window) / stride[1]) + 1, 1)
    crops = np.full((ny * nx, window, window, C), 255, np.uint8)
    info: list[tuple[int, int, int, int]] = []
    n = 0
    for i in range(ny):
        for j in range(nx):
            x0, y0 = j * stride[1], i * stride[0]
            x1, y1 = min(x0 + window, W), min(y0 + window, H)
            w, h = x1 - x0, y1 - y0
            xc, yc = (window - w) // 2, (window - h) // 2
            crops[n, yc : yc + h, xc : xc + w] = image[y0:y1, x0:x1]
            info.append((x0, y0, w, h))
            n += 1
    return crops, info


def unmap_boxes(
    boxes: np.ndarray,
    scores: np.ndarray,
    info: Sequence[tuple[int, int, int, int]],
    window: int = 512,
    score_thresh: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Window-normalized detections -> page pixel coordinates.

    boxes (N, K, 4) in [0,1] per window, scores (N, K); boxes falling in
    a window's white padding are clipped to the window content.
    """
    out_boxes, out_scores = [], []
    for (x0, y0, w, h), wb, ws in zip(info, boxes, scores):
        xc, yc = (window - w) // 2, (window - h) // 2
        for (bx1, by1, bx2, by2), s in zip(wb, ws):
            if s <= score_thresh:
                continue
            px1 = np.clip(bx1 * window - xc, 0, w) + x0
            py1 = np.clip(by1 * window - yc, 0, h) + y0
            px2 = np.clip(bx2 * window - xc, 0, w) + x0
            py2 = np.clip(by2 * window - yc, 0, h) + y0
            if px2 - px1 < 2 or py2 - py1 < 2:
                continue
            out_boxes.append([px1, py1, px2, py2])
            out_scores.append(float(s))
    if not out_boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
    return np.asarray(out_boxes, np.float32), np.asarray(out_scores, np.float32)


def expand_boxes(
    boxes: np.ndarray, page_hw: tuple[int, int], frac: float = 0.05
) -> np.ndarray:
    """Grow each box by ``frac`` of its width and height on every side,
    clipped to the page (the 5 % expansion before cropping)."""
    if len(boxes) == 0:
        return boxes
    H, W = page_hw
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    out = boxes.copy()
    out[:, 0] = np.clip(boxes[:, 0] - frac * w, 0, W)
    out[:, 1] = np.clip(boxes[:, 1] - frac * h, 0, H)
    out[:, 2] = np.clip(boxes[:, 2] + frac * w, 0, W)
    out[:, 3] = np.clip(boxes[:, 3] + frac * h, 0, H)
    return out
