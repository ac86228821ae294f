"""Page-level stitching of windowed detections by pixel voting
(counterpart of ``doc2tex_tpu.detection.stitch``).

Every window's detection casts votes onto a page-size accumulator (four
algorithms: equal / sum / max / avg of confidences), the accumulator is
thresholded, its 8-connected components become region boxes, and each box
is fitted to the ink: contracted to the ink inside it, then grown over
every ink component it touches (ScanSSD's ``stitch_patches_pdf.py`` and
``fit_box.py``).

The JAX package labels with ``scipy.ndimage.label`` (3x3 structure) and
``find_objects``; the port carries its own labelling in numpy
(``label_components``), which gives the same label image and slices: row
runs are joined to the overlapping runs of the next row (8-connected) by a
vectorised union-find, and the components are numbered in the raster order
of their first pixel, as ``ndimage.label`` numbers them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _row_runs(mask: np.ndarray):
    """The runs of nonzero pixels of each row, in raster order: (rows,
    starts, ends), ``ends`` exclusive."""
    m = np.asarray(mask) != 0
    H, W = m.shape
    padded = np.zeros((H, W + 2), np.int8)
    padded[:, 1:-1] = m
    d = np.diff(padded, axis=1)
    rows, starts = np.nonzero(d == 1)
    _, ends = np.nonzero(d == -1)
    return rows, starts, ends


def label_components(mask: np.ndarray) -> tuple[np.ndarray, list[tuple[slice, slice]]]:
    """8-connected components of ``mask``'s nonzero pixels -> (int32 label
    image, 0 = background, components numbered 1.. in the raster order of
    their first pixel; [(row slice, column slice)] of each component's
    bounding box, in label order): what ``scipy.ndimage.label(mask,
    structure=np.ones((3, 3)))`` and ``ndimage.find_objects`` give."""
    m = np.asarray(mask)
    H, W = m.shape
    rows, starts, ends = _row_runs(m)
    n = len(rows)
    labeled = np.zeros((H, W), np.int32)
    if n == 0:
        return labeled, []
    # runs of row r and row r + 1 touch (8-connected) when their columns
    # overlap after widening by one: a run of row r + 1 qualifies when its
    # end reaches this run's start and its start this run's end
    stride = W + 2
    start_key = rows.astype(np.int64) * stride + starts
    end_key = rows.astype(np.int64) * stride + ends
    below = (rows.astype(np.int64) + 1) * stride
    lo = np.searchsorted(end_key, below + starts, side="left")
    hi = np.searchsorted(start_key, below + ends, side="right")
    count = np.maximum(hi - lo, 0)
    u = np.repeat(np.arange(n), count)
    v = (np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
         + np.repeat(lo, count))
    # union-find: hook the larger root under the smaller, then compress
    parent = np.arange(n)
    while len(u):
        pu, pv = parent[u], parent[v]
        diff = pu != pv
        if not diff.any():
            break
        np.minimum.at(parent, np.maximum(pu, pv)[diff], np.minimum(pu, pv)[diff])
        while True:
            grand = parent[parent]
            if np.array_equal(grand, parent):
                break
            parent = grand
    # each root is its component's first run in raster order
    roots, label = np.unique(parent, return_inverse=True)
    label = label.astype(np.int32) + 1
    paint = np.zeros((H, W + 1), np.int32)
    np.add.at(paint, (rows, starts), label)
    np.add.at(paint, (rows, ends), -label)
    labeled[:] = np.cumsum(paint, axis=1)[:, :W]
    k = len(roots)
    y0 = np.full(k, H, np.int64)
    y1 = np.zeros(k, np.int64)
    x0 = np.full(k, W, np.int64)
    x1 = np.zeros(k, np.int64)
    np.minimum.at(y0, label - 1, rows)
    np.maximum.at(y1, label - 1, rows + 1)
    np.minimum.at(x0, label - 1, starts)
    np.maximum.at(x1, label - 1, ends)
    slices = [(slice(int(a), int(b)), slice(int(c), int(d)))
              for a, b, c, d in zip(y0, y1, x0, x1)]
    return labeled, slices


def vote_for_regions(
    boxes_scores: np.ndarray,
    page_hw: tuple[int, int],
    algorithm: str = "equal",
    thresh_votes: float = 30,
) -> np.ndarray:
    """(N, 5) [x1, y1, x2, y2, score] page-space detections -> uint8 vote
    mask.  ``equal`` counts overlapping detections, ``sum``/``avg``
    accumulate confidences, ``max`` keeps the highest."""
    h, w = page_hw
    votes = np.zeros((h, w), np.float32)
    b = np.asarray(boxes_scores, np.float32).reshape(-1, 5)

    def sl(box):
        x1, y1, x2, y2 = (int(v) for v in box[:4])
        return slice(max(y1, 0), max(y2, 0)), slice(max(x1, 0), max(x2, 0))

    if algorithm == "sum":
        for box in b:
            ys, xs = sl(box)
            votes[ys, xs] += box[4]
    elif algorithm == "max":
        for box in b[b[:, 4].argsort()]:
            ys, xs = sl(box)
            votes[ys, xs] = box[4]
    elif algorithm == "avg":
        counts = np.zeros_like(votes)
        for box in b:
            ys, xs = sl(box)
            votes[ys, xs] += box[4]
            counts[ys, xs] += 1
        counts[counts == 0] = 1
        votes /= counts
    else:  # "equal"
        for box in b:
            ys, xs = sl(box)
            votes[ys, xs] += 1

    return (votes >= thresh_votes).astype(np.uint8)


def fit_box(im_bw: np.ndarray, box, components=None) -> list[int]:
    """Contract a box to its ink, then grow it over every connected
    component it touches (ScanSSD's ``fit_box.adjust_box``).
    ``components``: ``label_components(im_bw)``, when the caller fits many
    boxes on one page."""
    x1, y1, x2, y2 = (int(round(v)) for v in box[:4])
    region = im_bw[y1:y2, x1:x2]
    if region.size == 0 or not region.any():
        return [0, 0, 0, 0]
    rows = np.flatnonzero(region.any(axis=1))
    cols = np.flatnonzero(region.any(axis=0))
    x1c, y1c = x1 + cols[0], y1 + rows[0]
    x2c, y2c = x1 + cols[-1] + 1, y1 + rows[-1] + 1

    if components is None:
        components = label_components(im_bw)
    labeled, slices = components
    touching = np.unique(labeled[y1c:y2c, x1c:x2c])
    touching = touching[touching != 0]
    if touching.size == 0:
        return [x1c, y1c, x2c, y2c]
    for comp in touching:
        ys, xs = slices[comp - 1]
        x1c, y1c = min(x1c, xs.start), min(y1c, ys.start)
        x2c, y2c = max(x2c, xs.stop), max(y2c, ys.stop)
    return [int(x1c), int(y1c), int(x2c), int(y2c)]


def _to_ink_mask(page_image: np.ndarray) -> np.ndarray:
    """uint8 page (grey or RGB) -> binary ink mask (ink dark)."""
    img = np.asarray(page_image)
    if img.ndim == 3:  # RGB page: the channel mean, rounded
        img = np.round(img.astype(np.float32).mean(axis=-1)).astype(np.uint8)
    return (img <= 127).astype(np.uint8)


def stitch_page(
    boxes_scores: np.ndarray,
    page_hw: tuple[int, int],
    page_image: Optional[np.ndarray] = None,
    algorithm: str = "equal",
    thresh_votes: float = 30,
    postprocess: bool = True,
) -> list[list[int]]:
    """Windowed detections (N, 5) -> stitched page regions [x1, y1, x2, y2]
    (ScanSSD's ``voting_algo``).  ``page_image``: uint8 page (ink dark) for
    the fit to the ink; without it the vote components are the boxes."""
    votes = vote_for_regions(boxes_scores, page_hw, algorithm, thresh_votes)
    _, vote_slices = label_components(votes)
    im_bw = components = None
    if page_image is not None and postprocess:
        im_bw = _to_ink_mask(page_image)
        components = label_components(im_bw)  # the page is labelled once

    boxes: list[list[int]] = []
    for ys, xs in vote_slices:
        box = [xs.start, ys.start, xs.stop, ys.stop]
        if im_bw is not None:
            box = fit_box(im_bw, box, components)
        if box[2] - box[0] < 1 or box[3] - box[1] < 1:
            continue
        boxes.append(box)
    return boxes
