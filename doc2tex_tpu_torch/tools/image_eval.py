"""Image-based prediction evaluation: the column-wise image edit distance
(the port's twin of ``doc2tex_tpu.tools.image_eval``).

The reference (``doc2tex/tools/result_evaluate/evaluate_images.py``)
renders the gold and predicted LaTeX to images, trims and binarises them,
takes each pixel column as one symbol and computes the Levenshtein
distance over the column sequences; the "w/o space" variant drops blank
columns first, and the fuzzy match counts columns that differ in fewer
than 5 pixels as the same symbol.  The distance over column ids runs in
the native library (``native.levenshtein_u64``); ``eval.metrics._lev_py``
is its plain version.  Host code only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import native


def trim_image(img: np.ndarray, thresh: int = 255) -> np.ndarray:
    """Crop the all-white border rows and columns (the reference's
    ``trim_image``); an all-white image becomes its top-left pixel."""
    mask = img < thresh
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return img[:1, :1]
    return img[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]


def _column_bits(img: np.ndarray) -> np.ndarray:
    """uint8 grey (H, W) -> (W, H) binary column matrix (ink where <= 128)."""
    return (trim_image(img).T <= 128).astype(np.uint8)


def _pad_cols(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    h = max(a.shape[1], b.shape[1])
    return np.pad(a, ((0, 0), (0, h - a.shape[1]))), np.pad(b, ((0, 0), (0, h - b.shape[1])))


def _exact_ids(cols_a: np.ndarray, cols_b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Equal columns (as bit strings) -> equal ids."""
    table: dict[bytes, int] = {}

    def ids(cols):
        return np.array([table.setdefault(c.tobytes(), len(table)) for c in cols], np.uint64)

    return ids(cols_a), ids(cols_b)


def _fuzzy_ids(cols_a: np.ndarray, cols_b: np.ndarray, tol: int = 5
               ) -> tuple[np.ndarray, np.ndarray]:
    """Columns within ``tol`` differing pixels of an earlier column's
    representative take its id (the reference's ``make_strs``)."""
    reps: list[np.ndarray] = []
    cache: dict[bytes, int] = {}

    def assign(col: np.ndarray) -> int:
        key = col.tobytes()
        if key in cache:
            return cache[key]
        for rid, rep in enumerate(reps):
            if np.abs(col.astype(np.int16) - rep.astype(np.int16)).sum() < tol:
                cache[key] = rid
                return rid
        reps.append(col)
        cache[key] = len(reps) - 1
        return len(reps) - 1

    return (np.array([assign(c) for c in cols_a], np.uint64),
            np.array([assign(c) for c in cols_b], np.uint64))


def img_edit_distance(im1: np.ndarray, im2: Optional[np.ndarray]
                      ) -> tuple[int, int, bool, bool]:
    """(edit distance, reference columns, match with spaces, match without
    spaces) of the gold render ``im1`` against the prediction's ``im2``
    (None when it did not render: wholly wrong, as in the reference)."""
    cols1 = _column_bits(np.asarray(im1, np.uint8))
    if im2 is None:
        return len(cols1), len(cols1), False, False
    cols2 = _column_bits(np.asarray(im2, np.uint8))
    cols1, cols2 = _pad_cols(cols1, cols2)
    ed = native.levenshtein_u64(*_exact_ids(cols1, cols2))
    if ed == 0:
        return 0, len(cols1), True, True
    match_w = native.levenshtein_u64(*_fuzzy_ids(cols1, cols2)) == 0
    nz1, nz2 = cols1[cols1.any(axis=1)], cols2[cols2.any(axis=1)]   # blank columns dropped
    match_wo = native.levenshtein_u64(*_fuzzy_ids(nz1, nz2)) == 0
    return ed, len(cols1), match_w, match_wo


def evaluate_image_pairs(pairs: Sequence[tuple[np.ndarray, Optional[np.ndarray]]]) -> dict:
    """Accuracy with and without spaces, the image edit distance score
    (1 - the summed distances over the summed reference columns) and the
    per-sample rows of (gold, prediction) image pairs."""
    total_ed = total_ref = total_num = correct_w = correct_wo = 0
    per_sample = []
    for gold, pred in pairs:
        ed, ref, m1, m2 = img_edit_distance(gold, pred)
        total_ed += ed
        total_ref += ref
        total_num += 1
        correct_w += int(m1)
        correct_wo += int(m2)
        per_sample.append({"ed": ed, "ref": ref, "match_w_space": m1, "match_wo_space": m2})
    return {
        "accuracy_w_space": correct_w / total_num if total_num else 0.0,
        "accuracy_wo_space": correct_wo / total_num if total_num else 0.0,
        "image_edit_distance": 1.0 - total_ed / total_ref if total_ref else 0.0,
        "n": total_num,
        "per_sample": per_sample,
    }
