"""Detection scores: precision, recall and F1 at IoU thresholds, and the
CROHME-2019 Task-3 coarse/fine scoring (a copy of
``doc2tex_tpu.detection.evaluate``, numpy only).

Greedy score-ordered matching of predicted to ground-truth boxes by IoU, as
the reference's GTDB scoring stack measures a page.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) corner boxes -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def match_detections(
    pred_boxes: np.ndarray,
    pred_scores: np.ndarray,
    gt_boxes: np.ndarray,
    iou_thresh: float = 0.5,
) -> tuple[int, int, int]:
    """Greedy score-ordered matching -> (tp, fp, fn)."""
    order = np.argsort(-np.asarray(pred_scores))
    matched = np.zeros(len(gt_boxes), bool)
    iou = iou_matrix(np.asarray(pred_boxes, np.float32).reshape(-1, 4),
                     np.asarray(gt_boxes, np.float32).reshape(-1, 4))
    tp = fp = 0
    for i in order:
        if iou.shape[1] == 0:
            fp += 1
            continue
        cand = np.where(~matched, iou[i], -1.0)
        j = int(np.argmax(cand))
        if cand[j] >= iou_thresh:
            matched[j] = True
            tp += 1
        else:
            fp += 1
    fn = int((~matched).sum())
    return tp, fp, fn


def evaluate_detections(
    predictions: Sequence[tuple[np.ndarray, np.ndarray]],
    ground_truths: Sequence[np.ndarray],
    iou_thresholds: Sequence[float] = (0.5, 0.75),
) -> dict:
    """Corpus metrics over pages.

    ``predictions``: per-page (boxes (K,4), scores (K,));
    ``ground_truths``: per-page gt boxes (M,4).
    """
    out: dict = {}
    for thr in iou_thresholds:
        tp = fp = fn = 0
        for (pb, ps), gb in zip(predictions, ground_truths):
            t, f, n = match_detections(pb, ps, gb, thr)
            tp, fp, fn = tp + t, fp + f, fn + n
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        out[f"precision@{thr}"] = prec
        out[f"recall@{thr}"] = rec
        out[f"f1@{thr}"] = f1
    return out


# ---------------------------------------------------------------------------
# CROHME-2019 Task-3 scoring (reference IOU_lib/IOUevaluater.py)


def _unique_match(pred_dict: dict, thresh: float) -> dict:
    """GT-centric unique matching (reference ``find_uni_pred`` /
    ``fix_preds``, IOUevaluater.py:109-182): when one detection is the
    best candidate for several GT boxes, the GT with the higher IoU keeps
    it and the others fall back to their next candidate, dropping out when
    that falls below ``thresh``."""
    d = {k: v for k, v in pred_dict.items() if v[0] >= thresh}
    while True:
        by_det: dict = {}
        for k, (iou, det, ious, dets) in d.items():
            by_det.setdefault(det, []).append(k)
        dups = [ks for ks in by_det.values() if len(ks) > 1]
        if not dups:
            return d
        for ks in dups:
            ks = sorted(ks, key=lambda k: -d[k][0])
            for k in ks[1:]:  # losers fall back to their next candidate
                iou, det, ious, dets = d[k]
                if len(ious) <= 1 or ious[1] < thresh:
                    del d[k]
                else:
                    d[k] = (ious[1], dets[1], ious[1:], dets[1:])


def crohme_detection_scores(
    predictions: Sequence[np.ndarray],
    ground_truths: Sequence[np.ndarray],
) -> dict:
    """CROHME Task-3 coarse/fine detection scoring
    (reference ``IoU_page_bboxes`` + ``pre_rec_calculate``,
    IOUevaluater.py:198-436): per GT box, all detections ranked by IoU;
    unique GT<->det assignment; correct at IoU>0.5 (coarse) and >0.75
    (fine); precision over ALL detections, recall over ALL GT boxes.

    ``predictions``: per-page det boxes (K,4); ``ground_truths``: per-page
    gt boxes (M,4).
    """
    all_gt = all_det = correct_c = correct_f = 0
    for det, gt in zip(predictions, ground_truths):
        det = np.asarray(det, np.float32).reshape(-1, 4)
        gt = np.asarray(gt, np.float32).reshape(-1, 4)
        all_gt += len(gt)
        all_det += len(det)
        if len(gt) == 0 or len(det) == 0:
            continue
        iou = iou_matrix(gt, det)
        pred_dict = {}
        for gi in range(len(gt)):
            order = np.argsort(-iou[gi])
            ious = [float(iou[gi, j]) for j in order]
            dets = [int(j) for j in order]
            pred_dict[gi] = (ious[0], dets[0], ious, dets)
        correct_c += len(_unique_match(dict(pred_dict), 0.5))
        correct_f += len(_unique_match(dict(pred_dict), 0.75))

    out = {"allGTbox": all_gt, "allDet": all_det,
           "correctDet_c": correct_c, "correctDet_f": correct_f}
    for tag, correct in (("coarse", correct_c), ("fine", correct_f)):
        pre = correct / all_det if all_det else 0.0
        rec = correct / all_gt if all_gt else 0.0
        f = 2 * pre * rec / (pre + rec) if (pre or rec) else 0.0
        out[f"{tag}_pre"] = round(pre, 4)
        out[f"{tag}_rec"] = round(rec, 4)
        out[f"{tag}_f"] = round(f, 4)
    return out
