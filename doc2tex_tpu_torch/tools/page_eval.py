"""Page-level accuracy of the port: detect -> crop -> recognize, scored end
to end (the port's twin of the repository's ``tools/page_eval.py``).

    python -m doc2tex_tpu_torch.tools.page_eval [--pages 100]
        [--version synthetic_tfm_big] [--coalesce_ratio R] [--conf 0.5]
        [--nms_iou 0.1] [--expand 0.05] [--iou 0.5] [--oracle_boxes]
        [--regions hard|structured] [--detect_weights W] [--stitch]
        [--bf16_detect | --int8_detect] [--device cuda] [--out result.json]

The same evaluation as the JAX package's: pages of 1024x1280 with up to 6
pasted formula renders (seed 35; hard-benchmark renders, or with
``--regions structured`` the structured grammar's), the page pipeline
(``app.App.detect_and_crop``: the released detector or ``--detect_weights``
in float32, or with ``--bf16_detect``/``--int8_detect`` in bfloat16 or
with its gated convolutions in int8, page NMS or with ``--stitch`` the
voting stitch, 5 % expansion) and the version block's recognizer as it ships
(``quantize: int8``, beam 10) on each page's crops in one call.
Detections are matched to the ground-truth boxes greedily at IoU
``--iou``, in the detector's order; the row holds detection precision,
recall and F1, exact match over the matched regions, end-to-end accuracy
(regions both detected and transcribed exactly over all regions) with
Wilson 95 % intervals, and seconds per page for each half.  The process's
TF32 settings are left as torch sets them, as the app and the server leave
them: the detector turns cuDNN's TF32 off for its own forward, and ``tf32``
in the row is the setting the recognizer's float32 convolutions (none in
the released ``bfloat16`` versions) ran under.  Rows carry the card's name
and power limit and are merged into ``--out`` (default
``doc2tex_tpu_torch/tools/page_eval_cuda.json``) under the reference's key
naming.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..app import App
from ..data.synthetic import synth_hard_sample, synth_structured_sample
from ..detection.evaluate import iou_matrix
from ..detection.windows import expand_boxes
from ..eval.metrics import get_single_ED
from ..latex.postprocess import postprocess_prediction
from ..recognition import MathRecognition, load_recog_config
from .release_eval import card, wilson

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_PATH = os.path.join(_ROOT, "doc2tex_tpu_torch", "tools", "page_eval_cuda.json")
PAGE_H, PAGE_W = 1024, 1280
EVAL_SEED = 35  # distinct from train 31 / curves 32 / release 33 / coalesce 34


def synth_labelled_page(rng: np.random.Generator, n_regions: int = 6, style: str = "hard"):
    """One page of pasted formula renders: (page uint8 (H, W), [(x1, y1,
    x2, y2), ...], [label, ...]).  ``style`` ``hard`` pastes hard-benchmark
    renders (what the released recognizers were trained on),
    ``structured`` the structured grammar's (what the released detector
    was trained on).  A render that finds no place 12 px clear of the
    others in 20 draws is left out."""
    page = np.full((PAGE_H, PAGE_W), 255, np.uint8)
    boxes, labels = [], []
    for _ in range(n_regions):
        if style == "hard":
            img, label = synth_hard_sample(rng, min_len=8, max_len=40, max_h=160, max_w=520,
                                           scale_range=(3, 5))
        else:
            img, label = synth_structured_sample(rng, min_len=4, max_len=30, max_h=160,
                                                 max_w=520)
        h, w = img.shape
        for _try in range(20):
            y = int(rng.integers(0, PAGE_H - h))
            x = int(rng.integers(0, PAGE_W - w))
            box = (x, y, x + w, y + h)
            if all(box[2] + 12 <= b[0] or box[0] >= b[2] + 12
                   or box[3] + 12 <= b[1] or box[1] >= b[3] + 12 for b in boxes):
                page[y:y + h, x:x + w] = img
                boxes.append(box)
                labels.append(label)
                break
    return page, boxes, labels


def result_key(version: str, pages: int, coalesce_ratio=None, conf: float = 0.5,
               nms_iou: float = 0.1, expand: float = 0.05, iou: float = 0.5,
               oracle_boxes: bool = False, stitch: bool = False, regions: str = "hard",
               detect_weights=None, detect_quantize=None) -> str:
    """The reference's row key: every knob off its default is named."""
    return version + ("_stitch" if stitch else "") + (
        f"_co{coalesce_ratio:g}" if coalesce_ratio else "") + (
        f"_{regions}" if regions != "hard" else "") + (
        f"_{detect_quantize}det" if detect_quantize else "") + (
        "_customdet" if detect_weights else "") + (
        "_oracle" if oracle_boxes else "") + (
        f"_iou{iou:g}" if iou != 0.5 else "") + (
        f"_p{pages}" if pages != 100 else "") + (
        f"_conf{conf:g}" if conf != 0.5 else "") + (
        f"_nms{nms_iou:g}" if nms_iou != 0.1 else "") + (
        f"_ex{expand:g}" if expand != 0.05 else "")


def evaluate(pages: int = 100, version: str = "synthetic_tfm_big", coalesce_ratio=None,
             conf: float = 0.5, nms_iou: float = 0.1, expand: float = 0.05,
             iou: float = 0.5, oracle_boxes: bool = False, device: str = "cuda",
             recognizer: MathRecognition | None = None, stitch: bool = False,
             regions: str = "hard", detect_weights=None, detect_quantize=None) -> dict:
    """The row of one arm.  ``recognizer`` replaces the version block's
    (a test's tiny model); ``coalesce_ratio`` is then its own.
    ``detect_quantize``: the detector's None, ``bf16`` or ``int8``."""
    if device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("page_eval: no CUDA card; pass --device cpu to run on the CPU")
    recog = recognizer
    if recog is None:
        cfg, weights = load_recog_config(version=version)
        recog = MathRecognition(cfg, weights, coalesce_ratio=coalesce_ratio, device=device)
    app = App(use_detect=True, recognizer=recog, detect_weights=detect_weights, conf_thresh=conf,
              nms_iou=nms_iou, expand_frac=expand, stitch=stitch,
              detect_quantize=detect_quantize, device=device)
    rng = np.random.default_rng(EVAL_SEED)
    data = [synth_labelled_page(rng, style=regions) for _ in range(pages)]
    n_gt = sum(len(b) for _, b, _ in data)
    tf32 = torch.backends.cudnn.allow_tf32 if device != "cpu" else None
    print(f"page_eval: {pages} pages / {n_gt} GT regions, version={version} "
          f"beam={recog.beam_size} quantize={recog.config.get('quantize')} "
          f"coalesce={recog.coalesce_ratio} stitch={stitch} regions={regions} "
          f"detect_quantize={detect_quantize} "
          f"device={device} tf32={tf32}",
          file=sys.stderr, flush=True)

    tp = fp = fn = 0
    matched = []  # (predicted latex, gt label)
    t_detect = t_recog = 0.0
    for pi, (page, gt_boxes, gt_labels) in enumerate(data):
        t0 = time.time()
        if oracle_boxes:
            det_boxes = expand_boxes(np.asarray(gt_boxes, np.float32).reshape(-1, 4),
                                     page.shape[:2], frac=expand)
            crops = app.detector.crop_regions(page, det_boxes)
            det_boxes = [tuple(int(round(v)) for v in b) for b in det_boxes]
        else:
            det_boxes, crops = app.detect_and_crop(page)
        t_detect += time.time() - t0
        t0 = time.time()
        latexes = recog(crops) if crops else []
        t_recog += time.time() - t0
        # greedy unique matching in the detector's order (boxes come sorted
        # by detector confidence)
        gt = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        db = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        ious = iou_matrix(db, gt)
        taken = np.zeros(len(gt), bool)
        for i in range(len(db)):
            cand = np.where(~taken, ious[i], -1.0) if len(gt) else []
            j = int(np.argmax(cand)) if len(gt) else -1
            if j >= 0 and cand[j] >= iou:
                taken[j] = True
                tp += 1
                matched.append((latexes[i], gt_labels[j]))
            else:
                fp += 1
        fn += int((~taken).sum())
        if (pi + 1) % 20 == 0:
            print(f"  {pi + 1}/{pages} pages", file=sys.stderr, flush=True)

    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    gts = [postprocess_prediction(g) for _, g in matched]
    preds = [p for p, _ in matched]
    n_match = len(matched)
    correct = sum(p == g for p, g in zip(preds, gts))
    char_match = (sum(get_single_ED(g, p) for p, g in zip(preds, gts)) / n_match
                  if n_match else 0.0)
    return {
        "version": version, "pages": pages, "gt_regions": n_gt, "stitch": bool(stitch),
        "beam": recog.beam_size, "quantize": recog.config.get("quantize"),
        "coalesce_ratio": recog.coalesce_ratio, "iou_thresh": iou, "conf_thresh": conf,
        "nms_iou": nms_iou, "expand_frac": expand, "detect_quantize": detect_quantize,
        "oracle_boxes": bool(oracle_boxes), "regions": regions,
        "det_precision": round(prec, 4), "det_precision_ci": wilson(tp, tp + fp),
        "det_recall": round(rec, 4), "det_recall_ci": wilson(tp, tp + fn),
        "det_f1": round(f1, 4),
        "em_matched": round(correct / max(n_match, 1), 4),
        "em_matched_ci": wilson(correct, n_match),
        "char_matched": round(char_match, 4),
        "end_to_end_acc": round(correct / max(n_gt, 1), 4),
        "end_to_end_ci": wilson(correct, n_gt),
        "detect_s_per_page": round(t_detect / pages, 3),
        "recog_s_per_page": round(t_recog / pages, 3),
        "seed": EVAL_SEED, "tf32": tf32, **card(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pages", type=int, default=100)
    ap.add_argument("--version", default="synthetic_tfm_big")
    ap.add_argument("--coalesce_ratio", type=float, default=None,
                    help="recognizer bucket coalescing (default: the version block's)")
    ap.add_argument("--conf", type=float, default=0.5, help="detector confidence threshold")
    ap.add_argument("--nms_iou", type=float, default=0.1, help="page-level NMS IoU")
    ap.add_argument("--expand", type=float, default=0.05, help="crop box expansion fraction")
    ap.add_argument("--iou", type=float, default=0.5, help="IoU of a matched detection")
    ap.add_argument("--oracle_boxes", action="store_true",
                    help="ground-truth boxes as detections (skip the detector): the exact "
                    "match a perfect detector would reach")
    ap.add_argument("--regions", default="hard", choices=["hard", "structured"],
                    help="region render style (see synth_labelled_page)")
    ap.add_argument("--detect_weights", default=None,
                    help="detector msgpack instead of the shipped one (a retrained detector)")
    ap.add_argument("--stitch", action="store_true",
                    help="the voting stitch instead of the page NMS")
    quant = ap.add_mutually_exclusive_group()
    quant.add_argument("--int8_detect", action="store_true",
                       help="the detector's gated convolutions in int8 (ops/quant.py)")
    quant.add_argument("--bf16_detect", action="store_true",
                       help="the detector's convolutions in bfloat16 (parameters float32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    detect_quantize = "int8" if args.int8_detect else "bf16" if args.bf16_detect else None
    row = evaluate(args.pages, args.version, args.coalesce_ratio, args.conf, args.nms_iou,
                   args.expand, args.iou, args.oracle_boxes, args.device, stitch=args.stitch,
                   regions=args.regions, detect_weights=args.detect_weights,
                   detect_quantize=detect_quantize)
    key = result_key(args.version, args.pages, args.coalesce_ratio, args.conf, args.nms_iou,
                     args.expand, args.iou, args.oracle_boxes, args.stitch, args.regions,
                     args.detect_weights, detect_quantize)
    merged = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            merged = json.load(f)
    merged[key] = row
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({key: row}))


if __name__ == "__main__":
    main()
