"""Image-metric CSV merge (the port's twin of the repository's
``tools/evaluate_images.py``).

    python -m doc2tex_tpu_torch.tools.evaluate_images --images_gold gold/
        --images_pred pred/ --csv_dir results.csv [--out_dir out/]

For every ``*.png`` of the gold render folder (sorted), the column-wise
image edit distance and the match flags (``tools.image_eval``) against the
same-named prediction render (missing: wholly wrong); the columns
``img_distance``, ``match_w_space`` and ``match_wo_space`` merged into the
prediction CSV (``api.infer``'s headered rows or the reference's seven
columns), written beside it as ``<stem>_img_metric.csv``; running totals
logged every 100 files; the unmatched files listed in
``<out_dir>/unmatched_filenames.txt``.  Renders are read by
``utils.png.decode_png`` (PIL's ``convert("L")`` bytes).  Host code only.
"""

from __future__ import annotations

import argparse
import csv
import glob
import logging
import os
from pathlib import Path

from ..utils.png import decode_png
from .image_eval import img_edit_distance

# the reference's prediction-CSV columns; api.infer writes a headered 5-column variant
REF_COLUMNS = ["name", "pred", "label", "ed", "word_ed", "bleu", "iscorrect"]
OUR_COLUMNS = ["name", "pred", "label", "ed", "iscorrect"]
MERGED_COLUMNS = ["img_distance", "match_w_space", "match_wo_space"]


def _read_pred_csv(path: str) -> tuple[list[str], list[dict]]:
    """A prediction CSV: headered (``api.infer``'s) or headerless (the reference's)."""
    with open(path, newline="") as f:
        raw = list(csv.reader(f))
    if not raw:
        return list(REF_COLUMNS), []
    if raw[0] and raw[0][0] == "name":
        cols, raw = raw[0], raw[1:]
    else:
        cols = REF_COLUMNS if len(raw[0]) >= 7 else OUR_COLUMNS
    return cols, [dict(zip(cols, r)) for r in raw]


def _load_gray(path: str):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return decode_png(f.read())


def merge_image_metrics(images_gold: str, images_pred: str, csv_dir: str, out_dir: str = ".",
                        log_every: int = 100) -> dict:
    """Write ``<stem>_img_metric.csv`` and the unmatched list; returns the
    totals the reference logs."""
    os.makedirs(out_dir, exist_ok=True)
    log = logging.getLogger("evaluate_images")
    cols, rows = _read_pred_csv(csv_dir)
    by_name: dict = {}
    for r in rows:
        by_name.setdefault(r["name"], []).append(r)
    total_ed = total_ref = total_num = correct_w = correct_wo = 0
    unmatched: list[str] = []
    uf_path = os.path.join(out_dir, "unmatched_filenames.txt")
    with open(uf_path, "w") as uf:
        for filename in sorted(glob.glob(os.path.join(images_gold, "*.png"))):
            base = os.path.basename(filename)
            ed, ref, m1, m2 = img_edit_distance(_load_gray(filename),
                                                _load_gray(os.path.join(images_pred, base)))
            total_ed += ed
            total_ref += ref
            total_num += 1
            correct_w += int(m1)
            correct_wo += int(m2)
            for r in by_name.get(base, []):
                r["img_distance"] = ed / ref if ref else 0.0
                r["match_w_space"] = int(m1)
                r["match_wo_space"] = int(m2)
            if not (m1 or m2):
                unmatched.append(filename)
            if total_num % log_every == 0:
                log.info("Total Num: %d", total_num)
                log.info("Accuracy (w spaces): %f", correct_w / total_num)
                log.info("Accuracy (w/o spaces): %f", correct_wo / total_num)
                log.info("Edit Dist (w spaces): %f", 1.0 - total_ed / total_ref)
                for fn in unmatched:
                    uf.write(fn + "\n")
                unmatched = []
                uf.flush()
        for fn in unmatched:
            uf.write(fn + "\n")

    stem = Path(csv_dir).stem.split(".")[0]
    out_csv = str(Path(csv_dir).parent / (stem + "_img_metric.csv"))
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols + MERGED_COLUMNS)
        for r in rows:
            w.writerow([r.get(c, "") for c in cols] + [r.get(c, "") for c in MERGED_COLUMNS])
    agg = {"n": total_num,
           "accuracy_w_space": correct_w / total_num if total_num else 0.0,
           "accuracy_wo_space": correct_wo / total_num if total_num else 0.0,
           "image_edit_distance": 1.0 - total_ed / total_ref if total_ref else 0.0,
           "merged_csv": out_csv, "unmatched_file": uf_path}
    log.info("Final: %s", agg)
    return agg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images_gold", required=True)
    p.add_argument("--images_pred", required=True)
    p.add_argument("--csv_dir", required=True, help="prediction CSV (api.infer's column set)")
    p.add_argument("--out_dir", default=".")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print(merge_image_metrics(args.images_gold, args.images_pred, args.csv_dir, args.out_dir))


if __name__ == "__main__":
    main()
