"""PDF-level voting-stitch driver (the port's twin of the repository's
``tools/stitch_pdf.py``).

    python -m doc2tex_tpu_torch.tools.stitch_pdf --data_file pdfs.txt
        --detections_dir det/ [--images_dir imgs/] --output_dir out/
        [--thresh_votes 30] [--algorithm equal|sum|max|avg] [--num_workers N]
    python -m doc2tex_tpu_torch.tools.stitch_pdf --pages 'scans/*.png' --output_dir out/
        [--conf_thresh 0.5] [--detect_weights W.msgpack] [--device cuda]

CSV mode (the reference's flow, ScanSSD's ``stitch_patches_pdf.py``):
read each PDF's raw windowed detections (``<detections_dir>/<pdf>.csv``,
rows ``page,x1,y1,x2,y2[,score]``; no score weighs every box 1), group
them by page, voting-stitch every page (``detection.stitch.stitch_page``,
fit to the ink of ``<images_dir>/<pdf>/<page+1>.png`` where that exists),
over a process pool of ``--num_workers``, and append the regions to
``<output_dir>/<pdf>.csv`` as ``page,x1,y1,x2,y2`` (``%.2f``).  Host code
only.  Live mode: each page image matching ``--pages`` (sorted) goes
through one detector (``MathDetector.detect_page(raw=True)`` on
``--device``, the card unless ``--device cpu``) and is stitched; every
region goes to ``<output_dir>/pages.csv`` under the page's index.  As in
the JAX tool, the detector is its seeded init unless ``--detect_weights``
names weights (the released ones are
``saved_models/math_detect/best_weights.msgpack``).  Pages are read by
``detection.data.read_page`` (PNG and baseline JPEG, PIL's
``convert("L")`` bytes), never PIL.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from ..detection.data import read_page
from ..detection.stitch import stitch_page


def _read_math(path: str) -> np.ndarray:
    """A raw-detection CSV: rows page,x1,y1,x2,y2[,score]."""
    data = np.genfromtxt(path, delimiter=",")
    if data.ndim == 1:
        data = data[None, :]
    return data


def _load_page_image(images_dir: str, pdf: str, page: int):
    # the reference's layout: <images_dir>/<pdf>/<page+1>.png
    path = os.path.join(images_dir, pdf, f"{page + 1}.png")
    if not os.path.exists(path):
        return None
    return read_page(path)


def _stitch_one(task):
    """One page's voting stitch (a pool worker)."""
    pdf, page, boxes_scores, page_image, page_hw, thresh_votes, algo = task
    if page_image is not None:
        page_hw = page_image.shape[:2]
    boxes = stitch_page(boxes_scores, page_hw, page_image=page_image, algorithm=algo,
                        thresh_votes=thresh_votes)
    return pdf, page, boxes


def _write_results(output_dir: str, results) -> list[str]:
    written = []
    for pdf, page, boxes in results:
        if not boxes:
            continue
        out_path = os.path.join(output_dir, pdf + ".csv")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        rows = np.concatenate([np.full((len(boxes), 1), float(page)),
                               np.asarray(boxes, float)], axis=1)
        with open(out_path, "a") as f:
            np.savetxt(f, rows, fmt="%.2f", delimiter=",")
        written.append(out_path)
    return written


def stitch_from_csvs(data_file: str, detections_dir: str, images_dir: str | None,
                     output_dir: str, thresh_votes: float = 30, algorithm: str = "equal",
                     num_workers: int = 1, default_page_hw=(1024, 1280)) -> list[str]:
    """CSV mode (see the module docstring); returns the files appended to,
    once per page with regions."""
    with open(data_file) as f:
        pdfs = [ln.strip() for ln in f if ln.strip()]
    tasks = []
    for pdf in pdfs:
        det = _read_math(os.path.join(detections_dir, pdf + ".csv"))
        for page in np.unique(det[:, 0]):
            rows = det[det[:, 0] == page][:, 1:]
            if rows.shape[1] == 4:    # no score column: weigh every box 1
                rows = np.concatenate([rows, np.ones((len(rows), 1))], axis=1)
            img = _load_page_image(images_dir, pdf, int(page)) if images_dir else None
            tasks.append((pdf, int(page), rows, img, default_page_hw, thresh_votes, algorithm))
    if num_workers > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
            results = pool.map(_stitch_one, tasks)
    else:
        results = [_stitch_one(t) for t in tasks]
    return _write_results(output_dir, results)


def stitch_live(pages_glob: str, output_dir: str, thresh_votes: float = 30,
                algorithm: str = "equal", conf_thresh: float = 0.5, device: str = "cuda",
                detect_weights: str | None = None, detector=None) -> list[str]:
    """Detect and stitch the page images matching ``pages_glob`` with one
    detector for every page: ``detector``, else a ``MathDetector`` of
    ``detect_weights`` (None: its seeded init, as the JAX tool builds it)."""
    if detector is None:
        from ..detection.flow import MathDetector

        detector = MathDetector(detect_weights, conf_thresh=conf_thresh, device=device)
    results = []
    for i, path in enumerate(sorted(glob.glob(pages_glob))):
        page = read_page(path)
        raw_boxes, raw_scores = detector.detect_page(page, raw=True)
        bs = (np.concatenate([raw_boxes, raw_scores[:, None]], axis=1)
              if len(raw_boxes) else np.zeros((0, 5), np.float32))
        results.append(_stitch_one(("pages", i, bs, page, page.shape[:2], thresh_votes,
                                    algorithm)))
        print(f"{path}: {len(results[-1][2])} regions", file=sys.stderr)
    return _write_results(output_dir, results)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_file", help="text file listing pdf names")
    p.add_argument("--detections_dir", help="dir of <pdf>.csv raw detections")
    p.add_argument("--images_dir", default=None,
                   help="dir of <pdf>/<page>.png page images (enables fit-to-ink postprocess)")
    p.add_argument("--pages", default=None, help="glob of page images for live detect+stitch")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--thresh_votes", type=float, default=30)
    p.add_argument("--algorithm", default="equal", choices=["equal", "sum", "max", "avg"])
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--conf_thresh", type=float, default=0.5)
    p.add_argument("--detect_weights", default=None,
                   help="the live mode's detector weights (default: its seeded init)")
    p.add_argument("--device", default="cuda", help="the live mode's detector device")
    args = p.parse_args(argv)

    if args.pages:
        import torch

        if args.device != "cpu" and not torch.cuda.is_available():
            raise SystemExit("stitch_pdf: no CUDA card; pass --device cpu to run on the CPU")
        written = stitch_live(args.pages, args.output_dir, args.thresh_votes, args.algorithm,
                              args.conf_thresh, args.device, args.detect_weights)
    else:
        if not (args.data_file and args.detections_dir):
            p.error("need --pages OR --data_file + --detections_dir")
        written = stitch_from_csvs(args.data_file, args.detections_dir, args.images_dir,
                                   args.output_dir, args.thresh_votes, args.algorithm,
                                   args.num_workers)
    print(f"wrote {len(written)} page row-groups under {args.output_dir}")


if __name__ == "__main__":
    main()
