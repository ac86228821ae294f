"""Full-page math detection and recognition (counterpart of the JAX
package's ``demo/app.py``).

A page is resized to width 1280, its math regions are detected (SSD512 over
sliding windows, NMS) and expanded by 5 %, each region is cropped and the
crops are recognized to LaTeX.  ``App(page)`` gives ``[(box, latex), ...]``
with boxes in the original page's pixels.  With ``stitch=True`` the regions
come from the voting stitch instead (``detection.stitch.stitch_page``): every
window's boxes (``detect_page(raw=True)``) vote on the resized page, the
regions with at least ``stitch_votes`` votes are fitted to the ink, each
scored 1.

    python -m doc2tex_tpu_torch.app page.png [--model_version synthetic_tfm_big]
        [--detect_weights W] [--no_detect] [--stitch] [--device cuda]

The page is read as PIL's ``convert("L")`` would read it (``utils/png.py``;
PNG only).  The recognizer is the version block's release as it ships
(``quantize: int8``, beam 10); the detector the released
``saved_models/math_detect`` weights in float32.  Everything runs on
``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from .detection.flow import SHIPPED_WEIGHTS, MathDetector
from .detection.stitch import stitch_page
from .recognition import MathRecognition
from .transforms.preprocess import detect_preprocess


class App:
    """page -> [(box, latex), ...]."""

    def __init__(
        self,
        recog_config=None,
        recog_weights: Optional[str] = None,
        detect_weights: Optional[str] = None,
        use_detect: bool = True,
        conf_thresh: float = 0.5,
        nms_iou: float = 0.1,
        expand_frac: float = 0.05,
        stitch: bool = False,
        stitch_votes: float = 8,
        recognizer: Optional[MathRecognition] = None,
        detect_quantize: Optional[str] = None,
        device="cuda",
    ):
        """``detect_weights``: a detector msgpack; None gives the released
        weights when the file is there (else a random init).
        ``recognizer``: a ``MathRecognition`` to share (a serving front's)
        instead of building one from ``recog_config``/``recog_weights``.
        ``stitch``: the voting stitch (``equal`` votes, at least
        ``stitch_votes``) instead of the page NMS.  ``detect_quantize``:
        the detector in ``bf16`` or ``int8`` (``MathDetector``)."""
        self.use_detect = use_detect
        self.stitch = stitch
        self.stitch_votes = stitch_votes
        self.detector = None
        if use_detect:
            if detect_weights is None and os.path.exists(SHIPPED_WEIGHTS):
                detect_weights = SHIPPED_WEIGHTS
            self.detector = MathDetector(
                detect_weights, conf_thresh=conf_thresh, iou_thresh=nms_iou,
                expand_frac=expand_frac, quantize=detect_quantize, device=device)
        self.recognizer = (recognizer if recognizer is not None
                           else MathRecognition(recog_config, recog_weights, device=device))

    def __call__(self, page: np.ndarray):
        if not self.use_detect:
            h, w = page.shape[:2]
            return [((0, 0, w, h), self.recognizer(page))]
        boxes, crops = self.detect_and_crop(page)
        latexes = self.recognizer(crops) if crops else []
        return list(zip(boxes, latexes))

    def detect_and_crop(self, page: np.ndarray):
        """The detection half: page -> aligned ``([boxes in the original
        page's pixels], [crops of the resized page])``, so a serving front
        (``serving.PageServer``) can send the crops to a shared recognizer."""
        if not self.use_detect:
            h, w = page.shape[:2]
            return [(0, 0, w, h)], [page]
        resized, scale = detect_preprocess(page)
        if self.stitch:
            raw_boxes, raw_scores = self.detector.detect_page(resized, raw=True)
            bs = (np.concatenate([raw_boxes, raw_scores[:, None]], axis=1) if len(raw_boxes)
                  else np.zeros((0, 5), np.float32))
            boxes = np.asarray(stitch_page(bs, resized.shape[:2], page_image=resized,
                                           thresh_votes=self.stitch_votes),
                               np.float32).reshape(-1, 4)
        else:
            boxes, _ = self.detector.detect_page(resized)
        crops = self.detector.crop_regions(resized, boxes)
        # boxes and crops are filtered together: dropping only the empty
        # crops would misalign every later (box, latex) pair
        kept = [(b, c) for b, c in zip(boxes, crops) if c.size > 0]
        if not kept:
            return [], []
        return [tuple(int(round(v / scale)) for v in b) for b, _ in kept], [c for _, c in kept]


def _cli(argv=None) -> None:
    from .recognition import load_recog_config
    from .utils.png import decode_png

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("image", help="page image (PNG)")
    p.add_argument("--recog_config", default=None,
                   help="recognizer yaml (default demo/recog_cfg.yaml)")
    p.add_argument("--model_version", default="synthetic_tfm_big",
                   help="version block of the recognizer yaml")
    p.add_argument("--recog_weights", default=None)
    p.add_argument("--detect_weights", default=None,
                   help="detector msgpack (default: the released saved_models/math_detect)")
    p.add_argument("--no_detect", action="store_true")
    p.add_argument("--stitch", action="store_true",
                   help="voting-stitch the regions instead of the page NMS")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg, weights = load_recog_config(args.recog_config, version=args.model_version)
    with open(args.image, "rb") as f:
        page = decode_png(f.read())
    app = App(recog_config=cfg, recog_weights=args.recog_weights or weights,
              detect_weights=args.detect_weights, use_detect=not args.no_detect,
              stitch=args.stitch, device=args.device)
    for box, latex in app(page):
        print(f"{box}\t{latex}")


if __name__ == "__main__":
    _cli()
