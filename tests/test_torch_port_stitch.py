"""The port's voting stitch against the JAX package's, on the CPU.

- ``label_components`` (numpy) against ``scipy.ndimage.label`` with a 3x3
  structure and ``find_objects`` on 50 seeded random masks (sparse and
  dense, with diagonal-only contacts, U shapes that join late, one-pixel
  rows and columns) and on the ink of a structured page: equal label
  images and equal slices;
- ``vote_for_regions`` for the 4 algorithms, ``fit_box`` and
  ``stitch_page`` against the JAX package's on synthetic detections over a
  structured labelled page: equal masks and equal boxes;
- ``detect_page(raw=True)`` returns the page candidates as they are, and
  ``App(stitch=True)`` stitches them as ``demo.app.App(stitch=True)``
  does (both detectors returning the same raw boxes), and the stitch's
  entry points (the app CLI's ``--stitch``, ``api.serve --detect
  --stitch``, ``page_eval --stitch --regions structured``) are reachable;
  the page-eval twin runs stitched over structured pages.

The golden stitched boxes and App strings ``chip_smoke.py`` holds the card
to are written by the JAX package on the CPU (``PYTHONPATH=. python
tests/test_torch_port_stitch.py --write-golden``, ~3 min); the tests only
read them.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest

from doc2tex_tpu_torch.detection import stitch as tstitch
from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS
from torch_port_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN_PAGES = os.path.join(HERE, "torch_port_golden_pages.json")
GOLDEN_STITCH = os.path.join(HERE, "torch_port_golden_stitch.json")
STITCH_VOTES = 8


def _masks():
    """50 seeded masks: random densities, plus shapes that test the
    labelling's joins."""
    rng = np.random.default_rng(123)
    out = []
    for i in range(44):
        h, w = int(rng.integers(1, 90)), int(rng.integers(1, 120))
        out.append((rng.random((h, w)) < rng.choice([0.05, 0.2, 0.45, 0.6, 0.9])).astype(np.uint8))
    diag = np.eye(40, dtype=np.uint8) | np.eye(40, k=3, dtype=np.uint8)[::-1]
    u = np.zeros((30, 30), np.uint8)
    u[2:28, 3] = u[2:28, 25] = u[27, 3:26] = 1           # a U: two arms join at the bottom
    u[5, 10:20] = 1
    stairs = np.zeros((25, 50), np.uint8)
    for r in range(25):
        stairs[r, 2 * r:2 * r + 1] = 1                    # no contact at all (gaps of one column)
        stairs[r, 49 - r] = 1                             # diagonal contacts only
    out += [diag, u, stairs, np.ones((1, 37), np.uint8), np.ones((33, 1), np.uint8),
            np.zeros((17, 19), np.uint8)]
    return out


def test_label_components_equals_ndimage():
    from scipy import ndimage

    structure = np.ones((3, 3), int)
    masks = _masks()
    assert len(masks) == 50
    for m in masks:
        want, n = ndimage.label(m, structure=structure)
        got, slices = tstitch.label_components(m)
        assert got.dtype == np.int32 and np.array_equal(got, want)
        assert slices == ndimage.find_objects(want) and len(slices) == n


def _structured_page(seed: int = 35):
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    return synth_labelled_page(np.random.default_rng(seed), style="structured")


def test_label_components_on_a_page_equals_ndimage():
    from scipy import ndimage

    page, _, _ = _structured_page()
    ink = tstitch._to_ink_mask(page)
    want, _ = ndimage.label(ink, structure=np.ones((3, 3), int))
    got, slices = tstitch.label_components(ink)
    assert np.array_equal(got, want) and slices == ndimage.find_objects(want)
    assert len(slices) > 100


def _detections(boxes, rng, per_box: int = 12):
    """Jittered copies of each box with scores, and a few strays: the
    (N, 5) page detections of a windowed detector."""
    out = []
    for x1, y1, x2, y2 in boxes:
        for _ in range(per_box):
            j = rng.normal(0, 4, 4)
            out.append([x1 + j[0], y1 + j[1], x2 + j[2], y2 + j[3], rng.uniform(0.3, 1.0)])
    for _ in range(5):
        x, y = rng.uniform(0, 1100, 2)
        out.append([x, y, x + rng.uniform(10, 150), y + rng.uniform(10, 60), rng.uniform(0.3, 1)])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("algorithm,thresh", [("equal", 8), ("equal", 1), ("sum", 4.0),
                                              ("max", 0.5), ("avg", 0.6)])
def test_vote_and_stitch_equal_jax(algorithm, thresh):
    from doc2tex_tpu.detection import stitch as jstitch

    page, gt_boxes, _ = _structured_page()
    bs = _detections(gt_boxes, np.random.default_rng(5))
    hw = page.shape[:2]
    np.testing.assert_array_equal(tstitch.vote_for_regions(bs, hw, algorithm, thresh),
                                  jstitch.vote_for_regions(bs, hw, algorithm, thresh))
    for kw in ({"page_image": page}, {}, {"page_image": np.stack([page] * 3, -1)},
               {"page_image": page, "postprocess": False}):
        want = jstitch.stitch_page(bs, hw, algorithm=algorithm, thresh_votes=thresh, **kw)
        got = tstitch.stitch_page(bs, hw, algorithm=algorithm, thresh_votes=thresh, **kw)
        assert got == [list(map(int, b)) for b in want] and len(got) >= 1


def test_fit_box_equals_jax():
    from doc2tex_tpu.detection import stitch as jstitch

    page, gt_boxes, _ = _structured_page()
    ink = tstitch._to_ink_mask(page)
    comps = tstitch.label_components(ink)
    rng = np.random.default_rng(9)
    boxes = [b for b in gt_boxes] + [(0, 0, 5, 5), (3.4, 2.6, 1279.5, 1023.4)]
    boxes += [tuple(rng.uniform(0, 1000, 2)) + tuple(rng.uniform(1000, 1280, 2))
              for _ in range(5)]
    for box in boxes:
        want = jstitch.fit_box(ink, box)
        assert tstitch.fit_box(ink, box) == want == tstitch.fit_box(ink, box, comps)


def test_detect_page_raw_returns_the_candidates(monkeypatch):
    from doc2tex_tpu_torch.detection.flow import MathDetector

    det = MathDetector(device="cpu")
    boxes = np.array([[10, 10, 80, 40], [12, 11, 82, 41], [500, 300, 700, 340]], np.float32)
    scores = np.array([0.9, 0.8, 0.6], np.float32)
    monkeypatch.setattr(det, "page_candidates", lambda page: (boxes, scores))
    got = det.detect_page(np.full((512, 768), 255, np.uint8), raw=True)
    assert got[0] is boxes and got[1] is scores
    nms = det.detect_page(np.full((512, 768), 255, np.uint8))
    assert len(nms[0]) == 2                                # the page NMS merged the pair


def test_app_stitch_matches_demo_app(monkeypatch):
    """``App(stitch=True)``: raw boxes -> ``stitch_page`` on the resized page
    (equal votes >= ``stitch_votes``, fit to the ink) -> crops, boxes
    scaled back: the same as ``demo.app.App(stitch=True)`` when both
    detectors return the same raw candidates."""
    import demo.app as demo_app

    from doc2tex_tpu_torch.app import App

    page, gt_boxes, _ = _structured_page()
    page = np.ascontiguousarray(page[:, :1000])             # resized to width 1280 by both
    cands = _detections([(x1 * 1.28, y1 * 1.28, x2 * 1.28, y2 * 1.28)
                         for x1, y1, x2, y2 in gt_boxes if x2 <= 1000], np.random.default_rng(3))
    reader = lambda crops: [f"{c.shape}" for c in crops]    # noqa: E731

    jax_app = demo_app.App(use_detect=True, stitch=True, recognizer=reader,
                           detect_weights=SHIPPED_WEIGHTS)
    port_app = App(use_detect=True, stitch=True, recognizer=reader, device="cpu")
    calls = []

    def detect_page(p, raw=False):
        calls.append(raw)
        return cands[:, :4].copy(), cands[:, 4].copy()

    for app in (jax_app, port_app):
        monkeypatch.setattr(app.detector, "detect_page", detect_page)
    want, got = jax_app(page), port_app(page)
    assert calls == [True, True] and got == want and len(got) >= 2
    assert port_app.stitch_votes == STITCH_VOTES == jax_app.stitch_votes


def test_stitch_entry_points_parse(tmp_path):
    """The stitch reaches every entry point: ``api.serve --detect --stitch``
    builds a stitching page app, ``--stitch`` alone is refused, and the
    page-eval key carries ``_stitch`` / ``_structured`` / ``_customdet``
    in the reference's order."""
    from doc2tex_tpu_torch.api import serve
    from doc2tex_tpu_torch.tools.page_eval import result_key

    args = serve.parse_args(["--detect", "--stitch", "--device", "cpu"])
    assert args.stitch and args.detect
    with pytest.raises(SystemExit, match="needs --detect"):
        serve.parse_args(["--stitch"])
    with pytest.raises(NotImplementedError, match="A10"):
        serve.parse_args(["--data_parallel", "2"])
    assert result_key("synthetic_tfm_big", 40, stitch=True, regions="structured",
                      detect_weights="w.msgpack", coalesce_ratio=8.0) == \
        "synthetic_tfm_big_stitch_co8_structured_customdet_p40"


def test_page_eval_stitch_runs_on_structured_pages(monkeypatch):
    """``page_eval --stitch --regions structured`` end to end on 2 pages,
    the detector's raw candidates replaced by 8 copies of each ground-truth
    box (no SSD forward): the stitch fits them to the ink, and the matching
    finds the regions."""
    from doc2tex_tpu_torch.detection.flow import MathDetector
    from doc2tex_tpu_torch.tools import page_eval

    rng = np.random.default_rng(page_eval.EVAL_SEED)
    truth = {}
    for _ in range(2):
        page, boxes, _ = page_eval.synth_labelled_page(rng, style="structured")
        truth[page.tobytes()] = np.repeat(np.asarray(boxes, np.float32), 8, axis=0)

    def candidates(self, page):
        boxes = truth[np.ascontiguousarray(page).tobytes()]
        return boxes, np.full(len(boxes), 0.9, np.float32)

    class Reader:
        beam_size, coalesce_ratio, config = 1, 0.0, {"quantize": None}

        def __call__(self, crops):
            return ["?"] * len(crops)

    monkeypatch.setattr(MathDetector, "page_candidates", candidates)
    row = page_eval.evaluate(pages=2, device="cpu", recognizer=Reader(), stitch=True,
                             regions="structured")
    assert row["stitch"] and row["regions"] == "structured" and row["gt_regions"] >= 8
    assert row["det_recall"] >= 0.9 and row["det_precision"] >= 0.9


def test_golden_stitch_file_lines_up():
    """The golden stitch file covers the golden pages (same sha256), and
    every region string sits on a stitched box."""
    with open(GOLDEN_STITCH) as f:
        golden = json.load(f)
    with open(GOLDEN_PAGES) as f:
        pages = json.load(f)["pages"]
    assert golden["thresh_votes"] == STITCH_VOTES and golden["algorithm"] == "equal"
    assert [p["sha256"] for p in golden["pages"]] == [p["sha256"] for p in pages]
    for p in golden["pages"]:
        assert len(p["boxes"]) >= len(p["regions"]) >= 1 and p["n_raw"] >= len(p["boxes"])


def write_golden() -> None:
    """Run the JAX package on the CPU over the golden pages:
    ``detect_page(raw=True)`` (the released detector, float32, host windows
    5 a batch: on a 1024x1280 page every window lies inside the page),
    ``stitch_page(thresh_votes=8, page_image=page)`` and
    ``demo.app.App(stitch=True)`` with the float32 ``synthetic_tfm_big``
    recognizer at beam 10."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import demo.app as demo_app
    import page_eval
    from doc2tex_tpu.detection.stitch import stitch_page
    from doc2tex_tpu.recognition.flow import MathRecognition as JaxRecognition
    from doc2tex_tpu.recognition.flow import load_recog_config as jax_load

    with open(GOLDEN_PAGES) as f:
        golden_pages = json.load(f)
    cfg, weights = jax_load(version="synthetic_tfm_big")
    cfg["dtype"], cfg["quantize"] = "float32", None
    recog = JaxRecognition(cfg, weights, beam_size=10)
    app = demo_app.App(use_detect=True, stitch=True, stitch_votes=STITCH_VOTES, recognizer=recog)
    app.detector.device_windows, app.detector.batch_size = False, 5
    rng = np.random.default_rng(golden_pages["seed"])
    pages = []
    for g in golden_pages["pages"]:
        page, _, _ = page_eval.synth_labelled_page(rng)
        assert hashlib.sha256(page.tobytes()).hexdigest() == g["sha256"]
        raw_boxes, raw_scores = app.detector.detect_page(page, raw=True)
        bs = np.concatenate([raw_boxes, raw_scores[:, None]], axis=1)
        boxes = stitch_page(bs, page.shape[:2], page_image=page, thresh_votes=STITCH_VOTES)
        regions = app(page)
        pages.append({
            "sha256": g["sha256"], "n_raw": int(len(raw_boxes)),
            "boxes": [list(map(int, b)) for b in boxes],
            "regions": [{"box": list(map(int, b)), "latex": t} for b, t in regions],
        })
        print(f"page {len(pages)}: {len(raw_boxes)} raw boxes, {len(boxes)} stitched, "
              f"{len(regions)} regions", flush=True)
    golden = {
        "seed": golden_pages["seed"], "page_hw": golden_pages["page_hw"],
        "detector": golden_pages["detector"], "detector_dtype": "float32",
        "conf_thresh": 0.5, "algorithm": "equal", "thresh_votes": STITCH_VOTES,
        "recognizer": {"version": "synthetic_tfm_big", "dtype": "float32", "quantize": None,
                       "beam": 10, "coalesce_ratio": recog.coalesce_ratio},
        "command": "PYTHONPATH=. python tests/test_torch_port_stitch.py --write-golden",
        "pages": pages,
    }
    with open(GOLDEN_STITCH, "w") as f:
        json.dump(golden, f, indent=1, ensure_ascii=False)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_port_stitch.py --write-golden")
    write_golden()
