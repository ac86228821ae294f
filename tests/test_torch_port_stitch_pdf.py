"""The PDF stitch driver's twin (``doc2tex_tpu_torch/tools/stitch_pdf.py``)
against the repository's ``tools/stitch_pdf.py``:

- CSV mode writes the same files, byte for byte, on generated raw window
  detections (with and without a score column) over two PDFs, with and
  without page images (the fit to the ink), for every voting algorithm
  and through the process pool (``--num_workers 2``), from ``main``'s
  arguments too;
- live mode parses its arguments and runs the detect-then-stitch loop
  with a stubbed detector: the regions equal the CSV mode's on the same
  raw boxes, the pages read from PNG and JPEG files.

Host code only: no JAX is imported.
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

from doc2tex_tpu_torch.tools import stitch_pdf  # noqa: E402
from tools import stitch_pdf as jax_stitch_pdf  # noqa: E402

PAGE_HW = (360, 480)


def _page(rng, clusters) -> np.ndarray:
    page = np.full(PAGE_HW, 255, np.uint8)
    for bx, by in clusters:
        page[by + 8:by + 30, bx + 10:bx + 140:3] = rng.integers(0, 90)
    return page


def _detections(rng, pdfs, score: bool):
    """{pdf: rows page,x1,y1,x2,y2[,score]} of dense window boxes around
    each page's clusters, and {pdf: {page: clusters}}."""
    det, clusters = {}, {}
    for k, pdf in enumerate(pdfs):
        rows, clusters[pdf] = [], {}
        for page in range(2 + k):
            cl = [(int(rng.integers(10, 300)), int(rng.integers(10, 300)))
                  for _ in range(int(rng.integers(1, 3)))]
            clusters[pdf][page] = cl
            for bx, by in cl:
                for dx in range(0, 40, 4):
                    jit = rng.integers(-3, 4, 2)
                    rows.append([page, bx + dx + jit[0], by + jit[1], bx + dx + 120, by + 40,
                                 round(float(rng.uniform(0.5, 1.0)), 2)])
        det[pdf] = np.asarray(rows, float)[:, :6 if score else 5]
    return det, clusters


def _setup(tmp_path, score=True, images=True, seed=0):
    rng = np.random.default_rng(seed)
    pdfs = ["paper1", "paper2"]
    det, clusters = _detections(rng, pdfs, score)
    det_dir, img_dir = tmp_path / "det", tmp_path / "imgs"
    det_dir.mkdir()
    for pdf in pdfs:
        np.savetxt(det_dir / f"{pdf}.csv", det[pdf], fmt="%.2f", delimiter=",")
        if images:
            (img_dir / pdf).mkdir(parents=True)
            for page, cl in clusters[pdf].items():
                Image.fromarray(_page(rng, cl)).save(img_dir / pdf / f"{page + 1}.png")
    data_file = tmp_path / "pdfs.txt"
    data_file.write_text("\n".join(pdfs) + "\n\n")
    return str(data_file), str(det_dir), str(img_dir) if images else None


def _files(out_dir) -> dict:
    return {name: open(os.path.join(out_dir, name), "rb").read()
            for name in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("algorithm", ["equal", "sum", "max", "avg"])
@pytest.mark.parametrize("score,images", [(True, True), (False, True), (True, False)],
                         ids=["score_ink", "noscore_ink", "score_noink"])
def test_csv_mode_writes_the_same_files(tmp_path, algorithm, score, images):
    data_file, det_dir, img_dir = _setup(tmp_path, score, images)
    # max and avg vote with scores (at most 1), equal and sum with counts
    kw = dict(thresh_votes=0.5 if algorithm in ("max", "avg") else 5, algorithm=algorithm)
    want = jax_stitch_pdf.stitch_from_csvs(data_file, det_dir, img_dir, str(tmp_path / "jax"),
                                           **kw)
    got = stitch_pdf.stitch_from_csvs(data_file, det_dir, img_dir, str(tmp_path / "port"), **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") != {}


def test_pool_and_main_write_the_same_files(tmp_path):
    data_file, det_dir, img_dir = _setup(tmp_path, seed=1)
    jax_stitch_pdf.stitch_from_csvs(data_file, det_dir, img_dir, str(tmp_path / "jax"),
                                    thresh_votes=5)
    stitch_pdf.stitch_from_csvs(data_file, det_dir, img_dir, str(tmp_path / "pool"),
                                thresh_votes=5, num_workers=2)
    stitch_pdf.main(["--data_file", data_file, "--detections_dir", det_dir, "--images_dir",
                     img_dir, "--output_dir", str(tmp_path / "main"), "--thresh_votes", "5"])
    assert _files(tmp_path / "pool") == _files(tmp_path / "jax") == _files(tmp_path / "main")


class _StubDetector:
    """``detect_page(page, raw=True)`` from a table of raw boxes by page size."""

    def __init__(self, raw):
        self.raw, self.calls = raw, []

    def detect_page(self, page, raw=False):
        assert raw
        self.calls.append(page.shape)
        rows = self.raw[page.shape]
        return rows[:, :4].astype(np.float32), rows[:, 4].astype(np.float32)


def test_live_mode_runs_with_a_stubbed_detector(tmp_path):
    rng = np.random.default_rng(3)
    det, clusters = _detections(rng, ["paper1"], score=True)
    pages_dir = tmp_path / "scans"
    pages_dir.mkdir()
    raw, pages = {}, []
    for page, cl in clusters["paper1"].items():
        img = _page(rng, cl)[: PAGE_HW[0] - 8 * page]       # a size a page: the stub's key
        raw[img.shape] = det["paper1"][det["paper1"][:, 0] == page][:, 1:]
        ext = ".png" if page == 0 else ".jpg"
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG" if ext == ".png" else "JPEG", quality=95)
        (pages_dir / f"{page:02d}{ext}").write_bytes(buf.getvalue())
        pages.append(np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("L")))
    stub = _StubDetector(raw)
    written = stitch_pdf.stitch_live(str(pages_dir / "*"), str(tmp_path / "live"),
                                     thresh_votes=5, detector=stub)
    assert written and stub.calls == [p.shape for p in pages]
    got = np.genfromtxt(tmp_path / "live" / "pages.csv", delimiter=",", ndmin=2)
    want = []
    for i, page in enumerate(pages):
        for box in stitch_pdf.stitch_page(raw[page.shape], page.shape, page_image=page,
                                          thresh_votes=5):
            want.append([i, *box])
    np.testing.assert_array_equal(got, np.asarray(want, float))
    with pytest.raises(SystemExit):
        stitch_pdf.main(["--output_dir", str(tmp_path / "x")])     # neither mode's arguments
