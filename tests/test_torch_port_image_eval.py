"""The image metric's twins against the JAX package's and the repository's
tools: ``doc2tex_tpu_torch/tools/image_eval.py`` against
``doc2tex_tpu.tools.image_eval``, ``tools/evaluate_images.py`` and
``tools/inspect_images.py`` against their namesakes under ``tools/``.

- ``img_edit_distance`` equal (all four outputs) on generated PNG pairs
  in every case: equal renders, a render off by under 5 pixels a column
  (the fuzzy match), one with extra blank columns (matches without spaces
  only), a different one, a missing one, all-white renders and renders of
  other heights; ``evaluate_image_pairs`` equal over them;
- the native edit distance over column ids equals the plain DP
  (``eval.metrics._lev_py``);
- ``merge_image_metrics``: the merged CSV, the unmatched list and the
  totals equal the JAX tool's, on headered and headerless prediction CSVs;
- ``inspect_images``: the compare sheets' pixels equal PIL's sheets
  written by the JAX tool, and ``split`` copies the same files.

Host code only: no JAX is imported (the JAX package's ``image_eval`` is
numpy).
"""

from __future__ import annotations

import csv
import os
import sys

import numpy as np
import pytest
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from doc2tex_tpu.tools import image_eval as jax_image_eval  # noqa: E402
from doc2tex_tpu_torch.eval.metrics import _lev_py  # noqa: E402
from doc2tex_tpu_torch import native  # noqa: E402
from doc2tex_tpu_torch.tools import evaluate_images, image_eval, inspect_images  # noqa: E402
from tools import evaluate_images as jax_evaluate_images  # noqa: E402
from tools import inspect_images as jax_inspect_images  # noqa: E402


def _render(rng, h=40, w=120) -> np.ndarray:
    img = np.full((h, w), 255, np.uint8)
    for _ in range(6):
        y, x = int(rng.integers(2, h - 12)), int(rng.integers(2, w - 12))
        img[y:y + int(rng.integers(3, 10)), x:x + int(rng.integers(2, 10))] = rng.integers(0, 120)
    return img


def _cases():
    """(name, gold, pred or None) covering every branch of the metric."""
    rng = np.random.default_rng(0)
    gold = _render(rng)
    fuzzy = gold.copy()
    ink = np.argwhere(gold < 128)
    y, x = ink[len(ink) // 2]
    fuzzy[y, x] = 255                                   # one pixel of one column
    spaced = np.full((40, 140), 255, np.uint8)
    spaced[:, :60] = gold[:, :60]
    spaced[:, 80:] = gold[:, 60:]                       # 20 blank columns inserted
    other = _render(np.random.default_rng(1))
    tall = np.full((60, 120), 255, np.uint8)
    tall[10:50] = gold
    return [("equal", gold, gold.copy()), ("fuzzy", gold, fuzzy), ("spaced", gold, spaced),
            ("other", gold, other), ("missing", gold, None),
            ("white", np.full((20, 30), 255, np.uint8), np.full((20, 30), 255, np.uint8)),
            ("white_vs_ink", np.full((20, 30), 255, np.uint8), other),
            ("taller", gold, tall), ("noise", _render(rng, 30, 90), _render(rng, 33, 97))]


CASES = _cases()


@pytest.mark.parametrize("name,gold,pred", CASES, ids=[c[0] for c in CASES])
def test_img_edit_distance_equals_jax(name, gold, pred):
    assert image_eval.img_edit_distance(gold, pred) == jax_image_eval.img_edit_distance(gold, pred)


def test_cases_cover_every_outcome():
    outs = {name: image_eval.img_edit_distance(g, p) for name, g, p in CASES}
    assert outs["equal"][0] == 0 and outs["equal"][2:] == (True, True)
    assert outs["fuzzy"][0] > 0 and outs["fuzzy"][2:] == (True, True)
    assert outs["spaced"][2:] == (False, True)
    assert outs["other"][2:] == (False, False) and outs["missing"][2:] == (False, False)


def test_evaluate_image_pairs_equals_jax():
    pairs = [(g, p) for _, g, p in CASES]
    assert image_eval.evaluate_image_pairs(pairs) == jax_image_eval.evaluate_image_pairs(pairs)


def test_native_column_distance_equals_plain_dp():
    rng = np.random.default_rng(2)
    for n, m in ((0, 5), (7, 0), (30, 41), (64, 64)):
        a, b = rng.integers(0, 6, n).astype(np.uint64), rng.integers(0, 6, m).astype(np.uint64)
        assert native.levenshtein_u64(a, b) == _lev_py(a.tolist(), b.tolist())


def _write_renders(tmp_path):
    gold, pred = tmp_path / "gold", tmp_path / "pred"
    gold.mkdir()
    pred.mkdir()
    names = []
    for i, (name, g, p) in enumerate(CASES):
        fname = f"f{i}_{name}.png"
        Image.fromarray(g).save(gold / fname)
        if p is not None:
            Image.fromarray(p if i % 2 else np.repeat(p[..., None], 3, -1)).save(pred / fname)
        names.append(fname)
    return gold, pred, names


@pytest.mark.parametrize("header", [True, False], ids=["headered", "reference_columns"])
def test_merge_image_metrics_equals_jax(tmp_path, header):
    gold, pred, names = _write_renders(tmp_path)
    outs = {}
    for tag, module in (("jax", jax_evaluate_images), ("port", evaluate_images)):
        d = tmp_path / tag
        d.mkdir()
        csv_path = d / "results.csv"
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            if header:
                w.writerow(evaluate_images.OUR_COLUMNS)
            for n in names + ["absent.png"]:
                w.writerow([n, "x y", "x", "0.5", "1"] if header
                           else [n, "x y", "x", "0.5", "0.4", "0.3", "1"])
        agg = module.merge_image_metrics(str(gold), str(pred), str(csv_path), str(d / "log"),
                                         log_every=4)
        merged = (d / "results_img_metric.csv").read_bytes()
        unmatched = (d / "log" / "unmatched_filenames.txt").read_text().replace(str(gold), "")
        outs[tag] = ({k: v for k, v in agg.items() if k not in ("merged_csv", "unmatched_file")},
                     merged, unmatched)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]["n"] == len(CASES) and "f4_missing.png" in outs["port"][2]


def test_inspect_images_equal_jax(tmp_path):
    gold, pred, names = _write_renders(tmp_path)
    n_jax = jax_inspect_images.build_compare_sheets(str(pred), str(gold), str(tmp_path / "sj"))
    n_port = inspect_images.build_compare_sheets(str(pred), str(gold), str(tmp_path / "sp"))
    assert n_port == n_jax == len(CASES) - 1
    assert sorted(os.listdir(tmp_path / "sp")) == sorted(os.listdir(tmp_path / "sj"))
    for name in os.listdir(tmp_path / "sj"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "sp" / name)),
                                      np.asarray(Image.open(tmp_path / "sj" / name)))
    a, b = np.full((4, 6), 10, np.uint8), np.full((3, 9, 3), 20, np.uint8)
    np.testing.assert_array_equal(inspect_images.vstack_autopad((a, b), pad_value=7),
                                  jax_inspect_images.vstack_autopad((a, b), pad_value=7))
    lst = tmp_path / "unmatched_filenames.txt"
    lst.write_text(f"some/dir/{names[1]}\n{names[3]}\n")
    counts = {}
    for tag, module in (("jax", jax_inspect_images), ("port", inspect_images)):
        renders = tmp_path / tag / "renders"
        renders.mkdir(parents=True)
        for n in names:
            (renders / n).write_bytes((gold / n).read_bytes())
        counts[tag] = module.split_by_match(str(lst), str(renders), rm_input=tag == "port")
        assert renders.exists() == (tag == "jax")
        counts[tag + "_dirs"] = {d: sorted(os.listdir(tmp_path / tag / d))
                                 for d in ("match", "un_match")}
    assert counts["port"] == counts["jax"] == {"match": len(names) - 2, "un_match": 2}
    assert counts["port_dirs"] == counts["jax_dirs"]
    assert inspect_images.main(["merge", str(pred), str(gold), str(tmp_path / "sm")]) == 0
    assert sorted(os.listdir(tmp_path / "sm")) == sorted(os.listdir(tmp_path / "sj"))
