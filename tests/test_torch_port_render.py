"""TeX rendering's twin (``doc2tex_tpu_torch/tools/render.py``) against
``doc2tex_tpu.tools.render``.  Neither machine has pdflatex or
ImageMagick, so the host parts are held to JAX's and the subprocess parts
run under the fake binaries of ``tests/test_render.py`` (its ``fake_tex``
and ``fake_tex_clean`` fixtures, which the port's module is pointed at
too):

- ``map_error_lines`` equal on canned logs (each formula, block edges,
  several errors, lines out of range, an empty log);
- ``postprocess_render`` equal on PNG renders (trim and pad, a blank
  page, a side over ``max_side``);
- ``render_formulas``: the same formulas kept and the same pixels written;
  the kill timer; ``render_dataset``'s fallback a formula at a time;
- ``selftest``: blocked without TeX, goldens written then passing;
- ``realdata``'s render stage: BLOCKED without TeX, ``imgs/`` and
  ``labels.tsv`` under the fakes.

No JAX is imported (the JAX package's render module is numpy and PIL).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from doc2tex_tpu.tools import render as jax_render  # noqa: E402
from doc2tex_tpu_torch.tools import realdata  # noqa: E402
from doc2tex_tpu_torch.tools import render  # noqa: E402
from test_render import fake_tex, fake_tex_clean, formula_line  # noqa: E402,F401

FORMULAS = [f"x_{i} + y^{i}" for i in range(8)]


def _log(*idx):
    return "\n".join(f"./batch.tex:{formula_line(FORMULAS, i)}: Undefined control sequence."
                     for i in idx)


@pytest.mark.parametrize("log", [
    _log(0), _log(3), _log(7), _log(1, 4, 6), "./batch.tex:1: x\n./batch.tex:999: y", "",
    "./batch.tex:%d: Missing $ inserted." % (formula_line(FORMULAS, 2) + 2),
    "./batch.tex:%d: Missing $ inserted." % (formula_line(FORMULAS, 5) - 1)])
def test_map_error_lines_equals_jax(log):
    assert render.map_error_lines(log, len(FORMULAS)) == jax_render.map_error_lines(
        log, len(FORMULAS))


@pytest.mark.parametrize("case", ["ink", "blank", "too_big", "rgb"])
def test_postprocess_render_equals_jax(tmp_path, case):
    rng = np.random.default_rng(0)
    img = np.full((40, 60), 255, np.uint8)
    img[10:20, 15:35] = rng.integers(0, 200, (10, 20))
    if case == "blank":
        img[:] = 255
    path = str(tmp_path / "x.png")
    Image.fromarray(np.repeat(img[..., None], 3, -1) if case == "rgb" else img).save(path)
    kw = {"max_side": 16} if case == "too_big" else {"pad": 5}
    got, want = render.postprocess_render(path, **kw), jax_render.postprocess_render(path, **kw)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def _point_port_at_fakes(monkeypatch):
    """The port's module at the binaries ``tests/test_render.py``'s fixture
    set on the JAX module."""
    for name in ("PDFLATEX", "CONVERT", "HAS_TEX"):
        monkeypatch.setattr(render, name, getattr(jax_render, name))


def _pixels(paths: dict) -> dict:
    return {i: np.asarray(Image.open(p).convert("L")) for i, p in paths.items()}


def test_render_formulas_under_fake_tex(fake_tex, tmp_path, monkeypatch):
    _point_port_at_fakes(monkeypatch)
    formulas = [f"f{i}" for i in range(fake_tex["n_pages"])]
    want = jax_render.render_formulas(formulas, str(tmp_path / "jax"))
    got = render.render_formulas(formulas, str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == [0, 1, 3]
    assert [os.path.basename(p) for p in got.values()] == [
        os.path.basename(p) for p in want.values()]
    for i, px in _pixels(got).items():
        np.testing.assert_array_equal(px, _pixels(want)[i])
    monkeypatch.setattr(render, "PDFLATEX", fake_tex["sleeper"])
    with pytest.raises(render.RenderError, match="timed out"):
        render.render_formulas(["x"], str(tmp_path / "out"), timeout=1.0)
    assert render.render_dataset(["a", "b"], str(tmp_path / "out"), timeout=0.5) == {}


def test_render_without_tex_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(render, "HAS_TEX", False)
    with pytest.raises(render.RenderError):
        render.render_formulas(["x"], str(tmp_path))
    assert render.selftest(str(tmp_path / "o")) == 2


def test_selftest_writes_goldens_then_passes(fake_tex_clean, tmp_path, monkeypatch):
    _point_port_at_fakes(monkeypatch)
    goldens = str(tmp_path / "goldens.json")
    assert render.selftest(str(tmp_path / "o"), goldens_path=goldens) == 0
    assert os.path.exists(goldens)
    assert render.selftest(str(tmp_path / "o2"), goldens_path=goldens) == 0


def test_realdata_render_stage(fake_tex_clean, tmp_path, monkeypatch):
    work = tmp_path / "work"
    work.mkdir()
    formulas = render.SELFTEST_FORMULAS[:4]
    (work / "formulas.norm.lst").write_text("\n".join(formulas) + "\n\n")
    monkeypatch.setattr(render, "HAS_TEX", False)
    assert realdata.stage_render(str(work), str(work / "formulas.norm.lst")) is False
    _point_port_at_fakes(monkeypatch)
    assert realdata.stage_render(str(work), str(work / "formulas.norm.lst")) is True
    rows = (work / "labels.tsv").read_text().splitlines()
    assert [r.split("\t") for r in rows] == [[f"f{i:06d}.png", f] for i, f in enumerate(formulas)]
    assert sorted(os.listdir(work / "imgs")) == [f"f{i:06d}.png" for i in range(4)]
