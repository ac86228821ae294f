"""LaTeX -> PNG rendering through pdflatex/xelatex and ImageMagick (the
port's twin of ``doc2tex_tpu.tools.render``).

The reference's ``Latex`` class and ``render_dataset`` driver
(``doc2tex/tools/build_data/render_data/``): many formulas go into one
``standalone`` + ``preview`` document, compiled with ``-interaction
nonstopmode -file-line-error`` under a time limit; the log's error lines
map back to the formulas, so one bad formula does not lose its batch;
ImageMagick's ``convert -density DPI`` gives a grey PNG a page, trimmed of
its white border and padded white.  PNGs are read by
``utils.png.decode_png`` and written by ``utils.png.encode_png`` (PIL's
bytes, without PIL).

The binaries are looked up at import; without pdflatex and convert
(``HAS_TEX`` False) the module imports and ``render_formulas`` raises
``RenderError``, as the JAX package's does.  Host code only.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

from ..utils.png import decode_png, encode_png

PDFLATEX = shutil.which("pdflatex")
XELATEX = shutil.which("xelatex")
CONVERT = shutil.which("convert") or shutil.which("magick")
HAS_TEX = PDFLATEX is not None and CONVERT is not None

DOC_TEMPLATE = r"""\documentclass[preview]{standalone}
\usepackage{amsmath}
\usepackage{amssymb}
\usepackage{amsfonts}
\begin{document}
%s
\end{document}
"""

FORMULA_TEMPLATE = "$\\displaystyle\n%s\n$\n\\newpage\n"

_ERR_LINE = re.compile(r"^.*?:(\d+):", re.M)


class RenderError(RuntimeError):
    pass


def _read_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def map_error_lines(log_text: str, n_formulas: int) -> set[int]:
    """The formula indices that ``file:line:`` entries of a
    ``-file-line-error`` TeX log point into: every formula spans the same
    number of source lines after the header."""
    bad: set[int] = set()
    header_lines = DOC_TEMPLATE.split("%s")[0].count("\n")
    lines_per_formula = FORMULA_TEMPLATE.count("\n")
    for m in _ERR_LINE.finditer(log_text or ""):
        idx = (int(m.group(1)) - header_lines - 1) // lines_per_formula
        if 0 <= idx < n_formulas:
            bad.add(idx)
    return bad


def render_formulas(formulas: Sequence[str], out_dir: str, names: Optional[Sequence[str]] = None,
                    dpi: int = 200, timeout: float = 20.0, engine: str = "pdflatex"
                    ) -> dict[int, str]:
    """Render each formula to ``out_dir/<name>.png``; {formula index: path}
    of those that rendered (a TeX error or an empty page skips its
    formula).  A timeout, a missing PDF or a failed convert raises
    ``RenderError``."""
    if not HAS_TEX:
        raise RenderError("pdflatex/convert binaries not available")
    os.makedirs(out_dir, exist_ok=True)
    names = list(names) if names else [f"f{i:06d}" for i in range(len(formulas))]
    with tempfile.TemporaryDirectory() as tmp:
        tex_path = os.path.join(tmp, "batch.tex")
        with open(tex_path, "w") as f:
            f.write(DOC_TEMPLATE % "".join(FORMULA_TEMPLATE % x for x in formulas))
        binary = XELATEX if engine == "xelatex" else PDFLATEX
        try:
            proc = subprocess.run([binary, "-interaction", "nonstopmode", "-file-line-error",
                                   "-output-directory", tmp, tex_path],
                                  capture_output=True, timeout=timeout, text=True)
        except subprocess.TimeoutExpired:
            raise RenderError(f"{engine} timed out after {timeout}s")
        pdf_path = os.path.join(tmp, "batch.pdf")
        if not os.path.exists(pdf_path):
            raise RenderError(proc.stdout[-2000:] if proc.stdout else "no pdf")
        bad = map_error_lines(proc.stdout, len(formulas))
        try:
            subprocess.run([CONVERT, "-density", str(dpi), pdf_path, "-colorspace", "gray",
                            os.path.join(tmp, "page.png")],
                           capture_output=True, timeout=max(timeout, 60), check=True)
        except (subprocess.TimeoutExpired, subprocess.CalledProcessError) as e:
            raise RenderError(f"convert failed: {e}")

        def page_number(p):
            m = re.search(r"(\d+)", p)
            return int(m.group(1)) if m else 0

        pages = sorted((p for p in os.listdir(tmp) if p.startswith("page") and p.endswith(".png")),
                       key=page_number)
        if len(formulas) == 1 and os.path.exists(os.path.join(tmp, "page.png")):
            pages = ["page.png"]
        out: dict[int, str] = {}
        for idx, page in enumerate(pages[:len(formulas)]):
            if idx in bad:
                continue
            img = postprocess_render(os.path.join(tmp, page))
            if img is None:
                continue
            dst = os.path.join(out_dir, names[idx] + ".png")
            with open(dst, "wb") as f:
                f.write(encode_png(img))
            out[idx] = dst
        return out


def postprocess_render(png_path: str, pad: int = 8, max_side: int = 4096
                       ) -> Optional[np.ndarray]:
    """A page render trimmed of its white border and padded with ``pad``
    white pixels (the reference's postprocess without its inversion);
    None for a blank page or a side over ``max_side``."""
    img = _read_gray(png_path)
    mask = img < 255
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return None
    img = img[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
    if max(img.shape) > max_side:
        return None
    return np.pad(img, pad, constant_values=255)


def render_dataset(formulas: Sequence[str], out_dir: str, batch_size: int = 100, **kwargs
                   ) -> dict[int, str]:
    """Batches of ``render_formulas``; a batch that fails is retried a
    formula at a time, so a bad formula loses only itself."""
    results: dict[int, str] = {}
    for start in range(0, len(formulas), batch_size):
        chunk = formulas[start:start + batch_size]
        names = [f"f{start + i:06d}" for i in range(len(chunk))]
        try:
            got = render_formulas(chunk, out_dir, names=names, **kwargs)
        except RenderError:
            got = {}
            for i, formula in enumerate(chunk):
                try:
                    one = render_formulas([formula], out_dir, names=[names[i]], **kwargs)
                    got.update({i: p for _, p in one.items()})
                except RenderError:
                    continue
        results.update({start + i: p for i, p in got.items()})
    return results


def installed_math_fonts(tex_path: str = "/usr/share/texmf") -> list[str]:
    """OpenType math fonts under ``tex_path`` for xelatex's font cycling,
    then Latin Modern Math (the reference's ``xelatex_render.py``)."""
    import glob

    fonts = [os.path.basename(p)
             for p in glob.glob(os.path.join(tex_path, "**", "*Math*.otf"), recursive=True)]
    fonts.extend(["Latin Modern Math"] * max(len(fonts), 1))
    return fonts


XELATEX_DOC_TEMPLATE = r"""\documentclass[preview]{standalone}
\usepackage{amsmath}
\usepackage{unicode-math}
\setmathfont{%s}
\begin{document}
%s
\end{document}
"""

# fractions, radicals, matrices, accents, large operators, greek: the
# self-test's formulas
SELFTEST_FORMULAS = [
    r"x^2 + y^2 = z^2",
    r"\frac{a+b}{c-d}",
    r"\sqrt{1+\sqrt{1+x}}",
    r"\sum_{i=1}^{n} i = \frac{n(n+1)}{2}",
    r"\int_0^\infty e^{-x^2}\,dx = \frac{\sqrt{\pi}}{2}",
    r"\begin{pmatrix} a & b \\ c & d \end{pmatrix}",
    r"\alpha + \beta \leq \gamma \cdot \delta",
    r"\lim_{x \to 0} \frac{\sin x}{x} = 1",
    r"\hat{f}(\xi) = \int_{-\infty}^{\infty} f(x) e^{-2\pi i x \xi} dx",
    r"\binom{n}{k} = \frac{n!}{k!(n-k)!}",
]
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "render_goldens.json")


def selftest(out_dir: Optional[str] = None, goldens_path: Optional[str] = None,
             write_goldens: bool = False) -> int:
    """Render SELFTEST_FORMULAS and check the trim and pad chain against
    structural goldens (each render's trimmed size within 25 % and its ink
    share within 40 % of the golden's; ``render_goldens.json`` beside
    this module by default, written by the first run that passes).  A process exit code: 2 without
    TeX, 1 on a failure or a drift, 0 otherwise."""
    import json

    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "render_selftest")
    goldens_path = goldens_path or GOLDENS
    if not HAS_TEX:
        print(f"BLOCKED: pdflatex={PDFLATEX} convert={CONVERT}; install TeX Live (pdflatex + "
              "preview.sty + amsmath) and ImageMagick, then re-run: python -m "
              "doc2tex_tpu_torch.tools.render --selftest")
        return 2
    got = render_dataset(SELFTEST_FORMULAS, out_dir, batch_size=10, dpi=200)
    print(f"rendered {len(got)}/{len(SELFTEST_FORMULAS)} -> {out_dir}")
    if len(got) < len(SELFTEST_FORMULAS):
        print(f"FAIL: formulas {sorted(set(range(len(SELFTEST_FORMULAS))) - set(got))} did "
              "not render")
        return 1
    stats, failures = {}, []
    for idx, path in sorted(got.items()):
        img = _read_gray(path)
        h, w = img.shape
        ink = float((img < 128).mean())
        stats[str(idx)] = {"h": h, "w": w, "ink": round(ink, 4)}
        border = np.concatenate([img[:8].ravel(), img[-8:].ravel(),
                                 img[:, :8].ravel(), img[:, -8:].ravel()])
        inner = img[8:-8, 8:-8]
        checks = [bool((border == 255).all()),
                  bool((inner[0] < 255).any() and (inner[-1] < 255).any()
                       and (inner[:, 0] < 255).any() and (inner[:, -1] < 255).any()),
                  0.005 < ink < 0.6,
                  20 <= h <= 2000 and 20 <= w <= 4096]
        if not all(checks):
            failures.append((idx, checks, stats[str(idx)]))
    for idx, checks, s in failures:
        print(f"FAIL formula {idx}: checks={checks} stats={s}")
    if failures:
        return 1
    if write_goldens or not os.path.exists(goldens_path):
        with open(goldens_path, "w") as f:
            json.dump(stats, f, indent=1, sort_keys=True)
        print(f"goldens written: {goldens_path}")
        return 0
    with open(goldens_path) as f:
        gold = json.load(f)
    drift = []
    for idx, s in stats.items():
        g = gold.get(idx)
        if g is not None and not (0.75 * g["h"] <= s["h"] <= 1.25 * g["h"]
                                  and 0.75 * g["w"] <= s["w"] <= 1.25 * g["w"]
                                  and 0.6 * g["ink"] <= s["ink"] <= 1.4 * g["ink"]):
            drift.append((idx, g, s))
    for idx, g, s in drift:
        print(f"DRIFT formula {idx}: golden={g} got={s}")
    print("selftest " + ("FAIL (golden drift)" if drift else "PASS"))
    return 1 if drift else 0


def render_formulas_xelatex(formulas: Sequence[str], out_dir: str,
                            fonts: Optional[Sequence[str]] = None, rng_seed: int = 0, **kwargs
                            ) -> dict[int, str]:
    """``render_formulas`` through xelatex with a math font drawn by
    ``rng_seed`` from ``fonts`` (default ``installed_math_fonts()``)."""
    import random

    if XELATEX is None:
        raise RenderError("xelatex binary not available")
    fonts = list(fonts) if fonts else installed_math_fonts()
    font = fonts[random.Random(rng_seed).randrange(len(fonts))]
    global DOC_TEMPLATE
    saved = DOC_TEMPLATE
    try:
        DOC_TEMPLATE = XELATEX_DOC_TEMPLATE % (font, "%s")
        return render_formulas(formulas, out_dir, engine="xelatex", **kwargs)
    finally:
        DOC_TEMPLATE = saved


if __name__ == "__main__":
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true",
                    help="render 10 formulas and check the trim/pad chain against structural "
                         "goldens")
    ap.add_argument("--out", default=None)
    ap.add_argument("--write_goldens", action="store_true")
    args = ap.parse_args()
    if args.selftest:
        sys.exit(selftest(args.out, write_goldens=args.write_goldens))
    ap.print_help()
