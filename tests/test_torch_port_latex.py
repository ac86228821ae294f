"""The port's native scorer and tokenizer, LaTeX pipeline and dataset tools
against their plain versions and the JAX package's, on the CPU.

- ``native.levenshtein`` (built once per process from ``native/*.cpp`` into
  ``build/``) equals ``eval.metrics._lev_py`` and JAX's native distance on
  random strings (with non-ASCII characters), hard-benchmark labels and
  their token lists; the metric functions equal JAX's.
- ``native.latex_normalize``/``latex_validate`` equal ``latex.pytok`` and
  ``latex.validate`` and the JAX package's, on ``tests/test_latex.py``'s
  corpora and 200 hard-benchmark labels, in both modes and strictnesses.
- ``normalize_file``, ``find_math``, ``pydemacro``, ``tools.vocab_tools``
  and ``tools.label_tools`` give the JAX package's output on
  ``tools/data/sample_paper.tex`` and on those labels.
- The ``realdata`` twin's ``mine`` stage writes ``formulas.norm.lst`` equal
  byte for byte to the JAX tool's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from doc2tex_tpu_torch import native
from doc2tex_tpu_torch.data.synthetic import synth_hard_dataset
from doc2tex_tpu_torch.eval import metrics

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_latex import CORPUS, INVALID_CORPUS  # noqa: E402
from test_torch_port_lmdb import jax_realdata  # noqa: E402

SAMPLE_PAPER = os.path.join(ROOT, "tools", "data", "sample_paper.tex")


@pytest.fixture(scope="module")
def labels():
    """200 hard-benchmark labels (small images: only the labels are used)."""
    return synth_hard_dataset(200, seed=21, max_len=60, max_h=160, max_w=640)[1]


def random_strings(rng, n):
    alphabet = list("abcxyz{}\\^_ 01") + ["α", "β", "∑", "é"]
    return ["".join(rng.choice(alphabet, rng.integers(0, 30))) for _ in range(n)]


def test_levenshtein_equals_plain_and_jax(labels):
    from doc2tex_tpu.eval import metrics as jax_metrics
    from doc2tex_tpu.native import levenshtein as jax_lev

    rng = np.random.default_rng(0)
    strings = random_strings(rng, 60) + labels[:40]
    for a, b in zip(strings[::2], strings[1::2]):
        want = metrics._lev_py(a, b)
        assert native.levenshtein(a, b) == metrics.levenshtein(a, b) == jax_lev(a, b) == want
        ta, tb = a.split(), b.split()
        assert metrics.levenshtein(ta, tb) == metrics._lev_py(ta, tb) == jax_metrics._lev_py(ta, tb)
        assert metrics.get_single_ED(a, b) == jax_metrics.get_single_ED(a, b)
    assert metrics.get_word_NED(strings[::2], strings[1::2]) == jax_metrics.get_word_NED(
        strings[::2], strings[1::2])
    cols = rng.integers(0, 4, (2, 40)).astype(np.uint64)
    assert native.levenshtein_u64(cols[0], cols[1]) == metrics._lev_py(list(cols[0]), list(cols[1]))
    assert native.library_path().startswith(os.path.join(ROOT, "build"))


@pytest.mark.parametrize("corpus", ["test_latex", "synth_hard"])
def test_native_tokenizer_equals_plain_and_jax(corpus, labels):
    from doc2tex_tpu.latex import pytok as jax_pytok
    from doc2tex_tpu.latex import validate as jax_validate

    from doc2tex_tpu_torch.latex import pytok, validate

    lines = CORPUS + INVALID_CORPUS if corpus == "test_latex" else labels
    for line in lines:
        for mode in ("tokenize", "normalize"):
            want = jax_pytok.normalize_string(line, mode)
            assert native.latex_normalize(line, mode) == pytok.normalize_string(line, mode) == want
        for strict in (True, False):
            want = jax_validate.validate_formula(line, strict)
            assert (native.latex_validate(line, strict)
                    == validate.validate_formula(line, strict) == want)


def test_pipeline_and_tools_equal_jax(labels, tmp_path):
    import doc2tex_tpu.latex as jax_latex
    from doc2tex_tpu.tools import label_tools as jax_label_tools
    from doc2tex_tpu.tools import vocab_tools as jax_vocab_tools

    import doc2tex_tpu_torch.latex as latex
    from doc2tex_tpu_torch.tools import label_tools, vocab_tools

    with open(SAMPLE_PAPER) as f:
        tex = f.read()
    assert latex.pydemacro(tex) == jax_latex.pydemacro(tex)
    mined = latex.find_math(latex.pydemacro(tex))
    assert mined == jax_latex.find_math(jax_latex.pydemacro(tex)) and mined
    for lines in (mined, CORPUS, labels):
        assert list(latex.normalize_file(lines)) == list(jax_latex.normalize_file(lines))
        assert ([latex.normalize_formula(x, validate=False) for x in lines]
                == [jax_latex.normalize_formula(x, validate=False) for x in lines])

    counts = vocab_tools.count_tokens(labels)
    assert counts == jax_vocab_tools.count_tokens(labels)
    for fn, args in (("build_vocab_with_threshold", (labels, 2)),
                     ("build_vocab_with_threshold", (labels, 1, True)),
                     ("find_unk_threshold", (counts, 0.01)),
                     ("augment_rare_tokens", (labels, 1, 3)),
                     ("recheck_queue", ([(str(i), x) for i, x in enumerate(labels)],
                                        sorted(counts)[::2]))):
        assert getattr(vocab_tools, fn)(*args) == getattr(jax_vocab_tools, fn)(*args)
    rows = [(f"f{i:06d}.png", x) for i, x in enumerate(labels)]
    assert (vocab_tools.apply_recheck_fixes(rows, {"f000001.png": "", "f000002.png": "x"})
            == jax_vocab_tools.apply_recheck_fixes(rows, {"f000001.png": "", "f000002.png": "x"}))
    for name, _ in rows[:5]:
        (tmp_path / name).write_bytes(b"")
    assert (label_tools.build_label_manifest(str(tmp_path), labels)
            == jax_label_tools.build_label_manifest(str(tmp_path), labels))
    assert (label_tools.filter_supported_tokens(rows, sorted(counts)[::3])
            == jax_label_tools.filter_supported_tokens(rows, sorted(counts)[::3]))
    assert label_tools.train_val_test_split(rows) == jax_label_tools.train_val_test_split(rows)
    label_tools.write_manifest(rows, str(tmp_path / "port.tsv"))
    jax_label_tools.write_manifest(rows, str(tmp_path / "jax.tsv"))
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


def test_realdata_mine_equals_jax(tmp_path):
    from doc2tex_tpu_torch.tools import realdata

    port = realdata.stage_mine(str(tmp_path / "port"), SAMPLE_PAPER)
    jax = jax_realdata().stage_mine(str(tmp_path / "jax"), SAMPLE_PAPER)
    with open(port, "rb") as f, open(jax, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want and got.count(b"\n") >= 3
