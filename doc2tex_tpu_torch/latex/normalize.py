"""Formula normalization pipeline: prepass -> tokenizer -> postpass (copied
from ``doc2tex_tpu.latex.normalize``).

Parity target: reference ``normalize_formulas.py`` (``doc2tex/tools/
build_data/latex_processing/normalize_formulas.py:88-222``): a regex
prepass (env rewrites, token skips), the KaTeX tokenize/normalize step
(here: the repository's native C++ tokenizer, ``native.latex_normalize``,
replacing the ``node standardize_latex.js`` subprocess at :130-136; a
failed build raises, and the plain ``pytok``/``validate`` are what the tests
hold it to), then a postpass
(redundant-bracket removal, whitespace standardization, array-env
flattening) and per-line skip rules (:143-183).
"""

from __future__ import annotations

import re
from typing import Iterable, Iterator, Optional

from .. import native
from .postprocess import (
    remove_redundant_array_env,
    remove_redundant_bracket,
    standardize_whitespace,
)

MIN_TOKENS = 5

SKIP_TOK = [r"\\smallskip", r"\\medskip", r"\\bigskip", r"\\nomallineskiplimit"]

FONT = {
    r"\textit": r"\mathit",
    r"\textbf": r"\mathbf",
    r"\textrm": r"\mathrm",
    r"\textsf": r"\mathsf",
    r"\textnormal": r"\mathnormal",
}

SIZE = [
    r"\Huge", r"\huge", r"\LARGE", r"\Large", r"\large", r"\small",
    r"\normalsize", r"\footnotesize", r"\scriptsize", r"\tiny",
]

# tokens whose presence skips the whole line (reference :143-183)
_SKIP_SUBSTR = (
    "\\genfrac", "\\textcolor", "\\boxed", "\\vcenter", "\\tag",
    "\\newcommand", "\\renewcommand",
)
_SKIP_TOKEN_SUBSTR = (
    "skip", "break", "smash", "mathllap", "mathrlap", "mathclap",
)


def prepass(text: str) -> str:
    """Regex prepass over raw formulas (reference :88-127)."""
    text = text.replace("\r", " ")
    text = re.sub(r"\\raisebox\{[^\}]+\}", "", text, flags=re.S)
    text = re.sub(r"\\allowbreak", "", text, flags=re.S)
    text = re.sub(r"\\mathop", r"\\operatorname*", text, flags=re.S)
    text = re.sub(r"\\noalign", "", text, flags=re.S)
    text = re.sub("|".join(SKIP_TOK), "", text, flags=re.S)
    text = re.sub(r"\\textcolor\{[\w]+\}", "", text, flags=re.S)
    text = re.sub(r"\\textcolor\[[\w]+\]\{[\d,\.]+\}", "", text, flags=re.S)
    text = re.sub(
        r"\\begin{(split|align|alignedat|alignat|eqnarray|gather|gathered)\*?}"
        r"(.+?)\\end{\1\*?}",
        r"\\begin{aligned}\2\\end{aligned}",
        text,
        flags=re.S,
    )
    text = re.sub(
        r"\\begin{d(cases|rcases)}(.+)\\end{\1}",
        r"\\begin{\1}\2\\end{\1}",
        text,
        flags=re.S,
    )
    text = re.sub(
        r"\\begin{(pmatrix|bmatrix|Bmatrix|vmatrix|Vmatrix)\*}(\[[rlc]+\])"
        r"(.+?)\\end{\1\*}",
        r"\\begin{\1}\3\\end{\1}",
        text,
        flags=re.S,
    )
    text = re.sub(
        r"\\begin{(smallmatrix)\*?}(.+?)\\end{\1\*?}",
        r"\\begin{matrix}\2\\end{matrix}",
        text,
        flags=re.S,
    )
    return text


def should_skip(line: str) -> bool:
    """Per-line skip rules applied after tokenization (reference :143-183)."""
    if any(s in line for s in _SKIP_SUBSTR):
        return True
    for tok in line.strip().split():
        if any(s in tok for s in _SKIP_TOKEN_SUBSTR):
            return True
    return False


def postpass(tokens_line: str) -> str:
    """Bracket/whitespace/array cleanups + font mapping (reference :185-212)."""
    post = remove_redundant_bracket(tokens_line.split())
    post = standardize_whitespace(post)
    for font, repl in FONT.items():
        post = post.replace(font, repl)
    for size_ in SIZE:
        post = post.replace(size_, "")
    post = post.replace(r"\\ \end{array}", r"\end{array}")
    post = remove_redundant_array_env(post)
    return post


def normalize_formula(
    line: str,
    mode: str = "normalize",
    validate: bool = True,
    strict: bool = True,
) -> Optional[str]:
    """One formula through the full pipeline; None if skipped or invalid.

    ``validate`` replicates the reference's KaTeX parse gate
    (``standardize_latex.js:39-42``: a ParseError makes the script emit an
    empty line, which the pipeline drops).  ``strict`` additionally
    rejects unknown control sequences (upstream-KaTeX semantics; the
    vendored copy is permissive — see ``latex/validate.py``).
    """
    line = prepass(line)
    if validate and native.latex_validate(line, strict) is not None:
        return None
    toks = native.latex_normalize(line, mode)
    if should_skip(toks):
        return None
    if len(toks.split()) <= MIN_TOKENS:
        return None
    return postpass(toks)


def tokenize_formula(line: str) -> Optional[str]:
    return normalize_formula(line, mode="tokenize")


def normalize_file(
    lines: Iterable[str],
    mode: str = "normalize",
    validate: bool = True,
    strict: bool = True,
) -> Iterator[str]:
    """Normalize many formulas, dropping skipped/short/invalid ones
    (the ``normalize_formulas.py`` main loop)."""
    for line in lines:
        out = normalize_formula(line.strip(), mode, validate, strict)
        if out:
            yield out
