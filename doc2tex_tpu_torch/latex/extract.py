"""Math-expression mining from LaTeX documents (copied from
``doc2tex_tpu.latex.extract``).

Parity target: reference ``find_math`` + ``clean_matches`` + ``check_brackets``
(``doc2tex/tools/build_data/latex_processing/extract_latex.py:8-107``) with
the regex patterns of ``standard_const.py:7-60``: ``$$...$$``, equation /
displaymath environments, align-family environments, ``\\displaystyle`` runs;
then label removal, outer-whitespace trim, bracket-balance check, char-count
filters, graphic-token rejection, dedup.
"""

from __future__ import annotations

import re
from typing import List

MIN_CHARS = 30
MAX_CHARS = 1000

DOLLAR = re.compile(
    r"((?<!\$)\${2}(?!\$))(.{%i,%i}?)(?<!\\)(?<!\$)\1(?!\$)" % (1, MAX_CHARS)
)
EQUATION = re.compile(
    r"\\begin\{(equation|displaymath)\*?\}(.{%i,%i}?)\\end\{\1\*?\}" % (1, MAX_CHARS),
    re.S,
)
ALIGN = re.compile(
    r"(\\begin\{(align|alignedat|alignat|flalign|eqnarray|gather|gathered)\*?\}"
    r"(.{%i,%i}?)\\end\{\2\*?\})" % (1, MAX_CHARS),
    re.S,
)
DISPLAYMATH = re.compile(
    r"(?:\\displaystyle)(.{%i,%i}?)((?<!\\)\}?(?:\"|<))" % (1, MAX_CHARS), re.S
)

LABEL_TAGS = [
    re.compile(r"\\%s\s?\{(.*?)\}" % s) for s in ("ref", "cite", "label", "eqref")
]

OUTER_WS_TOKENS = [
    r"\\,", "~", r"\\ ", r"\\thinspace", r"\\medspace", r"\\thickspace",
    r"\\!", r"\\:", r"\\;", r"\\enspace", r"\\quad", r"\\qquad",
    r"\\hspace\*?\{[a-zA-Z0-9]+\}", r"\\hfill", r"\\kern\{[a-zA-Z0-9]+\}",
    r"\\mkern\{[a-zA-Z0-9]+\}", r"\\mskip\{[a-zA-Z0-9]+\}",
    r"\\phantom\{[a-zA-Z0-9]+\}", r"\\hphantom\{[a-zA-Z0-9]+\}",
    r"\\vphantom\{[a-zA-Z0-9]+\}", r"\\negthinspace", r"\\negmedspace",
    r"\\negthickspace", r"\\mathstrut",
]
OUTER_WHITESPACE = re.compile(
    "|".join(f"^{t}|{t}$" for t in OUTER_WS_TOKENS)
)

GRAPHIC_TOKENS = (
    "tikz", r"\begin{picture}", r"\begin{fmfgraph}", r"\bigcirc",
    r"\bigotimes", r"\color",
)


def check_brackets(s: str) -> str:
    """Raise on unbalanced non-escaped braces; strip a single all-surrounding
    brace pair (reference ``check_brackets``)."""
    depth = 0
    min_interior = None
    surrounding = s.startswith("{")
    for i, c in enumerate(s):
        if c == "{" and (i == 0 or s[i - 1] != "\\"):
            depth += 1
        elif c == "}" and (i == 0 or s[i - 1] != "\\"):
            depth -= 1
            if depth < 0:
                raise ValueError(s)
            if i < len(s) - 1 and min_interior is None and depth == 0:
                min_interior = 0  # brace closed before end -> not surrounding
    if depth != 0:
        raise ValueError(s)
    if surrounding and s.endswith("}") and min_interior is None:
        return s[1:-1]
    return s


def remove_labels(string: str) -> str:
    for ptn in LABEL_TAGS:
        string = ptn.sub("", string)
    return string


def clean_matches(matches: List[str], min_chars: int = MIN_CHARS) -> List[str]:
    out = []
    for m in matches:
        if any(tok in m for tok in GRAPHIC_TOKENS):
            continue
        m = remove_labels(m)
        m = m.replace("\n", "").replace(r"\notag", "").replace(r"\nonumber", "")
        m = OUTER_WHITESPACE.sub("", m)
        if len(m) < min_chars:
            continue
        try:
            m = check_brackets(m)
        except ValueError:
            continue
        if not m or m.endswith("\\") or "newcommand" in m:
            continue
        out.append(m.strip())
    return sorted(set(out))


def find_math(s: str, wiki: bool = False) -> List[str]:
    """All math expressions in a LaTeX-like document (reference find_math)."""
    matches: List[str] = []
    matches.extend(g[1] for g in DOLLAR.findall(s))
    matches.extend(g[1] for g in EQUATION.findall(s))
    matches.extend(g[0] for g in ALIGN.findall(s))
    if wiki:
        matches.extend(g[0] for g in DISPLAYMATH.findall(s))
    return clean_matches(matches)
