"""Prediction postprocessing and the token-stream post-passes of
normalization (copied from ``doc2tex_tpu.latex.postprocess`` and
``doc2tex_tpu.recognition.flow.postprocess_prediction``).

Reference ``doc2tex/utils/data_utils.py``: ``remove_reduntant_bracket``
(:117-140), ``standardize_whitespace_v2`` (:143-172),
``remove_redundant_array_env`` (:176-289) and ``Postprocessing``
(:292-455).
"""

from __future__ import annotations

import re
from typing import Sequence


def remove_unused_whitespace(s: str) -> str:
    """Strip spaces except between letters."""
    text_reg = (
        r"(\\(operatorname|mathrm|mathbf|mathsf|mathit|mathfrak|"
        r"mathnormal)\s?\*? {.*?})"
    )
    letter = "[a-zA-Z]"
    noletter = r"[\W_^\d]"
    names = [x[0].replace(" ", "") for x in re.findall(text_reg, s)]
    s = re.sub(text_reg, lambda match: str(names.pop(0)), s)
    news = s
    while True:
        s = news
        news = re.sub(rf"(?!\\ )({noletter})\s+?({noletter})", r"\1\2", s)
        news = re.sub(rf"(?!\\ )({noletter})\s+?({letter})", r"\1\2", news)
        news = re.sub(rf"({letter})\s+?({noletter})", r"\1\2", news)
        if news == s:
            break
    return s


def postprocess_prediction(s: str) -> str:
    """Whitespace removal + hspace/vspace argument collapsing."""
    s = remove_unused_whitespace(s)
    for space in ("hspace", "vspace"):
        out, last = "", 0
        for m in re.finditer(space + r" ?{(.*?)}", s):
            out += s[last : m.start(1)] + m.group(1).replace(" ", "")
            last = m.end(1)
        s = out + s[last:]
    return s


STANDARD_SPACE = {2: 1, 4: 2, 8: 4}


def remove_redundant_bracket(tokens: Sequence[str]) -> str:
    """Remove empty ``{ }`` token groups (reference :117-140: a ``}`` whose
    matching ``{`` has nothing but braces in between)."""
    switch = 0
    left_stack: list[int] = []
    remove: set[int] = set()
    for idx, tok in enumerate(tokens):
        if tok == "{":
            switch += 1
            left_stack.append(idx)
        elif tok == "}" and switch > 0:
            switch -= 1
            remove.add(left_stack.pop())
            remove.add(idx)
        else:
            switch = 0
            left_stack = []
    if len(remove) > 1:
        return " ".join(t for i, t in enumerate(tokens) if i not in remove)
    return " ".join(tokens)


def standardize_whitespace(
    latex_str: str,
    std_ws: str = "\\,",
    standard_dict: dict[int, int] | None = None,
) -> str:
    """Collapse runs of the whitespace token (reference :143-172)."""
    standard_dict = standard_dict or STANDARD_SPACE
    ws_ptn = re.compile(r"(\%s\s)+" % std_ws)
    out = []
    prev_end = 0
    for m in ws_ptn.finditer(latex_str):
        out.append(latex_str[prev_end : m.start()])
        group = latex_str[m.start() : m.end() - 1].split()
        if len(group) > 1:
            for space_len, repl in standard_dict.items():
                if len(group) < space_len:
                    group = [std_ws] * repl
                    break
            else:
                group = [std_ws] * list(standard_dict.values())[-1]
        out.append(" ".join(group) + " ")
        prev_end = m.end()
    out.append(latex_str[prev_end:])
    return "".join(out)


_ARRAY_FLAT_PTN = re.compile(
    r"\\begin{array}\s\{[rlc\s]+\}\s(\&?\s?\{.*\})+\s\\end{array}"
)
_ARRAY_COMP_PTN = re.compile(r"\{([^\&]+)\}")


def _flatten_one_array(tokens: list[str]) -> list[str] | None:
    """Flatten one array env body of pure ``{..} & {..}`` groups with no
    row breaks; returns None if the env must be kept."""
    if "\\\\" in tokens:
        return None
    concat = " ".join(tokens)
    m = _ARRAY_FLAT_PTN.match(concat)
    if not m:
        return None
    body = concat[m.start(1) : m.end(1)]
    parts = [body[c.start(1) : c.end(1)] for c in _ARRAY_COMP_PTN.finditer(body)]
    return " ".join(parts).split()


def remove_redundant_array_env(text: str) -> str:
    """Flatten redundant (single-row, fully-braced) array environments,
    innermost first (reference :176-289)."""
    tokens = text.strip().split()
    # repeat until no more flattening applies (handles nesting innermost-out)
    changed = True
    while changed:
        changed = False
        begin_stack: list[int] = []
        spans: list[tuple[int, int]] = []
        for idx, t in enumerate(tokens):
            if t == "\\begin{array}":
                begin_stack.append(idx)
            elif t == "\\end{array}" and begin_stack:
                spans.append((begin_stack.pop(), idx + 1))
        # innermost = shortest span
        spans.sort(key=lambda se: se[1] - se[0])
        for s, e in spans:
            flat = _flatten_one_array(tokens[s:e])
            if flat is not None:
                tokens = tokens[:s] + flat + tokens[e:]
                changed = True
                break
    return " ".join(" ".join(tokens).split())


class Postprocessing:
    """Bracket normalization + balancing + whitespace removal on decoded
    predictions (reference ``data_utils.py:292-455``)."""

    _LEFT_FIX = [
        (re.compile(r"\\left\("), "("),
        (re.compile(r"\\left\\\{"), "{"),
        (re.compile(r"\\left\["), "["),
        (re.compile(r"\\right\)"), ")"),
        (re.compile(r"\\right\\\}"), "}"),
        (re.compile(r"\\right\]"), "]"),
    ]

    @staticmethod
    def balance(string: str, left: str, right: str) -> str:
        """Insert missing partners for unbalanced left/right brackets
        (stack algorithm, reference :346-396)."""
        # pass 1: insert lefts before orphan rights
        depth = 0
        inserts: list[tuple[int, str]] = []
        for i, c in enumerate(string):
            if c == left:
                depth += 1
            elif c == right:
                if depth == 0:
                    inserts.append((i, left))
                else:
                    depth -= 1
        for off, (i, ch) in enumerate(inserts):
            string = string[: i + off] + ch + string[i + off :]
        # pass 2: append rights for orphan lefts
        depth = 0
        orphan_left: list[int] = []
        for i, c in enumerate(string):
            if c == left:
                orphan_left.append(i)
            elif c == right and orphan_left:
                orphan_left.pop()
        for off, i in enumerate(orphan_left):
            string = string[: i + off + 1] + right + string[i + off + 1 :]
        return string

    @staticmethod
    def pipeline(snippet: str) -> str:
        result = snippet.strip()
        for ptn, repl in Postprocessing._LEFT_FIX:
            result = ptn.sub(repl.replace("\\", ""), result)
        result = Postprocessing.balance(result, "(", ")")
        result = Postprocessing.balance(result, "{", "}")
        result = Postprocessing.balance(result, "[", "]")
        return result

    remove_unused_whitespace = staticmethod(remove_unused_whitespace)
