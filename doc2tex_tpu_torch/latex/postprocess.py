"""Prediction postprocessing (copied from ``doc2tex_tpu.latex.postprocess``
and ``doc2tex_tpu.recognition.flow.postprocess_prediction``)."""

from __future__ import annotations

import re


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
