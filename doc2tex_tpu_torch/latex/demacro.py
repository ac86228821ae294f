"""User-macro unfolding (``\\newcommand`` / ``\\def`` expansion; copied from
``doc2tex_tpu.latex.demacro``).

Parity target: reference ``pydemacro`` / ``sweep`` / ``unfold``
(``doc2tex/tools/build_data/collect_latex/demacro.py:67-158``): collect all
``\\newcommand{\\x}[n]{body}`` and ``\\def\\x{body}`` definitions in a
document, then repeatedly substitute uses (with #1..#n argument splicing)
until a fixed point, so downstream normalization sees only standard LaTeX.
"""

from __future__ import annotations

import re


class DemacroError(Exception):
    pass


_NEWCOMMAND = re.compile(
    r"\\(?:re)?newcommand\*?\s*\{\\([a-zA-Z]+)\}\s*(?:\[(\d)\])?\s*"
)
_DEF = re.compile(r"\\def\s*\\([a-zA-Z]+)\s*")


def _read_group(s: str, i: int) -> tuple[str, int]:
    """Read a {...} group starting at s[i] == '{'; returns (body, end_idx)."""
    if i >= len(s) or s[i] != "{":
        raise DemacroError(f"expected '{{' at {i}")
    depth = 0
    j = i
    while j < len(s):
        c = s[j]
        if c == "\\" and j + 1 < len(s):
            j += 2
            continue
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return s[i + 1 : j], j + 1
        j += 1
    raise DemacroError("unterminated group")


def collect_macros(s: str) -> tuple[dict[str, tuple[int, str]], str]:
    """Find macro definitions; returns ({name: (nargs, body)}, s_without_defs)."""
    macros: dict[str, tuple[int, str]] = {}
    spans: list[tuple[int, int]] = []
    for ptn, has_args in ((_NEWCOMMAND, True), (_DEF, False)):
        for m in ptn.finditer(s):
            name = m.group(1)
            nargs = int(m.group(2)) if has_args and m.group(2) else 0
            try:
                body, end = _read_group(s, m.end())
            except DemacroError:
                continue
            macros[name] = (nargs, body)
            spans.append((m.start(), end))
    # drop definition text
    out = []
    prev = 0
    for a, b in sorted(spans):
        if a < prev:
            continue
        out.append(s[prev:a])
        prev = b
    out.append(s[prev:])
    return macros, "".join(out)


def _expand_once(s: str, macros: dict[str, tuple[int, str]]) -> tuple[str, bool]:
    changed = False
    out = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        m = re.match(r"\\([a-zA-Z]+)", s[i:])
        if not m or m.group(1) not in macros:
            out.append(c)
            i += 1
            continue
        name = m.group(1)
        nargs, body = macros[name]
        j = i + m.end()
        args = []
        ok = True
        for _ in range(nargs):
            while j < n and s[j] in " \t":
                j += 1
            if j < n and s[j] == "{":
                try:
                    arg, j = _read_group(s, j)
                except DemacroError:
                    ok = False
                    break
                args.append(arg)
            elif j < n:
                # single-token argument (TeX semantics)
                if s[j] == "\\":
                    mm = re.match(r"\\[a-zA-Z]+|\\.", s[j:])
                    args.append(s[j : j + mm.end()])
                    j += mm.end()
                else:
                    args.append(s[j])
                    j += 1
            else:
                ok = False
                break
        if not ok:
            out.append(c)
            i += 1
            continue
        expansion = body
        for k, arg in enumerate(args, 1):
            expansion = expansion.replace(f"#{k}", arg)
        out.append(expansion)
        # guard against gluing \cmdx: add space if body ends with a letter
        # and the next char is a letter
        if expansion and expansion[-1] == "\\":
            out.append(" ")
        i = j
        changed = True
    return "".join(out), changed


def pydemacro(s: str, max_iter: int = 10) -> str:
    """Expand user macros until fixed point (reference ``pydemacro``)."""
    macros, s = collect_macros(s)
    if not macros:
        return s
    for _ in range(max_iter):
        s, changed = _expand_once(s, macros)
        if not changed:
            break
    return s
