"""Pure-Python twin of the native LaTeX tokenizer/normalizer (copied from
``doc2tex_tpu.latex.pytok``).

Byte-identical behavior to ``native/latex_tokenizer.cpp`` (tests assert
agreement on a corpus); the plain version that ``native.latex_normalize`` is held
to.  See the C++ file for the list of KaTeX-pipeline behaviors
replicated from reference ``standardize_latex.js``.
"""

from __future__ import annotations

ARGS2 = {
    "\\frac", "\\binom", "\\cfrac", "\\dfrac", "\\tfrac", "\\dbinom",
    "\\tbinom", "\\overset", "\\underset", "\\stackrel", "\\sideset",
}
ARGS1 = {
    "\\overline", "\\underline", "\\hat", "\\bar", "\\vec", "\\dot",
    "\\ddot", "\\dddot", "\\tilde", "\\widehat", "\\widetilde", "\\check",
    "\\breve", "\\acute", "\\grave", "\\mathring", "\\overbrace",
    "\\underbrace", "\\mathrm", "\\mathbf", "\\mathsf", "\\mathit",
    "\\mathtt", "\\mathcal", "\\mathbb", "\\mathfrak", "\\mathnormal",
    "\\mathscr", "\\operatorname", "\\operatorname*", "\\boldsymbol",
    "\\bm", "\\text", "\\mbox", "\\textrm", "\\textbf", "\\textit",
    "\\textsf", "\\texttt", "\\textnormal", "\\phantom", "\\hphantom",
    "\\vphantom", "\\not", "\\cancel", "\\overrightarrow",
    "\\overleftarrow", "\\underrightarrow", "\\underleftarrow", "\\pmb",
}
OPT_ARG = {"\\sqrt", "\\xrightarrow", "\\xleftarrow"}
FONT_SWITCH = {
    "\\rm": "\\mathrm", "\\bf": "\\mathbf", "\\sf": "\\mathsf",
    "\\it": "\\mathit", "\\frak": "\\mathfrak", "\\tt": "\\mathtt",
    "\\cal": "\\mathcal", "\\Bbb": "\\mathbb",
}
SPACE_TO_COMMA = {
    "\\medspace", "\\thickspace", "\\hfill", "\\negthinspace",
    "\\negmedspace", "\\negthickspace", "\\mathstrut", "\\kern", "\\mkern",
}
DELIM_SIZERS = {
    "\\left", "\\right", "\\big", "\\Big", "\\bigg", "\\Bigg",
    "\\bigl", "\\bigr", "\\Bigl", "\\Bigr", "\\biggl", "\\biggr",
}
DROP = {"\\allowbreak", "\\noalign", "\\smallskip", "\\medskip", "\\bigskip"}


def _ascii_letter(c: str) -> bool:
    """Control words are ASCII-letter runs, like the KaTeX lexer regex
    ``\\\\(?:[a-zA-Z]+|...)`` (Lexer.js tokenRegex) and the C++ twin —
    str.isalpha would wrongly extend commands across unicode letters."""
    return "a" <= c <= "z" or "A" <= c <= "Z"


def lex(s: str) -> list[str]:
    toks: list[str] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c in " \t\n\r":
            i += 1
            continue
        if c == "%":
            while i < n and s[i] != "\n":
                i += 1
            continue
        if c == "\\":
            if i + 1 < n and _ascii_letter(s[i + 1]):
                j = i + 1
                while j < n and _ascii_letter(s[j]):
                    j += 1
                if j < n and s[j] == "*":
                    j += 1
                toks.append(s[i:j])
                i = j
            elif i + 1 < n:
                toks.append(s[i : i + 2])
                i += 2
            else:
                i += 1
            continue
        toks.append(c)
        i += 1
    return toks


class _Normalizer:
    def __init__(self, toks: list[str], flatten: bool):
        self.toks = toks
        self.p = 0
        self.out: list[str] = []
        self.flatten = flatten

    def peek(self):
        return self.toks[self.p] if self.p < len(self.toks) else None

    def next(self) -> str:
        t = self.toks[self.p]
        self.p += 1
        return t

    def emit(self, t: str) -> None:
        self.out.append(t)

    def skip_group(self) -> None:
        if self.peek() != "{":
            return
        self.next()
        depth = 1
        while self.p < len(self.toks) and depth:
            u = self.next()
            if u == "{":
                depth += 1
            elif u == "}":
                depth -= 1

    def parse_group(self) -> None:
        self.next()  # '{'
        t = self.peek()
        fw = FONT_SWITCH.get(t) if t else None
        if fw:
            self.next()
            self.emit(fw)
        self.emit("{")
        while self.p < len(self.toks) and self.peek() != "}":
            self.parse_one()
        if self.p < len(self.toks):
            self.next()
        self.emit("}")

    def parse_arg(self) -> None:
        t = self.peek()
        if t is None:
            self.emit("{")
            self.emit("}")
            return
        if t == "{":
            self.parse_group()
            return
        self.emit("{")
        self.parse_one()
        self.emit("}")

    def parse_env_name(self, cmd: str) -> None:
        if self.peek() == "{":
            self.next()
            name = ""
            while self.p < len(self.toks) and self.peek() != "}":
                name += self.next()
            if self.p < len(self.toks):
                self.next()
            self.emit(cmd + "{" + name + "}")
        else:
            self.emit(cmd)

    def pass_optional(self) -> None:
        if self.peek() != "[":
            return
        self.emit(self.next())
        while self.p < len(self.toks) and self.peek() != "]":
            self.parse_one()
        if self.p < len(self.toks):
            self.next()
            self.emit("]")

    def parse_one(self) -> None:
        if self.p >= len(self.toks):
            return
        t = self.next()

        if t == "$":
            return
        if t in ("\\>", "\\~"):
            return
        if t in ("\\label", "\\raisebox"):
            self.skip_group()
            return
        if t in DROP:
            return
        if t in SPACE_TO_COMMA:
            self.emit("\\,")
            return
        if t == "\\lparen":
            self.emit("(")
            return
        if t == "\\rparen":
            self.emit(")")
            return
        if t == "\\lang":
            self.emit("\\langle")
            return
        if t == "\\rang":
            self.emit("\\rangle")
            return
        if t == "\\mathop":
            self.emit("\\operatorname*")
            self.parse_arg()
            return
        if t == "\\\\":
            self.emit("\\," if self.flatten else "\\\\")
            return

        if t == "{":
            self.p -= 1
            self.parse_group()
            return
        if t == "}":
            self.emit("}")
            return

        if t in ("^", "_"):
            self.emit(t)
            self.parse_arg()
            return

        if t == "'":
            count = 1
            while self.peek() == "'":
                self.next()
                count += 1
            self.emit("^")
            self.emit("{")
            for _ in range(count):
                self.emit("\\prime")
            self.emit("}")
            return

        if t in ("\\begin", "\\end"):
            self.parse_env_name(t)
            return

        if t in DELIM_SIZERS:
            self.emit(t)
            if self.peek() is not None:
                self.emit(self.next())
            return

        fw = FONT_SWITCH.get(t)
        if fw:
            if self.peek() == "{":
                self.emit(fw)
                self.parse_group()
            else:
                self.emit(fw)
                self.emit("{")
                while self.p < len(self.toks) and self.peek() != "}":
                    self.parse_one()
                self.emit("}")
            return

        if t in OPT_ARG:
            self.emit(t)
            self.pass_optional()
            self.parse_arg()
            return
        if t in ARGS2:
            self.emit(t)
            self.parse_arg()
            self.parse_arg()
            return
        if t in ARGS1:
            self.emit(t)
            self.parse_arg()
            return

        self.emit(t)

    def run(self) -> str:
        while self.p < len(self.toks):
            self.parse_one()
        return " ".join(self.out)


def _merge_env_names(toks: list[str]) -> list[str]:
    """Tokenize-mode env-name merge: the reference's parser-built emission
    rewrites ``\\begin { m a t r i x }`` to ``\\begin {matrix}`` after the
    env-name function parses (``Parser.js:434,458`` global_str surgery), so
    the token stream carries ``{matrix}`` as ONE token."""
    out: list[str] = []
    i, n = 0, len(toks)
    while i < n:
        t = toks[i]
        if t in ("\\begin", "\\end") and i + 1 < n and toks[i + 1] == "{":
            j = i + 2
            name = ""
            while j < n and toks[j] != "}":
                name += toks[j]
                j += 1
            if j < n:  # closed: emit the merged form
                out.append(t)
                out.append("{" + name + "}")
                i = j + 1
                continue
        out.append(t)
        i += 1
    return out


def normalize_string(line: str, mode: str = "normalize") -> str:
    flatten = not any(k in line for k in ("matrix", "cases", "array", "begin"))
    toks = lex(line)
    if mode == "tokenize":
        return " ".join(t for t in _merge_env_names(toks) if t != "$")
    return _Normalizer(toks, flatten).run()
