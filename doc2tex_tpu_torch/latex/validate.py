"""KaTeX-grade parse validation for the dataset-construction pipeline
(copied from ``doc2tex_tpu.latex.validate``).

The reference's tokenize/normalize step runs every formula through the
vendored KaTeX parser inside a try/catch (``standardize_latex.js:39-42``,
``katex.__parse(line, {})``); a ParseError makes the script emit an empty
line, which the pipeline then drops.  This module replicates that parse
walk as a recursive-descent validator over the same token stream the
tokenizer uses, so ``normalize_formula`` can reject exactly the lines the
reference pipeline would lose.

The vendored KaTeX is *modified*: ``Parser.js:783-793`` (parseSymbol)
accepts unknown control sequences as ord atoms instead of throwing
"Undefined control sequence" — the reference pipeline therefore keeps
``\\notacommand{x}``.  The live (non-commented) errors in the vendored
copy, all replicated here:

- ``expect()`` mismatch (Parser.js:78): unbalanced ``{``/``}``, stray
  ``}``/``&``/``\\\\`` at top level, ``\\left`` without ``\\right``.
- "No such environment" (Parser.js:437) and env begin/end mismatch
  (Parser.js:460).
- "Expected group after '<func>'" — missing required argument
  (Parser.js:622), e.g. ``\\frac`` with one arg at EOF.
- "Invalid delimiter" after ``\\left``/``\\right``/``\\big...``
  (functions.js:347-350).
- "only one infix operator per group" (Parser.js:191) — double ``\\over``.
- "Limit controls must follow a math operator" (Parser.js:324).
- "Got function ... with no arguments as superscript" (Parser.js:255).
- "Expected & or \\\\ or \\end" inside array bodies (environments.js:44).
- "Invalid size" for size-typed arguments (Lexer.js:120-140).

On top of vendored parity, ``strict=True`` (the default for dataset
builds) also rejects control sequences unknown to both the KaTeX grammar
tables (``_katex_tables.py``, generated from the vendored sources) and
this pipeline's own rewrite tables (``pytok.py``) — upstream-KaTeX
"Undefined control sequence" semantics, which is what vocabulary hygiene
actually wants.  ``strict=False`` reproduces the vendored permissive
behavior exactly.

The C++ twin lives in ``native/latex_tokenizer.cpp`` (``d2t_latex_
validate``); fuzz tests assert both agree verdict-for-verdict and
message-for-message.
"""

from __future__ import annotations

from typing import Optional

from . import pytok
from ._katex_tables import (
    DELIMITERS,
    ENVIRONMENTS,
    FUNCTIONS,
    SIZE_FUNCS,
    STYLE_FUNCS,
    SYMBOLS_MATH,
    SYMBOLS_TEXT,
)

END_EXPR = ("}", "\\end", "\\right", "&", "\\\\", "\\cr")

# ops for the \limits check: symbol group == "op", or one of the op funcs
OP_FUNCS = frozenset(
    n for n, (na, no, at, gr) in FUNCTIONS.items()
    if na == 0 and no == 0
    and n[1:2].isalpha()
    and n in {
        "\\arcsin", "\\arccos", "\\arctan", "\\arg", "\\cos", "\\cosh",
        "\\cot", "\\coth", "\\csc", "\\deg", "\\dim", "\\exp", "\\hom",
        "\\ker", "\\lg", "\\ln", "\\log", "\\sec", "\\sin", "\\sinh",
        "\\tan", "\\tanh", "\\det", "\\gcd", "\\inf", "\\lim", "\\liminf",
        "\\limsup", "\\max", "\\min", "\\Pr", "\\sup", "\\int", "\\iint",
        "\\iiint", "\\oint", "\\coprod", "\\bigvee", "\\bigwedge",
        "\\biguplus", "\\bigcap", "\\bigcup", "\\intop", "\\prod", "\\sum",
        "\\bigotimes", "\\bigoplus", "\\bigodot", "\\bigsqcup",
        "\\smallint",
    }
)
DELIM_FUNCS = frozenset(
    {"\\left", "\\right"}
    | {p + s for p in ("\\big", "\\Big", "\\bigg", "\\Bigg")
       for s in ("", "l", "r", "m")}
)
INFIX_FUNCS = frozenset({"\\over", "\\choose"})

# strict-mode extras: commands this pipeline's own normalizer understands
# (pytok tables) that the old vendored grammar lacks -> (num_args, num_opt,
# greediness).  Kept as functions so arity is checked like KaTeX would.
EXTRA_FUNCS: dict[str, tuple[int, int, int]] = {}
for _c in pytok.ARGS2:
    if _c not in FUNCTIONS:
        EXTRA_FUNCS[_c] = (2, 0, 2)
for _c in pytok.ARGS1:
    if _c not in FUNCTIONS and _c not in SYMBOLS_MATH:
        EXTRA_FUNCS[_c] = (1, 0, 2)
for _c in pytok.OPT_ARG:
    if _c not in FUNCTIONS:
        EXTRA_FUNCS[_c] = (1, 1, 2)
# zero-arg commands our pipeline rewrites or passes through
EXTRA_SYMBOLS = frozenset(
    {c for c in pytok.SPACE_TO_COMMA if c not in SYMBOLS_MATH}
    | {c for c in pytok.FONT_SWITCH if c not in FUNCTIONS}
    | {c for c in pytok.DROP if c not in SYMBOLS_MATH}
    | {"\\lparen", "\\rparen", "\\lang", "\\rang", "\\operatorname",
       "\\operatorname*", "\\notag", "\\hdashline", "\\limits",
       "\\nolimits", "\\prime"}
)

_SIZE_RE_UNITS = "abcdefghijklmnopqrstuvwxyz"


class _Invalid(Exception):
    pass


def _is_size(s: str) -> bool:
    """Lexer.js sizeRegex: (-?)\\s*(\\d+(\\.\\d*)?|\\.\\d+)\\s*([a-z]{2})"""
    s = s.strip()
    if s.startswith("-"):
        s = s[1:].strip()
    i = 0
    seen_digit = False
    while i < len(s) and s[i].isdigit():
        i += 1
        seen_digit = True
    if i < len(s) and s[i] == ".":
        i += 1
        while i < len(s) and s[i].isdigit():
            i += 1
            seen_digit = True
    if not seen_digit:
        return False
    rest = s[i:].strip()
    return len(rest) == 2 and all(c in _SIZE_RE_UNITS for c in rest)


class _Sym:
    __slots__ = ("kind",)

    def __init__(self, kind: str):
        self.kind = kind  # "op" | "ord"


class _Func:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


_GROUP = _Sym("ord")


class _Validator:
    def __init__(self, toks: list[str], strict: bool):
        self.toks = toks
        self.p = 0
        self.strict = strict
        self.mode = "math"

    # ------------------------------------------------------------ plumbing
    def peek(self) -> Optional[str]:
        return self.toks[self.p] if self.p < len(self.toks) else None

    def advance(self) -> str:
        t = self.toks[self.p]
        self.p += 1
        return t

    def error(self, msg: str) -> None:
        raise _Invalid(msg)

    def expect(self, text: str) -> None:
        t = self.peek()
        if t != text:
            self.error(f"Expected '{text}', got '{t if t is not None else 'EOF'}'")
        self.advance()

    def _func_info(self, name: str):
        """(num_args, num_opt, arg_types, greediness) or None."""
        info = FUNCTIONS.get(name)
        if info is not None:
            return info
        if self.strict:
            x = EXTRA_FUNCS.get(name)
            if x is not None:
                return (x[0], x[1], (), x[2])
        return None

    # -------------------------------------------------------------- parser
    def validate(self) -> None:
        self.parse_expression(None)
        t = self.peek()
        if t is not None:
            self.error(f"Expected 'EOF', got '{t}'")

    def parse_expression(self, break_tok: Optional[str]) -> None:
        infix = 0
        while True:
            t = self.peek()
            if t is None or t in END_EXPR:
                return
            if break_tok is not None and t == break_tok:
                return
            start = self.p
            if self.parse_atom():
                infix += 1
                if infix > 1:
                    self.error("only one infix operator per group")
            if self.p == start:  # no progress (EOF inside atom)
                return

    def parse_atom(self) -> bool:
        """Parse base + sup/sub/prime/limits chain; True if infix atom."""
        base = self.parse_implicit_group()
        if base is None:
            return False
        while True:
            t = self.peek()
            if t in ("\\limits", "\\nolimits"):
                if base.kind != "op" if isinstance(base, _Sym) else True:
                    self.error("Limit controls must follow a math operator")
                self.advance()
            elif t in ("^", "_"):
                which = "superscript" if t == "^" else "subscript"
                self.advance()
                g = self.parse_group()
                if isinstance(g, _Func):
                    info = self._func_info(g.name)
                    greed = info[3] if info else 1
                    if greed > 1:
                        self.parse_function_args(g.name)
                    else:
                        self.error(
                            f"Got function '{g.name}' with no arguments "
                            f"as {which}"
                        )
            elif t == "'":
                self.advance()
                while self.peek() == "'":
                    self.advance()
            else:
                break
        return isinstance(base, _Func) and base.name in INFIX_FUNCS

    def parse_implicit_group(self):
        """Returns _Sym/_Func/None (None = no atom: EOF or end token)."""
        s = self.parse_symbol()
        if s is None:
            if self.peek() == "{":
                self.advance()
                self.parse_expression(None)
                self.expect("}")
                return _GROUP
            return None  # EOF / end-of-expression token
        if not isinstance(s, _Func):
            return s

        f = s.name
        if f == "\\left":
            self.check_delim(f)
            self.parse_expression(None)
            t = self.peek()
            if t != "\\right":
                self.error(
                    f"Expected '\\right', got "
                    f"'{t if t is not None else 'EOF'}'"
                )
            self.advance()
            self.check_delim("\\right")
            return _GROUP
        if f == "\\begin":
            name = self.parse_env_name(f)
            if name not in ENVIRONMENTS:
                self.error(f"No such environment: {name}")
            for _ in range(ENVIRONMENTS[name]):
                g = self.parse_group()
                if g is None:
                    self.error(f"Expected group after '\\begin{{{name}}}'")
            self.parse_array_body()
            t = self.peek()
            if t != "\\end":
                self.error(
                    f"Expected '\\end', got "
                    f"'{t if t is not None else 'EOF'}'"
                )
            self.advance()
            ename = self.parse_env_name("\\end")
            if ename != name:
                self.error(
                    f"Mismatch: \\begin{{{name}}} matched "
                    f"by \\end{{{ename}}}"
                )
            return _GROUP
        if f in SIZE_FUNCS or f in STYLE_FUNCS:
            self.parse_expression(None)
            return _GROUP
        self.parse_function_args(f)
        if f in OP_FUNCS:
            return _Sym("op")
        return s  # _Func; infix-ness checked by caller

    def parse_array_body(self) -> None:
        """environments.js parseArray: cells split by &, rows by \\\\."""
        while True:
            self.parse_expression(None)
            t = self.peek()
            if t == "&":
                self.advance()
            elif t == "\\end" or t == "}":
                return
            elif t in ("\\\\", "\\cr"):
                self.advance()
                if self.peek() == "[":  # optional size: \\[2mm]
                    self.advance()
                    self.lex_size_until("]")
            else:
                self.error("Expected & or \\\\ or \\end")

    def parse_env_name(self, cmd: str) -> str:
        if self.peek() != "{":
            self.error(f"Expected group after '{cmd}'")
        self.advance()
        name = ""
        while self.peek() is not None and self.peek() != "}":
            name += self.advance()
        self.expect("}")
        return name

    def lex_size_until(self, close: str) -> None:
        body = ""
        while self.peek() is not None and self.peek() != close:
            body += self.advance()
        self.expect(close)
        if not _is_size(body):
            self.error(f"Invalid size: '{body}'")

    def lex_color_until(self, close: str) -> None:
        body = ""
        while self.peek() is not None and self.peek() != close:
            body += self.advance()
        self.expect(close)
        ok = body and (
            all(c.isalnum() for c in body)
            or (body[0] == "#" and all(c.isalnum() for c in body[1:]))
        )
        if not ok:
            self.error(f"Invalid color: '{body}'")

    def parse_function_args(self, f: str) -> None:
        info = self._func_info(f)
        if info is None:
            return  # unknown treated as ord upstream of here
        num_args, num_opt, arg_types, greed = info
        for i in range(num_opt):
            at = arg_types[i] if i < len(arg_types) else None
            if self.peek() != "[":
                continue
            self.advance()
            if at == "size":
                self.lex_size_until("]")
            elif at == "color":
                self.lex_color_until("]")
            else:
                self.parse_expression("]")
                self.expect("]")
        if f in DELIM_FUNCS:
            self.check_delim(f)
            return
        for i in range(num_args):
            at = (
                arg_types[num_opt + i]
                if num_opt + i < len(arg_types)
                else None
            )
            if at in ("size", "color"):
                self.expect("{")
                if at == "size":
                    self.lex_size_until("}")
                else:
                    self.lex_color_until("}")
            elif at == "text":
                old = self.mode
                self.mode = "text"
                g = self.parse_group()
                self.mode = old
                if g is None:
                    self.error(f"Expected group after '{f}'")
            else:
                g = self.parse_group()
                if g is None:
                    self.error(f"Expected group after '{f}'")
                if isinstance(g, _Func):
                    ginfo = self._func_info(g.name)
                    ggreed = ginfo[3] if ginfo else 1
                    if ggreed > greed:
                        self.parse_function_args(g.name)
                    # else: permissive (vendored commented-out throw)

    def check_delim(self, f: str) -> None:
        t = self.peek()
        if t is None:
            self.error(f"Expected group after '{f}'")
        if t == "{":
            self.advance()
            self.parse_expression(None)
            self.expect("}")
            self.error(f"Invalid delimiter: group after '{f}'")
        self.advance()
        if t not in DELIMITERS:
            self.error(f"Invalid delimiter: '{t}' after '{f}'")

    def parse_group(self):
        t = self.peek()
        if t == "{":
            self.advance()
            self.parse_expression(None)
            self.expect("}")
            return _GROUP
        return self.parse_symbol()

    def parse_symbol(self):
        t = self.peek()
        if t is None or t == "{" or t in END_EXPR:
            # "}" & friends end the enclosing expression; in argument
            # position KaTeX's parseSymbol would consume "}" as an ord
            # (modified else-branch) — replicated in parse_group callers
            # via the permissive None -> "Expected group" path only at EOF,
            # so consume it here like the vendored parser does.
            if t is not None and t == "}":
                self.advance()
                return _Sym("ord")
            return None
        symtab = SYMBOLS_MATH if self.mode == "math" else SYMBOLS_TEXT
        if t in FUNCTIONS:
            self.advance()
            return _Func(t)
        if t in symtab:
            self.advance()
            return _Sym("op" if symtab[t] == "op" else "ord")
        if self.strict:
            if t in EXTRA_FUNCS:
                self.advance()
                return _Func(t)
            if t in EXTRA_SYMBOLS:
                self.advance()
                return _Sym("ord")
            if len(t) > 1 and t[0] == "\\":
                self.error(f"Undefined control sequence: {t}")
        self.advance()
        return _Sym("ord")


def _pre_skip(toks: list[str], flatten: bool) -> list[str]:
    """The JS script's pre-parse rewrites (standardize_latex.js:13-31),
    applied at token level: drop $/\\>/\\~, strip \\label{...} and
    \\raisebox{...}, flatten \\\\ -> \\, outside multi-row formulas."""
    out: list[str] = []
    i, n = 0, len(toks)
    while i < n:
        t = toks[i]
        if t in ("$", "\\>", "\\~"):
            i += 1
            continue
        if t in ("\\label", "\\raisebox"):
            i += 1
            if i < n and toks[i] == "{":
                depth = 1
                i += 1
                while i < n and depth:
                    if toks[i] == "{":
                        depth += 1
                    elif toks[i] == "}":
                        depth -= 1
                    i += 1
            continue
        if flatten and t == "\\\\":
            out.append("\\,")
            i += 1
            continue
        out.append(t)
        i += 1
    return out


def validate_formula(line: str, strict: bool = True) -> Optional[str]:
    """Validate one (prepassed) formula; returns None if it parses, else
    the error message the KaTeX-equivalent parse walk produced."""
    flatten = not any(
        k in line for k in ("matrix", "cases", "array", "begin")
    )
    toks = _pre_skip(pytok.lex(line), flatten)
    try:
        _Validator(toks, strict).validate()
        return None
    except _Invalid as e:
        return str(e)
