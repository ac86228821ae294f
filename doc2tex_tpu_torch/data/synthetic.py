"""Synthetic formula crops: ``synth_hard_sample`` (the hard grammar the
releases were trained on), ``synth_hard_dataset`` (the release eval's set
and the ``hard`` training data), ``synth_long_sample`` and
``synth_long_dataset`` (multi-line displays up to 500 tokens on 448x960
canvases, the ``synthetic_long`` release's eval set),
``synth_structured_sample`` and ``synth_structured_dataset`` (the nested
frac/sqrt/script/matrix grammar over the flat vocabulary: the
``structured`` training data, and half the regions of the detector's
training pages) and the flat ``synth_sample`` (the serving selftest's load)
with ``synth_dataset`` (the ``flat`` training data).

Copied from ``doc2tex_tpu.data.synthetic`` (numpy only), with one change
that keeps every crop and label the same: the JAX package builds the hard
grammar's terminal and unary-command lists by running its LaTeX normalizer
over a KaTeX inventory, and those lists are exactly the released
``version2`` vocabulary (``hard_vocab()`` equals
``saved_models/math_recog/version2/vocab.txt``), so here they are read back
from that file.  The same seed gives the same crop, label and generator
state afterwards as the JAX package (the port's tests hold their sha256).
"""

from __future__ import annotations

import os

import numpy as np

from ..tokenizer.vocab import load_vocab

HARD_VOCAB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "saved_models", "math_recog", "version2", "vocab.txt",
)

# The flat synthetic vocabulary of ``synth_sample``; a token's index seeds
# its glyph's pattern (the hard grammar's two delimiters use theirs too).
SYNTH_VOCAB: list[str] = (
    [chr(c) for c in range(ord("a"), ord("z") + 1)]
    + [str(d) for d in range(10)]
    + [
        "\\frac", "\\sqrt", "\\sum", "\\int", "\\alpha", "\\beta", "\\gamma",
        "\\cdot", "\\times", "\\partial", "\\infty", "\\left(", "\\right)",
        "{", "}", "^", "_", "+", "-", "=", "(", ")", "[", "]", "|",
    ]
    + [
        "\\begin{matrix}", "\\end{matrix}", "\\\\", "&",
        "\\pi", "\\sigma", "\\mu", "\\lambda", "\\theta", "\\phi",
        "\\psi", "\\omega", "\\delta", "\\epsilon", "\\rho", "\\tau",
        "\\leq", "\\geq", "\\neq", "\\pm", "\\to", "\\prod", "\\lim",
        "\\log", "\\sin", "\\cos", "\\exp", "\\nabla", "\\langle",
        "\\rangle", ",", ".", "/", "!", "<", ">",
    ]
)

_GLYPH_CACHE: dict[int, np.ndarray] = {}
_GLYPH_H, _GLYPH_W = 12, 8


def _token_glyph(token_id: int) -> np.ndarray:
    """Deterministic binary glyph for a token id (12x8).

    Each token renders as a unique, stable pixel pattern, so the label IS
    decodable from the image — synthetic training can reach ~100% exact
    match, which is what makes convergence tests meaningful."""
    g = _GLYPH_CACHE.get(token_id)
    if g is None:
        rng = np.random.default_rng(1000 + token_id)
        g = (rng.random((_GLYPH_H, _GLYPH_W)) < 0.45).astype(np.uint8)
        g[0, :] = 1  # top bar anchors vertical alignment
        _GLYPH_CACHE[token_id] = g
    return g


def synth_sample(
    rng: np.random.Generator,
    min_len: int = 3,
    max_len: int = 40,
    min_h: int = 24,
    max_h: int = 120,
) -> tuple[np.ndarray, str]:
    """One flat (image, label) pair: uint8 (H, W) white background with one
    deterministic dark glyph per token laid out left to right (plus random
    scale/offset jitter).  The serving selftest's load."""
    n_tok = int(rng.integers(min_len, max_len + 1))
    tok_ids = [int(rng.integers(len(SYNTH_VOCAB))) for _ in range(n_tok)]
    toks = [SYNTH_VOCAB[i] for i in tok_ids]
    h = int(rng.integers(min_h, max_h + 1))
    # glyph scale fits the canvas height with jitter; floor of 2 when the
    # canvas allows it
    hi = max(h // _GLYPH_H, 2)
    lo = 2 if hi > 2 else 1
    scale = max(int(rng.integers(lo, hi + 1)), 1)
    gh, gw = _GLYPH_H * scale, _GLYPH_W * scale
    gap = int(rng.integers(1, 4)) * scale // 2 + 1
    w = int(np.clip(n_tok * (gw + gap) + 2 * gap + int(rng.integers(0, 20)), 32, 900))
    img = np.full((h, w), 255, dtype=np.uint8)
    y0 = int(rng.integers(0, max(h - gh, 1)))
    ink = int(rng.integers(0, 60))
    x = gap
    for tid in tok_ids:
        if x + gw > w:
            break
        glyph = np.kron(_token_glyph(tid), np.ones((scale, scale), np.uint8))
        region = img[y0 : y0 + gh, x : x + gw]
        region[glyph[: region.shape[0], : region.shape[1]] > 0] = ink
        x += gw + gap
    return img, " ".join(toks)


def synth_dataset(n: int, seed: int = 0, **kwargs) -> tuple[list[np.ndarray], list[str]]:
    """``n`` consecutive ``synth_sample`` draws from one generator seeded
    with ``seed``."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for _ in range(n):
        img, label = synth_sample(rng, **kwargs)
        images.append(img)
        labels.append(label)
    return images, labels


_WHITE = 255


def _glyph_img(token: str, scale: int, ink: int) -> np.ndarray:
    g = _token_glyph(SYNTH_VOCAB.index(token))
    g = np.kron(g, np.ones((scale, scale), np.uint8))
    img = np.full(g.shape, _WHITE, np.uint8)
    img[g > 0] = ink
    return img


def _hstack(parts: list[np.ndarray], gap: int) -> np.ndarray:
    """Concatenate horizontally, centering each part vertically."""
    h = max(p.shape[0] for p in parts)
    w = sum(p.shape[1] for p in parts) + gap * (len(parts) - 1)
    out = np.full((h, w), _WHITE, np.uint8)
    x = 0
    for p in parts:
        y = (h - p.shape[0]) // 2
        out[y : y + p.shape[0], x : x + p.shape[1]] = p
        x += p.shape[1] + gap
    return out


# the structured grammar's terminals: the flat vocabulary without its
# structural tokens (\left( and \right) come only as a balanced pair)
_STRUCT_SYMBOLS = [
    t for t in SYNTH_VOCAB
    if t not in {
        "\\frac", "\\sqrt", "{", "}", "^", "_",
        "\\begin{matrix}", "\\end{matrix}", "\\\\", "&",
        "\\left(", "\\right)",
    }
]


class _StructGen:
    """The structured grammar: nested \\frac / \\sqrt / scripts / \\left( \\right)
    / matrix environments over the flat vocabulary's symbols, rendered in 2D
    with the flat glyphs.  Renders a formula and emits its brace-explicit
    token string, so the label is exactly decodable from the pixels.  The
    hard grammar below overrides its terminal, environment and atom hooks."""

    def __init__(self, rng: np.random.Generator, scale: int, ink: int,
                 max_tokens: int, max_depth: int = 3):
        self.rng = rng
        self.s = scale
        self.ink = ink
        self.budget = max_tokens
        self.max_depth = max_depth

    def _pick_terminal(self) -> str:
        return _STRUCT_SYMBOLS[int(self.rng.integers(len(_STRUCT_SYMBOLS)))]

    def _render_terminal(self, t: str) -> np.ndarray:
        return _glyph_img(t, self.s, self.ink)

    def atom(self, depth: int) -> tuple[np.ndarray, list[str]]:
        r = self.rng.random()
        deep_ok = depth < self.max_depth and self.budget >= 6
        if deep_ok and r < 0.12:
            return self.frac(depth)
        if deep_ok and r < 0.18:
            return self.sqrt(depth)
        if deep_ok and r < 0.34:
            return self.script(depth)
        if deep_ok and r < 0.38:
            return self.delims(depth)
        if deep_ok and depth == 0 and r < 0.42 and self.budget >= 10:
            return self.matrix(depth)
        return self._sym()

    def _sym(self) -> tuple[np.ndarray, list[str]]:
        t = self._pick_terminal()
        self.budget -= 1
        return self._render_terminal(t), [t]

    def expr(self, depth: int, max_atoms: int) -> tuple[np.ndarray, list[str]]:
        n = int(self.rng.integers(1, max_atoms + 1))
        imgs, toks = [], []
        for _ in range(n):
            if self.budget <= 0:
                break
            i, t = self.atom(depth)
            imgs.append(i)
            toks.extend(t)
        if not imgs:
            i, t = self._sym()
            imgs, toks = [i], t
        return _hstack(imgs, gap=self.s), toks

    def frac(self, depth: int) -> tuple[np.ndarray, list[str]]:
        self.budget -= 5  # \frac { } { }
        num, nt = self.expr(depth + 1, 3)
        den, dt = self.expr(depth + 1, 3)
        w = max(num.shape[1], den.shape[1]) + 2 * self.s
        bar = np.full((max(self.s // 2, 2), w), self.ink, np.uint8)
        gap = np.full((self.s, w), _WHITE, np.uint8)

        def center(p):
            out = np.full((p.shape[0], w), _WHITE, np.uint8)
            x = (w - p.shape[1]) // 2
            out[:, x : x + p.shape[1]] = p
            return out

        img = np.concatenate(
            [center(num), gap, bar, gap, center(den)], axis=0
        )
        return img, ["\\frac", "{", *nt, "}", "{", *dt, "}"]

    def sqrt(self, depth: int) -> tuple[np.ndarray, list[str]]:
        self.budget -= 3  # \sqrt { }
        body, bt = self.expr(depth + 1, 3)
        bar_h = max(self.s // 2, 2)
        hook_w = 2 * self.s
        h = body.shape[0] + bar_h + self.s
        w = body.shape[1] + hook_w + self.s
        img = np.full((h, w), _WHITE, np.uint8)
        img[bar_h + self.s :, hook_w : hook_w + body.shape[1]] = body
        img[:bar_h, hook_w - self.s :] = self.ink       # top bar
        # diagonal hook
        for k in range(h):
            x = int(hook_w * k / h)
            img[h - 1 - k, max(x - bar_h, 0) : x + 1] = self.ink
        return img, ["\\sqrt", "{", *bt, "}"]

    def script(self, depth: int) -> tuple[np.ndarray, list[str]]:
        base, bt = self._sym()
        which = "^" if self.rng.random() < 0.5 else "_"
        self.budget -= 3  # ^ { }
        sup, st = self.expr(depth + 1, 2)
        bh, bw = base.shape
        sh, sw = sup.shape
        # enough rows for the raised/lowered script even when the script
        # subtree is taller than the base glyph
        h = max(bh + sh // 2 + self.s, sh + self.s)
        w = bw + sw + self.s
        img = np.full((h, w), _WHITE, np.uint8)
        if which == "^":
            img[h - bh :, :bw] = base
            img[: sh, bw + self.s :] = sup
        else:
            img[:bh, :bw] = base
            img[h - sh :, bw + self.s :] = sup
        return img, [*bt, which, "{", *st, "}"]

    def delims(self, depth: int) -> tuple[np.ndarray, list[str]]:
        """Balanced \\left( ... \\right) pair around a sub-expression."""
        self.budget -= 2
        body, bt = self.expr(depth + 1, 3)
        left = _glyph_img("\\left(", self.s, self.ink)
        right = _glyph_img("\\right)", self.s, self.ink)
        img = _hstack([left, body, right], gap=self.s)
        return img, ["\\left(", *bt, "\\right)"]

    def matrix(self, depth: int) -> tuple[np.ndarray, list[str]]:
        env = self._pick_env()
        rows, cols = self._matrix_dims()
        self.budget -= rows * cols + 2
        cells = [
            [self.expr(depth + 1, 2) for _ in range(cols)]
            for _ in range(rows)
        ]
        col_w = [
            max(cells[r][c][0].shape[1] for r in range(rows))
            for c in range(cols)
        ]
        row_h = [
            max(cells[r][c][0].shape[0] for c in range(cols))
            for r in range(rows)
        ]
        gap = 2 * self.s
        h = sum(row_h) + gap * (rows - 1)
        w = sum(col_w) + gap * (cols - 1)
        img = np.full((h, w), _WHITE, np.uint8)
        toks = ["\\begin{%s}" % env]
        y = 0
        for r in range(rows):
            x = 0
            for c in range(cols):
                p, t = cells[r][c]
                img[y + (row_h[r] - p.shape[0]) // 2 :, x :][
                    : p.shape[0], : p.shape[1]
                ] = p
                if toks[-1] == "\\\\" and t and t[0] == "[":
                    # "\\ [" would parse as the row break's optional size
                    # argument (KaTeX cr function); brace the cell
                    t = ["{", *t, "}"]
                toks.extend(t)
                if c < cols - 1:
                    toks.append("&")
                x += col_w[c] + gap
            if r < rows - 1:
                toks.append("\\\\")
            y += row_h[r] + gap
        toks.append("\\end{%s}" % env)
        return self._decorate_env(env, img), toks

    def _pick_env(self) -> str:
        return "matrix"

    def _matrix_dims(self) -> tuple[int, int]:
        return int(self.rng.integers(2, 4)), int(self.rng.integers(2, 4))

    def _decorate_env(self, env: str, img: np.ndarray) -> np.ndarray:
        return img


def synth_structured_sample(
    rng: np.random.Generator,
    min_len: int = 3,
    max_len: int = 40,
    max_h: int = 256,
    max_w: int = 900,
) -> tuple[np.ndarray, str]:
    """One structured (image, label): nested LaTeX layout, exact labels.

    Oversized renders are regenerated with a halved token budget rather
    than clipped (clipping would cut pixels off while the label kept the
    lost tokens)."""
    budget = int(rng.integers(min_len, max_len + 1))
    for _ in range(8):
        scale = int(rng.integers(2, 4))
        ink = int(rng.integers(0, 60))
        gen = _StructGen(rng, scale, ink, max_tokens=budget)
        img, toks = gen.expr(0, max_atoms=8)
        pad = int(rng.integers(2, 8))
        img = np.pad(img, pad, constant_values=_WHITE)
        if img.shape[0] <= max_h and img.shape[1] <= max_w:
            break
        budget = max(budget // 2, min_len)
    else:  # guaranteed-small fallback: symbols only at min scale
        gen = _StructGen(rng, 2, 0, max_tokens=min_len, max_depth=0)
        img, toks = gen.expr(0, max_atoms=min_len)
        img = np.pad(img, 4, constant_values=_WHITE)
    h = max(img.shape[0], 24)
    w = max(img.shape[1], 32)
    canvas = np.full((h, w), _WHITE, np.uint8)
    canvas[: img.shape[0], : img.shape[1]] = img
    return canvas, " ".join(toks)


def synth_structured_dataset(n: int, seed: int = 0, **kwargs
                             ) -> tuple[list[np.ndarray], list[str]]:
    """``n`` consecutive ``synth_structured_sample`` draws from one
    generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for _ in range(n):
        img, label = synth_structured_sample(rng, **kwargs)
        images.append(img)
        labels.append(label)
    return images, labels


_HARD_FONTS = 3
_HARD_ENVS = ("matrix", "pmatrix", "bmatrix")
# 1-arg accent/style commands, rendered as a deterministic marker strip
# above the argument so labels stay exactly decodable from pixels
_HARD_UNARY_CANDIDATES = (
    "\\hat", "\\bar", "\\tilde", "\\vec", "\\dot", "\\ddot", "\\acute",
    "\\breve", "\\check", "\\grave", "\\overline", "\\underline",
    "\\mathbf", "\\mathrm", "\\mathcal", "\\mathbb", "\\mathit",
    "\\mathsf", "\\mathfrak", "\\boldsymbol",
)

_HARD_STRUCTURAL = (
    "\\frac", "\\sqrt", "{", "}", "^", "_", "\\\\", "&",
    "\\left(", "\\right)",
)
_hard_cache: dict = {}


def _hard_lists() -> tuple[list[str], list[str]]:
    """(terminals, unary commands) of the hard grammar, read back from the
    released vocabulary: structural tokens, env delimiters and unary
    commands come first, the sorted terminals after them."""
    if "lists" not in _hard_cache:
        vocab = load_vocab(HARD_VOCAB_PATH)
        envs = {f"\\begin{{{e}}}" for e in _HARD_ENVS} | {
            f"\\end{{{e}}}" for e in _HARD_ENVS
        }
        unary = [t for t in vocab if t in _HARD_UNARY_CANDIDATES]
        skip = set(_HARD_STRUCTURAL) | envs | set(unary)
        terms = [t for t in vocab if t not in skip]
        if terms != sorted(terms):
            raise ValueError(f"{HARD_VOCAB_PATH} is not the hard-mode vocabulary")
        _hard_cache["lists"] = (terms, unary)
    return _hard_cache["lists"]


_HARD_GLYPH_CACHE: dict[tuple[int, int], np.ndarray] = {}


def _hard_glyph(term_idx: int, font: int) -> np.ndarray:
    """Deterministic binary glyph for terminal #term_idx in font #font.

    Fonts are STYLE TRANSFORMS of one base shape per token — regular
    (0), bold (1: horizontal dilation), italic (2: row shear) — like real
    typefaces, where renderings of a symbol are correlated.  (Unrelated
    random patterns per font were measured to put glyph identity out of
    the soak model's reach: train loss floored at ~3.0 == structure
    learned, terminals unread.)"""
    g = _HARD_GLYPH_CACHE.get((term_idx, font))
    if g is None:
        rng = np.random.default_rng([7000 + term_idx])
        base = (rng.random((_GLYPH_H, _GLYPH_W)) < 0.45).astype(np.uint8)
        base[0, :] = 1  # top bar anchors vertical alignment
        if font % 3 == 1:  # bold: dilate horizontally
            g = base.copy()
            g[:, 1:] |= base[:, :-1]
        elif font % 3 == 2:  # italic: shear rows rightward
            g = np.zeros((_GLYPH_H, _GLYPH_W + 3), np.uint8)
            for r in range(_GLYPH_H):
                off = (_GLYPH_H - 1 - r) // 4
                g[r, off : off + _GLYPH_W] = base[r]
        else:
            g = base
        _HARD_GLYPH_CACHE[(term_idx, font)] = g
    return g


_UNARY_MARK_CACHE: dict[int, np.ndarray] = {}


def _unary_mark(unary_idx: int) -> np.ndarray:
    """4x10 deterministic marker identifying a unary command (drawn above
    its argument, like an accent)."""
    m = _UNARY_MARK_CACHE.get(unary_idx)
    if m is None:
        rng = np.random.default_rng([91000 + unary_idx])
        m = (rng.random((4, 10)) < 0.55).astype(np.uint8)
        m[-1, :] = 1
        _UNARY_MARK_CACHE[unary_idx] = m
    return m


def _filter3(img: np.ndarray, op) -> np.ndarray:
    """3x3 neighborhood min/max/mean via shifted stacks (no scipy here)."""
    p = np.pad(img, 1, mode="edge")
    h, w = img.shape
    stack = np.stack(
        [p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    )
    return op(stack, axis=0)


def apply_render_noise(
    img: np.ndarray, rng: np.random.Generator,
    level: float = 1.0, scale: int = 3,
) -> np.ndarray:
    """Per-sample render noise: ink thickness, blur, contrast jitter,
    salt-and-pepper.  ``scale`` gates thinning (a 3x3 max filter would
    erase 2x2 ink blocks entirely at glyph scale 2)."""
    if level <= 0:
        return img
    out = img.astype(np.float32)
    r = rng.random()
    if r < 0.35 * level:
        out = _filter3(out, np.min)  # thicken ink (dark = low values)
    elif r < 0.55 * level and scale >= 3:
        out = _filter3(out, np.max)  # thin ink
    if rng.random() < 0.5 * level and scale >= 3:
        # blur only at scale>=3: a 3x3 box blur over 2x2 ink blocks washes
        # out glyph identity entirely (measured: train loss floors at ~2.6
        # and eval BLEU at ~0.14 with blur-at-2 on)
        out = _filter3(out, np.mean)
    alpha = 1.0 + (rng.random() - 0.5) * 0.3 * level
    beta = (rng.random() - 0.5) * 60 * level
    out = out * alpha + beta
    frac = rng.random() * 0.005 * level
    n_px = int(frac * out.size)
    if n_px:
        ys = rng.integers(0, out.shape[0], n_px)
        xs = rng.integers(0, out.shape[1], n_px)
        out[ys, xs] = rng.integers(0, 2, n_px) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


class _HardGen(_StructGen):
    """The hard grammar: KaTeX-inventory terminals in several fonts, unary
    commands, delimited matrix envs, display-scale layouts."""

    def __init__(self, rng: np.random.Generator, scale: int, ink: int,
                 max_tokens: int, max_depth: int = 3, fonts: int = _HARD_FONTS):
        super().__init__(rng, scale, ink, max_tokens, max_depth)
        self.terms, self.unary = _hard_lists()
        self._term_idx = {t: i for i, t in enumerate(self.terms)}
        self.fonts = fonts

    def _pick_terminal(self) -> str:
        return self.terms[int(self.rng.integers(len(self.terms)))]

    def _render_terminal(self, t: str) -> np.ndarray:
        font = int(self.rng.integers(self.fonts))
        g = _hard_glyph(self._term_idx[t], font)
        g = np.kron(g, np.ones((self.s, self.s), np.uint8))
        img = np.full(g.shape, _WHITE, np.uint8)
        img[g > 0] = self.ink
        return img

    def _pick_env(self) -> str:
        return _HARD_ENVS[int(self.rng.integers(len(_HARD_ENVS)))]

    def _matrix_dims(self) -> tuple[int, int]:
        # display-scale grids when the budget allows (fills gate buckets)
        if self.budget >= 60:
            return (int(self.rng.integers(3, 7)), int(self.rng.integers(2, 6)))
        return (int(self.rng.integers(2, 4)), int(self.rng.integers(2, 4)))

    def _decorate_env(self, env: str, img: np.ndarray) -> np.ndarray:
        if env == "matrix":
            return img
        h = img.shape[0]
        bar = max(self.s // 2, 2)
        dw = 2 * self.s
        out = np.full((h, img.shape[1] + 2 * (dw + self.s)), _WHITE, np.uint8)
        out[:, dw + self.s : dw + self.s + img.shape[1]] = img
        # vertical strokes; bmatrix adds square-bracket ticks
        out[:, :bar] = self.ink
        out[:, -bar:] = self.ink
        if env == "bmatrix":
            out[:bar, :dw] = self.ink
            out[-bar:, :dw] = self.ink
            out[:bar, -dw:] = self.ink
            out[-bar:, -dw:] = self.ink
        return out

    def unary_atom(self, depth: int) -> tuple[np.ndarray, list[str]]:
        u_idx = int(self.rng.integers(len(self.unary)))
        u = self.unary[u_idx]
        self.budget -= 3  # cmd { }
        body, bt = self.expr(depth + 1, 2)
        mark = np.kron(_unary_mark(u_idx), np.ones((self.s, self.s), np.uint8))
        mark_img = np.full(mark.shape, _WHITE, np.uint8)
        mark_img[mark > 0] = self.ink
        w = max(body.shape[1], mark_img.shape[1])
        h = body.shape[0] + mark_img.shape[0] + self.s
        img = np.full((h, w), _WHITE, np.uint8)
        xm = (w - mark_img.shape[1]) // 2
        img[: mark_img.shape[0], xm : xm + mark_img.shape[1]] = mark_img
        xb = (w - body.shape[1]) // 2
        img[mark_img.shape[0] + self.s :, xb : xb + body.shape[1]] = body
        return img, [u, "{", *bt, "}"]

    def atom(self, depth: int) -> tuple[np.ndarray, list[str]]:
        r = self.rng.random()
        deep_ok = depth < self.max_depth and self.budget >= 6
        if deep_ok and r < 0.10:
            return self.frac(depth)
        if deep_ok and r < 0.15:
            return self.sqrt(depth)
        if deep_ok and r < 0.21 and self.unary:
            return self.unary_atom(depth)
        if deep_ok and r < 0.35:
            return self.script(depth)
        if deep_ok and r < 0.39:
            return self.delims(depth)
        if deep_ok and depth == 0 and r < 0.46 and self.budget >= 10:
            return self.matrix(depth)
        return self._sym()


def synth_hard_sample(
    rng: np.random.Generator,
    min_len: int = 8,
    max_len: int = 150,
    max_h: int = 448,
    max_w: int = 960,
    noise: float = 1.0,
    fonts: int = _HARD_FONTS,
    scale_range: tuple[int, int] = (2, 4),
) -> tuple[np.ndarray, str]:
    """One reference-scale (image, label) pair.  Same decodable-label
    contract as synth_structured_sample (oversized renders regenerate with
    a halved budget; never clipped).  ``scale_range``: half-open glyph
    scale range; the soak's calibrated operating point uses (3, 5) — at
    scale 2 a glyph spans ~1.5 positions of the encoder's /16 stride and
    token accuracy ceilings too low for sequence-level exact match."""
    budget = int(rng.integers(min_len, max_len + 1))
    for _ in range(12):
        scale = int(rng.integers(*scale_range))
        ink = int(rng.integers(0, 60))
        gen = _HardGen(rng, scale, ink, max_tokens=budget, fonts=fonts)
        img, toks = gen.expr(0, max_atoms=max(min(budget // 2, 14), 3))
        pad = int(rng.integers(2, 8))
        img = np.pad(img, pad, constant_values=_WHITE)
        fits = img.shape[0] <= max_h and img.shape[1] <= max_w
        if fits and min_len <= len(toks) <= max_len:
            break
        if not fits or len(toks) > max_len:
            budget = max(budget // 2, min_len)
        # too short: just resample (structural atoms emit several tokens,
        # so a small-n draw can undershoot min_len)
    else:  # guaranteed-valid fallback: exactly min_len plain symbols
        scale = scale_range[0]
        gen = _HardGen(rng, scale, 0, max_tokens=min_len + 1, max_depth=0,
                       fonts=fonts)
        parts = [gen._sym() for _ in range(min_len)]
        img = _hstack([p for p, _ in parts], gap=2)
        toks = [t for _, ts in parts for t in ts]
        img = np.pad(img, 4, constant_values=_WHITE)
    img = apply_render_noise(img, rng, level=noise, scale=scale)
    h = max(img.shape[0], 24)
    w = max(img.shape[1], 32)
    canvas = np.full((h, w), int(img.max()) if img.size else _WHITE, np.uint8)
    canvas[: img.shape[0], : img.shape[1]] = img
    return canvas, " ".join(toks)


def synth_hard_dataset(n: int, seed: int = 0, **kwargs) -> tuple[list[np.ndarray], list[str]]:
    """``n`` consecutive ``synth_hard_sample`` draws from one generator
    seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for _ in range(n):
        img, label = synth_hard_sample(rng, **kwargs)
        images.append(img)
        labels.append(label)
    return images, labels


def synth_long_sample(
    rng: np.random.Generator,
    min_len: int = 120,
    max_len: int = 500,
    max_h: int = 448,
    max_w: int = 960,
    noise: float = 1.0,
    fonts: int = _HARD_FONTS,
    scale: int = 3,
) -> tuple[np.ndarray, str]:
    """One LONG multi-line (image, label) of the reference eval contract's
    regime (``config/test.yaml``: 448x960 canvases, decode up to 500
    tokens): the ``synthetic_long`` release's eval set.

    Layout: an align-style display — K left-aligned lines stacked
    vertically, labelled as a single-column ``matrix`` environment (rows
    joined by ``\\\\``), which keeps the label inside the released
    ``hard_vocab`` (no new embedding rows; the shipped checkpoints can be
    fine-tuned directly).  Each line is a ``_HardGen`` expression at
    shallow depth, so height stays bounded while token count climbs; lines
    are added until the sampled token target or the canvas height is
    reached — fit by construction, labels exactly decodable from pixels
    (same contract as ``synth_hard_sample``)."""
    target = int(rng.integers(min_len, max_len + 1))
    ink = int(rng.integers(0, 60))
    pad = int(rng.integers(2, 8))
    gap = 3 * scale
    lines: list[tuple[np.ndarray, list[str]]] = []
    n_toks = 2  # \begin{matrix} ... \end{matrix}
    h_used = 2 * pad
    for _ in range(96):
        room = target - n_toks - (1 if lines else 0)
        if room < 8:
            break
        # a row = 1-2 cells ('&'-separated) for token density: two
        # side-by-side expressions double tokens-per-row at the same
        # height, the way real align displays carry eq + annotation
        n_cells = 2 if room >= 64 and rng.random() < 0.6 else 1
        cells: list[tuple[np.ndarray, list[str]]] = []
        for _c in range(n_cells):
            cell_budget = min(int(rng.integers(28, 64)),
                              max(room // n_cells - 1, 8))
            gen = _HardGen(rng, scale, ink, max_tokens=cell_budget,
                           max_depth=2, fonts=fonts)
            # a group may hold at most ONE infix command (\over/\choose —
            # KaTeX Parser.js:191); the flat grammar's short groups dodge
            # that, long '&'-joined rows would not: drop infix terminals
            gen.terms = [t for t in gen.terms if t not in ("\\over", "\\choose")]
            # depth starts at 1: no matrix envs INSIDE a line (they need
            # depth 0), so line height stays a few glyph rows and the
            # token target — not canvas height — bounds the sample.
            # expr() draws a uniform atom count, which underfills long
            # cells — keep appending chunks until the budget is spent
            imgs_c: list[np.ndarray] = []
            toks: list[str] = []
            while gen.budget > 2:
                im, tk = gen.expr(1, 6)
                imgs_c.append(im)
                toks.extend(tk)
            img = _hstack(imgs_c, gap=2 * scale)
            if toks and img.shape[0] <= 22 * scale:
                cells.append((img, toks))
        if not cells:
            continue
        row_h = max(im.shape[0] for im, _ in cells)
        row_w = sum(im.shape[1] for im, _ in cells) + 8 * scale * (len(cells) - 1)
        if row_w > max_w - 2 * pad:
            continue  # too wide: resample the row
        if h_used + row_h + (gap if lines else 0) > max_h - 2 * pad:
            break
        row_img = np.full((row_h, row_w), _WHITE, np.uint8)
        x = 0
        row_toks: list[str] = []
        for ci, (im, toks) in enumerate(cells):
            if ci:
                row_toks.append("&")
            y0 = (row_h - im.shape[0]) // 2
            row_img[y0 : y0 + im.shape[0], x : x + im.shape[1]] = im
            x += im.shape[1] + 8 * scale
            row_toks.extend(toks)
        h_used += row_h + (gap if lines else 0)
        n_toks += len(row_toks) + (1 if lines else 0)
        lines.append((row_img, row_toks))
    if not lines:  # degenerate canvas budget: one guaranteed-small line
        gen = _HardGen(rng, scale, 0, max_tokens=8, max_depth=0, fonts=fonts)
        img, toks = gen.expr(0, max_atoms=4)
        lines = [(img, toks)]
    w = max(img.shape[1] for img, _ in lines) + 2 * pad
    h = sum(img.shape[0] for img, _ in lines) + gap * (len(lines) - 1) + 2 * pad
    canvas = np.full((max(h, 24), max(w, 32)), _WHITE, np.uint8)
    y = pad
    label_toks = ["\\begin{matrix}"]
    for i, (img, toks) in enumerate(lines):
        canvas[y : y + img.shape[0], pad : pad + img.shape[1]] = img
        y += img.shape[0] + gap
        if i:
            label_toks.append("\\\\")
        label_toks.extend(toks)
    label_toks.append("\\end{matrix}")
    canvas = apply_render_noise(canvas, rng, level=noise, scale=scale)
    return canvas, " ".join(label_toks)


def synth_long_dataset(n: int, seed: int = 0, **kwargs) -> tuple[list[np.ndarray], list[str]]:
    """``n`` consecutive ``synth_long_sample`` draws from one generator
    seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for _ in range(n):
        img, label = synth_long_sample(rng, **kwargs)
        images.append(img)
        labels.append(label)
    return images, labels

def hard_vocab() -> list[str]:
    """The hard grammar's full vocabulary, the released ``version2`` one:
    structural tokens, env delimiters, unary commands, then the terminals."""
    return load_vocab(HARD_VOCAB_PATH)


def seeded_crops(n: int, max_h: int = 224, max_w: int = 704, min_side: int = 32):
    """The first ``n`` seeds (0, 1, ...) whose ``synth_hard_sample`` crop has
    both sides >= ``min_side``, so it needs no resize in a config whose
    min_dimension is that size.  Returns [(seed, image, label), ...]."""
    out, seed = [], 0
    while len(out) < n:
        img, label = synth_hard_sample(np.random.default_rng(seed), max_h=max_h, max_w=max_w)
        if min(img.shape) >= min_side:
            out.append((seed, img, label))
        seed += 1
    return out
