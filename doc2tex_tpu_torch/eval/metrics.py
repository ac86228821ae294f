"""Evaluation metrics (copied from ``doc2tex_tpu.eval.metrics``): corpus
BLEU-4, normalized edit distances and exact match.

``levenshtein`` runs the repository's native edit distance
(``native.levenshtein``, built from ``native/levenshtein.cpp``), as the JAX
package does; ``_lev_py``, the two-row dynamic program in Python, is its
plain version, which the tests hold it to.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Hashable, Sequence

from .. import native


def _lev_py(a: Sequence[Hashable], b: Sequence[Hashable]) -> int:
    """Classic two-row DP Levenshtein."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def levenshtein(a: Sequence[Hashable], b: Sequence[Hashable]) -> int:
    """Edit distance of two strings or two token lists (native)."""
    return native.levenshtein(a, b)


def get_single_ED(gt: str, pred: str) -> float:
    """ICDAR2019 normalized character match score (1 - ED / longer side);
    0 when either string is empty."""
    if len(gt) == 0 or len(pred) == 0:
        return 0.0
    denom = len(gt) if len(gt) > len(pred) else len(pred)
    return 1.0 - levenshtein(pred, gt) / denom


def get_word_NED(list_preds, list_gts) -> float:
    """Word-level normalized match score averaged over the batch."""
    if isinstance(list_preds, str):
        list_preds = [list_preds]
    if isinstance(list_gts, str):
        list_gts = [list_gts]
    total = 0.0
    for gt, pred in zip(list_gts, list_preds):
        wg, wp = gt.split(), pred.split()
        cur_max = max(len(wg), len(wp))
        if len(gt) == 0 or len(pred) == 0:
            continue
        total += 1.0 - levenshtein(wg, wp) / cur_max
    return total / float(len(list_gts))


def exact_match(preds: Sequence[str], gts: Sequence[str]) -> float:
    """Exact-match accuracy after whitespace normalization."""
    n = sum(1 for p, g in zip(preds, gts) if " ".join(p.split()) == " ".join(g.split()))
    return n / max(len(gts), 1)


def _ngram_counter(tokens: Sequence[str], max_n: int) -> Counter:
    c: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            c[tuple(tokens[i : i + n])] += 1
    return c


def bleu_score(
    candidate_corpus: Sequence[Sequence[str]],
    references_corpus: Sequence[Sequence[Sequence[str]]],
    max_n: int = 4,
    weights: Sequence[float] = (0.25,) * 4,
) -> float:
    """Corpus BLEU: clipped counts, closest-reference brevity penalty, 0.0
    when any order has no match."""
    if len(candidate_corpus) != len(references_corpus):
        raise ValueError("candidate and reference corpora differ in length")
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0.0
    refs_len = 0.0
    for cand, refs in zip(candidate_corpus, references_corpus):
        cand = list(cand)
        cand_len += len(cand)
        ref_lens = [float(len(r)) for r in refs]
        refs_len += min(ref_lens, key=lambda x: abs(len(cand) - x))
        ref_counter = _ngram_counter(list(refs[0]), max_n)
        for r in refs[1:]:
            ref_counter |= _ngram_counter(list(r), max_n)
        cand_counter = _ngram_counter(cand, max_n)
        for ngram, cnt in (cand_counter & ref_counter).items():
            clipped[len(ngram) - 1] += cnt
        for i in range(max_n):
            totals[i] += max(len(cand) - i, 0)
    if min(clipped) == 0:
        return 0.0
    log_pn = sum(w * math.log(c / t) for w, c, t in zip(weights, clipped, totals))
    bp = math.exp(min(1.0 - refs_len / cand_len, 0.0))
    return bp * math.exp(log_pn)
