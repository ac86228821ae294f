"""Vocabulary construction tooling (copied from
``doc2tex_tpu.tools.vocab_tools``).

Parity targets (reference ``doc2tex/tools/build_data/construct_label/``):
- ``generate_latex_vocab.py:60-155``: frequency-counted vocab with an UNK
  threshold; raw mode writes token<TAB>freq, filtered mode writes sorted
  token list
- ``find_threshold.py:11-30+``: cumulative-frequency threshold finder (cut
  where the cumulative sum of rare-token counts stays under a fraction of
  the total)
- ``augmentation_dupp.py``: rare-token augmentation by duplicating label
  lines ("templates") containing rare tokens
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence


def count_tokens(label_lines: Iterable[str]) -> Counter:
    c: Counter = Counter()
    for line in label_lines:
        c.update(line.split())
    return c


def build_vocab_with_threshold(
    label_lines: Sequence[str],
    unk_threshold: int = 0,
    raw: bool = False,
):
    """Vocab above the UNK threshold.

    raw=True  -> [(token, freq), ...] frequency-sorted (vocab.txt w/ counts)
    raw=False -> sorted token list (vocab_full_filter.txt)
    Returns (vocab, unknown) like the reference logs unknown tokens.
    """
    counts = count_tokens(label_lines)
    items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    kept = [(t, f) for t, f in items if f > unk_threshold]
    unknown = [(t, f) for t, f in items if f <= unk_threshold]
    if raw:
        return kept, unknown
    return sorted(t for t, _ in kept), unknown


def find_unk_threshold(
    counts: Counter, cut_fraction: float = 0.001
) -> int:
    """Smallest frequency F such that tokens with freq <= F contribute
    less than ``cut_fraction`` of all token occurrences (reference
    ``find_threshold.py``)."""
    total = sum(counts.values())
    if total == 0:
        return 0
    freqs = sorted(counts.values())
    cum = 0
    threshold = 0
    for f in freqs:
        cum += f
        if cum / total < cut_fraction:
            threshold = f
        else:
            break
    return threshold


def augment_rare_tokens(
    label_lines: Sequence[str],
    unk_threshold: int,
    target_freq: int | None = None,
) -> list[str]:
    """Duplicate label lines containing rare tokens until each rare token
    reaches ~target_freq occurrences (reference ``augmentation_dupp.py``:
    rare-token template duplication).  Returns the extra lines to append."""
    counts = count_tokens(label_lines)
    target = target_freq if target_freq is not None else unk_threshold + 1
    rare = {t for t, f in counts.items() if f <= unk_threshold}
    if not rare:
        return []
    # best template per rare token = shortest line containing it
    extra: list[str] = []
    current = Counter(counts)
    for tok in sorted(rare):
        templates = sorted(
            (ln for ln in label_lines if tok in ln.split()), key=len
        )
        if not templates:
            continue
        i = 0
        while current[tok] < target:
            line = templates[i % len(templates)]
            extra.append(line)
            current.update(line.split())
            i += 1
    return extra


def recheck_queue(
    label_rows: Sequence[tuple[str, str]],
    vocab: Sequence[str],
) -> list[tuple[str, str, list[str]]]:
    """Labels needing manual recheck: rows whose tokens fall outside the
    vocab (reference ``get_recheck_textline.py`` /
    ``process_recheck_textline.py`` queue construction).

    ``label_rows``: (name, label) pairs.  Returns (name, label,
    offending_tokens) for each flagged row.
    """
    vocab_set = set(vocab)
    out = []
    for name, label in label_rows:
        bad = [t for t in label.split() if t not in vocab_set]
        if bad:
            out.append((name, label, bad))
    return out


def apply_recheck_fixes(
    label_rows: Sequence[tuple[str, str]],
    fixes: dict[str, str],
) -> list[tuple[str, str]]:
    """Merge rechecked labels back (reference process_recheck_textline):
    ``fixes`` maps name -> corrected label; empty string drops the row."""
    out = []
    for name, label in label_rows:
        if name in fixes:
            if fixes[name]:
                out.append((name, fixes[name]))
        else:
            out.append((name, label))
    return out
