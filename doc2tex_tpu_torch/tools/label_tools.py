"""Label-file construction: manifest building, filtering, splitting
(copied from ``doc2tex_tpu.tools.label_tools``).

Parity targets (reference ``doc2tex/tools/build_data/construct_label/``):
- ``generate_latex_label.py``: match rendered images back to their source
  formulas, emit id<TAB>label manifests, train/val/test split
- ``standard_total_df.py``: drop rows containing tokens outside the
  supported (KaTeX) token set
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Sequence

_RENDER_NAME = re.compile(r"f(\d+)\.png$")


def build_label_manifest(
    image_dir: str, formulas: Sequence[str]
) -> list[tuple[str, str]]:
    """Match rendered images (``fNNNNNN.png`` from tools.render) back to the
    formula list by index (reference generate_latex_label main loop).
    Returns (image_name, label) rows for images that exist."""
    rows = []
    for fname in sorted(os.listdir(image_dir)):
        m = _RENDER_NAME.search(fname)
        if not m:
            continue
        idx = int(m.group(1))
        if 0 <= idx < len(formulas):
            rows.append((fname, formulas[idx].strip()))
    return rows


def filter_supported_tokens(
    rows: Iterable[tuple[str, str]], supported: Iterable[str]
) -> tuple[list[tuple[str, str]], list[tuple[str, str]]]:
    """(kept, dropped) by whether every label token is in the supported set
    (reference standard_total_df.py OOV removal)."""
    sup = set(supported)
    kept, dropped = [], []
    for name, label in rows:
        if all(t in sup for t in label.split()):
            kept.append((name, label))
        else:
            dropped.append((name, label))
    return kept, dropped


def train_val_test_split(
    rows: Sequence[tuple[str, str]],
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 1999,
):
    """Deterministic shuffled split (reference uses sklearn
    train_test_split with a fixed seed)."""
    import numpy as np

    order = np.random.default_rng(seed).permutation(len(rows))
    n_val = int(len(rows) * val_frac)
    n_test = int(len(rows) * test_frac)
    val = [rows[i] for i in order[:n_val]]
    test = [rows[i] for i in order[n_val : n_val + n_test]]
    train = [rows[i] for i in order[n_val + n_test :]]
    return train, val, test


def write_manifest(rows: Sequence[tuple[str, str]], path: str) -> None:
    """id<TAB>label TSV (the LABEL_KEY schema, reference data_const.py)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        # plain TAB join, no csv quoting/escaping: LaTeX labels hold `"`
        # and `\` literally and never hold tabs/newlines; this round-trips
        # exactly with the QUOTE_NONE readers (lmdb_builder/infer)
        for name, label in rows:
            f.write(f"{name}\t{label}\n")
