"""Vocabulary loading (copied from ``doc2tex_tpu.tokenizer.vocab``)."""

from __future__ import annotations


def load_vocab(path: str) -> list[str]:
    """Load a newline-separated token vocabulary file."""
    with open(path, "r", encoding="utf-8") as f:
        tokens = [line.rstrip("\n") for line in f]
    return [t for t in tokens if t]
