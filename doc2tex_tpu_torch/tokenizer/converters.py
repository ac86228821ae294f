"""Label converters (copied from ``doc2tex_tpu.tokenizer.converters``).

Two families, told apart by the Prediction head:

- Attn (LSTM heads ``Attn``/``Attnv2``): [GO]=0, [s]=1, [UNK]=2; pad is
  [GO] = 0;
- TFM: [PAD]=0, [GO]=1, [s]=2, [UNK]=3.

The vocabulary follows the special tokens.  Only the decode direction is
needed for recognition: ``detokenize`` cuts each row at its first [s].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class _BaseConverter:
    list_token: list[str] = []

    def __init__(self, character: Sequence[str]):
        self.character: list[str] = list(self.list_token) + list(character)

    @property
    def num_classes(self) -> int:
        return len(self.character)

    def detokenize(self, token_ids: np.ndarray) -> list[list[str]]:
        """Token-id matrix -> token lists, cut at the first [s]."""
        chars = self.character
        out: list[list[str]] = []
        for row in np.asarray(token_ids):
            toks: list[str] = []
            for i in row:
                i = int(i)
                if i == self.END:
                    break
                toks.append(chars[i])
            out.append(toks)
        return out


class AttnLabelConverter(_BaseConverter):
    list_token = ["[GO]", "[s]", "[UNK]"]
    GO, END, UNK = 0, 1, 2
    PAD = GO


class TFMLabelConverter(_BaseConverter):
    list_token = ["[PAD]", "[GO]", "[s]", "[UNK]"]
    PAD, GO, END, UNK = 0, 1, 2, 3


def create_converter(config) -> _BaseConverter:
    """Load the vocab into ``config['character']`` and build the converter
    of the Prediction head's family."""
    from .vocab import load_vocab

    if not config.get("character"):
        vocab_path = config.get("vocab")
        if not vocab_path:
            raise ValueError("config needs 'vocab' path or 'character' list")
        config["character"] = load_vocab(vocab_path)
    pred = config["Prediction"]["name"]
    if pred.startswith("Attn"):
        return AttnLabelConverter(config["character"])
    if pred == "TFM":
        return TFMLabelConverter(config["character"])
    raise NotImplementedError(f"Prediction head {pred!r} is not ported yet")
