"""Label converters (copied from ``doc2tex_tpu.tokenizer.converters``).

Two families, told apart by the Prediction head:

- Attn (LSTM heads ``Attn``/``Attnv2``): [GO]=0, [s]=1, [UNK]=2; pad is
  [GO] = 0;
- TFM: [PAD]=0, [GO]=1, [s]=2, [UNK]=3.

The vocabulary follows the special tokens.  ``detokenize`` cuts each row
at its first [s]; ``encode`` (training) lays a batch out as
``[GO] t1 ... tn [s] pad ...`` at the static width ``batch_max_length + 2``,
with the JAX package's truncation quirk (at most ``batch_max_length``
tokens before [s]).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class _BaseConverter:
    list_token: list[str] = []

    def __init__(self, character: Sequence[str]):
        self.character: list[str] = list(self.list_token) + list(character)
        self.dict: dict[str, int] = {c: i for i, c in enumerate(self.character)}

    def encode(self, text: Sequence[Sequence[str]], batch_max_length: int = 25
               ) -> tuple[np.ndarray, np.ndarray]:
        """Token lists -> (ids int32 (B, batch_max_length + 2), lengths
        int32 (B,) = tokens + 1)."""
        length = np.asarray([len(s) + 1 for s in text], dtype=np.int32)
        inner_max = batch_max_length + 1
        d = self.dict   # special ids by lookup, as the JAX converter takes them
        batch = np.full((len(text), inner_max + 1), d[self.list_token[0]], dtype=np.int32)
        batch[:, 0] = d["[GO]"]
        for i, toks in enumerate(text):
            toks = list(toks)
            if len(toks) > inner_max:
                toks = toks[: inner_max - 1]
            ids = [d.get(t, d["[UNK]"]) for t in toks] + [d["[s]"]]
            batch[i, 1: 1 + len(ids)] = ids
        return batch, length

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
    """Load the vocab into ``config['character']`` (the flat synthetic
    vocabulary when there is none and the data is ``synthetic_data``) and
    build the converter of the Prediction head's family."""
    from .vocab import load_vocab

    if not config.get("character"):
        vocab_path = config.get("vocab")
        if vocab_path:
            config["character"] = load_vocab(vocab_path)
        elif config.get("synthetic_data"):
            from ..data.synthetic import SYNTH_VOCAB

            config["character"] = list(SYNTH_VOCAB)
        else:
            raise ValueError("config needs 'vocab' path or 'character' list")
    pred = config["Prediction"]["name"]
    if pred.startswith("Attn"):
        return AttnLabelConverter(config["character"])
    if pred in ("TFM", "MS_TFM"):
        return TFMLabelConverter(config["character"])
    raise ValueError(f"Unknown Prediction head: {pred!r}")
