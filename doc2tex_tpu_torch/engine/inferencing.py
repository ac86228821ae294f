"""Validation: decode every eval batch and score it (the decode side of
``doc2tex_tpu.engine.inferencing.validation``; no teacher-forced loss).

Each loader batch is decoded as it is, with no batch padding, so the int8
encoder's per-batch activation scales are those of the JAX package's run
over the same loader.  Predictions are the detokenized rows joined with
spaces (word level) or nothing (char level), compared with the labels as
they are.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from ..eval.metrics import bleu_score, get_single_ED, get_word_NED


def validation(decode_fn: Callable, converter, loader, config) -> dict[str, Any]:
    """Run ``decode_fn`` (``decode.runner.make_decode_fn``) over ``loader``
    and return the JAX package's metric dict: ``accuracy`` (exact match),
    ``bleu``, ``ED`` (character match score), ``word_ED``, ``n_samples``,
    ``samples`` [(name, label, prediction)] and the decode seconds per
    sample, ``avg_infer_s``."""
    sep = " " if config.get("token_level", "word") == "word" else ""
    n = correct = 0
    ned_sum = t_infer = 0.0
    preds_all: list[str] = []
    gts_all: list[str] = []
    names_all: list[str] = []
    for batch in loader:
        nb = len(batch.labels)
        t0 = time.perf_counter()
        tokens = decode_fn(batch.images)[0][:nb].cpu().numpy()   # the host copy syncs
        t_infer += time.perf_counter() - t0
        for pred_tokens, gt, name in zip(converter.detokenize(tokens), batch.labels,
                                         batch.names):
            p = sep.join(pred_tokens)
            n += 1
            correct += p == gt
            ned_sum += get_single_ED(gt, p)
            preds_all.append(p)
            gts_all.append(gt)
            names_all.append(name)
    bleu = bleu_score([p.split() for p in preds_all],
                      [[g.split()] for g in gts_all]) if preds_all else 0.0
    return {
        "samples": list(zip(names_all, gts_all, preds_all)),
        "accuracy": correct / n if n else 0.0,
        "bleu": float(bleu),
        "ED": ned_sum / n if n else 0.0,
        "word_ED": float(get_word_NED(preds_all, gts_all)) if preds_all else 0.0,
        "n_samples": n,
        "avg_infer_s": t_infer / max(n, 1),
    }
