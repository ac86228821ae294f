"""Validation: decode every eval batch, score it, and with ``eval_step``
take the teacher-forced loss (counterpart of
``doc2tex_tpu.engine.inferencing.validation``).

Each loader batch is decoded as it is, with no batch padding, so the int8
encoder's per-batch activation scales are those of the JAX package's run
over the same loader.  Predictions are the detokenized rows joined with
spaces (word level) or nothing (char level), compared with the labels as
they are.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Callable, Optional

import numpy as np

from ..eval.metrics import bleu_score, get_single_ED, get_word_NED
from ..utils.common import Averager


def validation(decode_fn: Callable, converter, loader, config, eval_step=None, state=None,
               max_batches: Optional[int] = None, export_csv: Optional[str] = None
               ) -> dict[str, Any]:
    """Run ``decode_fn`` (``decode.runner.make_decode_fn``) over ``loader``
    and return the JAX package's metric dict: ``accuracy`` (exact match),
    ``bleu``, ``ED`` (character match score), ``word_ED``, ``n_samples``,
    ``samples`` [(name, label, prediction)], ``loss`` (the mean
    teacher-forced loss by ``eval_step(state, images, text)``, 0 without
    one), ``worst`` (the ten highest per-sample losses, formatted) and the
    decode and post-processing seconds per sample.  ``max_batches`` stops
    early; ``export_csv`` writes name, pred, label, ed, iscorrect rows."""
    sep = " " if config.get("token_level", "word") == "word" else ""
    loss_avg = Averager()
    n = correct = 0
    ned_sum = t_infer = t_post = 0.0
    preds_all: list[str] = []
    gts_all: list[str] = []
    names_all: list[str] = []
    worst: list[tuple[float, str, str, str]] = []
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        nb = len(batch.labels)
        per_sample = np.zeros(nb)
        if eval_step is not None:
            em = eval_step(state, batch.images, batch.text)
            loss_avg.add(float(em["loss"]), nb)
            per_sample = em["per_sample_loss"].cpu().numpy()
        t0 = time.perf_counter()
        tokens = decode_fn(batch.images)[0][:nb].cpu().numpy()   # the host copy syncs
        t_infer += time.perf_counter() - t0
        t0 = time.perf_counter()
        for pred_tokens, gt, name, ls in zip(converter.detokenize(tokens), batch.labels,
                                             batch.names, per_sample):
            p = sep.join(pred_tokens)
            n += 1
            correct += p == gt
            ned_sum += get_single_ED(gt, p)
            preds_all.append(p)
            gts_all.append(gt)
            names_all.append(name)
            worst.append((float(ls), name, gt, p))
        t_post += time.perf_counter() - t0
    worst.sort(key=lambda t: -t[0])
    bleu = bleu_score([p.split() for p in preds_all],
                      [[g.split()] for g in gts_all]) if preds_all else 0.0
    if export_csv:
        os.makedirs(os.path.dirname(export_csv) or ".", exist_ok=True)
        with open(export_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "pred", "label", "ed", "iscorrect"])
            for nm, g, p in zip(names_all, gts_all, preds_all):
                w.writerow([nm, p, g, round(get_single_ED(g, p), 4), int(p == g)])
    return {
        "samples": list(zip(names_all, gts_all, preds_all)),
        "loss": loss_avg.val(),
        "accuracy": correct / n if n else 0.0,
        "bleu": float(bleu),
        "ED": ned_sum / n if n else 0.0,
        "word_ED": float(get_word_NED(preds_all, gts_all)) if preds_all else 0.0,
        "n_samples": n,
        "avg_infer_s": t_infer / max(n, 1),
        "avg_postprocess_s": t_post / max(n, 1),
        "worst": [f"loss={ls:.3f} [{nm}] gt={gt[:60]!r} pred={p[:60]!r}"
                  for ls, nm, gt, p in worst[:10]],
    }
