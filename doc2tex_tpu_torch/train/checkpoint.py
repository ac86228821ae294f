"""Checkpoints the JAX package can read (counterpart of
``doc2tex_tpu.train.checkpoint``).

``save_checkpoint`` writes the tree that the JAX ``save_checkpoint``
writes, as flax msgpack: ``step`` (int32), ``params`` and ``batch_stats``
in flax's layout (``weights.to_variables``), and ``opt_state`` laid out as
``flax.serialization.to_state_dict`` lays out the optax state
(``optim.state_to_flax``), plus a ``.json`` sidecar of scalars.  So JAX's
``load_checkpoint(path, template)`` restores a port checkpoint, and
``load_checkpoint`` here restores JAX's (a tree that does not fit this
optimizer raises).  ``BestCheckpointKeeper`` keeps ``best_bleu``,
``best_accuracy`` and ``last_checkpoint`` as the JAX keeper does.

On a mesh every rank holds the whole tree (a model axis replicates), so a
checkpoint is already the gathered tree: rank 0 writes it (``BestCheckpointKeeper(write=...)``),
and a resume loads it whole on every rank, whatever the mesh's shape.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional

import numpy as np

from .. import _msgpack
from ..weights import load_variables, to_variables
from .optim import state_from_flax, state_to_flax
from .trainer import TrainState


def save_checkpoint(path: str, state: TrainState, extra: Optional[Mapping[str, Any]] = None
                    ) -> None:
    """``state`` to ``path`` (.msgpack) and ``extra`` to ``path + '.json'``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    variables = to_variables(state.model)
    _msgpack.save(path, {"step": np.asarray(state.step, np.int32),
                         "params": variables["params"],
                         "batch_stats": variables["batch_stats"],
                         "opt_state": state_to_flax(state.opt_state)})
    with open(path + ".json", "w") as f:
        json.dump(dict(extra or {}), f, indent=2, default=float)


def load_checkpoint(path: str, state_template: Optional[TrainState] = None
                    ) -> tuple[Any, dict]:
    """Without a template: (the raw tree, the sidecar).  With one (a fresh
    state of the same model and optimizer): its model takes the
    checkpoint's parameters and statistics in place, and (the restored
    state, the sidecar) is returned."""
    payload = _msgpack.load(path)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    if state_template is None:
        return payload, meta
    load_variables(state_template.model, {"params": payload["params"],
                                          "batch_stats": payload["batch_stats"]})
    opt_state = state_from_flax(state_template.opt_state, payload["opt_state"])
    return TrainState(int(np.asarray(payload["step"])), state_template.model, opt_state), meta


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: Mapping) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def partial_restore(saved_tree: Mapping, target_tree: Mapping) -> tuple[dict, dict]:
    """Every leaf of ``saved_tree`` whose path and shape match takes its
    place in ``target_tree`` (flax layout, numpy); a flat (N+1, D)
    ``pos_embed`` whose length differs is resized.  Returns (tree, counts
    of loaded, skipped and resized leaves)."""
    saved, flat = _flatten(saved_tree), _flatten(target_tree)
    loaded = skipped = resized = 0
    for k, v in flat.items():
        v = np.asarray(v)
        sv = np.asarray(saved[k]) if k in saved else None
        if sv is not None and sv.shape == v.shape:
            flat[k] = sv.astype(v.dtype)
            loaded += 1
        elif (sv is not None and "pos_embed" in k and sv.ndim == v.ndim == 2
              and sv.shape[-1] == v.shape[-1]):
            flat[k] = resize_pos_embed(sv, v.shape[0]).astype(v.dtype)
            resized += 1
        else:
            skipped += 1
    return _unflatten(flat), {"loaded": loaded, "skipped": skipped, "resized": resized}


def load_pretrained_params(path: str, model) -> dict:
    """Partial init of ``model``'s parameters from a checkpoint's
    ``params`` (its BatchNorm statistics stay as they are, as in the JAX
    engine's ``pretrained_weight`` path).  Returns the counts."""
    variables = to_variables(model)
    params, info = partial_restore(_msgpack.load(path)["params"], variables["params"])
    load_variables(model, {"params": params, "batch_stats": variables["batch_stats"]})
    return info


def load_pretrained_variables(path: str, model) -> dict:
    """Partial init of the parameters and the BatchNorm statistics."""
    payload, variables = _msgpack.load(path), to_variables(model)
    params, info = partial_restore(payload["params"], variables["params"])
    stats = variables["batch_stats"]
    if payload.get("batch_stats"):
        stats, sinfo = partial_restore(payload["batch_stats"], stats)
        info = dict(info, stats_loaded=sinfo["loaded"], stats_skipped=sinfo["skipped"])
    load_variables(model, {"params": params, "batch_stats": stats})
    return info


def resize_pos_embed(table: np.ndarray, new_len: int) -> np.ndarray:
    """A flat (N+1, D) learned position table (class row 0) resized to
    ``new_len`` rows: ``jax.image.resize(..., "linear")`` over the
    sequence axis (a triangle kernel, widened when shrinking), in float32."""
    cls, grid = table[:1], np.asarray(table[1:], np.float32)
    n_in, n_out = grid.shape[0], new_len - 1
    inv_scale = np.float32(1.0) / np.float32(n_out / n_in)   # as JAX forms it
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(0.0, 1.0 - x / max(inv_scale, 1.0)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return np.concatenate([cls, np.einsum("nd,nm->md", grid, w).astype(np.float32)], axis=0)


class BestCheckpointKeeper:
    """``best_bleu.msgpack`` and ``best_accuracy.msgpack`` when the metric
    improves, ``last_checkpoint.msgpack`` at every validation."""

    def __init__(self, log_dir: str, write: bool = True):
        """``write=False`` (a mesh's ranks but 0): the same decisions,
        no files."""
        self.log_dir, self.write = log_dir, write
        self.best = {"bleu": -1.0, "accuracy": -1.0, "ED": -1.0, "word_ED": -1.0}
        if write:
            os.makedirs(log_dir, exist_ok=True)

    def seed_best(self, meta: Mapping[str, Any]) -> None:
        """The best-metric gates from a resumed checkpoint's sidecar, so the
        first validation after a resume cannot overwrite a better file."""
        for meta_key, key in (("best_bleu", "bleu"), ("best_acc", "accuracy"),
                              ("best_ED", "ED"), ("best_word_ED", "word_ED")):
            if meta_key in meta:
                self.best[key] = max(self.best[key], float(meta[meta_key]))

    def _extra(self, iteration: int) -> dict:
        return {"iter": iteration, "best_bleu": self.best["bleu"],
                "best_acc": self.best["accuracy"], "best_ED": self.best["ED"],
                "best_word_ED": self.best["word_ED"]}

    def update(self, state: TrainState, iteration: int, metrics: Mapping[str, float]
               ) -> list[str]:
        """Save the improved best files and the last one; returns their names."""
        saved = []
        for key, fname in (("bleu", "best_bleu.msgpack"), ("accuracy", "best_accuracy.msgpack")):
            v = float(metrics.get(key, -1.0))
            if v > self.best[key]:
                self.best[key] = v
                for mkey in ("ED", "word_ED"):
                    if mkey in metrics:
                        self.best[mkey] = max(self.best[mkey], float(metrics[mkey]))
                self._save(fname, state, iteration)
                saved.append(fname)
        self._save("last_checkpoint.msgpack", state, iteration)
        saved.append("last_checkpoint.msgpack")
        return saved

    def _save(self, fname: str, state: TrainState, iteration: int) -> None:
        if self.write:
            save_checkpoint(os.path.join(self.log_dir, fname), state, self._extra(iteration))
