"""Per-crop math recognition (counterpart of
``doc2tex_tpu.recognition.flow``).

Crops are preprocessed (grey, CLAHE where the version block leaves it on,
the resize), grouped into the bucket ladder the weights were
trained in (``bucket_growth`` of the model's version block), optionally
coalesced into containing buckets, batched on a {1, 8, 64, ...} ladder and
decoded on the device; tokens are cut at [s], joined and postprocessed.

With a mesh (``parallel.mesh``, single controller) rank 0 calls the
recognizer: each batch, its size rounded up to the data axis with copies of
row 0, is broadcast and every rank decodes its rows; the other ranks build
the same ``MathRecognition`` and run ``mesh.follow()``.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import load_yaml, make_config
from ..data.buckets import make_ladder, pad_to_bucket
from ..decode.runner import make_decode_fn
from ..latex.postprocess import postprocess_prediction
from ..models import build_model
from ..ops.quant import parts_for_mode
from ..tokenizer.converters import create_converter
from ..transforms.preprocess import clahe, minmax_size, resize_for_inference
from ..weights import load_weights

__all__ = ["MathRecognition", "load_recog_config", "coalesce_groups",
           "postprocess_prediction"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_RECOG_CFG = os.path.join(_ROOT, "demo", "recog_cfg.yaml")


def coalesce_groups(groups: dict, ratio: float) -> dict:
    """Merge per-bucket index groups into CONTAINING buckets, largest
    first: a group joins the smallest already-kept bucket that contains it
    and whose area is <= ``ratio`` x its own.  ``ratio <= 1`` is the
    identity."""
    if ratio <= 1.0 or len(groups) < 2:
        return groups
    order = sorted(groups, key=lambda b: (b[0] * b[1], b), reverse=True)
    merged: dict = {}
    for b in order:
        area = b[0] * b[1]
        cands = [
            t for t in merged
            if t[0] >= b[0] and t[1] >= b[1] and t[0] * t[1] <= ratio * area
        ]
        if cands:
            t = min(cands, key=lambda t: (t[0] * t[1], t))
            merged[t].extend(groups[b])
        else:
            merged[b] = list(groups[b])
    return merged


def _snap_batch(n: int, cap: int = 64) -> int:
    """Snap the batch axis to {1, 8, cap, 2*cap, ...} (padding rows repeat
    row 0 and are dropped from the outputs)."""
    if n >= cap:
        return -(-n // cap) * cap
    return 1 if n == 1 else 8 if n <= 8 else cap


def load_recog_config(path: Optional[str] = None, version: str = "version2"):
    """``(config, weights_path)`` from a recognizer YAML: the ``common``
    block updated by the ``version`` block (a flat file skips the merge).
    Relative vocab/weight paths resolve against the repository root; a
    missing weights file gives None with a warning."""
    raw = load_yaml(path or DEFAULT_RECOG_CFG)
    if "common" not in raw:
        merged = dict(raw)
    else:
        if version not in raw:
            raise KeyError(f"unknown model version {version!r}; have "
                           f"{sorted(k for k in raw if k != 'common')}")
        merged = dict(raw["common"])
        merged.update(raw[version])
    vocab = merged.get("vocab")
    if vocab and not os.path.isabs(vocab):
        merged["vocab"] = os.path.join(_ROOT, vocab)
    weights = merged.pop("weight_path", None)
    if weights and not os.path.isabs(weights):
        weights = os.path.join(_ROOT, weights)
    if weights and not os.path.exists(weights):
        logging.getLogger(__name__).warning(
            "recog weights %s not found; using random init", weights)
        weights = None
    return make_config(merged), weights


class MathRecognition:
    """Crop images -> LaTeX strings, decoded on ``device``."""

    def __init__(
        self,
        config=None,
        weights_path: Optional[str] = None,
        beam_size: Optional[int] = None,
        seed: int = 0,
        use_clahe: Optional[bool] = None,
        device="cuda",
        coalesce_ratio: Optional[float] = None,
        mesh=None,
    ):
        """``seed`` seeds the random init used when ``weights_path`` is
        None.  ``use_clahe`` overrides the config's ``clahe`` (on unless the
        block turns it off, as the releases trained without it do): CLAHE
        (clip 2, a 2x2 grid) before the resize, as the reference's demo
        recognizer applies it.  ``quantize`` in the config is ``int8`` (the
        encoder's gated products in int8, as every release ships),
        ``int8_full`` (also the decode attention memory in int8) or None;
        ``model.set_quantize`` takes an explicit parts tuple too.
        ``coalesce_ratio`` overrides the config's.  ``mesh``: decode every
        batch sharded over the mesh's data axis (see the module's
        docstring); the strings are the single-device ones."""
        if config is None:
            raise ValueError("MathRecognition needs a config (see load_recog_config)")
        self.config = config
        self.device = device
        self.use_clahe = bool(self.config.get("clahe", True) if use_clahe is None else use_clahe)
        parts_for_mode(self.config.get("quantize"))  # refuses an unknown mode, early
        self.coalesce_ratio = float(
            coalesce_ratio if coalesce_ratio is not None
            else self.config.get("coalesce_ratio", 0.0) or 0.0)
        self.converter = create_converter(self.config)
        self.config["num_class"] = self.converter.num_classes
        with torch.random.fork_rng(devices=[]):  # seeds the init without touching the caller's RNG
            torch.manual_seed(seed)
            self.model = build_model(self.config, self.converter.num_classes)
        if weights_path:
            load_weights(self.model, weights_path)
        self.model.to(device).eval()
        if self.model.quant_parts:
            layers = self.model.int8_layers
            print(f"MathRecognition: quantize {self.config['quantize']} (parts "
                  f"{', '.join(self.model.quant_parts)}): {len(layers)} int8 layers: "
                  f"{', '.join(layers) or 'none'}", file=sys.stderr, flush=True)
        self.beam_size = (beam_size if beam_size is not None
                          else int(self.config.get("beam_size", 1)))
        self.table = make_ladder(
            self.config["min_dimension"], self.config["max_dimension"],
            self.config.get("scale_factor", 32),
            growth=float(self.config.get("bucket_growth", 1.5)))
        self.mesh = mesh
        self._decode = make_decode_fn(self.model, self.config, beam_size=self.beam_size,
                                      device=device, mesh=mesh)
        if mesh is not None:
            self._decode = mesh.register("MathRecognition", self._decode)

    def bucket_key(self, image: np.ndarray):
        """The bucket this crop decodes in — shape arithmetic only."""
        h, w = image.shape[:2]
        cfg = self.config
        ds = cfg.get("downsample", 1) or 1
        if ds > 1 and h / ds >= cfg["min_dimension"][0] and w / ds >= cfg["min_dimension"][1]:
            h, w = int(h / ds), int(w / ds)
        h, w = minmax_size(h, w, tuple(cfg["max_dimension"]), tuple(cfg["min_dimension"]))
        sf = cfg.get("scale_factor", 32)
        h, w = -(-h // sf) * sf, -(-w // sf) * sf
        bucket = self.table.lookup(h, w)
        return bucket if bucket is not None else self.table.shapes[-1]

    def _preprocess(self, image: np.ndarray) -> np.ndarray:
        if image.ndim == 3:
            image = np.round(image.astype(np.float32).mean(axis=-1)).astype(np.uint8)
        if self.use_clahe:
            image = clahe(image, clip_limit=2.0, grid=(2, 2))
        return resize_for_inference(image, self.config)

    @staticmethod
    def make_batch(prepped: Sequence[np.ndarray], bucket, multiple: int = 1) -> np.ndarray:
        """Preprocessed uint8 crops -> one (N, H, W, 1) batch padded to
        ``bucket``, the batch axis snapped to the {1, 8, 64, ...} ladder and
        rounded up to a ``multiple`` (a mesh's data axis).  The padding rows
        repeat row 0, so they leave the int8 encoder's per-tensor activation
        scale (the batch's abs-max) unchanged."""
        batch = np.stack([pad_to_bucket(img, bucket) for img in prepped])[..., None]
        n = batch.shape[0]
        padded_n = -(-_snap_batch(n) // multiple) * multiple
        if padded_n != n:
            batch = np.concatenate([batch, np.repeat(batch[:1], padded_n - n, axis=0)])
        return batch

    def decode_group(self, prepped: Sequence[np.ndarray], bucket) -> list[str]:
        """Preprocessed uint8 crops -> strings, decoded as one batch (see
        ``make_batch``)."""
        n = len(prepped)
        tokens, _ = self._decode(self.make_batch(prepped, bucket,
                                                 1 if self.mesh is None else self.mesh.nd))
        sep = " " if self.config.get("token_level", "word") == "word" else ""
        return [postprocess_prediction(sep.join(self.converter.detokenize(row[None])[0]))
                for row in tokens[:n].cpu().numpy()]

    def group(self, prepped: list[np.ndarray]) -> dict:
        """{bucket: crop indices} of preprocessed crops, after coalescing.
        A crop larger than the largest bucket is cut to it in place."""
        groups: dict[tuple[int, int], list[int]] = {}
        for i, img in enumerate(prepped):
            bucket = self.table.lookup(*img.shape[:2])
            if bucket is None:
                bucket = self.table.shapes[-1]
                prepped[i] = img[: bucket[0], : bucket[1]]
            groups.setdefault(bucket, []).append(i)
        return coalesce_groups(groups, self.coalesce_ratio)

    def __call__(self, images) -> list[str] | str:
        """One crop or a list of crops -> LaTeX string(s)."""
        single = isinstance(images, np.ndarray)
        crops: Sequence[np.ndarray] = [images] if single else list(images)
        prepped = [self._preprocess(c) for c in crops]
        groups = self.group(prepped)

        results: list[str] = [""] * len(crops)
        for bucket, idxs in groups.items():
            for i, text in zip(idxs, self.decode_group([prepped[i] for i in idxs], bucket)):
                results[i] = text
        return results[0] if single else results
