"""Host-side batches (counterpart of ``doc2tex_tpu.data.loader``): dataset
-> length filter -> bucket clusters -> padded uint8 batches, for training
and evaluation.

The bucket plan, the batch order, the trimming of each cluster to whole
batches (``keep_smaller_batches``) and the white (255) padding are the JAX
package's, so an eval sees the same batches (that matters for int8: the
activation scale is taken over a whole batch, so another batching is
another int8 function).  A training loader (``train=True``) draws from
numpy generators seeded as the JAX package seeds them, so the same seed
gives the same batches, byte for byte: over-padding promotion (seed + 17),
the per-epoch shuffles, the per-sample geometric augmentation seeds (with
``augment``) and the pad jitter.  Two quirks are copied as they are: with
augment off the pad jitter's seed is a constant per sample (9176 + index),
and the over-padding promotion is drawn once per run.

With a ``converter`` the batches carry the encoded labels (``text``,
``lengths``), as training and the validation loss need.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from ..transforms.geometry import geometry_transform
from ..transforms.preprocess import _resize_area
from .buckets import batch_plan, get_size, pad_to_bucket, plan_buckets


class ArrayDataset:
    """In-memory dataset of (H, W) or (H, W, C) uint8 images and labels."""

    def __init__(self, images: Sequence[np.ndarray], labels: Sequence[str],
                 names: Optional[Sequence[str]] = None):
        self.images, self.labels = list(images), list(labels)
        self.names = list(names) if names else [str(i) for i in range(len(images))]

    def __len__(self) -> int:
        return len(self.images)

    def image(self, i: int) -> np.ndarray:
        return self.images[i]

    def label(self, i: int) -> str:
        return self.labels[i]

    def size(self, i: int) -> tuple[int, int]:
        return self.images[i].shape[:2]

    def name(self, i: int) -> str:
        return self.names[i]


class LmdbDataset:
    """0-based view of an LMDB store (``lmdb_reader.LmdbReader``, 1-based);
    ``size`` reads the h/w sidecar keys without decoding the image."""

    def __init__(self, root: str, rgb: bool = False):
        from .lmdb_reader import LmdbReader

        self.reader = LmdbReader(root, rgb=rgb)

    def __len__(self) -> int:
        return len(self.reader)

    def image(self, i: int) -> np.ndarray:
        return self.reader.image(i + 1)

    def label(self, i: int) -> str:
        return self.reader.label(i + 1)

    def size(self, i: int) -> tuple[int, int]:
        return self.reader.size(i + 1)

    def name(self, i: int) -> str:
        return self.reader.name(i + 1)


@dataclass
class Batch:
    bucket: tuple[int, int]
    images: np.ndarray    # (B, H, W, 1) uint8
    labels: list[str]
    names: list[str]
    text: Optional[np.ndarray] = None      # (B, L+2) int32 encoded labels
    lengths: Optional[np.ndarray] = None   # (B,) int32
    rows_of: Optional[int] = None          # a shard's rows: of a global batch this size


class BucketLoader:
    """Batches of ``dataset``: in the JAX package's deterministic order, or
    with ``train`` shuffled per epoch (``infinite`` loops the epochs), with
    the prefetch thread of the JAX loader when ``prefetch`` > 0.

    ``shard`` = (n_data, data_index) gives a data rank of a mesh its rows of
    each global batch and reads and decodes only those: the global batch is
    padded to a multiple of n_data with white images whose text leads with
    [GO] and is PAD after it (``train.trainer.pad_batch``'s rows), and
    ``Batch.rows_of`` holds its padded size.  Every rank draws the global
    batch's plan and augmentation seeds, so the ranks' rows make up the
    batch the unsharded loader yields."""

    def __init__(self, dataset, config, converter=None, train: bool = False, seed: int = 0,
                 prefetch: int = 0, shard: Optional[tuple[int, int]] = None):
        self.dataset = dataset
        self.shard = shard
        self.config = config
        self.converter = converter
        self.train = train
        self.batch_max_length = config["batch_max_length"]
        self.token_level = config.get("token_level", "word")
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        workers = config.get("workers", 0) or 0
        if workers < 0:
            workers = max((os.cpu_count() or 2) // 2, 1)
        self._pool = None
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)
        # samples with more tokens than the decode can emit are dropped
        kept = [i for i in range(len(dataset))
                if len(self._tokens(dataset.label(i))) <= self.batch_max_length]
        self.indices = kept
        self.table, clusters, excluded = plan_buckets(
            [dataset.size(i) for i in kept], config,
            overpad_rng=np.random.default_rng(seed + 17) if train else None)
        self.clusters = {b: [kept[j] for j in js] for b, js in clusters.items()}
        self.excluded = [kept[j] for j in excluded]
        self.num_samples = sum(len(v) for v in self.clusters.values())

    def _tokens(self, label: str) -> list[str]:
        return label.split() if self.token_level == "word" else list(label)

    def _prepare_one(self, i: int, bucket, aug_seed) -> np.ndarray:
        img = self.dataset.image(i)
        if img.ndim == 3:
            img = np.round(img.astype(np.float32).mean(-1)).astype(np.uint8)
        if (self.config.get("downsample", 1) or 1) > 1:
            img = _resize_area(img, *get_size(img.shape[0], img.shape[1], self.config))
        if aug_seed is not None:
            rng = np.random.default_rng(aug_seed)
            if rng.random() < 0.5:
                img = geometry_transform(img, rng)
        h, w = min(img.shape[0], bucket[0]), min(img.shape[1], bucket[1])
        # pad jitter: a random white margin at the top and left before the
        # top-left-anchored bucket pad (training only)
        jit = int(self.config.get("pad_jitter", 0) or 0) if self.train else 0
        if jit > 0:
            jr = np.random.default_rng(aug_seed if aug_seed is not None else 9176 + i)
            top = int(jr.integers(0, min(jit, bucket[0] - h) + 1))
            left = int(jr.integers(0, min(jit, bucket[1] - w) + 1))
            if top or left:
                img = np.pad(img[:h, :w], ((top, 0), (left, 0)), constant_values=255)
                h, w = img.shape[:2]
        return pad_to_bucket(img[:h, :w], bucket)

    def _assemble(self, bucket: tuple[int, int], idxs: list[int]) -> Batch:
        augment = self.train and self.config.get("augment", False)
        seeds = ([int(self.rng.integers(2 ** 31)) for _ in idxs] if augment
                 else [None] * len(idxs))
        rows_of, n_pad = None, 0
        if self.shard is not None:
            n_data, index = self.shard
            rows_of = len(idxs) + (-len(idxs) % n_data)
            per = rows_of // n_data
            lo, hi = index * per, (index + 1) * per
            n_pad = hi - max(lo, min(hi, len(idxs)))
            idxs, seeds = idxs[lo:hi], seeds[lo:hi]
        if self._pool is not None and len(idxs) > 2:
            rows = list(self._pool.map(lambda a: self._prepare_one(a[0], bucket, a[1]),
                                       zip(idxs, seeds)))
        else:
            rows = [self._prepare_one(i, bucket, s) for i, s in zip(idxs, seeds)]
        rows += [np.full(bucket, 255, np.uint8)] * n_pad
        images = np.stack(rows)[..., None]
        labels = [self.dataset.label(i) for i in idxs]
        batch = Batch(bucket, images, labels + [""] * n_pad,
                      [self.dataset.name(i) for i in idxs] + [""] * n_pad, rows_of=rows_of)
        if self.converter is not None:
            text, lengths = self.converter.encode([self._tokens(lb) for lb in labels],
                                                  self.batch_max_length)
            if n_pad:
                pad = np.zeros((n_pad, text.shape[1]), text.dtype)
                pad[:, 0] = type(self.converter).GO
                text = np.concatenate([text, pad])
                lengths = np.concatenate([lengths, np.zeros(n_pad, lengths.dtype)])
            batch.text, batch.lengths = text, lengths
        return batch

    def batches_per_epoch(self) -> int:
        bs = self.config["batch_size"]
        keep = self.config.get("keep_smaller_batches", True)
        total = 0
        for idxs in self.clusters.values():
            q, r = divmod(len(idxs), bs)
            total += q + (1 if (r and keep) else 0)
        return total

    def __iter__(self) -> Iterator[Batch]:
        plan = batch_plan(self.clusters, self.config["batch_size"],
                          keep_smaller_batches=self.config.get("keep_smaller_batches", True),
                          rng=self.rng, shuffle=self.train)
        if self.prefetch <= 0:
            for bucket, idxs in plan:
                yield self._assemble(bucket, idxs)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()

        def producer():
            try:
                for bucket, idxs in plan:
                    q.put(self._assemble(bucket, idxs))
                q.put(done)
            except BaseException as e:   # surfaced in the consumer
                q.put(e)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def infinite(self) -> Iterator[Batch]:
        """Endless batches, one shuffled epoch after another."""
        while True:
            n = 0
            for batch in self:
                n += 1
                yield batch
            if n == 0:
                raise RuntimeError(
                    f"loader produced 0 batches from {self.num_samples} samples: check "
                    "max_dimension/batch_size/keep_smaller_batches against the data")


def build_loader(config, converter, seed: int = 0, shard: Optional[tuple[int, int]] = None):
    """(train_loader, valid_loader); ``shard`` (``BucketLoader``'s) splits
    the train loader's batches over a mesh's data ranks.  ``train_data``/``valid_data`` name
    LMDB roots (``LmdbDataset``); where the path is not a folder and
    ``synthetic_data: N`` is set, the split is N samples made in memory (N
    for training, max(N // 10, 4) for validation, from ``seed`` and
    ``seed + 1``) by the ``flat``, ``structured`` or ``hard`` generator
    (``synthetic_style``)."""
    from . import synthetic

    gens = {"flat": synthetic.synth_dataset, "structured": synthetic.synth_structured_dataset,
            "hard": synthetic.synth_hard_dataset}

    def split(key: str, train: bool):
        path = config.get(key)
        if path and os.path.isdir(path):
            dataset = LmdbDataset(path, rgb=config.get("rgb", False))
        elif config.get("synthetic_data"):
            style = str(config.get("synthetic_style") or "flat")
            if style not in gens:
                raise ValueError(f"synthetic_style {style!r}: pick one of {sorted(gens)}")
            n = int(config["synthetic_data"])
            images, labels = gens[style](n if train else max(n // 10, 4),
                                         seed=seed if train else seed + 1,
                                         **dict(config.get("synthetic_kwargs") or {}))
            dataset = ArrayDataset(images, labels)
        else:
            raise FileNotFoundError(f"{key}: {path!r} not found")
        return BucketLoader(dataset, config, converter=converter, train=train, seed=seed,
                            prefetch=2, shard=shard if train else None)

    return split("train_data", True), split("valid_data", False)
