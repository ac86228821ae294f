"""Host-side eval batches (the eval side of ``doc2tex_tpu.data.loader``):
dataset -> length filter -> bucket clusters -> padded uint8 batches.

The bucket plan, the batch order, the trimming of each cluster to whole
batches (``keep_smaller_batches``) and the white (255) padding are the JAX
package's, so an eval sees the same batches.  That matters for int8: the
activation scale is taken over a whole batch, so another batching is
another int8 function.  Training-only parts (augmentation, pad jitter,
over-padding promotion, shuffles, prefetch threads) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

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


@dataclass
class Batch:
    bucket: tuple[int, int]
    images: np.ndarray    # (B, H, W, 1) uint8
    labels: list[str]
    names: list[str]


class BucketLoader:
    """Eval batches of ``dataset`` in the JAX package's deterministic order
    (``BucketLoader(train=False)``)."""

    def __init__(self, dataset, config):
        self.dataset = dataset
        self.config = config
        self.batch_max_length = config["batch_max_length"]
        self.token_level = config.get("token_level", "word")
        # samples with more tokens than the decode can emit are dropped
        kept = [i for i in range(len(dataset))
                if len(self._tokens(dataset.label(i))) <= self.batch_max_length]
        self.table, clusters, excluded = plan_buckets([dataset.size(i) for i in kept], config)
        self.clusters = {b: [kept[j] for j in js] for b, js in clusters.items()}
        self.excluded = [kept[j] for j in excluded]
        self.num_samples = sum(len(v) for v in self.clusters.values())

    def _tokens(self, label: str) -> list[str]:
        return label.split() if self.token_level == "word" else list(label)

    def _prepare_one(self, i: int, bucket) -> np.ndarray:
        img = self.dataset.image(i)
        if img.ndim == 3:
            img = np.round(img.astype(np.float32).mean(-1)).astype(np.uint8)
        if (self.config.get("downsample", 1) or 1) > 1:
            img = _resize_area(img, *get_size(img.shape[0], img.shape[1], self.config))
        h, w = min(img.shape[0], bucket[0]), min(img.shape[1], bucket[1])
        return pad_to_bucket(img[:h, :w], bucket)

    def __iter__(self) -> Iterator[Batch]:
        plan = batch_plan(self.clusters, self.config["batch_size"],
                          keep_smaller_batches=self.config.get("keep_smaller_batches", True))
        for bucket, idxs in plan:
            images = np.stack([self._prepare_one(i, bucket) for i in idxs])[..., None]
            yield Batch(bucket, images, [self.dataset.label(i) for i in idxs],
                        [self.dataset.name(i) for i in idxs])
