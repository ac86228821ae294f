"""Device-resident sample pools: training steps that take no host input
(counterpart of ``doc2tex_tpu.data.device_pool``).

Each bucket's padded uint8 samples and encoded labels are uploaded once;
each step draws its batch indices on the device and gathers the batch
there, so the steady-state loop moves no pixels from the host.  The bucket
sequence (``pool_schedule``) is numpy's and equals the JAX package's for
the same generator.  The index draws are a ``torch.Generator``'s on the
pool's device, not ``jax.random``'s: the same seed gives other batches than
the JAX package's, so a run is held to JAX's by the pools' contents and the
schedule, not by its draws.

Usage:
    pools = build_device_pools(loader, converter, config, device="cuda")
    step = make_pool_step(train_step, batch_size)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for bucket in pool_schedule(pools, batch_size, np.random.default_rng(5)):
        loss = step(state, gen, pools[bucket].images, pools[bucket].text)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DevicePool(NamedTuple):
    bucket: tuple[int, int]
    images: torch.Tensor  # (N, H, W, 1) uint8 on the device
    text: torch.Tensor    # (N, L) int32 on the device
    n: int


def build_device_pools(loader, converter, config, min_samples=None, device="cuda"
                       ) -> list[DevicePool]:
    """Every bucket's padded samples, uploaded to ``device`` once.

    ``loader``: a ``BucketLoader`` (its clusters and per-sample preparation).
    Buckets with fewer than ``min_samples`` (default: the batch size)
    samples are skipped.  The host's geometric augmentation is not applied
    (the pixels are fixed on the device); the train step's augmentation
    still runs."""
    min_samples = min_samples or config["batch_size"]
    pools: list[DevicePool] = []
    for bucket, idxs in sorted(loader.clusters.items()):
        if len(idxs) < min_samples:
            continue
        images = np.stack([loader._prepare_one(i, bucket, None) for i in idxs])[..., None]
        text, _ = converter.encode([loader._tokens(loader.dataset.label(i)) for i in idxs],
                                   config["batch_max_length"])
        pools.append(DevicePool(bucket, torch.from_numpy(images).to(device),
                                torch.from_numpy(np.asarray(text, np.int32)).to(device),
                                len(idxs)))
    return pools


def make_pool_step(train_step, batch_size: int):
    """Wrap a ``step(state, images, text, generator) -> metrics`` train step
    so that batches come from a pool: ``fn(state, generator, images_pool,
    text_pool) -> loss`` (a 0-d device tensor).  ``generator`` lives on the
    pools' device; it draws the indices, and its seed seeds the step's own
    random streams (``train.trainer.step_generator``)."""

    def pool_step(state, generator: torch.Generator, images_pool, text_pool):
        idx = torch.randint(0, images_pool.shape[0], (batch_size,), generator=generator,
                            device=images_pool.device)
        return train_step(state, images_pool[idx], text_pool[idx], generator)["loss"]

    return pool_step


def pool_schedule(pools, batch_size: int, rng: np.random.Generator):
    """Endless bucket-index schedule proportional to pool sizes."""
    base = np.concatenate([np.full(max(p.n // batch_size, 1), i) for i, p in enumerate(pools)])
    while True:
        rng.shuffle(base)
        yield from base
