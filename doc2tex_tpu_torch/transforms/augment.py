"""Input normalization and the training augmentation (counterpart of
``doc2tex_tpu.transforms.augment``).

``train_augment`` draws, per sample, whether to sharpen (probability p), a
sharpness factor in [0, sharpness), whether to shift the brightness
(probability p) and a shift in [-brightness, brightness), all from one
``torch.Generator``; ``augment`` is the pure function of the images and
those draws, so it can be held against the JAX function on the same
draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import rand


def normalize(images: torch.Tensor, mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """uint8/float (B, H, W, C) -> normalized float32."""
    x = images.to(torch.float32)
    x = torch.clamp(x, 0.0, 255.0) / 255.0
    return (x - mean) / std


def _sharpness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend with a 3x3 smoothing kernel ([[1, 1, 1], [1, 5, 1], [1, 1, 1]]
    / 13, depthwise, zero padding): x + factor * (x - blurred), clipped to
    [0, 1].  x (B, H, W, C) in [0, 1], factor (B,)."""
    C = x.shape[-1]
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                          device=x.device) / 13.0
    weight = kernel.expand(C, 1, 3, 3)
    blurred = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1, groups=C).permute(0, 2, 3, 1)
    return torch.clamp(x + factor.reshape(-1, 1, 1, 1) * (x - blurred), 0.0, 1.0)


def augment(images, apply_sharp, sharp_factor, apply_bright, delta,
            mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """The augmentation given its draws (each (B,)), then normalize."""
    x = torch.clamp(images.to(torch.float32), 0.0, 255.0) / 255.0
    x = torch.where(apply_sharp.reshape(-1, 1, 1, 1), _sharpness(x, sharp_factor), x)
    bright = torch.clamp(x + delta.reshape(-1, 1, 1, 1), 0.0, 1.0)
    x = torch.where(apply_bright.reshape(-1, 1, 1, 1), bright, x)
    return (x - mean) / std


def draw_augment(generator, batch: int, device, p: float = 0.5, brightness: float = 0.1,
                 sharpness: float = 0.5):
    """(apply_sharp, sharp_factor, apply_bright, delta) for ``batch``
    samples from ``generator`` (on ``device``)."""
    def uniform(lo, hi):
        return lo + rand((batch,), generator=generator, device=device) * (hi - lo)

    apply_sharp = rand((batch,), generator=generator, device=device) < p
    sharp_factor = uniform(0.0, sharpness)
    apply_bright = rand((batch,), generator=generator, device=device) < p
    delta = uniform(-brightness, brightness)
    return apply_sharp, sharp_factor, apply_bright, delta


def train_augment(generator, images, mean: float = 0.5, std: float = 0.5, p: float = 0.5,
                  brightness: float = 0.1, sharpness: float = 0.5) -> torch.Tensor:
    """Random sharpness and brightness, each applied with probability
    ``p`` per sample, then normalize."""
    draws = draw_augment(generator, images.shape[0], images.device, p, brightness, sharpness)
    return augment(images, *draws, mean=mean, std=std)
