"""Input normalization (the eval path of ``doc2tex_tpu.transforms.augment``)."""

from __future__ import annotations

import torch


def normalize(images: torch.Tensor, mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """uint8/float (B, H, W, C) -> normalized float32."""
    x = images.to(torch.float32)
    x = torch.clamp(x, 0.0, 255.0) / 255.0
    return (x - mean) / std
