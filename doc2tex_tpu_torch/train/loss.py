"""Losses: cross entropy and label smoothing with an ignore index
(counterpart of ``doc2tex_tpu.train.loss``).

Both take float32 log-probabilities whatever the logits' type, average
over the positions whose target is not ``ignore_index`` and divide by
``max(count, 1)``, so a batch of padding gives 0 and not NaN.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _masked_mean(per_position, targets, ignore_index: int):
    mask = (targets != ignore_index).float()
    return (per_position * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy_loss(logits, targets, ignore_index: int = 0):
    """Mean negative log-likelihood over the non-ignored positions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return _masked_mean(nll, targets, ignore_index)


def label_smoothing_loss(logits, targets, smoothing: float = 0.1, ignore_index: int = 0):
    """Smoothed NLL: the target gets 1 - smoothing, every other class
    smoothing / (V - 1)."""
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    true_dist = torch.where(F.one_hot(targets.long(), V).bool(),
                            torch.tensor(1.0 - smoothing), torch.tensor(smoothing / (V - 1)))
    loss = -(true_dist.to(logp.device) * logp).sum(dim=-1)
    return _masked_mean(loss, targets, ignore_index)


def create_criterion(name: str, ignore_index: int, **kwargs) -> Callable:
    """'entropy' | 'smooth'."""
    if name == "entropy":
        return lambda logits, targets: cross_entropy_loss(logits, targets, ignore_index)
    if name == "smooth":
        smoothing = kwargs.get("smoothing", 0.1)
        return lambda logits, targets: label_smoothing_loss(logits, targets, smoothing,
                                                            ignore_index)
    raise ValueError(f"unknown criterion {name!r}")
