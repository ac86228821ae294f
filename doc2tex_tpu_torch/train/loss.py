"""Losses: cross entropy and label smoothing with an ignore index
(counterpart of ``doc2tex_tpu.train.loss``).

Both take float32 log-probabilities whatever the logits' type, average
over the positions whose target is not ``ignore_index`` and divide by
``max(count, 1)``, so a batch of padding gives 0 and not NaN.  A
criterion's ``terms`` gives the numerator and the count apart, which a
data-parallel step sums over the data ranks before it divides.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _masked_terms(per_position, targets, ignore_index: int):
    mask = (targets != ignore_index).float()
    return (per_position * mask).sum(), mask.sum()


def _masked_mean(per_position, targets, ignore_index: int):
    total, count = _masked_terms(per_position, targets, ignore_index)
    return total / torch.clamp(count, min=1.0)


def _nll(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


def _smoothed_nll(logits, targets, smoothing: float):
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    true_dist = torch.where(F.one_hot(targets.long(), V).bool(),
                            torch.tensor(1.0 - smoothing), torch.tensor(smoothing / (V - 1)))
    return -(true_dist.to(logp.device) * logp).sum(dim=-1)


def cross_entropy_loss(logits, targets, ignore_index: int = 0):
    """Mean negative log-likelihood over the non-ignored positions."""
    return _masked_mean(_nll(logits, targets), targets, ignore_index)


def label_smoothing_loss(logits, targets, smoothing: float = 0.1, ignore_index: int = 0):
    """Smoothed NLL: the target gets 1 - smoothing, every other class
    smoothing / (V - 1)."""
    return _masked_mean(_smoothed_nll(logits, targets, smoothing), targets, ignore_index)


class Criterion:
    """``criterion(logits, targets)``: the masked mean;
    ``criterion.terms(logits, targets)``: (its numerator, its count)."""

    def __init__(self, per_position: Callable, ignore_index: int):
        self.per_position, self.ignore_index = per_position, ignore_index

    def __call__(self, logits, targets):
        return _masked_mean(self.per_position(logits, targets), targets, self.ignore_index)

    def terms(self, logits, targets):
        return _masked_terms(self.per_position(logits, targets), targets, self.ignore_index)


def create_criterion(name: str, ignore_index: int, **kwargs) -> Criterion:
    """'entropy' | 'smooth'."""
    if name == "entropy":
        return Criterion(_nll, ignore_index)
    if name == "smooth":
        smoothing = kwargs.get("smoothing", 0.1)
        return Criterion(lambda logits, targets: _smoothed_nll(logits, targets, smoothing),
                         ignore_index)
    raise ValueError(f"unknown criterion {name!r}")
