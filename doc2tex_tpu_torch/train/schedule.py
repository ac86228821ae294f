"""Learning-rate schedule: linear warmup, then a half-cycle cosine
(counterpart of ``doc2tex_tpu.train.schedule``).

The schedule is a function of the optimizer's update count, in "epochs"
of ``valInterval`` updates, computed in float32 with the JAX function's
order of operations; it returns the float32 value as a Python float.
"""

from __future__ import annotations

import math

import numpy as np

_F = np.float32


def warmup_cosine_schedule(base_lr: float, min_lr: float, warmup_epochs: float,
                           total_epochs: float, steps_per_epoch: int):
    """f(count) -> lr.  Clamped at the horizon: past ``total_epochs`` the
    rate holds at ``min_lr`` instead of the raw cosine's rise."""
    warm_den = _F(max(warmup_epochs, 1e-8))
    cos_den = _F(max(total_epochs - warmup_epochs, 1e-8))
    scale = _F((base_lr - min_lr) * 0.5)

    def schedule(count: int) -> float:
        epoch = min(_F(count) / _F(steps_per_epoch), _F(total_epochs))
        if epoch < _F(warmup_epochs):
            return float(_F(base_lr) * epoch / warm_den)
        cos = _F(math.cos(_F(math.pi) * (epoch - _F(warmup_epochs)) / cos_den))
        return float(_F(min_lr) + scale * (_F(1.0) + cos))

    return schedule


def schedule_from_config(config):
    """The config's schedule: ``total_epochs = (num_iter // accum_grad) //
    valInterval``, held at 1 at least (0 would pin the rate at 0 for the
    whole run), and the warmup cut to 0.9 of the horizon."""
    total_epochs = max((config["num_iter"] // config.get("accum_grad", 1))
                       // config["valInterval"], 1)
    warmup = min(float(config["warmup_epochs"]), 0.9 * total_epochs)
    return warmup_cosine_schedule(config["optimizer"]["lr"], config["min_lr"], warmup,
                                  total_epochs, config["valInterval"])
