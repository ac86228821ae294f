"""Per-bucket step timing (counterpart of ``doc2tex_tpu.utils.profiling.
StepTimer``).

A bucket's first step is kept apart (it pays cuDNN's and cuBLAS's first
calls for that shape), later ones are averaged.  The loop times only the
steps it synchronises anyway (a bucket's first step, log boundaries), so
the timer adds no device sync of its own: ``step`` synchronises the device
at its end, the point where the JAX loop blocks on the loss.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import torch


class StepTimer:
    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self.first_s: dict = {}
        self.times: dict = defaultdict(list)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def step(self, key) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            if key not in self.first_s:
                self.first_s[key] = dt
            else:
                self.times[key].append(dt)

    def summary(self) -> dict:
        out = {}
        for key, first in self.first_s.items():
            ts = self.times.get(key, [])
            row = {"first_s": round(first, 3), "steps": len(ts)}
            if ts:
                row.update(mean_ms=round(1e3 * sum(ts) / len(ts), 2),
                           min_ms=round(1e3 * min(ts), 2))
            out[str(key)] = row
        return out
