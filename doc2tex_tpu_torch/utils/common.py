"""Host helpers of the training loop (copied from
``doc2tex_tpu.utils.common``): a running average, the elapsed-time format,
the ``summary.csv`` metric history and the ``log_train.txt`` logger."""

from __future__ import annotations

import csv
import logging
import os
import sys
from collections import OrderedDict
from typing import Mapping


class Averager:
    """Running average of a scalar."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.sum = 0.0

    def add(self, v: float, count: int = 1) -> None:
        self.sum += float(v) * count
        self.n += count

    def val(self) -> float:
        return self.sum / self.n if self.n else 0.0


def cal_elapsed_time(seconds: float) -> str:
    """'H:MM:SS'."""
    s = int(seconds)
    return f"{s // 3600}:{(s % 3600) // 60:02d}:{s % 60:02d}"


def update_summary(iteration: int, metrics: Mapping[str, float], filename: str,
                   write_header: bool = False) -> None:
    """Append one row of metric history to a CSV (header on the first)."""
    rowd = OrderedDict(iteration=iteration)
    rowd.update(metrics)
    write_header = write_header or not os.path.exists(filename)
    with open(filename, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rowd.keys()))
        if write_header:
            writer.writeheader()
        writer.writerow(rowd)


def setup_logger(log_dir: str | None, name: str = "doc2tex_tpu_torch") -> logging.Logger:
    """Console and, with ``log_dir``, an append-only ``log_train.txt``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s", datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "log_train.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
