"""SSD prior (default) boxes of the math detector (a copy of
``doc2tex_tpu.detection.priors``, numpy only).

The ``math_gtdb_512`` configuration of the ScanSSD reference: 7 feature
maps, 12 priors per location (s_k, sqrt(s_k * s_k+1), then for each aspect
ratio a horizontal and a vertical box), clipped to [0, 1].  At 512 that is
12 x 5461 = 65,532 priors, index for index with ``SSD512``'s outputs.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

MATH_GTDB_512: dict[str, Any] = {
    "num_classes": 2,
    "feature_maps": [64, 32, 16, 8, 4, 2, 1],
    "min_dim": 512,
    "steps": [8, 16, 32, 64, 128, 256, 512],
    "min_sizes": [8.00, 76.8, 153.6, 230.4, 307.2, 384.0, 460.8],
    "max_sizes": [76.8, 153.6, 230.4, 307.2, 384.0, 460.8, 537.6],
    "aspect_ratios": [[2, 3, 5, 7, 10]] * 7,
    "variance": [0.1, 0.2],
    "clip": True,
    "vertical_boxes": True,
    "mbox": [12] * 7,
    "extras": [256, "S", 512, 128, "S", 256, 128, "S", 256, 128, "S", 256],
    "mean_pixel": (246, 246, 246),
}


def make_priors(cfg: dict[str, Any] = MATH_GTDB_512) -> np.ndarray:
    """(N, 4) priors in center-offset form (cx, cy, w, h), normalized."""
    image_size = cfg["min_dim"]
    out = []
    for k, f in enumerate(cfg["feature_maps"]):
        f_k = image_size / cfg["steps"][k]
        s_k = cfg["min_sizes"][k] / image_size
        s_k_prime = math.sqrt(s_k * (cfg["max_sizes"][k] / image_size))
        for i in range(f):
            for j in range(f):
                cx = (j + 0.5) / f_k
                cy = (i + 0.5) / f_k
                out.append([cx, cy, s_k, s_k])
                out.append([cx, cy, s_k_prime, s_k_prime])
                for ar in cfg["aspect_ratios"][k]:
                    r = math.sqrt(ar)
                    out.append([cx, cy, s_k * r, s_k / r])
                    if cfg["vertical_boxes"]:
                        out.append([cx, cy, s_k / r, s_k * r])
    priors = np.asarray(out, np.float32)
    if cfg["clip"]:
        priors = np.clip(priors, 0.0, 1.0)
    return priors
