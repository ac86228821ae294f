"""Where the time of one train step goes, on a CUDA card.

    python -m doc2tex_tpu_torch.tools.profile_train [--config config/train_hard_tfm_big.yaml]
        [--soak] [--batch 32] [--bucket 224 704] [--steps 5] [--dtype bfloat16]
        [--out result.json]

Builds the recipe's model and optimizer (``engine.training.init_training``,
a seeded random init; ``--soak``: the coverage-LSTM recipe of the shipped
``synthetic`` release, ``tools/structured_soak.py --hard``, in place of
``--config``), makes one batch of ``--batch`` hard synthetic crops
padded into ``--bucket`` with labels at the recipe's ``batch_max_length``,
takes 3 steps to warm up, ``--steps`` timed steps (host clock around
synchronised steps), then ``--steps`` steps under ``torch.profiler``.
Prints and writes: ms a step, steps/s, peak memory allocated, the device's
busy time a step (sum of kernel times; one stream) and idle share, the
device time of the step's parts (``train/forward``, ``train/backward``,
``train/optimizer``: the kernels each launched; the backward is the rest)
and their host time, the kernels' device time by kind (the hand-written
B1, B2 and B2's backward apart), their launches a step, and the kernels
that took the most.  Needs a card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from ..config import load_config
from ..data.buckets import pad_to_bucket
from ..data.synthetic import synth_hard_dataset
from ..data.synthetic import hard_vocab
from ..engine.training import init_training
from ..ops import attention_step, decode_attention
from . import structured_soak
from .profile_slice import _device_us

RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "config", "train_hard_tfm_big.yaml")
PARTS = ("train/forward", "train/backward", "train/optimizer")
# kernel kinds, by the first pattern a kernel's name matches
KINDS = (("B2 backward (hand-written)", r"b2_bwd_"),
         ("B2 (hand-written)", r"attention_step_kernel"),
         ("B1 (hand-written)", r"decode_attention"),
         ("convolution", r"conv|cudnn|implicit|wgrad|dgrad|fprop|winograd"),
         ("matmul", r"gemm|cutlass|sm90_xmma|ampere_|cublas"),
         ("optimizer (foreach)", r"multi_tensor|foreach"),
         ("reduction", r"reduce|Reduce|norm|softmax|Softmax"),
         ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"))


def _kind(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


def soak_config(dtype: str) -> dict:
    """The shipped ``synthetic`` release's recipe: the soak twin's --hard arm."""
    cfg = structured_soak.arm_config(structured_soak.parse_args(["--hard"]))
    cfg.update(dtype=dtype, character=hard_vocab(),
               synthetic_kwargs=dict(structured_soak.HARD_KW))
    return cfg


def _launches() -> dict:
    return {"decode_attention": decode_attention.decode_attention.launches,
            "attention_step": attention_step.coverage_attention_step.launches,
            "attention_step_content": attention_step.content_attention_step.launches,
            "attention_step_backward": attention_step.coverage_attention_step_backward.launches,
            "attention_step_backward_content":
                attention_step.content_attention_step_backward.launches}


def profile(config: str, batch: int, bucket: tuple, steps: int, dtype: str,
            soak: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = soak_config(dtype) if soak else load_config(config, dtype=dtype)
    b = init_training(cfg, device="cuda")
    kw = dict(cfg.get("synthetic_kwargs") or {})
    kw.update(max_h=min(kw.get("max_h", bucket[0]), bucket[0]),
              max_w=min(kw.get("max_w", bucket[1]), bucket[1]))
    crops, labels = synth_hard_dataset(batch, seed=90, **kw)
    images = np.stack([pad_to_bucket(c, bucket) for c in crops])[..., None]
    text, _ = b.converter.encode([lb.split() for lb in labels], cfg["batch_max_length"])
    gen = torch.Generator().manual_seed(7)
    for _ in range(3):
        b.train_step(b.state, images, text, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _launches()
    t = time.perf_counter()
    for _ in range(steps):
        b.train_step(b.state, images, text, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / steps
    peak = torch.cuda.max_memory_allocated()
    launches = {k: (v - before[k]) // steps for k, v in _launches().items()}

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            b.train_step(b.state, images, text, gen)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    events = prof.key_averages()
    # the ranges also appear as device-side annotations: not kernels
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in PARTS]
    busy_us = sum(_device_us(e) for e in kernels)
    # a host range's device time: the kernels its ops launched (the
    # backward's kernels are launched by autograd's own thread, outside
    # its range, so the backward is the rest of the busy time)
    parts = {}
    for e in events:
        if e.key in PARTS and e.device_type == torch.autograd.DeviceType.CPU:
            total = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            parts[e.key] = {"device_ms_per_step": total / 1e3 / steps,
                            "host_ms_per_step": e.cpu_time_total / 1e3 / steps}
    rest = busy_us / 1e3 / steps - sum(p["device_ms_per_step"] for k, p in parts.items()
                                       if k != "train/backward")
    parts.setdefault("train/backward", {})["device_ms_per_step"] = rest
    kinds: dict = {}
    for e in kernels:
        k = kinds.setdefault(_kind(e.key), {"device_ms_per_step": 0.0, "launches_per_step": 0})
        k["device_ms_per_step"] += _device_us(e) / 1e3 / steps
        k["launches_per_step"] += e.count // steps
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "config": "structured_soak --hard" if soak else config,
        "hand_written_launches_per_step": launches,
        "dtype": dtype, "batch": batch, "bucket": list(bucket), "text_width": text.shape[1],
        "steps": steps, "step_ms": step_s * 1e3, "steps_per_s": 1.0 / step_s,
        "peak_allocated_gib": peak / 2 ** 30,
        "profiled_step_ms": prof_wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
        "parts": parts, "kinds": kinds,
        "top_kernels": [{"name": e.key[:120], "device_ms_per_step": _device_us(e) / 1e3 / steps,
                         "launches_per_step": e.count // steps} for e in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=RECIPE)
    ap.add_argument("--soak", action="store_true",
                    help="the synthetic release's recipe (structured_soak --hard) instead")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--bucket", type=int, nargs=2, default=[224, 704])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = profile(args.config, args.batch, tuple(args.bucket), args.steps, args.dtype,
                     args.soak)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
