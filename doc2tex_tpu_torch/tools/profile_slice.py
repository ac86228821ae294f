"""Where the time of the port's main path goes, on a CUDA card.

    python -m doc2tex_tpu_torch.tools.profile_slice [--version synthetic_tfm_big]
        [--crops 16] [--beam 10] [--dtype bfloat16] [--out result.json]

Runs MathRecognition with the released weights of ``--version``
(``synthetic_tfm_big``, the TFM head, or ``synthetic``, the coverage-LSTM
head) on seeded synthetic crops (the first ``--crops`` seeds whose crop
needs no resize, as ``chip_smoke.py`` uses), once to warm up, once timed,
and once under ``torch.profiler``.  Prints and writes: wall time, crops/s,
the device's busy time (sum of kernel times; one stream) and idle share,
the encoder's time on the batches the main path builds (mean of 20
passes), the head's hand-written kernel's device time and launches, and
the kernels that took the most device time (as JSON, also to ``--out``
when given).  Needs a card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..data.synthetic import seeded_crops
from ..ops.attention_step import fused_attention_step
from ..ops.decode_attention import decode_attention
from ..recognition import MathRecognition, load_recog_config
from ..transforms.augment import normalize


ENCODE_REPS = 20  # the encoder's time is the mean of this many passes over the batches


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time")


def profile(version: str, n_crops: int, beam: int, dtype: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, weights = load_recog_config(version=version)
    cfg["dtype"] = dtype
    cfg["quantize"] = None
    rec = MathRecognition(cfg, weights, beam_size=beam, device="cuda")
    crops = [img for _, img, _ in seeded_crops(n_crops)]
    rec(crops)
    torch.cuda.synchronize()

    tfm = rec.model.head == "TFM"
    kernel, kernel_name = ((decode_attention, "decode_attention") if tfm
                           else (fused_attention_step, "attention_step"))
    kernel.launches = 0
    t = time.perf_counter()
    rec(crops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernel.launches
    steps = launches // (2 * rec.model.predicter.num_layers) if tfm else launches

    # the encoder alone, on the batches the main path builds
    prepped = [rec._preprocess(c) for c in crops]
    groups = rec.group(prepped)
    batches = [normalize(torch.from_numpy(rec.make_batch([prepped[i] for i in idxs], b)).cuda())
               for b, idxs in groups.items()]
    with torch.inference_mode():
        for x in batches:
            rec.model.encode(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(ENCODE_REPS):
            for x in batches:
                rec.model.encode(x)
        torch.cuda.synchronize()
    encode_s = (time.perf_counter() - t) / ENCODE_REPS

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        rec(crops)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    kernel_us = sum(_device_us(e) for e in kernels if kernel_name in e.key)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "version": version, "dtype": dtype, "beam": beam, "crops": n_crops,
        "batches": [{"bucket": list(b), "crops": len(idxs), "rows": int(x.shape[0])}
                    for (b, idxs), x in zip(groups.items(), batches)],
        "wall_s": wall, "crops_per_s": n_crops / wall, "kernel": kernel_name,
        "kernel_launches": launches, "decode_steps": steps, "encode_s": encode_s,
        "profiled_wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
        "kernel_device_s": kernel_us / 1e6,
        "top_kernels": [{"name": e.key[:120], "device_s": _device_us(e) / 1e6,
                         "count": e.count} for e in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", default="synthetic_tfm_big",
                    choices=["synthetic_tfm_big", "synthetic"])
    ap.add_argument("--crops", type=int, default=16)
    ap.add_argument("--beam", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = profile(args.version, args.crops, args.beam, args.dtype)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
