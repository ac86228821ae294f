"""Where the time of the port's main path goes, on a CUDA card.

    python -m doc2tex_tpu_torch.tools.profile_slice [--version synthetic_tfm_big]
        [--crops 16] [--beam 10] [--dtype bfloat16] [--quantize int8|int8_full|int8_kv]
        [--against OTHER_CHECKOUT] [--out result.json]
    python -m doc2tex_tpu_torch.tools.profile_slice --zoo zoo_vgg_bahdanau [--crops 8] ...

Runs MathRecognition with the released weights of ``--version``
(``synthetic_tfm_big``, ``synthetic_tfm`` or ``synthetic_long``, the TFM
head, or ``synthetic``, the coverage-LSTM head; ``--quantize int8`` as the
releases ship, ``int8_full`` with the decode memory in int8 too, and
``int8_kv`` the parts encoder, decoder_mem and decoder_kv, the TFM head's
self-attention caches in int8 as well; unquantized by default) on seeded
synthetic crops (the first
``--crops`` seeds whose crop needs no resize, as ``chip_smoke.py`` uses;
for ``synthetic_long`` the long generator's seeds 0, 1, ..., its golden
crops), once to warm up, once timed,
and once under ``torch.profiler``.  Prints and writes: wall time, crops/s,
the device's busy time (sum of kernel times; one stream) and idle share,
the encoder's time on the batches the main path builds (mean of 20
passes), the head's hand-written kernel's device time and launches (and
those of its int8 form, which reads decode memory in int8), and the
kernels that took the most device time (as JSON, also to ``--out`` when
given).  ``--zoo BLOCK`` profiles a block of ``tests/torch_port_zoo.yaml``
instead (no weights ship: every leaf drawn from numpy's seed 0, as
``chip_smoke.py``'s zoo phase draws them).  ``--against`` then profiles the
same call with another checkout's head kernel in place of this one's (B1's
``decode_attention``, or B2's coverage or content step for the LSTM head;
loaded into this process as the bench tools' ``--against`` loads it;
everything else this checkout's), in the order other, this, this, other,
under ``"against"``.  Needs a card; fails without one.
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

from ..data.synthetic import seeded_crops, synth_long_sample
from ..ops.attention_step import content_attention_step, coverage_attention_step
from ..ops.decode_attention import decode_attention
from ..ops.quant import NAMED_PARTS
from ..recognition import MathRecognition, load_recog_config
from ..transforms.augment import normalize


ENCODE_REPS = 20  # the encoder's time is the mean of this many passes over the batches
ZOO_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "torch_port_zoo.yaml")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time")


def profiled_call(rec, crops, kernel_name):
    """One call under torch.profiler: (wall seconds, device events, the
    kernel's device µs, its int8 forms' device µs (the instances whose K/V
    or memory type is int8))."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        rec(crops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(_device_us(e) for e in kernels if kernel_name in e.key)
    # int8_t is "signed char" in the instance's name ("unsigned char" is the mask's)
    int8_us = sum(_device_us(e) for e in kernels
                  if kernel_name in e.key and re.search(r"(?<!un)signed char", e.key))
    return wall, kernels, kernel_us, int8_us


def against(rec, crops, checkout: str) -> list:
    """The call profiled with ``checkout``'s head kernel and with this
    one's (B1's ``decode_attention`` for the TFM head; B2's coverage or
    content step for the LSTM head), in the order other, this, this,
    other: wall of an unprofiled call, device busy, the kernel's device
    time and launches, of them its int8 form's."""
    if rec.model.head == "TFM":
        from ..models import decoder_tfm as module
        from .bench_decode_attention import load_other

        name, kernel_name = "decode_attention", "decode_attention"
    else:
        from ..models import decoder_lstm as module
        from .bench_attention_step import load_other

        content = getattr(rec.model.predicter, "attn_type", None) == "bahdanau"
        name = "content_attention_step" if content else "coverage_attention_step"
        kernel_name = "attention_step"
    theirs, mine = getattr(load_other(checkout), name), getattr(module, name)
    rows = []
    for tree, fn in (("other", theirs), ("this", mine), ("this", mine), ("other", theirs)):
        setattr(module, name, fn)
        try:
            rec(crops)
            torch.cuda.synchronize()
            fn.launches = fn.int8_launches = 0
            t = time.perf_counter()
            rec(crops)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches, int8_launches = fn.launches + fn.int8_launches, fn.int8_launches
            prof_wall, kernels, kernel_us, int8_us = profiled_call(rec, crops, kernel_name)
        finally:
            setattr(module, name, mine)
        rows.append({"tree": tree, "wall_s": wall, "profiled_wall_s": prof_wall,
                     "device_busy_s": sum(_device_us(e) for e in kernels) / 1e6,
                     "kernel_launches": launches, "kernel_device_s": kernel_us / 1e6,
                     "kernel_int8_launches": int8_launches, "kernel_int8_device_s": int8_us / 1e6})
    return rows


def profile(version: str, n_crops: int, beam: int, dtype: str, quantize=None,
            other: str | None = None, zoo: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if zoo:
        from ..weights import load_variables, random_variables, to_variables

        cfg, weights = load_recog_config(ZOO_CONFIG, version=zoo)
        version = zoo
    else:
        cfg, weights = load_recog_config(version=version)
    cfg["dtype"] = dtype
    cfg["quantize"] = "int8_full" if quantize in NAMED_PARTS else quantize
    rec = MathRecognition(cfg, weights, beam_size=beam, device="cuda")
    if zoo:
        load_variables(rec.model, random_variables(to_variables(rec.model),
                                                   np.random.default_rng(0)))
        rec.model.to("cuda")
    if quantize in NAMED_PARTS:
        rec.model.set_quantize(NAMED_PARTS[quantize])
    if version == "synthetic_long":     # its 448x960 regime: the long generator's seeds 0, 1, ...
        crops = [synth_long_sample(np.random.default_rng(s))[0] for s in range(n_crops)]
    else:
        crops = [img for _, img, _ in seeded_crops(n_crops)]
    rec(crops)
    torch.cuda.synchronize()

    tfm = rec.model.head == "TFM"
    # the LSTM head's kernel: B2 in its coverage form, or its content form
    # for the bahdanau head (one launch a step)
    content = getattr(rec.model.predicter, "attn_type", None) == "bahdanau"
    kernel, kernel_name = ((decode_attention, "decode_attention") if tfm
                           else (content_attention_step if content else coverage_attention_step,
                                 "attention_step"))
    kernel.launches = kernel.int8_launches = 0
    t = time.perf_counter()
    rec(crops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    int8_launches = kernel.int8_launches
    launches = kernel.launches + int8_launches
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

    prof_wall, kernels, kernel_us, int8_us = profiled_call(rec, crops, kernel_name)
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "version": version, "dtype": dtype, "quantize": quantize, "beam": beam,
        "crops": n_crops,
        "batches": [{"bucket": list(b), "crops": len(idxs), "rows": int(x.shape[0])}
                    for (b, idxs), x in zip(groups.items(), batches)],
        "wall_s": wall, "crops_per_s": n_crops / wall, "kernel": kernel_name,
        "kernel_launches": launches, "decode_steps": steps, "encode_s": encode_s,
        "profiled_wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
        "kernel_device_s": kernel_us / 1e6,
        "kernel_int8_launches": int8_launches, "kernel_int8_device_s": int8_us / 1e6,
        "top_kernels": [{"name": e.key[:120], "device_s": _device_us(e) / 1e6,
                         "count": e.count} for e in top],
        "against": against(rec, crops, other) if other else None,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", default="synthetic_tfm_big",
                    choices=["synthetic_tfm_big", "synthetic", "synthetic_tfm",
                             "synthetic_long"])
    ap.add_argument("--crops", type=int, default=16)
    ap.add_argument("--beam", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--quantize", default=None, choices=["int8", "int8_full", "int8_kv"])
    ap.add_argument("--zoo", default=None, metavar="BLOCK",
                    help="a block of tests/torch_port_zoo.yaml (numpy-drawn weights)")
    ap.add_argument("--against", default=None, metavar="OTHER_CHECKOUT")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = profile(args.version, args.crops, args.beam, args.dtype, args.quantize,
                     args.against, args.zoo)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
