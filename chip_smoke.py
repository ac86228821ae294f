#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``doc2tex_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one.  Phases, one line each:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds the beam decode attention kernel (seconds taken);
3. kernel  — the kernel against its plain PyTorch version on the card, at
   the decode shapes of the release model (self-attention with a random
   beam-ancestry mask, cross-attention over 623 memory tokens), in float32
   and bfloat16; then times at the release shape (batch 64, beam 10, step
   151) beside the plain version, F.scaled_dot_product_attention (a
   yardstick only; the port never calls it) and the bytes bound;
4. slice   — MathRecognition with the released ``synthetic_tfm_big``
   weights, beam 10, on 16 seeded synthetic crops: float32 (the strings
   must equal the JAX package's golden strings on >= 15 of 16) and
   bfloat16, the release compute type (agreement printed, not gated).  The
   kernel's launch count must rise in each run.

Then a JSON line with the kernel's numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the traceback
is printed and the exit code is 1.  A hang is cut by faulthandler.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback

TIME_LIMIT_S = 1100
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "torch_port_golden.json")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor rate
KERNEL_SOURCE = "doc2tex_tpu_torch/csrc/decode_attention.cu"
KERNEL_REPLACES = "doc2tex_tpu/ops/decode_attention.py:104"
# stated tolerances of kernel vs plain version (abs + rel * |plain|)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 0.0)}
MIN_GOLDEN_MATCH = 15


def log(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase} {time.perf_counter() - t0:7.2f}s] {msg}", flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return out.stdout.strip() or f"unavailable (rc {out.returncode}: {out.stderr.strip()})"


def cuda_time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_inputs(B, K, M, nh, hd, dtype, device, masked, seed, last_step=False):
    """Random q/k/v and, if ``masked``, a random beam-ancestry mask over
    M = T*K flat positions: each hypothesis's prefix picks one slot per
    position up to the current step, and its own slot at that step.  The
    current step is random per sample, or T-1 with ``last_step``."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn(B, K, nh, hd, generator=g) / hd ** 0.5).to(device, dtype)
    k = torch.randn(B, M, nh, hd, generator=g).to(device, dtype)
    v = torch.randn(B, M, nh, hd, generator=g).to(device, dtype)
    mask = None
    if masked:
        T = M // K
        slot = torch.randint(0, K, (B, K, T), generator=g)
        t_cur = (torch.full((B,), T - 1) if last_step
                 else torch.randint(0, T, (B,), generator=g))
        slot[torch.arange(B)[:, None], torch.arange(K)[None, :], t_cur[:, None]] = torch.arange(K)
        live = torch.arange(T)[None, None, :, None] <= t_cur[:, None, None, None]
        sel = torch.nn.functional.one_hot(slot, K).bool() & live   # (B, K, T, K)
        mask = sel.reshape(B, K, T * K).to(device)
    return q, k, v, mask


def kernel_phase(t0):
    """Kernel vs plain version at the decode shapes; timings at the release
    shape.  Returns the JSON record of the kernel (launches filled later);
    its numbers are those of the self-attention shape."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    nh, hd, S = 8, 32, 623
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        atol, rtol = TOL[name]
        worst[name] = 0.0
        for B in (1, 16, 64):
            for K in (1, 5, 10):
                for M, masked in ((31 * K, True), (151 * K, True), (S, False)):
                    q, k, v, mask = attention_inputs(B, K, M, nh, hd, dtype, "cuda", masked,
                                                     seed=B * 1000 + K * 10 + masked)
                    out = decode_attention(q, k, v, mask)
                    ref = decode_attention_reference(q, k, v, mask)
                    torch.cuda.synchronize()
                    if not torch.isfinite(out).all():
                        raise AssertionError(f"non-finite kernel output at B{B} K{K} M{M} {name}")
                    err = (out.float() - ref.float()).abs()
                    bound = atol + rtol * ref.float().abs()
                    if (err > bound).any():
                        raise AssertionError(
                            f"kernel disagrees with plain version at B{B} K{K} M{M} "
                            f"mask={masked} {name}: max abs err {err.max().item():.3e}")
                    worst[name] = max(worst[name], err.max().item())
    log("kernel", t0, "matches plain version at B{1,16,64} x K{1,5,10} x "
        "{self M=31K, 151K masked; cross M=623}: max abs err "
        + ", ".join(f"{n} {e:.3e} (tol {TOL[n][0]:g} abs + {TOL[n][1]:g} rel)"
                    for n, e in worst.items()))

    timings = {}
    for label, (B, K, M, masked) in (("self", (64, 10, 1510, True)),
                                      ("cross", (64, 10, S, False))):
        q, k, v, mask = attention_inputs(B, K, M, nh, hd, torch.bfloat16, "cuda", masked,
                                         seed=7, last_step=True)
        sdpa_mask = None if mask is None else mask[:, None]
        qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
        before = decode_attention.launches
        ms = cuda_time_ms(lambda: decode_attention(q, k, v, mask))
        decode_attention.launches = before  # timing launches are not main-path launches
        plain_ms = cuda_time_ms(lambda: decode_attention_reference(q, k, v, mask))
        library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, scale=1.0))
        err = (decode_attention(q, k, v, mask).float()
               - decode_attention_reference(q, k, v, mask).float()).abs().max().item()
        decode_attention.launches = before
        elem = 2  # bf16
        # bytes this data needs: q read, out written, the mask, and the K/V
        # rows that at least one beam of the sample attends
        kv_rows = B * M if mask is None else int(mask.any(dim=1).sum().item())
        nbytes = (2 * q.numel() + 2 * kv_rows * nh * hd) * elem
        nbytes += 0 if mask is None else mask.numel()
        attended = B * K * M if mask is None else int(mask.sum().item())
        flops = 4 * attended * nh * hd  # q.k and p.v over the attended positions
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS * 1e3
        timings[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=max(bytes_ms, ops_ms),
                              bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                              max_abs_err=err, bytes=nbytes, flops=flops)
        log("kernel", t0, f"{label} B{B} K{K} M{M} nh{nh} hd{hd} bf16: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa (yardstick) {library_ms:.4f} ms, "
            f"bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB), "
            f"achieved {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
    rel = timings["self"]
    return {
        "name": "decode_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": 0, "max_abs_err": rel["max_abs_err"],
        "ms": rel["ms"], "plain_ms": rel["plain_ms"], "bound_ms": rel["bound_ms"],
        "bound_by": rel["bound_by"], "library_ms": rel["library_ms"],
    }


def golden_crops():
    """The 16 crops of the golden file, regenerated from their seeds; their
    sha256 must match, so a numpy difference fails here and not as a
    parity miss."""
    import hashlib

    import numpy as np

    from doc2tex_tpu_torch.data.synthetic import synth_hard_sample

    with open(GOLDEN) as f:
        golden = json.load(f)
    h, w = golden["crop_max"]
    crops = []
    for c in golden["crops"]:
        img, _ = synth_hard_sample(np.random.default_rng(c["seed"]), max_h=h, max_w=w)
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        if digest != c["sha256"]:
            raise AssertionError(f"crop of seed {c['seed']} differs from the golden crop")
        crops.append(img)
    return golden, crops


def run_slice(config, weights_path, crops, beam_size: int, device: str):
    """Drive the port's main path: MathRecognition on ``crops``.  Returns
    (strings, kernel launches, decode steps, seconds of the timed run).
    The first call warms up; the counted and timed call is the second."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.recognition import MathRecognition

    rec = MathRecognition(config, weights_path, beam_size=beam_size, device=device)
    rec(crops)
    if device != "cpu":
        torch.cuda.synchronize()
    decode_attention.launches = 0
    t = time.perf_counter()
    out = rec(crops)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = decode_attention.launches
    steps = launches // (2 * rec.model.predicter.num_layers)
    return out, launches, steps, seconds


def slice_phase(t0, record):
    from doc2tex_tpu_torch.recognition import load_recog_config

    golden, crops = golden_crops()
    want = [c["beam10"] for c in golden["crops"]]
    for dtype in ("float32", "bfloat16"):
        cfg, weights = load_recog_config(version=golden["version"])
        cfg["dtype"] = dtype
        cfg["quantize"] = None
        out, launches, steps, seconds = run_slice(cfg, weights, crops, 10, "cuda")
        if launches <= 0:
            raise AssertionError(f"{dtype} run launched the decode attention kernel 0 times")
        misses = [i for i, (a, b) in enumerate(zip(out, want)) if a != b]
        match = len(want) - len(misses)
        log("slice", t0, f"synthetic_tfm_big beam 10 {dtype}: {match}/{len(want)} equal to "
            f"the JAX golden (misses at crops {misses}), {len(crops) / seconds:.2f} crops/s "
            f"({seconds:.3f} s), {steps} decode steps, {launches} kernel launches")
        if dtype == "float32":
            record["launches"] = launches
            if match < MIN_GOLDEN_MATCH:
                raise AssertionError(
                    f"float32 strings equal the golden on {match}/16 < {MIN_GOLDEN_MATCH}: "
                    + "; ".join(f"crop {i}: {out[i]!r} != {want[i]!r}" for i in misses))


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # float32 means float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from doc2tex_tpu_torch.ops.decode_attention import build

    name = torch.cuda.get_device_name(0)
    log("device", t0, f"{name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    log("device", t0, f"nvidia-smi: {nvidia_smi()}")
    info = build()
    log("build", t0, f"decode_attention built in {info['seconds']:.2f} s "
        f"({'compiled' if info['built'] else 'cached'}): {info['path']}")
    if info["ptxas"]:
        print(info["ptxas"], file=sys.stderr, flush=True)
    record = kernel_phase(t0)
    slice_phase(t0, record)
    print(json.dumps({"kernels": [record]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # report every failed phase, then exit non-zero
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
