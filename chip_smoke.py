#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``doc2tex_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one.  Phases, one line each:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds both kernels at once, one process per source
   (seconds taken);
3. kernel  — beam decode attention (B1) against its plain PyTorch version
   on the card, at the decode shapes of the TFM release model
   (self-attention with a random beam-ancestry mask, cross-attention over
   623 memory tokens), in float32 and bfloat16; then times at the release
   shape (batch 64, beam 10, step 151) beside the plain version,
   F.scaled_dot_product_attention (a yardstick only; the port never calls
   it) and the bound;
4. kernel  — the coverage-attention step (B2) against its plain version at
   rows {1, 10, 37, 640} x S {83, 623, 2525} x (D, H, Kl) {(128, 128, 64),
   (256, 256, 128)}, and at the (rows, S) of every batch the ``synthetic``
   slice phase decodes, x valid_len {None, S - 17}, float32 and bfloat16
   memory; then times (bf16) at each of the slice's shapes and at the
   release shape (640 rows = 64 crops x beam 10, S 623) beside the plain
   version and the bound.  The JSON record holds the slice's largest
   launch;
5. slice   — MathRecognition with the released ``synthetic_tfm_big``
   weights, beam 10, on 16 seeded synthetic crops: float32 (the strings
   must equal the JAX package's golden strings on >= 15 of 16) and
   bfloat16, the release compute type (agreement printed, not gated).  B1's
   launch count must rise in each run;
6. slice   — the same with the released coverage-LSTM ``synthetic``
   against its own golden file; B2's launch count must rise in each run.

Then a JSON line with both kernels' numbers, and last
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
GOLDEN = {"synthetic_tfm_big": os.path.join(ROOT, "tests", "torch_port_golden.json"),
          "synthetic": os.path.join(ROOT, "tests", "torch_port_golden_synthetic.json")}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor rate
F32_FLOPS = 67e12                  # H100 SXM float32 rate outside the tensor cores
KERNEL_SOURCE = "doc2tex_tpu_torch/csrc/decode_attention.cu"
KERNEL_REPLACES = "doc2tex_tpu/ops/decode_attention.py:104"
B2_SOURCE = "doc2tex_tpu_torch/csrc/attention_step.cu"
B2_REPLACES = "doc2tex_tpu/ops/attention_step.py:99"
# stated tolerances of kernel vs plain version (abs + rel * |plain|)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 0.0)}
# B2 computes in float32 whatever the memory's type, so one tolerance for
# both: float32 sums of the same terms in another order
B2_TOL = (1e-5, 1e-5)
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


def attention_step_inputs(rows, S, D, H, Kl, dtype, seed):
    """Random inputs of the coverage-attention step on the card, at the
    scales of a decode: unit-variance memory and keys, location features of
    a coverage conv, weights scaled by fan-in."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return dict(
        enc=randn(rows, S, D).to(dtype), enc_proj=randn(rows, S, H).to(dtype),
        q=randn(rows, H), loc_feat=randn(rows, S, Kl, scale=0.5),
        w_loc=randn(Kl, H, scale=Kl ** -0.5), b_loc=randn(H, scale=0.1),
        w_score=randn(H, 1, scale=H ** -0.5),
    )


def lstm_launch_shapes(version: str = "synthetic", beam_size: int = 10):
    """(rows, S, D, H, Kl) of the B2 launches the ``version`` slice phase
    makes: one shape per batch that MathRecognition builds from the golden
    crops (rows = the padded batch x beam; S = the bucket's patch grid, the
    v2 cls token split off).  Host arithmetic only."""
    from doc2tex_tpu_torch.models.vit import grid_size_for
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    _, crops = golden_crops(version)
    cfg, weights = load_recog_config(version=version)
    cfg["quantize"] = None
    rec = MathRecognition(cfg, weights, beam_size=beam_size, device="cpu")
    vit, head = cfg["SequenceModeling"]["params"], cfg["Prediction"]["params"]
    prepped = [rec._preprocess(c) for c in crops]
    shapes = set()
    for bucket, idxs in rec.group(prepped).items():
        gh, gw = grid_size_for(bucket, tuple(vit["patch_size"]))
        rows = rec.make_batch([prepped[i] for i in idxs], bucket).shape[0] * beam_size
        shapes.add((rows, gh * gw, vit["hidden_size"], head["hidden_size"], head["kernel_dim"]))
    return sorted(shapes)


def attention_step_timing(rows, S, D, H, Kl):
    """Kernel and plain version timed at one shape with bf16 memory (the
    release compute type), and the bound of the same work."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        attention_step_reference, fused_attention_step)

    kw = attention_step_inputs(rows, S, D, H, Kl, torch.bfloat16, seed=7)
    before = fused_attention_step.launches
    ms = cuda_time_ms(lambda: fused_attention_step(**kw))
    plain_ms = cuda_time_ms(lambda: attention_step_reference(**kw))
    got, ref = fused_attention_step(**kw), attention_step_reference(**kw)
    fused_attention_step.launches = before  # timing launches are not main-path launches
    err = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())
    nbytes = sum(t.numel() * t.element_size() for t in kw.values())
    nbytes += (got[0].numel() + got[1].numel()) * 4
    # float32 work per position: loc.w_loc, the adds, tanh and w_score over
    # H, the softmax, and alpha.enc over D
    flops = rows * S * (2 * Kl * H + 5 * H + 3 + 2 * D)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=err,
                text=f"rows {rows} S {S} D{D} H{H} Kl{Kl} bf16: kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
                     f"{bytes_ms:.4f} ms for {nbytes / 1e6:.1f} MB, operations {ops_ms:.4f} ms "
                     f"for {flops / 1e9:.3f} GFLOP f32), achieved "
                     f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, "
                     f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")


def attention_step_phase(t0):
    """B2 vs its plain version over the listed shapes and the shapes of the
    ``synthetic`` slice; timings at each of the slice's shapes and at the
    release shape.  Returns the kernel's JSON record (launches filled
    later); its numbers are those of the slice's largest launch."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        attention_step_reference, fused_attention_step)

    main_path = lstm_launch_shapes()
    log("kernel", t0, "attention_step launch shapes of the synthetic slice (rows, S, D, H, Kl): "
        + ", ".join(map(str, main_path)))
    grid = [(rows, S, D, H, Kl) for D, H, Kl in ((128, 128, 64), (256, 256, 128))
            for S in (83, 623, 2525) for rows in (1, 10, 37, 640)]
    atol, rtol = B2_TOL
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for rows, S, D, H, Kl in grid + main_path:
            for valid in (None, S - 17):
                kw = attention_step_inputs(rows, S, D, H, Kl, dtype, seed=n)
                n += 1
                got = fused_attention_step(**kw, valid_len=valid)
                ref = attention_step_reference(**kw, valid_len=valid)
                torch.cuda.synchronize()
                for what, a, b in (("context", got[0], ref[0]), ("alpha", got[1], ref[1])):
                    if not torch.isfinite(a).all():
                        raise AssertionError(f"non-finite {what} at rows {rows} S {S} "
                                             f"D {D} {name}")
                    err = (a - b).abs()
                    if (err > atol + rtol * b.abs()).any():
                        raise AssertionError(
                            f"attention step disagrees with plain version ({what}) at rows "
                            f"{rows} S {S} D{D} H{H} Kl{Kl} valid {valid} {name}: max "
                            f"abs err {err.max().item():.3e}")
                    worst[name] = max(worst[name], err.max().item())
                del kw, got, ref
    log("kernel", t0, f"attention_step matches plain version at {n} shapes (rows {{1,10,37,640}} "
        "x S {83,623,2525} x (D,H,Kl) {(128,128,64),(256,256,128)}, and the synthetic slice's "
        "shapes; x valid {None, S-17}): max abs err "
        + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
        + f" (tol {atol:g} abs + {rtol:g} rel)")

    timings = {shape: attention_step_timing(*shape) for shape in main_path}
    for timing in timings.values():
        log("kernel", t0, f"attention_step (synthetic slice) {timing['text']}")
    log("kernel", t0, "attention_step (release shape, 64 crops x beam 10) "
        + attention_step_timing(640, 623, 128, 128, 64)["text"])
    # the record: the slice's largest launch (most rows, then longest S)
    rel = timings[max(main_path)]
    return {
        "name": "attention_step", "route": "cuda", "source": B2_SOURCE,
        "replaces": B2_REPLACES, "launches": 0, "max_abs_err": rel["max_abs_err"],
        "ms": rel["ms"], "plain_ms": rel["plain_ms"], "bound_ms": rel["bound_ms"],
        "bound_by": rel["bound_by"], "library_ms": None,
    }


def golden_crops(version: str = "synthetic_tfm_big"):
    """The 16 crops of ``version``'s golden file, regenerated from their
    seeds; their sha256 must match, so a numpy difference fails here and
    not as a parity miss."""
    import hashlib

    import numpy as np

    from doc2tex_tpu_torch.data.synthetic import synth_hard_sample

    with open(GOLDEN[version]) as f:
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
    (strings, launches of the head's kernel, decode steps, seconds of the
    timed run).  The first call warms up; the counted and timed call is
    the second, with every kernel's count set to 0 just before it."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import fused_attention_step
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.recognition import MathRecognition

    rec = MathRecognition(config, weights_path, beam_size=beam_size, device=device)
    rec(crops)
    if device != "cpu":
        torch.cuda.synchronize()
    decode_attention.launches = fused_attention_step.launches = 0
    t = time.perf_counter()
    out = rec(crops)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    if rec.model.head == "TFM":
        launches = decode_attention.launches
        steps = launches // (2 * rec.model.predicter.num_layers)
    else:  # the LSTM head: one attention step per decode step
        launches = steps = fused_attention_step.launches
    return out, launches, steps, seconds


def slice_phase(t0, version, record):
    from doc2tex_tpu_torch.recognition import load_recog_config

    golden, crops = golden_crops(version)
    want = [c["beam10"] for c in golden["crops"]]
    for dtype in ("float32", "bfloat16"):
        cfg, weights = load_recog_config(version=golden["version"])
        cfg["dtype"] = dtype
        cfg["quantize"] = None
        out, launches, steps, seconds = run_slice(cfg, weights, crops, 10, "cuda")
        if launches <= 0:
            raise AssertionError(f"{version} {dtype} run launched its kernel "
                                 f"{record['name']} 0 times")
        misses = [i for i, (a, b) in enumerate(zip(out, want)) if a != b]
        match = len(want) - len(misses)
        log("slice", t0, f"{version} beam 10 {dtype}: {match}/{len(want)} equal to "
            f"the JAX golden (misses at crops {misses}), {len(crops) / seconds:.2f} crops/s "
            f"({seconds:.3f} s), {steps} decode steps, {launches} {record['name']} launches")
        if dtype == "float32":
            record["launches"] = launches
            if match < MIN_GOLDEN_MATCH:
                raise AssertionError(
                    f"float32 strings equal the golden on {match}/16 < {MIN_GOLDEN_MATCH}: "
                    + "; ".join(f"crop {i}: {out[i]!r} != {want[i]!r}" for i in misses))


def build_kernels(t0):
    """nvcc on both sources at once (one process each)."""
    from concurrent.futures import ThreadPoolExecutor

    from doc2tex_tpu_torch.ops import attention_step, decode_attention

    with ThreadPoolExecutor(max_workers=2) as pool:
        infos = list(pool.map(lambda m: (m.SOURCE, m.build()), (decode_attention, attention_step)))
    for source, info in infos:
        log("build", t0, f"{source} built in {info['seconds']:.2f} s "
            f"({'compiled' if info['built'] else 'cached'}): {info['path']}")
        if info["ptxas"]:
            print(info["ptxas"], file=sys.stderr, flush=True)


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
    name = torch.cuda.get_device_name(0)
    log("device", t0, f"{name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    log("device", t0, f"nvidia-smi: {nvidia_smi()}")
    build_kernels(t0)
    records = [kernel_phase(t0), attention_step_phase(t0)]
    slice_phase(t0, "synthetic_tfm_big", records[0])
    slice_phase(t0, "synthetic", records[1])
    print(json.dumps({"kernels": records}), flush=True)
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
