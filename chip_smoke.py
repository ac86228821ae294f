#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``doc2tex_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one.  Phases, one line each:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds both kernels at once, one process per source
   (seconds taken);
3. slice   — MathRecognition with the released ``synthetic_tfm_big``
   weights, beam 10, on 16 seeded synthetic crops: float32 (the strings
   must equal the JAX package's golden strings on >= 15 of 16) and
   bfloat16, the release compute type (agreement printed, not gated).  B1's
   launch count must rise in each run; the float32 run's decode steps give
   the slice's B1 launch shapes (``tfm_launch_shapes``);
4. kernel  — beam decode attention (B1) against its plain PyTorch version
   on the card, in float32 and bfloat16: at the decode shapes of the TFM
   release model (self-attention with a random beam-ancestry mask,
   cross-attention over 623 memory tokens), at the slice's own launch
   shapes, and where the kernel splits M over a cluster (batch 1 and 8, M
   5010); bit for bit in bf16 and f16 on inputs that show where the
   probabilities are rounded.  Then times (each a call's share of a CUDA
   graph of 20 calls) at the release shape (batch 64, beam 10, step 151;
   the JSON record), at the slice's shapes and at the split shapes, beside
   the plain version, F.scaled_dot_product_attention (a yardstick only; the
   port never calls it) and the bound;
5. kernel  — the coverage-attention step (B2) against its plain versions.
   The feature form (the TPU kernel's contract) at rows {1, 10, 37, 640} x
   S {83, 623, 2525} x (D, H, Kl) {(128, 128, 64), (256, 256, 128)} and at
   the rows and S of every batch the ``synthetic`` slice phase decodes; the
   coverage form (the main path's: location conv folded in, memory at
   sample rows) at samples {1, 8, 64} x K {1, 5, 10} x S {83, 445, 623,
   2525} x the same widths and the slice's shapes, on coverage of decode
   steps 1 and 150; each x valid_len {None, S - 17}, float32 and bfloat16
   memory.  Then both forms timed (bf16, CUDA graphs) at each of the
   slice's shapes and at the release shape (64 crops x beam 10, S 623)
   beside the plain version and the bound.  The JSON record holds the
   coverage form at the slice's largest launch;
6. slice   — the same with the released coverage-LSTM ``synthetic``
   against its own golden file; B2's coverage-form launch count must rise
   in each run;
7. int8    — every int8 layer of both releases' encoders (``quantize:
   int8``: the gated ResNet convolutions, the patch conv, the ViT Denses)
   on the card against the same layer on the CPU, in float32 and
   bfloat16, on the inputs the layer gets when the release encodes a golden
   crop at the slice's largest bucket: equal bits (integer sums are exact
   and the rescale is the same ops in the same order), and at M <= 16 rows
   (the product's zero-row padding);
8. slice   — both releases as they ship, ``quantize: int8``: float32
   against the JAX package's int8 golden (equal strings printed; gated on
   a mean character match >= 0.85 and >= 2 strings that differ from the
   float32 golden, ``check_int8_strings``: int8 strings follow every float
   op's last bit), and bfloat16 (printed), each kernel's launch count
   rising;
9. serve   — ``python -m doc2tex_tpu_torch.api.serve --selftest 32
   --model_version synthetic`` (int8, as shipped) in a child process, its
   stats printed (batches, p50/p99 latency, crops/s); then the HTTP front
   in this process on a localhost port: POST /recognize with a PNG must
   return a string, B2 launching in that request;
10. eval   — the release-eval twin (``tools/release_eval.py``) on
   ``synthetic`` at 256 generated samples, bf16 and int8, printed (at
   that size the interval is too wide to gate);
11. detect — ``MathDetector`` (the released detector, float32; it turns
   cuDNN's TF32 off for its forward) on the 3 golden pages of
   ``tests/torch_port_golden_pages.json`` (1024x1280, 35 windows each),
   with the process's TF32 as torch leaves it, as the app and the server
   run: every box matched one to one with the JAX package's, within 0.5 px
   and scores within 1e-3, at most one box over all pages unmatched and
   only one scored within 0.01 of the threshold; the same bits with TF32
   off process-wide.  Then SSD512's forward, the per-window NMS, the page NMS and the whole
   ``detect_page`` timed on a page beside the SSD's float32 bound
   (``tools/profile_page.detect_timings``);
12. page   — ``App`` with the shared ``synthetic_tfm_big`` recognizer:
   (a) float32, beam 10, on the golden pages: strings equal to the JAX
   package's on every crop whose integer box equals JAX's, but at most
   one, B1 launching; (b) the page-eval twin (``tools/page_eval.py``) on 40
   pages of seed 35 as the reference's record ran (``quantize: int8`` as
   shipped, beam 10, coalescing off): detection precision, recall and
   end-to-end accuracy each inside the record's Wilson interval
   (``tools/page_eval_r05.json``); (c) the HTTP front with ``--detect`` in
   this process: ``POST /recognize_page`` with a PNG page returns regions,
   B1 launching in that request.  (b) and (c) run with the process's TF32
   as torch leaves it.

Then a JSON line with both kernels' numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the traceback
is printed and the exit code is 1.  A hang is cut by faulthandler.
"""

from __future__ import annotations

import contextlib
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
GOLDEN_INT8 = {"synthetic_tfm_big": os.path.join(ROOT, "tests", "torch_port_golden_int8.json"),
               "synthetic": os.path.join(ROOT, "tests", "torch_port_golden_synthetic_int8.json")}
GOLDEN_PAGES = os.path.join(ROOT, "tests", "torch_port_golden_pages.json")
# the reference's page-eval record this port is held to: 40 pages, seed 35,
# synthetic_tfm_big int8 beam 10, float32 detector, page NMS, coalescing off
PAGE_EVAL_REF = (os.path.join(ROOT, "tools", "page_eval_r05.json"),
                 "synthetic_tfm_big_ftrecog_p40")
PAGE_EVAL_PAGES = 40
# cuDNN's TF32 setting as torch leaves it in a process that does not set it
# (the app, the server); main reads it before it turns TF32 off
USERS_CUDNN_TF32 = None
# the detect phase's gates against the golden pages
BOX_TOL_PX = 0.5
SCORE_TOL = 1e-3
NEAR_THRESHOLD = 0.01   # an unmatched box must score this close to conf_thresh
MAX_UNMATCHED = 1
MAX_PAGE_STRING_MISSES = 1
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
# the int8 strings' gates (see check_int8_strings)
INT8_MIN_CHAR_MATCH = 0.85
INT8_MIN_CHANGED = 2


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


def attention_inputs(B, K, M, nh, hd, dtype, device, masked, seed, step=None):
    """Random q/k/v and, if ``masked``, a random beam-ancestry mask over
    M = T*K flat positions: each hypothesis's prefix picks one slot per
    position up to the current step, and its own slot at that step.  The
    current step is ``step`` for every sample (the positions after it are
    the cache's dead tail), or random per sample when ``step`` is None."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn(B, K, nh, hd, generator=g) / hd ** 0.5).to(device, dtype)
    k = torch.randn(B, M, nh, hd, generator=g).to(device, dtype)
    v = torch.randn(B, M, nh, hd, generator=g).to(device, dtype)
    mask = None
    if masked:
        T = M // K
        slot = torch.randint(0, K, (B, K, T), generator=g)
        t_cur = (torch.full((B,), step) if step is not None
                 else torch.randint(0, T, (B,), generator=g))
        slot[torch.arange(B)[:, None], torch.arange(K)[None, :], t_cur[:, None]] = torch.arange(K)
        live = torch.arange(T)[None, None, :, None] <= t_cur[:, None, None, None]
        sel = torch.nn.functional.one_hot(slot, K).bool() & live   # (B, K, T, K)
        mask = sel.reshape(B, K, T * K).to(device)
    return q, k, v, mask


ROUNDING_POINT_CASES = ((3, 1.25), (7, 1.25), (7, 5.0))  # (attended positions, v)


def rounding_point_inputs(n, v0, dtype, device, B=1, K=1, nh=1, hd=32, spread=1, seed=0):
    """Inputs on which rounding the normalised probabilities to v's type
    before P.V (the reference's order) and keeping them in float32 give
    different results: q = 0, so the ``n`` attended positions (every
    ``spread``-th of M = n * spread) score alike and p = 1/n; V is ``v0`` at
    position 0 and 0 elsewhere.  Every output element is then
    round(round(1/n) * v0), one product summed with zeros."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    M = n * spread
    q = torch.zeros(B, K, nh, hd)
    k = torch.randn(B, M, nh, hd, generator=g)
    v = torch.zeros(B, M, nh, hd)
    v[:, 0] = v0
    mask = None
    if spread > 1:
        mask = torch.zeros(B, K, M, dtype=torch.bool)
        mask[:, :, ::spread] = True
        mask = mask.to(device)
    return q.to(device, dtype), k.to(device, dtype), v.to(device, dtype), mask


def check_attention(B, K, M, nh, hd, dtype, masked, seed, step=None):
    """B1 against its plain version at one shape; returns the max abs error."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    name = str(dtype).split(".")[-1]
    atol, rtol = TOL[name]
    q, k, v, mask = attention_inputs(B, K, M, nh, hd, dtype, "cuda", masked, seed, step)
    out = decode_attention(q, k, v, mask)
    ref = decode_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"non-finite kernel output at B{B} K{K} M{M} {name}")
    err = (out.float() - ref.float()).abs()
    if (err > atol + rtol * ref.float().abs()).any():
        raise AssertionError(f"kernel disagrees with plain version at B{B} K{K} M{M} "
                             f"mask={masked} step={step} {name}: max abs err "
                             f"{err.max().item():.3e}")
    return err.max().item()


def attention_timing(B, K, M, masked, step, nh=8, hd=32):
    """B1, its plain version and SDPA (a yardstick; the port never calls
    it) timed at one bf16 shape, and the bound of the same work.  Each time
    is one call's share of a CUDA graph of 20 calls, so host time between
    launches is not counted."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference, launch_plan)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    q, k, v, mask = attention_inputs(B, K, M, nh, hd, torch.bfloat16, "cuda", masked,
                                     seed=7, step=step)
    sdpa_mask = None if mask is None else mask[:, None]
    qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    before = decode_attention.launches
    ms = graph_ms(lambda: decode_attention(q, k, v, mask))
    plain_ms = graph_ms(lambda: decode_attention_reference(q, k, v, mask))
    library_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, scale=1.0))
    err = (decode_attention(q, k, v, mask).float()
           - decode_attention_reference(q, k, v, mask).float()).abs().max().item()
    decode_attention.launches = before  # timing launches are not main-path launches
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
    bound = max(bytes_ms, ops_ms)
    plan = launch_plan(B, K, M, nh, hd, torch.bfloat16)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=err,
                text=f"B{B} K{K} M{M} {'step ' + str(step) if masked else 'no mask'} nh{nh} "
                     f"hd{hd} bf16 (cluster {plan.cluster}, chunk {plan.chunk}, "
                     f"{plan.smem_bytes} B smem): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"sdpa (yardstick) {library_ms:.4f} ms, bound {bound:.4f} ms "
                     f"({nbytes / 1e6:.2f} MB), {bound / ms:.0%} of bound, achieved "
                     f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")


def kernel_phase(t0, slice_shapes):
    """B1 against its plain version over the listed grid, the launch shapes
    of the ``synthetic_tfm_big`` slice, shapes where M is split over a
    cluster, and bit for bit on the rounding-point inputs; then times at
    the release shape (the JSON record), the slice's shapes and the split
    shapes.  Returns the kernel's JSON record (launches filled later)."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    nh, hd, S = 8, 32, 623
    grid = [(B, K, M, masked, None) for B in (1, 16, 64) for K in (1, 5, 10)
            for M, masked in ((31 * K, True), (151 * K, True), (S, False))]
    grid += [(B, K, M, t is not None, t) for B, K, M, t in slice_shapes]
    grid += [(B, 10, M, masked, None) for B in (1, 8) for M, masked in ((1510, True), (623, False))]
    grid += [(1, 10, 5010, True, 500), (64, 10, 5010, True, None)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        worst[name] = max(check_attention(B, K, M, nh, hd, dtype, masked,
                                          seed=B * 1000 + K * 10 + masked, step=step)
                          for B, K, M, masked, step in grid)
    log("kernel", t0, f"matches plain version at {len(grid)} shapes per dtype (B{{1,16,64}} x "
        "K{1,5,10} x {self M=31K, 151K masked; cross M=623}; the slice's shapes "
        f"{slice_shapes}; B{{1,8}} x M{{1510 masked, 623}}; M 5010 at B{{1,64}}): max abs err "
        + ", ".join(f"{n} {e:.3e} (tol {TOL[n][0]:g} abs + {TOL[n][1]:g} rel)"
                    for n, e in worst.items()))

    n = 0
    for dtype in (torch.bfloat16, torch.float16):
        for m, v0 in ROUNDING_POINT_CASES:
            for spread, B, K, nh_ in ((1, 1, 1, 1), (500, 1, 10, 8)):
                q, k, v, mask = rounding_point_inputs(m, v0, dtype, "cuda", B=B, K=K, nh=nh_,
                                                      spread=spread)
                out = decode_attention(q, k, v, mask)
                ref = decode_attention_reference(q, k, v, mask)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"rounding point: kernel {out.flatten()[0].item()!r} != plain "
                        f"{ref.flatten()[0].item()!r} at n {m}, v {v0}, spread {spread}, {dtype}")
                n += 1
    log("kernel", t0, f"equals plain version bit for bit on {n} rounding-point inputs "
        "(p = 1/n rounded to v's type before P.V; bf16 and f16; unsplit and over 8 blocks)")

    timings = {}
    for label, shape in (("self", (64, 10, 1510, True, 150)), ("cross", (64, 10, S, False, None))):
        timings[label] = attention_timing(*shape)
        log("kernel", t0, f"{label} (release shape) {timings[label]['text']}")
    slice_ms = 0.0
    for B, K, M, step in slice_shapes:
        timing = attention_timing(B, K, M, step is not None, step)
        log("kernel", t0, f"synthetic_tfm_big slice {timing['text']}")
        slice_ms += timing["ms"]
    log("kernel", t0, f"sum over the slice's {len(slice_shapes)} shapes: {slice_ms:.4f} ms")
    for B, K, M, masked, step in ((1, 10, 1510, True, 150), (8, 10, 1510, True, 150),
                                  (1, 10, S, False, None), (8, 10, S, False, None),
                                  (1, 10, 5010, True, 500), (64, 10, 5010, True, 500)):
        log("kernel", t0, f"split {attention_timing(B, K, M, masked, step)['text']}")
    rel = timings["self"]
    return {
        "name": "decode_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": 0, "max_abs_err": rel["max_abs_err"],
        "ms": rel["ms"], "plain_ms": rel["plain_ms"], "bound_ms": rel["bound_ms"],
        "bound_by": rel["bound_by"], "library_ms": rel["library_ms"],
    }


def attention_step_inputs(rows, S, D, H, Kl, dtype, seed):
    """Random inputs of the feature form of the attention step on the card,
    at the scales of a decode: unit-variance memory and keys, location
    features of a coverage conv, weights scaled by fan-in."""
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


COVERAGE_STEPS = (1, 150)  # decode steps whose coverage the B2 checks hold


def coverage_step_inputs(Bs, K, S, D, H, Kl, dtype, t, seed, taps=5):
    """Random inputs of the coverage form on the card, as a decode at step
    ``t`` gives them: the memory at Bs sample rows, q at Bs*K rows, and the
    coverage the sum of t softmax rows over S (non-negative; about 1 in
    all at t = 1, about t at t = 150).  Weights at the released
    ``synthetic`` head's scales (std 0.5 conv, 0.35 w_loc, 0.4 w_score)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    mem = torch.zeros(Bs * K, S, device="cuda")
    for _ in range(t):
        mem += torch.softmax(randn(Bs * K, S, scale=3.0), dim=-1)
    return dict(
        enc=randn(Bs, S, D).to(dtype), enc_proj=randn(Bs, S, H, scale=1.5).to(dtype),
        q=randn(Bs * K, H, scale=1.5), mem=mem,
        loc_conv_w=randn(taps, 1, Kl, scale=0.5), loc_conv_b=randn(Kl, scale=0.1),
        w_loc=randn(Kl, H, scale=0.35), b_loc=randn(H, scale=0.17),
        w_score=randn(H, 1, scale=0.4),
    )


def lstm_launch_shapes(version: str = "synthetic", beam_size: int = 10):
    """(samples, K, S, D, H, Kl) of the B2 launches the ``version`` slice
    phase makes: one shape per batch that MathRecognition builds from the
    golden crops (samples = the padded batch, K = the beam; S = the bucket's
    patch grid, the v2 cls token split off).  Host arithmetic only."""
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
        samples = rec.make_batch([prepped[i] for i in idxs], bucket).shape[0]
        shapes.add((samples, beam_size, gh * gw, vit["hidden_size"], head["hidden_size"],
                    head["kernel_dim"]))
    return sorted(shapes)


def tfm_launch_shapes(steps: int, config=None, beam_size: int = 10):
    """(B, K, M, t) of the B1 launches that the ``synthetic_tfm_big`` slice
    phase makes on the golden crops when each batch decodes ``steps``
    steps: for self-attention one entry per KV-cache chunk the decode
    reaches (M = the chunk's end step x K, the decode's chunk schedule) with
    t the last step decoded in it, whose ancestry mask is the densest of
    the chunk; for cross-attention (B, K, S, None), S the patch grid and
    the cls token.  ``config`` defaults to the release's.  Host arithmetic
    only: no weights are read and nothing is decoded."""
    from doc2tex_tpu_torch.decode.runner import DECODE_CHUNKS, _chunk_ends
    from doc2tex_tpu_torch.models.vit import grid_size_for
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    if config is None:
        config, _ = load_recog_config(version="synthetic_tfm_big")
        config["quantize"] = None
    _, crops = golden_crops("synthetic_tfm_big")
    rec = MathRecognition(config, None, beam_size=beam_size, device="cpu")
    patch = tuple(config["SequenceModeling"]["params"]["patch_size"])
    ends = _chunk_ends(config["batch_max_length"] + 1, DECODE_CHUNKS)
    prepped = [rec._preprocess(c) for c in crops]
    shapes = set()
    for bucket, idxs in rec.group(prepped).items():
        B = rec.make_batch([prepped[i] for i in idxs], bucket).shape[0]
        gh, gw = grid_size_for(bucket, patch)
        shapes.add((B, beam_size, gh * gw + 1, None))
        for start, end in zip([0] + ends, ends):
            if start < steps:
                shapes.add((B, beam_size, end * beam_size, min(end, steps) - 1))
    return sorted(shapes, key=lambda s: (s[3] is None, s))


def _b2_result(ms, plain_ms, got, ref, nbytes, flops, text):
    """B2's timing record: the bound of the work, and the text line."""
    err = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=err,
                text=f"{text}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
                     f"(bytes {bytes_ms:.4f} ms for {nbytes / 1e6:.2f} MB, operations "
                     f"{ops_ms:.4f} ms for {flops / 1e9:.4f} GFLOP f32), {bound / ms:.0%} of "
                     f"bound, achieved {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, "
                     f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")


def attention_step_timing(rows, S, D, H, Kl):
    """The feature form (the TPU kernel's contract, memory at the rows of
    q) and its plain version timed at one shape with bf16 memory, each a
    call's share of a CUDA graph of 20 calls, and the bound of the same
    work."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        attention_step_reference, fused_attention_step)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    kw = attention_step_inputs(rows, S, D, H, Kl, torch.bfloat16, seed=7)
    before = fused_attention_step.launches
    ms = graph_ms(lambda: fused_attention_step(**kw))
    plain_ms = graph_ms(lambda: attention_step_reference(**kw))
    got, ref = fused_attention_step(**kw), attention_step_reference(**kw)
    fused_attention_step.launches = before  # timing launches are not main-path launches
    nbytes = sum(t.numel() * t.element_size() for t in kw.values())
    nbytes += (got[0].numel() + got[1].numel()) * 4
    # float32 work per position: loc.w_loc, the adds, tanh and w_score over
    # H, the softmax, and alpha.enc over D
    flops = rows * S * (2 * Kl * H + 5 * H + 3 + 2 * D)
    return _b2_result(ms, plain_ms, got, ref, nbytes, flops,
                      f"feature form, rows {rows} S {S} D{D} H{H} Kl{Kl} bf16")


def coverage_step_timing(Bs, K, S, D, H, Kl):
    """The coverage form (the main path's) and its plain version timed at
    one shape with bf16 memory, as ``attention_step_timing``, and the bound
    of the fused function: the memory read once per sample, the coverage,
    q and the weights read and the outputs written once; per position 5
    window taps times H, the adds, tanh and w_score, the softmax, and
    alpha.enc over D."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        COVERAGE, coverage_attention_step, coverage_attention_step_reference, launch_plan)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    kw = coverage_step_inputs(Bs, K, S, D, H, Kl, torch.bfloat16, COVERAGE_STEPS[-1], seed=7)
    before = coverage_attention_step.launches
    ms = graph_ms(lambda: coverage_attention_step(**kw))
    plain_ms = graph_ms(lambda: coverage_attention_step_reference(**kw))
    got, ref = coverage_attention_step(**kw), coverage_attention_step_reference(**kw)
    coverage_attention_step.launches = before  # timing launches are not main-path launches
    taps = kw["loc_conv_w"].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in kw.values())
    nbytes += (got[0].numel() + got[1].numel()) * 4
    flops = Bs * K * S * (2 * taps * H + 5 * H + 3 + 2 * D)
    plan = launch_plan(Bs, K, S, D, H, Kl, torch.bfloat16, COVERAGE, taps)
    return _b2_result(ms, plain_ms, got, ref, nbytes, flops,
                      f"coverage form, {Bs} samples x K {K} S {S} D{D} H{H} Kl{Kl} bf16 "
                      f"(cluster {plan.cluster}, chunk {plan.chunk}, zsplit {plan.zsplit}, "
                      f"{plan.smem_bytes} B smem)")


def _check_b2(name, got, ref, where):
    """Both outputs of a B2 call finite and within B2_TOL of the plain
    version's; returns (the largest error, the largest error over its
    tolerance)."""
    import torch

    atol, rtol = B2_TOL
    worst = (0.0, 0.0)
    for what, a, b in (("context", got[0], ref[0]), ("alpha", got[1], ref[1])):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {what} at {where}")
        err = (a - b).abs()
        if (err > atol + rtol * b.abs()).any():
            raise AssertionError(f"{name} disagrees with plain version ({what}) at {where}: "
                                 f"max abs err {err.max().item():.3e}")
        ratio = (err / (atol + rtol * b.abs())).max().item()
        worst = (max(worst[0], err.max().item()), max(worst[1], ratio))
    return worst


def attention_step_phase(t0):
    """B2 against its plain versions: the feature form over the listed
    grid and the shapes of the ``synthetic`` slice (memory at the rows of
    q), the coverage form over the listed grid and the slice's shapes
    (memory at sample rows, coverage of steps 1 and 150); then both forms
    timed at each of the slice's shapes and at the release shape.  Returns
    the kernel's JSON record (launches filled later): the coverage form at
    the slice's largest launch."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        attention_step_reference, coverage_attention_step, coverage_attention_step_reference,
        fused_attention_step)

    main_path = lstm_launch_shapes()
    log("kernel", t0, "attention_step launch shapes of the synthetic slice (samples, K, S, D, H, "
        "Kl): " + ", ".join(map(str, main_path)))
    widths = ((128, 128, 64), (256, 256, 128))
    grid = [(rows, S, D, H, Kl) for D, H, Kl in widths
            for S in (83, 623, 2525) for rows in (1, 10, 37, 640)]
    grid += [(Bs * K, S, D, H, Kl) for Bs, K, S, D, H, Kl in main_path]
    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for rows, S, D, H, Kl in grid:
            for valid in (None, S - 17):
                kw = attention_step_inputs(rows, S, D, H, Kl, dtype, seed=n)
                n += 1
                got = fused_attention_step(**kw, valid_len=valid)
                ref = attention_step_reference(**kw, valid_len=valid)
                torch.cuda.synchronize()
                worst[name] = tuple(map(max, worst[name], _check_b2(
                    "attention step (feature form)", got, ref,
                    f"rows {rows} S {S} D{D} H{H} Kl{Kl} valid {valid} {name}")))
                del kw, got, ref
    log("kernel", t0, f"attention_step feature form matches plain version at {n} shapes (rows "
        "{1,10,37,640} x S {83,623,2525} x (D,H,Kl) {(128,128,64),(256,256,128)}, and the "
        "synthetic slice's shapes; x valid {None, S-17}): max abs err "
        + ", ".join(f"{k} {e:.3e} (at most {r:.2f} of its tolerance)"
                    for k, (e, r) in worst.items())
        + f"; tol {B2_TOL[0]:g} abs + {B2_TOL[1]:g} rel")

    cgrid = [(Bs, K, S, D, H, Kl) for D, H, Kl in widths for S in (83, 445, 623, 2525)
             for Bs in (1, 8, 64) for K in (1, 5, 10)]
    cgrid += [shape for shape in main_path if shape not in cgrid]
    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for Bs, K, S, D, H, Kl in cgrid:
            for t in COVERAGE_STEPS:
                kw = coverage_step_inputs(Bs, K, S, D, H, Kl, dtype, t, seed=n)
                for valid in (None, S - 17):
                    n += 1
                    got = coverage_attention_step(**kw, valid_len=valid)
                    ref = coverage_attention_step_reference(**kw, valid_len=valid)
                    torch.cuda.synchronize()
                    worst[name] = tuple(map(max, worst[name], _check_b2(
                        "attention step (coverage form)", got, ref,
                        f"{Bs} samples K {K} S {S} D{D} H{H} Kl{Kl} step {t} valid {valid} "
                        f"{name}")))
                    del got, ref
                del kw
    log("kernel", t0, f"attention_step coverage form matches plain version at {n} shapes "
        "(samples {1,8,64} x K {1,5,10} x S {83,445,623,2525} x (D,H,Kl) {(128,128,64),"
        "(256,256,128)}, and the synthetic slice's shapes; x coverage of step {1,150} x valid "
        "{None, S-17}): max abs err " + ", ".join(
            f"{k} {e:.3e} (at most {r:.2f} of its tolerance)" for k, (e, r) in worst.items())
        + f"; tol {B2_TOL[0]:g} abs + {B2_TOL[1]:g} rel")

    timings = {shape: coverage_step_timing(*shape) for shape in main_path}
    for Bs, K, S, D, H, Kl in main_path:
        log("kernel", t0, f"attention_step (synthetic slice) {timings[Bs, K, S, D, H, Kl]['text']}")
        log("kernel", t0, "attention_step (synthetic slice) "
            + attention_step_timing(Bs * K, S, D, H, Kl)["text"])
    log("kernel", t0, "attention_step (release shape, 64 crops x beam 10) "
        + coverage_step_timing(64, 10, 623, 128, 128, 64)["text"])
    log("kernel", t0, "attention_step (release shape, 64 crops x beam 10) "
        + attention_step_timing(640, 623, 128, 128, 64)["text"])
    # the record: the slice's largest launch (most samples, then longest S)
    rel = timings[max(main_path)]
    return {
        "name": "attention_step", "route": "cuda", "source": B2_SOURCE,
        "replaces": B2_REPLACES, "launches": 0, "max_abs_err": rel["max_abs_err"],
        "ms": rel["ms"], "plain_ms": rel["plain_ms"], "bound_ms": rel["bound_ms"],
        "bound_by": rel["bound_by"], "library_ms": None,
    }


def golden_crops(version: str = "synthetic_tfm_big", quantize=None):
    """The 16 crops of ``version``'s golden file (the int8 one with
    ``quantize``), regenerated from their seeds; their sha256 must match,
    so a numpy difference fails here and not as a parity miss."""
    import hashlib

    import numpy as np

    from doc2tex_tpu_torch.data.synthetic import synth_hard_sample

    with open((GOLDEN_INT8 if quantize else GOLDEN)[version]) as f:
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

    from doc2tex_tpu_torch.ops.attention_step import (
        coverage_attention_step, fused_attention_step)
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.recognition import MathRecognition

    rec = MathRecognition(config, weights_path, beam_size=beam_size, device=device)
    rec(crops)
    if device != "cpu":
        torch.cuda.synchronize()
    decode_attention.launches = fused_attention_step.launches = 0
    coverage_attention_step.launches = 0
    t = time.perf_counter()
    out = rec(crops)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    if rec.model.head == "TFM":
        launches = decode_attention.launches
        steps = launches // (2 * rec.model.predicter.num_layers)
    else:  # the LSTM head: one attention step (coverage form) per decode step
        launches = steps = coverage_attention_step.launches
    return out, launches, steps, seconds


def slice_phase(t0, version, kernel, quantize=None):
    """Decode the golden crops of ``version`` in float32 and bfloat16, with
    ``quantize`` (None or ``int8``) against the matching golden; returns
    (launches of ``kernel``, decode steps) of the float32 run."""
    from doc2tex_tpu_torch.recognition import load_recog_config

    from doc2tex_tpu_torch.eval.metrics import get_single_ED

    golden, crops = golden_crops(version, quantize)
    want = [c["beam10"] for c in golden["crops"]]
    for dtype in ("float32", "bfloat16"):
        cfg, weights = load_recog_config(version=golden["version"])
        cfg["dtype"] = dtype
        cfg["quantize"] = quantize
        out, launches, steps, seconds = run_slice(cfg, weights, crops, 10, "cuda")
        if launches <= 0:
            raise AssertionError(f"{version} {dtype} run launched its kernel {kernel} 0 times")
        misses = [i for i, (a, b) in enumerate(zip(out, want)) if a != b]
        match = len(want) - len(misses)
        chars = sum(get_single_ED(b, a) for a, b in zip(out, want)) / len(want)
        log("slice", t0, f"{version} beam 10 {dtype} quantize {quantize}: {match}/{len(want)} "
            f"equal to the JAX {'int8 ' if quantize else ''}golden (misses at crops {misses}; "
            f"character match {chars:.4f}), {len(crops) / seconds:.2f} crops/s "
            f"({seconds:.3f} s), {steps} decode steps, {launches} {kernel} launches")
        if dtype == "float32" and quantize:
            counted = launches, steps
            check_int8_strings(version, out, chars)
        elif dtype == "float32":
            counted = launches, steps
            if match < MIN_GOLDEN_MATCH:
                raise AssertionError(
                    f"float32 strings equal the golden on {match}/16 < {MIN_GOLDEN_MATCH}: "
                    + "; ".join(f"crop {i}: {out[i]!r} != {want[i]!r}" for i in misses))
    return counted


def int8_clone(layer, dtype, device):
    """A copy of an int8 layer (Conv or Dense) in compute type ``dtype`` on
    ``device``, with the int8 flag set."""
    from doc2tex_tpu_torch.models.layers import Dense
    from doc2tex_tpu_torch.models.resnet import Conv

    bias = layer.bias is not None
    if isinstance(layer, Dense):
        clone = Dense(*layer.kernel.shape, bias=bias, dtype=dtype)
    else:
        cout, cin, kh, kw = layer.kernel.shape
        clone = Conv(cin, cout, (kh, kw), layer.stride, layer.padding, bias=bias, dtype=dtype)
    clone.load_state_dict(layer.state_dict())
    clone.int8 = True
    return clone.to(device)


def int8_op_phase(t0):
    """Every int8 layer of both releases on the card against the same layer
    on the CPU (equal bits), float32 and bfloat16, on the inputs a golden
    crop gives it at the slice's largest bucket; and M <= 16 calls."""
    import torch

    from doc2tex_tpu_torch.models.layers import Dense
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
    from doc2tex_tpu_torch.tools.bench_int8 import call_batches, record_inputs

    def check(layer, x, dtype, where):
        card, cpu = int8_clone(layer, dtype, "cuda"), int8_clone(layer, dtype, "cpu")
        with torch.inference_mode():
            got, want = card(x.to("cuda", dtype)), cpu(x.to("cpu", dtype))
        if not (torch.isfinite(got).all() and torch.equal(got.cpu(), want)):
            err = (got.float().cpu() - want.float()).abs().max().item()
            raise AssertionError(f"int8 {where} {dtype}: card differs from CPU (max {err:.3e})")
        return got.shape

    for version in ("synthetic_tfm_big", "synthetic"):
        cfg, weights = load_recog_config(version=version)   # quantize: int8, bf16, as shipped
        rec = MathRecognition(cfg, weights, beam_size=1)
        _, crops = golden_crops(version)
        batches = call_batches(rec, crops)
        largest = max(batches, key=lambda x: x.shape[1] * x.shape[2])[:1]
        calls = record_inputs(rec.model, [largest])
        small = 0
        for dtype in (torch.float32, torch.bfloat16):
            for name, layer, x in calls:
                check(layer, x, dtype, f"{version} {name} {tuple(x.shape)}")
            for name, layer, x in calls:    # M <= 16: 5 token rows; a 16-patch window
                if isinstance(layer, Dense):
                    check(layer, x.reshape(-1, x.shape[-1])[:5], dtype, f"{name} M 5")
                elif name == "HybridEmbed_0.Conv_0":
                    check(layer, x[:, :, :8, :8], dtype, f"{name} M 16")
                else:
                    continue
                small += 1
        log("int8", t0, f"{version}: {len(calls)} int8 layers x float32, bfloat16 equal the CPU "
            f"bit for bit at the bucket {tuple(largest.shape[1:3])} (batch 1; inputs "
            f"{tuple(calls[0][2].shape)} to {tuple(calls[-1][2].shape)}), and {small} calls at "
            "M <= 16")
        del rec, batches, calls


def serve_phase(t0):
    """The serving entry point on the card: ``--selftest 32`` of the
    shipped ``synthetic`` (int8) in a child process, then the HTTP front in
    this process with one PNG request; returns B2's launches in that
    request."""
    import threading
    from http.client import HTTPConnection
    from http.server import ThreadingHTTPServer

    from doc2tex_tpu_torch.api import serve
    from doc2tex_tpu_torch.ops.attention_step import coverage_attention_step
    from doc2tex_tpu_torch.utils.png import encode_png

    cmd = [sys.executable, "-m", "doc2tex_tpu_torch.api.serve", "--selftest", "32",
           "--model_version", "synthetic"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serve --selftest failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    if stats["completed"] != 32 or stats["errors"] or stats["quantize"] != "int8" \
            or stats["device"] != "cuda":
        raise AssertionError(f"serve --selftest: {stats}")
    log("serve", t0, f"selftest 32 synthetic int8 on cuda: {stats['batches']} batches (avg "
        f"{stats['avg_batch']}), p50 {stats['latency_p50_ms']} ms, p99 "
        f"{stats['latency_p99_ms']} ms, {stats['crops_per_s']} crops/s over {stats['wall_s']} s "
        "(burst; includes the first calls of each bucket)")
    print(json.dumps({"serve_selftest": stats}), file=sys.stderr, flush=True)

    args = serve.parse_args(["--model_version", "synthetic"])
    recog, server = serve.build_server(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(
        server, config_info={"model_version": "synthetic", "beam_size": recog.beam_size}))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        _, crops = golden_crops("synthetic")
        body = encode_png(crops[0])
        replies = []
        for _ in range(2):      # the first request warms the bucket; the second is counted
            coverage_attention_step.launches = 0
            conn = HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
            conn.request("POST", "/recognize", body=body)
            resp = conn.getresponse()
            replies.append((resp.status, json.loads(resp.read())))
            conn.close()
        launches = coverage_attention_step.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=30)
    status, payload = replies[-1]
    if status != 200 or not isinstance(payload.get("latex"), str) or launches <= 0:
        raise AssertionError(f"POST /recognize: {status} {payload}, {launches} B2 launches")
    log("serve", t0, f"HTTP POST /recognize ({len(body)} B PNG) -> 200 in {payload['ms']} ms, "
        f"{launches} attention_step launches: {payload['latex'][:80]!r}")
    return launches


def eval_phase(t0, n_gen=256):
    """The release-eval twin on ``synthetic`` at ``n_gen`` generated samples."""
    from doc2tex_tpu_torch.tools.release_eval import evaluate

    version, rows = evaluate("attn", False, n_gen=n_gen, modes=("bf16", "int8"))
    for mode, row in rows.items():
        log("eval", t0, f"{version} {mode}: EM {row['em']} {row['em_ci95']} at n {row['n']}, "
            f"BLEU {row['bleu']}, char {row['char']}, {row['eval_s']} s (not gated)")


def check_int8_strings(version: str, out, chars: float) -> None:
    """The gate of the float32 int8 run: its strings share at least
    ``INT8_MIN_CHAR_MATCH`` of their characters with the JAX package's int8
    strings (mean match score), and differ from the float32 golden on at
    least ``INT8_MIN_CHANGED`` crops (int8 is in effect).

    Exact agreement cannot be the gate.  The int8 encoder takes one
    activation scale per tensor, its abs-max, so a last-bit difference in
    any float op before an int8 layer (another convolution algorithm,
    another summation order) that moves the largest element moves every
    quantized value of the next layer, and two implementations' int8
    strings part wherever the model is unsure, however exact the int8 ops
    are (one float32 ulp on one weight changes 4 of 16 int8 strings in the
    JAX package itself).  JAX's own float32 and int8 strings share 0.90 of
    their characters on these crops, the port's int8 strings on the CPU
    0.93-0.95 of JAX's int8 ones, a model that reads nothing ~0.5 of the
    labels'."""
    with open(GOLDEN[version]) as f:
        plain = [c["beam10"] for c in json.load(f)["crops"]]
    changed = sum(a != b for a, b in zip(out, plain))
    if chars < INT8_MIN_CHAR_MATCH or changed < INT8_MIN_CHANGED:
        raise AssertionError(
            f"{version} float32 int8: character match {chars:.4f} with the JAX int8 golden "
            f"(need {INT8_MIN_CHAR_MATCH}), {changed} strings differ from the float32 golden "
            f"(need {INT8_MIN_CHANGED})")


@contextlib.contextmanager
def users_tf32():
    """The block runs with cuDNN's TF32 as torch leaves it (USERS_CUDNN_TF32),
    as the app and the server run; TF32 is off again after it."""
    import torch

    torch.backends.cudnn.allow_tf32 = USERS_CUDNN_TF32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def golden_pages():
    """The golden file of the page phases and its pages, regenerated with
    the page-eval twin's generator; their sha256 must match."""
    import hashlib

    import numpy as np

    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    with open(GOLDEN_PAGES) as f:
        golden = json.load(f)
    rng = np.random.default_rng(golden["seed"])
    pages = []
    for g in golden["pages"]:
        page, _, _ = synth_labelled_page(rng)
        if hashlib.sha256(page.tobytes()).hexdigest() != g["sha256"]:
            raise AssertionError(f"page {len(pages)} of seed {golden['seed']} differs from the "
                                 "golden page")
        pages.append(page)
    return golden, pages


def match_boxes(want_boxes, want_scores, got_boxes, got_scores):
    """Pair each golden box with an unpaired box of ours whose corners are
    all within BOX_TOL_PX (the closest); returns (pairs, unmatched), each
    unmatched entry ("jax" or "port", score)."""
    import numpy as np

    want, got = np.asarray(want_boxes, np.float64), np.asarray(got_boxes, np.float64)
    taken = np.zeros(len(got), bool)
    pairs, unmatched = [], []
    for i, box in enumerate(want):
        dist = np.abs(got - box).max(axis=1) if len(got) else np.zeros(0)
        dist[taken] = np.inf
        j = int(np.argmin(dist)) if len(dist) else -1
        if j >= 0 and dist[j] <= BOX_TOL_PX:
            taken[j] = True
            pairs.append((i, j, float(dist[j]), abs(float(got_scores[j]) - want_scores[i])))
        else:
            unmatched.append(("jax", float(want_scores[i])))
    unmatched += [("port", float(got_scores[j])) for j in np.flatnonzero(~taken)]
    return pairs, unmatched


def check_detections(golden, results, conf_thresh):
    """The detect phase's gates over all golden pages: paired boxes within
    BOX_TOL_PX and SCORE_TOL, at most MAX_UNMATCHED unpaired boxes, each
    scored within NEAR_THRESHOLD of ``conf_thresh``.  Returns (pairs,
    worst corner distance, worst score difference, unmatched)."""
    n_pairs, worst_px, worst_score, unmatched = 0, 0.0, 0.0, []
    for g, (boxes, scores) in zip(golden["pages"], results):
        pairs, miss = match_boxes(g["boxes"], g["scores"], boxes, scores)
        n_pairs += len(pairs)
        unmatched += miss
        for _, _, px, ds in pairs:
            worst_px, worst_score = max(worst_px, px), max(worst_score, ds)
    if worst_score > SCORE_TOL:
        raise AssertionError(f"a detection's score differs from the golden by {worst_score:.2e}"
                             f" > {SCORE_TOL}")
    far = [u for u in unmatched if abs(u[1] - conf_thresh) > NEAR_THRESHOLD]
    if len(unmatched) > MAX_UNMATCHED or far:
        raise AssertionError(f"unmatched boxes {unmatched} (at most {MAX_UNMATCHED}, each scored "
                             f"within {NEAR_THRESHOLD} of {conf_thresh})")
    return n_pairs, worst_px, worst_score, unmatched


def check_page_strings(golden, regions_per_page):
    """Page phase (a)'s gate: on every region whose integer box equals the
    golden's, the same string, but at most MAX_PAGE_STRING_MISSES.
    Returns (regions compared, misses)."""
    compared, misses = 0, []
    for p, (g, regions) in enumerate(zip(golden["pages"], regions_per_page)):
        ours = {tuple(box): latex for box, latex in regions}
        for r in g["regions"]:
            if tuple(r["box"]) in ours:
                compared += 1
                if ours[tuple(r["box"])] != r["latex"]:
                    misses.append((p, r["box"], ours[tuple(r["box"])], r["latex"]))
    if len(misses) > MAX_PAGE_STRING_MISSES or compared == 0:
        raise AssertionError(f"page strings: {len(misses)} of {compared} differ from the golden "
                             f"(at most {MAX_PAGE_STRING_MISSES}): {misses}")
    return compared, misses


def detect_phase(t0):
    """The released detector on the golden pages against JAX's boxes, run
    as the app and the server run it (the process's cuDNN TF32 setting as
    torch leaves it) and again with TF32 off in the whole process: the
    boxes must not move.  Then its parts timed on a page."""
    import numpy as np
    import torch

    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
    from doc2tex_tpu_torch.tools.profile_page import detect_timings

    golden, pages = golden_pages()
    det = MathDetector(SHIPPED_WEIGHTS, conf_thresh=golden["conf_thresh"],
                       iou_thresh=golden["nms_iou"], expand_frac=golden["expand_frac"])
    with users_tf32():
        results = [det.detect_page(page) for page in pages]
    n_pairs, worst_px, worst_score, unmatched = check_detections(
        golden, results, golden["conf_thresh"])
    off = [det.detect_page(page) for page in pages]       # TF32 off process-wide (main)
    if not all(np.array_equal(a, b) for r, o in zip(results, off) for a, b in zip(r, o)):
        raise AssertionError("the detector's boxes depend on the process's cuDNN TF32 setting")
    # what the detector's own setting keeps out: its bare forward under the
    # process's TF32 against the path's (printed, not gated)
    x = det.model_input(det.page_windows(pages[0])[0])
    with torch.inference_mode():
        want = det.ssd(x)
        with users_tf32():
            got = det.model(x)
    tf32_diff = max((g - w).abs().max().item() for g, w in zip(got, want))
    log("detect", t0, f"{len(pages)} golden pages ({'x'.join(map(str, golden['page_hw']))}), "
        f"cuDNN TF32 as torch leaves it ({USERS_CUDNN_TF32}): {n_pairs} boxes matched to the JAX "
        f"package's within {worst_px:.4f} px (tol {BOX_TOL_PX}) and scores within "
        f"{worst_score:.2e} (tol {SCORE_TOL}); unmatched {unmatched}; the same bits with TF32 "
        f"off process-wide; SSD512's bare forward under TF32 {USERS_CUDNN_TF32} would differ "
        f"from the path's by up to {tf32_diff:.3e} in loc/conf")
    tm = detect_timings(det, pages[0])
    log("detect", t0, f"page 0 ({tm['windows']} windows, float32, TF32 off): SSD512 forward "
        f"{tm['ssd_ms']:.2f} ms (bound {tm['ssd_bound_ms']:.2f} ms: {tm['ssd_gflop']:.0f} GFLOP "
        f"at {F32_FLOPS / 1e12:.0f} TFLOP/s; achieved {tm['ssd_tflop_per_s']:.1f} TFLOP/s), "
        f"per-window decode + NMS {tm['window_nms_ms']:.2f} ms, page NMS "
        f"{tm['page_nms_ms']:.2f} ms ({tm['page_nms_boxes']} candidates), detect_page whole "
        f"{tm['detect_page_ms']:.2f} ms (host clock)")
    print(json.dumps({"detect_timings": tm}), file=sys.stderr, flush=True)


def page_phase(t0):
    """App with the shared synthetic_tfm_big recognizer: (a) float32 on the
    golden pages (TF32 off process-wide), (b) the page-eval twin against
    the reference's record and (c) POST /recognize_page, both with the
    process's TF32 settings as torch leaves them, as users run them."""
    from doc2tex_tpu_torch.app import App
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
    from doc2tex_tpu_torch.tools.page_eval import evaluate

    golden, pages = golden_pages()
    cfg, weights = load_recog_config(version=golden["recognizer"]["version"])
    cfg["dtype"], cfg["quantize"] = "float32", None
    app = App(recognizer=MathRecognition(cfg, weights, beam_size=golden["recognizer"]["beam"]))
    decode_attention.launches = 0
    t = time.perf_counter()
    regions = [app(page) for page in pages]
    seconds = time.perf_counter() - t
    launches = decode_attention.launches
    compared, misses = check_page_strings(golden, regions)
    if launches <= 0:
        raise AssertionError("the page path launched decode_attention 0 times")
    log("page", t0, f"(a) {len(pages)} golden pages, synthetic_tfm_big float32 beam 10: "
        f"{sum(map(len, regions))} regions, {compared - len(misses)}/{compared} strings equal to "
        f"the JAX package's where the boxes are equal (misses {misses}); {seconds:.2f} s, "
        f"{launches} decode_attention launches ({launches / len(pages):.0f} a page)")

    with open(PAGE_EVAL_REF[0]) as f:
        ref = json.load(f)[PAGE_EVAL_REF[1]]
    with users_tf32():
        row = evaluate(pages=PAGE_EVAL_PAGES, version=ref["version"], coalesce_ratio=0)
    # each of the port's rates inside the reference's Wilson interval
    inside = {k: ref[f"{ci}_ci"][0] <= row[k] <= ref[f"{ci}_ci"][1] for k, ci in (
        ("det_precision", "det_precision"), ("det_recall", "det_recall"),
        ("end_to_end_acc", "end_to_end"))}
    log("page", t0, f"(b) page-eval twin, {row['pages']} pages / {row['gt_regions']} regions, "
        f"quantize {row['quantize']}, beam {row['beam']}, coalesce {row['coalesce_ratio']}: "
        f"precision {row['det_precision']} {row['det_precision_ci']} (reference "
        f"{ref['det_precision']} {ref['det_precision_ci']}), recall {row['det_recall']} "
        f"{row['det_recall_ci']} (reference {ref['det_recall']} {ref['det_recall_ci']}), "
        f"det-F1 {row['det_f1']} (reference {ref['det_f1']}), em_matched {row['em_matched']} "
        f"(reference {ref['em_matched']}), end to end {row['end_to_end_acc']} "
        f"{row['end_to_end_ci']} (reference {ref['end_to_end_acc']} {ref['end_to_end_ci']}); "
        f"detect {row['detect_s_per_page']} s a page, recognize {row['recog_s_per_page']} s a "
        "page (host clock)")
    print(json.dumps({"page_eval": row}), file=sys.stderr, flush=True)
    if not all(inside.values()):
        raise AssertionError(f"page eval outside the reference's interval: {inside}")

    with users_tf32():
        page_request(t0, ref["version"], pages[0])


def page_request(t0, version, page):
    """Page phase (c): the HTTP front with ``--detect`` in this process,
    one PNG page twice; B1 must launch during the second request."""
    import threading
    from http.client import HTTPConnection
    from http.server import ThreadingHTTPServer

    from doc2tex_tpu_torch.api import serve
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.utils.png import encode_png

    args = serve.parse_args(["--model_version", version, "--detect"])
    recog, server = serve.build_server(args)
    page_server = serve.build_page_server(args, recog, server)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(
        server, page_server, config_info={"model_version": version,
                                          "beam_size": recog.beam_size}))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        body = encode_png(page)
        replies = []
        for _ in range(2):      # the first request warms the page's buckets; the second is counted
            decode_attention.launches = 0
            conn = HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=600)
            conn.request("POST", "/recognize_page", body=body)
            resp = conn.getresponse()
            replies.append((resp.status, json.loads(resp.read())))
            conn.close()
        launches = decode_attention.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        page_server.close()
        server.close()
        thread.join(timeout=30)
    status, payload = replies[-1]
    regions = payload.get("regions") or []
    if status != 200 or not regions or launches <= 0 or not all(
            len(r["box"]) == 4 and isinstance(r["latex"], str) for r in regions):
        raise AssertionError(f"POST /recognize_page: {status} {payload}, {launches} B1 launches")
    log("page", t0, f"(c) HTTP POST /recognize_page ({len(body)} B PNG, --detect, int8 as "
        f"shipped) -> 200 in {payload['ms']} ms, {len(regions)} regions, {launches} "
        f"decode_attention launches: {regions[0]}")


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
    global USERS_CUDNN_TF32
    USERS_CUDNN_TF32 = torch.backends.cudnn.allow_tf32
    # float32 means float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log("device", t0, f"{name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    log("device", t0, f"nvidia-smi: {nvidia_smi()}")
    build_kernels(t0)
    tfm_launches, tfm_steps = slice_phase(t0, "synthetic_tfm_big", "decode_attention")
    slice_shapes = tfm_launch_shapes(tfm_steps)
    log("kernel", t0, "decode_attention launch shapes of the synthetic_tfm_big slice "
        f"(B, K, M, live step; None = cross-attention): {slice_shapes}")
    records = [kernel_phase(t0, slice_shapes), attention_step_phase(t0)]
    records[0]["launches"] = tfm_launches
    records[1]["launches"], _ = slice_phase(t0, "synthetic", "attention_step")
    int8_op_phase(t0)
    slice_phase(t0, "synthetic_tfm_big", "decode_attention", quantize="int8")
    slice_phase(t0, "synthetic", "attention_step", quantize="int8")
    serve_phase(t0)
    eval_phase(t0)
    detect_phase(t0)
    page_phase(t0)
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
