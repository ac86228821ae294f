"""Accuracy gate of serving bucket coalescing on the card (the port's twin
of the repository's ``tools/coalesce_eval.py``).

    python -m doc2tex_tpu_torch.tools.coalesce_eval [--version synthetic_tfm_big]
        [--n 512] [--ratios 4,8,16] [--chunk 64] [--beam N] [--weights W]
        [--profile] [--out result.json] [--device cuda]

Coalescing pads a crop up to a containing bucket (white, top-left) so that
sparse per-bucket groups merge into one decode invocation.  The tool
decodes the same held-out hard crops (``synth_hard_dataset(n, seed=34)``
at the soak's operating point) in server-like chunks of ``--chunk`` crops
with coalescing off and at each ratio, after one warm-up pass with it off,
and reports for each: exact match against the labels with its Wilson 95 %
interval, the share of crops whose prediction equals the off pass's
(``identity``), the decode invocations (calls of
``MathRecognition.decode_group``, one per (bucket, batch)), B1's launches
and the wall time.  ``--profile`` adds, for each row, the first chunk
again under ``torch.profiler`` (device activity): the device's busy time
and B1's device time in that chunk.  The
version block decides the rest (``quantize``, ``dtype``, its beam unless
``--beam``).  Rows are merged into ``--out`` (default
``doc2tex_tpu_torch/tools/coalesce_eval_cuda.json``) under the version's
name, beside the reference record's row (``tools/coalesce_eval_r05.json``)
where it has one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..data.synthetic import synth_hard_dataset
from ..ops.decode_attention import decode_attention
from ..recognition.flow import MathRecognition, load_recog_config, postprocess_prediction
from .release_eval import GENERATOR, card, wilson

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_PATH = os.path.join(_ROOT, "doc2tex_tpu_torch", "tools", "coalesce_eval_cuda.json")
REFERENCE = os.path.join(_ROOT, "tools", "coalesce_eval_r05.json")
EVAL_SEED = 34  # never used by training (31), curves (32) or the release eval (33)


def b1_launches() -> int:
    return decode_attention.launches + decode_attention.int8_launches


def evaluate(recog, images, labels, ratios=(4, 8, 16), chunk: int = 64, warmup: bool = True,
             profile: bool = False) -> tuple[dict, dict]:
    """Decode ``images`` in chunks of ``chunk`` with coalescing off and at
    each of ``ratios``; ``({"off": row, "ratio_<r>": row, ...}, {same keys:
    predictions})``.  A row holds ``em``, ``em_ci95``, ``identity`` (against
    the off pass), ``invocations`` (``decode_group`` calls), ``b1_launches``
    and ``wall_s``; with ``profile`` also ``chunk0_busy_s`` and
    ``chunk0_b1_device_s``, the first chunk once more under
    ``torch.profiler`` (needs a card).  ``recog``'s
    ratio is restored afterwards."""
    gts = [postprocess_prediction(label) for label in labels]
    chunks = [list(images[i:i + chunk]) for i in range(0, len(images), chunk)]
    calls = [0]
    real = recog.decode_group

    def spy(prepped, bucket):
        calls[0] += 1
        return real(prepped, bucket)

    cuda = str(recog.device) != "cpu"

    def run(ratio):
        recog.coalesce_ratio = float(ratio)
        calls[0] = 0
        launches = b1_launches()
        preds = []
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        for i, ch in enumerate(chunks):
            preds.extend(recog(ch))
            print(f"  ratio {ratio:g}: chunk {i + 1}/{len(chunks)}, {calls[0]} invocations, "
                  f"{time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k = sum(p == g for p, g in zip(preds, gts))
        row = {"em": round(k / len(gts), 4), "em_ci95": list(wilson(k, len(gts))),
               "invocations": calls[0], "b1_launches": b1_launches() - launches,
               "wall_s": round(wall, 3)}
        if profile:
            from .profile_slice import _device_us

            # the first chunk only: a whole pass is millions of profiler events
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                recog(chunks[0])
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            row["chunk0_busy_s"] = round(sum(_device_us(e) for e in kernels) / 1e6, 4)
            row["chunk0_b1_device_s"] = round(sum(_device_us(e) for e in kernels
                                                  if "decode_attention" in e.key) / 1e6, 4)
        return preds, row

    saved = recog.coalesce_ratio
    recog.decode_group = spy
    try:
        if warmup:
            run(0.0)   # the first call of each (bucket, batch) picks cuDNN's algorithms
        base, row = run(0.0)
        rows, preds = {"off": dict(row, identity=1.0)}, {"off": base}
        print(f"off: {json.dumps(rows['off'])}", file=sys.stderr, flush=True)
        for r in ratios:
            got, row = run(float(r))
            row["identity"] = round(sum(p == b for p, b in zip(got, base)) / len(got), 4)
            key = f"ratio_{r}"
            rows[key], preds[key] = row, got
            print(f"ratio {r}: {json.dumps(row)}", file=sys.stderr, flush=True)
    finally:
        del recog.decode_group   # the instance attribute goes; the method shows again
        recog.coalesce_ratio = saved
    return rows, preds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", default="synthetic_tfm_big")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--ratios", default="4,8,16")
    ap.add_argument("--chunk", type=int, default=64,
                    help="crops per recognizer call (the server's dispatch batch)")
    ap.add_argument("--beam", type=int, default=None,
                    help="override the version block's beam (the demo's contract is 10)")
    ap.add_argument("--weights", default=None,
                    help="override the version block's weights file")
    ap.add_argument("--profile", action="store_true",
                    help="the first chunk of each row again under torch.profiler: busy and B1 "
                         "device time")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("coalesce_eval: no CUDA card; pass --device cpu to run on the CPU")

    cfg, weights = load_recog_config(version=args.version)
    images, labels = synth_hard_dataset(args.n, seed=EVAL_SEED, **GENERATOR)
    recog = MathRecognition(cfg, weights_path=args.weights or weights, beam_size=args.beam,
                            device=args.device)
    ratios = [int(r) if float(r).is_integer() else float(r) for r in args.ratios.split(",")]
    rows, _ = evaluate(recog, images, labels, ratios, args.chunk, profile=args.profile)
    out = {"version": args.version, "n": len(labels), "beam": recog.beam_size,
           "quantize": cfg.get("quantize"), "dtype": cfg.get("dtype"), "chunk": args.chunk,
           "seed": EVAL_SEED, "weights_override": args.weights, "rows": rows, **card()}
    if os.path.exists(REFERENCE):
        with open(REFERENCE) as f:
            recs = json.load(f)
        ref = recs.get(args.version + "_ft") or recs.get(args.version) or {}
        for key, row in ref.get("rows", {}).items():
            k = round(row["em"] * ref["n"])
            print(f"{key}: EM {rows.get(key, {}).get('em')} (JAX's row {row['em']}, its 95 % "
                  f"interval {list(wilson(k, ref['n']))}), invocations "
                  f"{rows.get(key, {}).get('invocations')} (JAX's {row['invocations']})",
                  flush=True)
    merged = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            merged = json.load(f)
    merged[args.version + ("_ft" if args.weights else "")] = out
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
