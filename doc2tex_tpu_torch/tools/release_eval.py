"""Release-grade accuracy of the port: held-out exact match with Wilson
intervals (the port's twin of the repository's ``tools/release_eval.py``).

    python -m doc2tex_tpu_torch.tools.release_eval --family attn         # `synthetic`
    python -m doc2tex_tpu_torch.tools.release_eval --family tfm          # `synthetic_tfm`
    python -m doc2tex_tpu_torch.tools.release_eval --family tfm --big    # `synthetic_tfm_big`
    python -m doc2tex_tpu_torch.tools.release_eval --long                # `synthetic_long`
        [--n_gen N] [--modes bf16,int8] [--out result.json] [--device cuda]

The same evaluation as the JAX package's: the model configuration the
release was trained with (``tools/structured_soak.py::build`` with
``hard=True``: batch 32, bucket growth 2.2, ragged batches dropped; with
``long=True``: 448x960, ``batch_max_length`` 500, batch 16, growth 4.0),
``--n_gen`` fresh samples drawn with seed 33 (never used in training) from
the hard generator at the soak's operating point, or with ``--long`` from
``synth_long_dataset`` at its defaults, beam 5, every loader batch decoded
as it is, exact match and edit metrics as ``validation`` computes them.
1536 generated hard samples (the default) keep 1440 after the trim; the
768 long samples of ``--long``'s default all keep.

Modes: ``bf16`` (bfloat16, unquantized), ``int8`` (bfloat16 with the int8
encoder, as the releases ship), ``f32`` and ``f32_int8``.  The weights must
fill the model exactly (every leaf used); anything else raises.  Each row
carries the card's name and power limit (nvidia-smi).  Rows are merged
into ``--out`` (default ``doc2tex_tpu_torch/tools/release_eval_cuda.json``)
under the release's name.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

from ..config import make_config
from ..data.loader import ArrayDataset, BucketLoader
from ..data.synthetic import hard_vocab, synth_hard_dataset, synth_long_dataset
from ..decode.runner import make_decode_fn
from ..engine.inferencing import validation
from ..models import build_model
from ..tokenizer.converters import AttnLabelConverter, TFMLabelConverter
from ..weights import load_weights

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_PATH = os.path.join(_ROOT, "doc2tex_tpu_torch", "tools", "release_eval_cuda.json")
# train = 31, curve evals = 32 (structured_soak.py); 33 is held out
EVAL_SEED = 33
# the soak's calibrated operating point (tools/release_eval.py)
GENERATOR = {"min_len": 8, "max_len": 150, "max_h": 220, "max_w": 696, "scale_range": (3, 5)}
BEAM = 5
# the long samples all fall in the 448x960 bucket, so the reference record's
# n 768 is 768 generated
LONG_N_GEN = 768
MODES = {"bf16": ("bfloat16", None), "int8": ("bfloat16", "int8"),
         "f32": ("float32", None), "f32_int8": ("float32", "int8")}


def soak_config(family: str = "attn", big: bool = False, long: bool = False) -> dict:
    """The configuration ``tools/structured_soak.py::build(steps, hard=True,
    family=family, big=big, long=long)`` gives (its training-only keys
    left out)."""
    if family == "tfm":
        prediction = {"name": "TFM", "params": {
            "d_model": 256 if big else 128, "nhead": 8 if big else 4,
            "num_decoder_layers": 6 if big else 3,
            "dim_feedforward": 1024 if big else 512, "dropout": 0.1}}
    else:
        prediction = {"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 256 if big else 128,
            "hidden_size": 256 if big else 128, "kernel_size": 2, "kernel_dim": 64,
            "embed_target": True, "enc_init": True, "attn_type": "coverage",
            "droprate": 0.1}}
    return make_config(dict(
        max_dimension=[448, 960] if long else [224, 704], min_dimension=[32, 32],
        batch_max_length=500 if long else 150, batch_size=16 if long else 32,
        augment=False, keep_smaller_batches=False, bucket_growth=4.0 if long else 2.2,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1,
                         "output_channel": 256 if big else 128, "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 6 if big else 3,
            "num_heads": 8 if big else 4, "hidden_size": 256 if big else 128}},
        Prediction=prediction, beam_size=BEAM,
    ))


def wilson(k: int, n: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score 95 % interval for a binomial proportion."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (round(center - half, 4), round(center + half, 4))


def card() -> dict:
    """The card's name and nvidia-smi's name and power limit."""
    if not torch.cuda.is_available():
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def evaluate(family: str = "attn", big: bool = False, n_gen: int | None = None,
             modes=("bf16", "int8"), device: str = "cuda", long: bool = False
             ) -> tuple[str, dict]:
    """(version, {mode: row}) for one release; ``long`` is the
    ``synthetic_long`` release (the TFM family at the big width).
    ``n_gen`` defaults to 1536, or LONG_N_GEN with ``long``."""
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("release_eval: no CUDA card; pass --device cpu to run on the CPU")
    if long:
        family, big = "tfm", True
    n_gen = n_gen or (LONG_N_GEN if long else 1536)
    version = ("synthetic_long" if long else "synthetic" if family == "attn"
               else "synthetic_tfm_big" if big else "synthetic_tfm")
    weights = os.path.join(_ROOT, "saved_models", "math_recog", version, "best_weights.msgpack")
    cfg = soak_config(family, big, long)
    t0 = time.time()
    if long:
        images, labels = synth_long_dataset(n_gen, seed=EVAL_SEED)
    else:
        images, labels = synth_hard_dataset(n_gen, seed=EVAL_SEED, **GENERATOR)
    print(f"generated {n_gen} samples in {time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    conv = (TFMLabelConverter if family == "tfm" else AttnLabelConverter)(hard_vocab())
    loader = BucketLoader(ArrayDataset(images, labels), cfg)
    rows, models = {}, {}
    for mode in modes:
        dtype, quantize = MODES[mode]
        if dtype not in models:
            model = build_model(dict(cfg, dtype=dtype), conv.num_classes)
            load_weights(model, weights)    # raises unless every leaf fills the model
            models[dtype] = model.to(device).eval()
        model = models[dtype]
        model.set_quantize(quantize)
        decode_fn = make_decode_fn(model, dict(cfg, dtype=dtype), beam_size=BEAM,
                                   device=device)
        t0 = time.time()
        res = validation(decode_fn, conv, loader, cfg)
        n = int(res["n_samples"])
        k = round(res["accuracy"] * n)
        rows[mode] = {
            "version": version, "dtype": dtype, "quantize": quantize, "n": n,
            "em": round(res["accuracy"], 4), "em_ci95": list(wilson(k, n)),
            "bleu": round(res["bleu"], 4), "char": round(res["ED"], 4),
            "word": round(res["word_ED"], 4), "eval_s": round(time.time() - t0, 1),
            # of which decode (host clock around each synchronised batch) and
            # scoring (detokenize, exact match, the Python edit distance)
            "decode_s": round(res["avg_infer_s"] * n, 1),
            "score_s": round(res["avg_postprocess_s"] * n, 1),
            "seed": EVAL_SEED, "n_gen": n_gen, "beam": BEAM, **card(),
        }
        print(f"{version} {mode}: {json.dumps(rows[mode])}", flush=True)
    return version, rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="attn", choices=["attn", "tfm"])
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--long", action="store_true",
                    help="the synthetic_long release on held-out long samples (448x960, up "
                         "to 500 tokens)")
    ap.add_argument("--n_gen", type=int, default=None,
                    help="samples generated: 1536 (the trim to whole batches keeps 1440), "
                         "768 with --long (all in one bucket; the reference's record has n 768)")
    ap.add_argument("--modes", default="bf16,int8", help=f"comma list of {sorted(MODES)}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    unknown = sorted(set(modes) - set(MODES))
    if unknown:
        raise SystemExit(f"unknown modes {unknown}; have {sorted(MODES)}")
    version, rows = evaluate(args.family, args.big, args.n_gen, modes, args.device, args.long)
    merged = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            merged = json.load(f)
    merged.setdefault(version, {}).update(rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({version: rows}))


if __name__ == "__main__":
    main()
