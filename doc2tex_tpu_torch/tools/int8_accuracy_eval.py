"""Accuracy cost of the port's int8 inference modes on the released weights
(the port's twin of the repository's ``tools/int8_accuracy_eval.py``).

    python -m doc2tex_tpu_torch.tools.int8_accuracy_eval [--n_eval 256]
        [--family attn|tfm] [--big] [--modes bf16,int8,int8_full,int8_kv]
        [--weights W] [--device cuda] [--out result.json]

The same evaluation as the JAX tool's: the soak's configuration
(``tools/structured_soak.py::build(100000, hard=True, family, big)``),
``--n_eval`` held-out samples of the hard generator at the soak's
calibrated operating point with seed 32 (the soak's curve set; batch
trimming keeps 160 of 256), beam 5, every loader batch decoded as it is,
``validation``'s metrics.  The released weights by family:
``synthetic`` (attn), ``synthetic_tfm`` (tfm) or ``synthetic_tfm_big``
(tfm ``--big``).  Modes, each on the same bf16 model:

- ``bf16``: unquantized;
- ``int8``: the encoder's gated products in int8 (as the releases ship);
- ``int8_full``: also the decode attention memory in int8 (B2's int8 form
  for the coverage head, B1's int8 K/V form for the cross-attention);
- ``int8_kv``: also the TFM head's self-attention caches in int8 (the parts
  ``encoder, decoder_mem, decoder_kv``; an LSTM head ignores the last).

Each row adds to the JAX tool's keys the sample count, the exact match's
Wilson 95 % interval and the card's name and power limit; the last line
printed is the JSON object of all rows, as the JAX tool prints it.  Rows
are merged into ``--out`` (default
``doc2tex_tpu_torch/tools/int8_eval_cuda.json``) under the release's name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..data.loader import ArrayDataset, BucketLoader
from ..data.synthetic import hard_vocab, synth_hard_dataset
from ..decode.runner import make_decode_fn
from ..engine.inferencing import validation
from ..models import build_model
from ..tokenizer.converters import AttnLabelConverter, TFMLabelConverter
from ..weights import load_weights
from .release_eval import card, wilson
from .structured_soak import HARD_KW, build

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_PATH = os.path.join(_ROOT, "doc2tex_tpu_torch", "tools", "int8_eval_cuda.json")
EVAL_SEED = 32         # the soak's held-out curve set, as the JAX tool uses
BEAM = 5
# mode -> the quantized parts (Model.set_quantize)
MODES = {"bf16": None, "int8": "int8", "int8_full": "int8_full",
         "int8_kv": ("encoder", "decoder_mem", "decoder_kv")}


def release_version(family: str, big: bool) -> str:
    return "synthetic" if family == "attn" else "synthetic_tfm_big" if big else "synthetic_tfm"


def release_weights(family: str, big: bool) -> str:
    return os.path.join(_ROOT, "saved_models", "math_recog", release_version(family, big),
                        "best_weights.msgpack")


def merge_rows(path: str, version: str, rows: dict) -> None:
    """Merge ``rows`` into the JSON file at ``path`` under ``version``."""
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged.setdefault(version, {}).update(rows)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
        f.write("\n")


def evaluate(n_eval: int = 256, family: str = "attn", big: bool = False,
             modes=("bf16", "int8"), weights: str | None = None, device: str = "cuda") -> dict:
    """{mode: row} for the released weights of ``family``/``big``."""
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("int8_accuracy_eval: no CUDA card; pass --device cpu to run on the CPU")
    unknown = sorted(set(modes) - set(MODES))
    if unknown:
        raise SystemExit(f"unknown modes {unknown}; have {sorted(MODES)}")
    weights = weights or release_weights(family, big)
    cfg = build(100000, hard=True, family=family, big=big)
    images, labels = synth_hard_dataset(n_eval, seed=EVAL_SEED, **HARD_KW)
    conv = (TFMLabelConverter if family == "tfm" else AttnLabelConverter)(hard_vocab())
    model = build_model(cfg, conv.num_classes)
    load_weights(model, weights)
    model.to(device).eval()
    print(f"loaded {weights} ({cfg['dtype']}, {device})", file=sys.stderr, flush=True)
    loader = BucketLoader(ArrayDataset(images, labels), cfg, converter=conv, prefetch=0)
    rows = {}
    for mode in modes:
        model.set_quantize(MODES[mode])
        decode_fn = make_decode_fn(model, cfg, beam_size=BEAM, device=device)
        t0 = time.time()
        res = validation(decode_fn, conv, loader, cfg)
        n = int(res["n_samples"])
        rows[mode] = {
            "em": round(res["accuracy"], 4), "bleu": round(res["bleu"], 4),
            "char": round(res["ED"], 4), "word": round(res["word_ED"], 4),
            "eval_s": round(time.time() - t0, 1), "n": n,
            "em_ci95": list(wilson(round(res["accuracy"] * n), n)),
            "parts": list(model.quant_parts or ()), **card(),
        }
        print(f"{mode}: {rows[mode]}", flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_eval", type=int, default=256,
                    help="held-out samples generated (batch trimming keeps 160 of 256)")
    ap.add_argument("--weights", default=None,
                    help="weights file (default: the family's released weights)")
    ap.add_argument("--modes", default="bf16,int8", help=f"comma list of {sorted(MODES)}")
    ap.add_argument("--family", default="attn", choices=["attn", "tfm"])
    ap.add_argument("--big", action="store_true",
                    help="the synthetic_tfm_big release (with --family tfm)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    rows = evaluate(args.n_eval, args.family, args.big, args.modes.split(","), args.weights,
                    args.device)
    merge_rows(args.out, release_version(args.family, args.big), rows)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
