"""Inference / evaluation CLI of the port, with the flags of ``api/infer.py``:

    python -m doc2tex_tpu_torch.api.infer --config <cfg.yaml> --data_dir imgs/ \\
        --csv_dir labels.tsv --log_path out/ [--batch_size 32] [--beam_size 10] \\
        [--int8 | --int8-full] [--amp] [--strong_log] [--device cuda|cpu]

Evaluates a model over a TSV manifest (``name<TAB>label``, an optional
header row) and an image folder, over the LMDB store that the config's
``eval_data`` names (``data.loader.LmdbDataset``, images as stored), or
over ``synthetic_data: N`` flat synthetic samples of the config, and
reports exact match, BLEU-4, char and word NED match, time and memory;
with ``--log_path`` it writes ``predictions.csv`` (name, pred, label, ed,
iscorrect) and ``metrics.json``.
Images go through the same bucket ladder and batches as the JAX package's
CLI (``data.loader.BucketLoader``, every batch decoded as it is), so
``quantize: int8`` takes the same per-batch activation scales.
``--int8-full`` (``quantize: int8_full``) also keeps the decode attention
memory in int8, through the int8 forms of B1 and B2 on the card.

Images are PNGs, read by ``utils.png.decode_png`` (PIL's ``convert("L")``
bytes; the card's machine has no PIL).  ``--resizer`` runs each manifest
image through the learned width resizer first (``make_resizer_hook``).  What
is not ported raises, naming its ROADMAP item: JPEG images (A11) and
``--platform`` (a JAX switch; the port takes ``--device``).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import resource
import time

import numpy as np
import torch

from ..config import load_config
from ..data.loader import ArrayDataset, BucketLoader, LmdbDataset
from ..decode.runner import make_decode_fn
from ..engine.inferencing import validation
from ..models import build_model
from ..models.extras import LearnedResizer
from ..ops.quant import parts_for_mode
from ..tokenizer.converters import create_converter
from ..train.checkpoint import load_pretrained_variables
from ..train.trainer import param_count
from ..transforms.preprocess import _resize_area, learned_resize, resize_for_inference
from ..utils.png import decode_png
from ..weights import load_variables, random_variables, to_variables

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHIPPED_RESIZER = os.path.join(_ROOT, "saved_models", "resizer", "best_weights.msgpack")


def make_resizer_hook(config, device="cuda"):
    """The learned width-bucket resizer as a hook ``img_u8 -> img_u8``
    (``learned_resize`` driven by a ``LearnedResizer`` of
    ``resizer_buckets`` classes, default 21, over the crop resized to 64x64,
    its raw 0-255 values).  Its weights (parameters and BatchNorm
    statistics) come from the config's ``resizer_weights``, else from
    ``saved_models/resizer/best_weights.msgpack`` where that exists, else a
    seeded init: ``weights.random_variables`` of numpy's seed 0, the same
    weights with every torch.  The model runs on ``device``; the hook
    carries it as ``hook.model``."""
    model = LearnedResizer(num_buckets=config.get("resizer_buckets", 21))
    weights = config.get("resizer_weights") or (
        SHIPPED_RESIZER if os.path.exists(SHIPPED_RESIZER) else None)
    if weights:
        load_pretrained_variables(weights, model)
    else:
        load_variables(model, random_variables(to_variables(model), np.random.default_rng(0)))
    model.to(device).eval()

    @torch.inference_mode()
    def predict(img):
        x = torch.from_numpy(_resize_area(img, 64, 64).astype("float32"))[None, ..., None]
        return int(model(x.to(device)).argmax(-1)[0])

    def hook(img):
        return learned_resize(img, predict)

    hook.model = model
    return hook


def load_csv_dataset(csv_dir: str, data_dir: str, config, resize_hook=None) -> ArrayDataset:
    """TSV manifest (name<TAB>label) + image folder -> ArrayDataset of
    images resized for inference (after ``resize_hook``, the learned
    resizer, where given).  Rows whose image is missing are skipped; a
    first row whose name is ``id``, ``image`` or ``name`` is a header."""
    images, labels, names = [], [], []
    with open(csv_dir, newline="") as f:
        # QUOTE_NONE: LaTeX labels contain `"`, which csv quoting would
        # merge with the next row
        reader = csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        rows = [r for r in reader if len(r) >= 2]
    if rows and rows[0][0].lower() in ("id", "image", "name"):
        rows = rows[1:]
    for name, label in ((r[0], r[1]) for r in rows):
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            img = decode_png(f.read())
        if resize_hook is not None:
            img = resize_hook(img)
        images.append(resize_for_inference(img, config))
        labels.append(label)
        names.append(name)
    return ArrayDataset(images, labels, names)


def run_infer(config, dataset, log_path: str | None = None, device="cuda") -> dict:
    """Decode ``dataset`` with the config's model on ``device`` and return
    ``validation``'s metrics with the run's time, images per second,
    parameter count (millions) and peak host memory."""
    parts_for_mode(config.get("quantize"))      # refuses an unknown mode, early
    converter = create_converter(config)
    config["num_class"] = converter.num_classes
    with torch.random.fork_rng(devices=[]):     # a seeded init that leaves the caller's RNG
        torch.manual_seed(0)
        model = build_model(config, converter.num_classes)
    if config.get("saved_model"):
        info = load_pretrained_variables(config["saved_model"], model)
        print(f"loaded weights: {info}")
    model.to(device).eval()
    loader = BucketLoader(dataset, config, converter=converter,
                          prefetch=int(config.get("prefetch", 2)))
    decode_fn = make_decode_fn(model, config, beam_size=int(config.get("beam_size", 1)),
                               device=device)
    t0 = time.time()
    result = validation(decode_fn, converter, loader, config,
                        export_csv=(os.path.join(log_path, "predictions.csv")
                                    if log_path else None))
    elapsed = time.time() - t0
    n = max(result["n_samples"], 1)
    result["total_time_s"] = elapsed
    result["avg_infer_time_s"] = elapsed / n
    result["images_per_sec"] = n / elapsed
    result["params_M"] = param_count(model) / 1e6
    result["peak_mem_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--csv_dir", default=None, help="CSV manifest (id\\tlabel)")
    parser.add_argument("--data_dir", default=None, help="Image folder")
    parser.add_argument("--log_path", default=None)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--beam_size", type=int, default=None)
    parser.add_argument("--start_idx", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=-1,
                        help="host prefetch depth (reference DataLoader workers); -1 = default")
    parser.add_argument("--strong_log", action="store_true", default=False,
                        help="print every sample's gt/pred line")
    parser.add_argument("--amp", action="store_true", default=False,
                        help="bf16 compute dtype (already the config default)")
    parser.add_argument("--resizer", action="store_true", default=False)
    parser.add_argument("--int8", action="store_true", default=False,
                        help="int8 dynamic-quant encoder (ops/quant.py)")
    parser.add_argument("--int8-full", action="store_true", default=False,
                        help="--int8 plus int8 decode attention memory")
    parser.add_argument("--platform", default=None, help="a JAX platform; use --device")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.platform:
        raise NotImplementedError("--platform picks a JAX platform and is not ported; "
                                  "the port takes --device cuda|cpu")
    config = load_config(args.config)
    config["batch_size"] = args.batch_size
    if args.beam_size is not None:
        config["beam_size"] = args.beam_size
    if args.amp:
        config["dtype"] = "bfloat16"
    if args.int8:
        config["quantize"] = "int8"
    if args.int8_full:
        config["quantize"] = "int8_full"
    if args.num_workers >= 0:
        config["prefetch"] = args.num_workers

    if args.csv_dir and args.data_dir:
        hook = make_resizer_hook(config, device=args.device) if args.resizer else None
        dataset = load_csv_dataset(args.csv_dir, args.data_dir, config, hook)
    elif config.get("eval_data") and os.path.isdir(config["eval_data"]):
        dataset = LmdbDataset(config["eval_data"], rgb=config.get("rgb", False))
    elif config.get("synthetic_data"):
        from ..data.synthetic import synth_dataset

        images, labels = synth_dataset(int(config["synthetic_data"]), seed=7)
        dataset = ArrayDataset(images, labels)
    else:
        parser.error("need --csv_dir/--data_dir, or eval_data/synthetic_data in config")

    if args.log_path:
        os.makedirs(args.log_path, exist_ok=True)
    result = run_infer(config, dataset, args.log_path, device=args.device)
    if args.strong_log:
        for name, gt, pred in result.get("samples", []):
            print(f"[{name}] {'OK ' if pred == gt else 'ERR'} gt={gt!r} pred={pred!r}")
    if args.log_path:
        with open(os.path.join(args.log_path, "metrics.json"), "w") as f:
            json.dump({k: v for k, v in result.items() if isinstance(v, (int, float))},
                      f, indent=2)

    print(f"samples:        {result['n_samples']}")
    print(f"exact match:    {result['accuracy']:.4f}")
    print(f"BLEU-4:         {result['bleu']:.4f}")
    print(f"char NED match: {result['ED']:.4f}")
    print(f"word NED match: {result['word_ED']:.4f}")
    print(f"images/sec:     {result['images_per_sec']:.2f}")
    print(f"avg time/image: {result['avg_infer_time_s']*1000:.1f} ms")
    print(f"avg infer:      {result.get('avg_infer_s', 0)*1000:.1f} ms")
    print(f"avg postproc:   {result.get('avg_postprocess_s', 0)*1000:.1f} ms")
    print(f"peak mem:       {result['peak_mem_mb']:.0f} MB")


if __name__ == "__main__":
    main()
