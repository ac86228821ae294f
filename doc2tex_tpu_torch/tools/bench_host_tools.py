"""Host-side timings of the reference's tools in the port (no card needed;
run it where the numbers are wanted).

    python -m doc2tex_tpu_torch.tools.bench_host_tools [--jpeg] [--images N]
        [--reps 5] [--out result.json]

``--jpeg``: the committed 1,700 x 2,200 page (``tests/torch_port_jpeg/
page_2200x1700.jpg``, 4:2:0, quality 90) decoded to grey by the native
library (``utils.jpeg.decode_jpeg``, the median of ``--reps``), by its
plain Python version (``decode_jpeg_py``, once), and the same page's grey
pixels as a PNG (``encode_png``) through ``decode_png`` (the median of
``--reps``).  ``--images N``: ``tools.evaluate_images.merge_image_metrics``
over N generated gold/prediction render pairs (hard synthetic crops, seed
44; every third prediction the gold render, every third one column of ink
lighter, the rest another crop), written as PNGs to a temporary
directory: the wall time and the metrics.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import statistics
import tempfile
import time

import numpy as np

from ..utils.jpeg import decode_jpeg, decode_jpeg_py
from ..utils.png import decode_png, encode_png
from .release_eval import card

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PAGE = os.path.join(_ROOT, "tests", "torch_port_jpeg", "page_2200x1700.jpg")


def _median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def bench_jpeg(reps: int = 5) -> dict:
    with open(PAGE, "rb") as f:
        data = f.read()
    gray = decode_jpeg(data)
    png = encode_png(gray)
    t = time.perf_counter()
    plain = decode_jpeg_py(data)
    plain_s = time.perf_counter() - t
    if not np.array_equal(plain, gray):
        raise AssertionError("the plain version's page differs from the native one's")
    return {"page": os.path.relpath(PAGE, _ROOT), "shape": list(gray.shape),
            "jpeg_bytes": len(data), "png_bytes": len(png),
            "native_s": _median_s(lambda: decode_jpeg(data), reps),
            "plain_s": plain_s,
            "png_s": _median_s(lambda: decode_png(png), reps)}


def bench_images(n: int) -> dict:
    from ..data.synthetic import synth_hard_sample
    from .evaluate_images import merge_image_metrics

    rng = np.random.default_rng(44)
    with tempfile.TemporaryDirectory() as d:
        gold_dir, pred_dir = os.path.join(d, "gold"), os.path.join(d, "pred")
        os.makedirs(gold_dir)
        os.makedirs(pred_dir)
        rows = []
        for i in range(n):
            gold, label = synth_hard_sample(rng, max_h=110, max_w=340)
            if i % 3 == 0:
                pred = gold
            elif i % 3 == 1:
                pred = gold.copy()
                col = int(np.argmax((gold < 128).sum(axis=0)))
                pred[:, col] = np.maximum(pred[:, col], 200)
            else:
                pred, _ = synth_hard_sample(rng, max_h=110, max_w=340)
            name = f"f{i:05d}.png"
            for directory, img in ((gold_dir, gold), (pred_dir, pred)):
                with open(os.path.join(directory, name), "wb") as f:
                    f.write(encode_png(img))
            rows.append([name, label, label, "0.0", "1"])
        csv_path = os.path.join(d, "results.csv")
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "pred", "label", "ed", "iscorrect"])
            w.writerows(rows)
        t = time.perf_counter()
        agg = merge_image_metrics(gold_dir, pred_dir, csv_path, os.path.join(d, "log"))
        seconds = time.perf_counter() - t
    return {"n": n, "wall_s": seconds, "ms_a_pair": 1e3 * seconds / n,
            **{k: agg[k] for k in ("accuracy_w_space", "accuracy_wo_space",
                                   "image_edit_distance")}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jpeg", action="store_true")
    ap.add_argument("--images", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = {"host_cpus": os.cpu_count(), **card()}
    if args.jpeg:
        result["jpeg"] = bench_jpeg(args.reps)
    if args.images:
        result["evaluate_images"] = bench_images(args.images)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
