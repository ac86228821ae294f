"""LMDB dataset builder CLI (counterpart of ``doc2tex_tpu.tools.lmdb_builder``).

Reference ``createDataset``
(``doc2tex/tools/lmdb_builders/create_lmdb_dataset.py:36-98``): a TSV
manifest (id<TAB>label, an optional header row) and an image folder -> an
LMDB store with PNG image bytes, labels, names, int32 h/w sidecars and the
``num-samples`` key (``data.lmdb_reader.write_lmdb``).  Images are read as
PIL's ``convert("L")`` would read them (``data.lmdb_reader.decode_image``:
PNG and baseline JPEG); other formats raise (ROADMAP A12).

Usage:
    python -m doc2tex_tpu_torch.tools.lmdb_builder --csv labels.tsv \\
        --image_dir imgs/ --out train_data/
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Iterator

import numpy as np

from ..data.lmdb_reader import decode_image, write_lmdb


def iter_manifest(csv_path: str, image_dir: str) -> Iterator[tuple[np.ndarray, str, str]]:
    """(gray image, label, name) of each manifest row whose image exists."""
    with open(csv_path, newline="") as f:
        # QUOTE_NONE: LaTeX labels contain `"`, which csv quoting would
        # merge with the next row
        reader = csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        rows = [r for r in reader if len(r) >= 2]
    if rows and rows[0][0].lower() in ("id", "image", "name"):
        rows = rows[1:]
    for name, label in ((r[0], r[1]) for r in rows):
        path = os.path.join(image_dir, name)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            img = decode_image(f.read(), what=path)
        yield img, label, name


def build(csv_path: str, image_dir: str, out_path: str, map_size: int = 1 << 34) -> int:
    """Pack the manifest's images into a store at ``out_path``; returns the
    number of samples."""
    images, labels, names = [], [], []
    for img, label, name in iter_manifest(csv_path, image_dir):
        images.append(img)
        labels.append(label)
        names.append(name)
    write_lmdb(out_path, images, labels, names, map_size=map_size)
    return len(images)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--csv", required=True, help="id<TAB>label manifest")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out", required=True, help="output LMDB directory")
    p.add_argument("--map_size", type=int, default=1 << 34)
    args = p.parse_args(argv)
    n = build(args.csv, args.image_dir, args.out, args.map_size)
    print(f"wrote {n} samples to {args.out}")


if __name__ == "__main__":
    main()
