"""Visual inspection of rendered-image evaluations (the port's twin of
the repository's ``tools/inspect_images.py``).

    python -m doc2tex_tpu_torch.tools.inspect_images merge PRED_DIR GOLD_DIR OUT_DIR
    python -m doc2tex_tpu_torch.tools.inspect_images split UNMATCH_LIST INPUT_DIR [--rm-input]

``merge`` stacks each gold render above the same-named prediction render
(right-padded to one width) into a compare sheet (the reference's
``merge_img.py``); ``split`` copies renders into ``match/`` and
``un_match/`` beside the input folder by the evaluator's unmatched list
(``split_image_folder.py``), deleting the input only with ``--rm-input``.
Renders are read by ``utils.png.decode_png(rgb=True)`` and sheets written
by ``utils.png.encode_png`` (PIL's bytes are not needed: the pixels equal
PIL's).  Host code only.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

import numpy as np

from ..utils.png import decode_png, encode_png


def vstack_autopad(images, pad_value: int = 0) -> np.ndarray:
    """Stack images vertically, each right-padded to the widest; (H, W)
    and (H, W, C) mix, grey repeated to the most channels."""
    arrs = [np.asarray(im) for im in images]
    if not arrs:
        raise ValueError("no images to stack")
    max_c = max(1 if a.ndim == 2 else a.shape[2] for a in arrs)
    max_w = max(a.shape[1] for a in arrs)
    rows = []
    for a in arrs:
        if a.ndim == 2 and max_c > 1:
            a = np.repeat(a[:, :, None], max_c, axis=2)
        pad = [(0, 0), (0, max_w - a.shape[1])] + ([(0, 0)] if a.ndim == 3 else [])
        rows.append(np.pad(a, pad, constant_values=pad_value))
    return np.vstack(rows)


def _read_rgb(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), rgb=True)


def build_compare_sheets(pred_dir, gold_dir, out_dir) -> int:
    """A gold-over-prediction sheet in ``out_dir`` for every gold render
    with a same-named prediction render; a file that fails is skipped.
    Returns the sheet count."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(gold_dir)):
        pred_path = Path(pred_dir) / name
        if not pred_path.exists():
            continue
        try:
            sheet = vstack_autopad((_read_rgb(Path(gold_dir) / name), _read_rgb(pred_path)))
            (out_dir / name).write_bytes(encode_png(sheet))
            n += 1
        except Exception as exc:  # noqa: BLE001 -- a file at a time, as the reference
            print(f"skip {name}: {exc}", file=sys.stderr)
    return n


def split_by_match(list_file, input_dir, rm_input: bool = False) -> dict:
    """Copy the renders of ``input_dir`` into ``match``/``un_match`` beside
    it by the unmatched list (a path or name a line); ``{"match": n,
    "un_match": n}``."""
    input_dir = Path(input_dir)
    unmatch_dir, match_dir = input_dir.parent / "un_match", input_dir.parent / "match"
    unmatch_dir.mkdir(exist_ok=True)
    match_dir.mkdir(exist_ok=True)
    with open(list_file) as f:
        un_match = {os.path.basename(line.strip()) for line in f if line.strip()}
    counts = {"match": 0, "un_match": 0}
    for name in os.listdir(input_dir):
        src = input_dir / name
        if not src.is_file():
            continue
        kind = "un_match" if name in un_match else "match"
        shutil.copy(src, (unmatch_dir if kind == "un_match" else match_dir) / name)
        counts[kind] += 1
    if rm_input:
        shutil.rmtree(input_dir)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge", help="gold-over-pred compare sheets")
    m.add_argument("pred_dir")
    m.add_argument("gold_dir")
    m.add_argument("out_dir")
    s = sub.add_parser("split", help="split renders into match/un_match")
    s.add_argument("unmatch_list")
    s.add_argument("input_dir")
    s.add_argument("--rm-input", action="store_true",
                   help="delete input_dir afterwards (the reference's behaviour)")
    args = ap.parse_args(argv)
    if args.cmd == "merge":
        n = build_compare_sheets(args.pred_dir, args.gold_dir, args.out_dir)
        print(f"wrote {n} compare sheets to {args.out_dir}")
    else:
        counts = split_by_match(args.unmatch_list, args.input_dir, rm_input=args.rm_input)
        print(f"match: {counts['match']}  un_match: {counts['un_match']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
