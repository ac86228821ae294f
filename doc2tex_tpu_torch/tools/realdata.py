"""Real-data chain of the port (the twin of ``tools/realdata.py``):
fetch -> mine -> render -> package -> lmdb -> train.

    python -m doc2tex_tpu_torch.tools.realdata --stage mine [--work DIR]
    python -m doc2tex_tpu_torch.tools.realdata --stage package --synthetic_fallback
    python -m doc2tex_tpu_torch.tools.realdata --stage lmdb
    python -m doc2tex_tpu_torch.tools.realdata --stage train --config config/train.yaml \\
        --steps 4 [--device cpu]

Every stage reads and writes under ``--work`` (default ``realdata`` in the
system's temporary directory, ``tempfile.gettempdir()``).  Each stage
reports whether it ran, or what blocks it:

- ``fetch`` downloads im2latex-100k or the im2markup lists (the JAX
  tool's probe, as it is; it needs a network).
- ``mine``: ``.tex`` sources -> demacro -> ``find_math`` ->
  normalize/validate -> ``formulas.norm.lst`` (``latex.normalize`` with the
  native tokenizer; ``tools/data/sample_paper.tex`` by default).
- ``render`` (TeX to PNG) is not ported (ROADMAP A11) and raises.
- ``package`` converts the im2markup lists (``--im2markup_dir``) to
  ``labels_<split>.tsv``, or with ``--synthetic_fallback`` writes
  ``--n`` hard-benchmark synthetic PNGs (seed 77) and ``labels.tsv``:
  plumbing only, not real data.
- ``lmdb``: ``labels.tsv`` + ``imgs/`` -> ``lmdb/``
  (``tools.lmdb_builder``, the reference's key schema); with ``--valid_n``
  also ``lmdb_valid/`` of the manifest's first N rows.
- ``train`` writes ``train_realdata.yaml`` pointing at the store (the JAX
  tool's small config, or ``--config`` with its data, vocabulary and
  iteration keys replaced) and runs ``python -m
  doc2tex_tpu_torch.api.train`` on it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FETCH_URLS = [
    # im2latex-100k raw (reference README.md:129)
    "https://zenodo.org/record/56198/files/formula_images.tar.gz",
    # im2markup preprocessed (reference README.md:129)
    "https://im2markup.yuntiandeng.com/data/im2latex_formulas.norm.lst",
]
FALLBACK_SEED = 77


def stage_fetch(work: str) -> bool:
    os.makedirs(work, exist_ok=True)
    import urllib.request

    ok = False
    for url in FETCH_URLS:
        dst = os.path.join(work, os.path.basename(url))
        try:
            print(f"fetch {url} ...", flush=True)
            urllib.request.urlretrieve(url, dst)
            print(f"  -> {dst} ({os.path.getsize(dst)} bytes)")
            ok = True
        except Exception as e:
            print(f"  BLOCKED: {type(e).__name__}: {e}")
    if not ok:
        print("fetch BLOCKED: no network. On a networked machine the two URLs above are "
              "the only inputs the rest of the chain needs.")
    return ok


def stage_mine(work: str, tex_glob: str) -> str:
    """tex -> mined, normalized formulas.  Returns the .lst path."""
    from ..latex.normalize import normalize_file
    from .arxiv import mine_document

    os.makedirs(work, exist_ok=True)
    paths = sorted(glob.glob(tex_glob))
    if not paths:
        sys.exit(f"mine: no .tex files match {tex_glob}")
    raw = []
    for p in paths:
        with open(p, errors="ignore") as f:
            raw.extend(mine_document(f.read()))
    print(f"mine: {len(paths)} documents -> {len(raw)} raw formulas")
    normed = list(normalize_file(raw))
    out = os.path.join(work, "formulas.norm.lst")
    with open(out, "w") as f:
        f.write("\n".join(normed) + "\n")
    print(f"mine: {len(normed)} normalized+validated -> {out}")
    if not normed:
        sys.exit("mine: normalization dropped everything; inspect the inputs")
    return out


def stage_render(work: str, formulas_path: str) -> None:
    raise NotImplementedError("render: TeX rendering (tools/render.py) is not ported yet "
                              "(ROADMAP A11); package --synthetic_fallback or --im2markup_dir")


def stage_package_im2markup(work: str, im2markup_dir: str) -> None:
    """Convert preprocessed im2markup lists to ``labels_<split>.tsv``: a
    formulas file with one normalized formula per line, and per split a
    list of ``<image_name> <formula_line_idx>`` (or ``<idx> <name> <mode>``)."""
    formulas_path = None
    for cand in ("im2latex_formulas.norm.lst", "formulas.norm.lst", "im2latex_formulas.lst"):
        p = os.path.join(im2markup_dir, cand)
        if os.path.exists(p):
            formulas_path = p
            break
    if formulas_path is None:
        sys.exit(f"package: no formulas list in {im2markup_dir}")
    with open(formulas_path, errors="ignore") as f:
        formulas = f.read().split("\n")
    for split in ("train", "validate", "test"):
        lst = None
        for cand in (f"im2latex_{split}_filter.lst", f"im2latex_{split}.lst"):
            p = os.path.join(im2markup_dir, cand)
            if os.path.exists(p):
                lst = p
                break
        if lst is None:
            continue
        rows = []
        with open(lst) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                a, b = parts[0], parts[1]
                name, idx = (a, b) if not a.isdigit() else (b, a)
                try:
                    label = formulas[int(idx)].strip()
                except (ValueError, IndexError):
                    continue
                if label:
                    if not os.path.splitext(name)[1]:
                        name += ".png"
                    rows.append((name, label))
        out = os.path.join(work, f"labels_{split}.tsv")
        with open(out, "w") as f:
            for name, label in rows:
                f.write(f"{name}\t{label}\n")
        print(f"package: {split} {len(rows)} rows -> {out}")


def stage_package_fallback(work: str, n: int = 512) -> None:
    """Stand-in images: ``n`` hard-benchmark synthetic PNGs (seed 77) and
    their manifest, on the file path real renders take.  Plumbing only: NOT
    real data."""
    from ..data.synthetic import synth_hard_dataset
    from ..utils.png import encode_png

    imgs, labels = synth_hard_dataset(n, seed=FALLBACK_SEED)
    img_dir = os.path.join(work, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    with open(os.path.join(work, "labels.tsv"), "w") as f:
        for i, (img, label) in enumerate(zip(imgs, labels)):
            name = f"fb{i:06d}.png"
            with open(os.path.join(img_dir, name), "wb") as g:
                g.write(encode_png(img))
            f.write(f"{name}\t{label}\n")
    print(f"package: SYNTHETIC-FALLBACK {n} images -> {img_dir} (plumbing validation only)")


def stage_lmdb(work: str, valid_n: int = 0) -> str:
    """``labels.tsv`` + ``imgs/`` -> ``lmdb/`` (and with ``valid_n`` the
    first ``valid_n`` rows -> ``lmdb_valid/``).  Returns the store's path."""
    from .lmdb_builder import build

    tsv = os.path.join(work, "labels.tsv")
    img_dir = os.path.join(work, "imgs")
    if not (os.path.exists(tsv) and os.path.isdir(img_dir)):
        sys.exit(f"lmdb: need {tsv} + {img_dir} (run render or package)")
    out = os.path.join(work, "lmdb")
    n = build(tsv, img_dir, out)
    print(f"lmdb: {n} samples -> {out}")
    if valid_n:
        with open(tsv) as f:
            rows = f.readlines()[:valid_n]
        head = os.path.join(work, "labels_valid.tsv")
        with open(head, "w") as f:
            f.writelines(rows)
        n = build(head, img_dir, os.path.join(work, "lmdb_valid"))
        print(f"lmdb: {n} samples -> {os.path.join(work, 'lmdb_valid')}")
    return out


def _yaml_scalar(value) -> str:
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    return "null" if value is None else repr(value)


def override_yaml(text: str, overrides: dict) -> str:
    """``text`` (a config) with each top-level scalar key of ``overrides``
    dropped and set again at the end."""
    keep = [line for line in text.splitlines()
            if not (m := re.match(r"([A-Za-z_][\w]*)\s*:", line)) or m.group(1) not in overrides]
    return "\n".join(keep + [f"{k}: {_yaml_scalar(v)}" for k, v in overrides.items()]) + "\n"


SMALL_CONFIG = """# written by doc2tex_tpu_torch.tools.realdata (the schema of train_synth.yaml)
character: []
max_dimension: [224, 704]
min_dimension: [32, 32]
batch_max_length: 150
keep_smaller_batches: True
mean: 0.5
std: 0.5
augment: True
batch_size: 8
bucket_growth: 2.2

FeatureExtraction:
  name: 'None'

SequenceModeling:
  name: 'ViT'
  params:
    backbone:
      name: 'resnet'
      input_channel: 1
      output_channel: 128
      gcb: False
    fix_embed: True
    input_channel: 1
    patching_style: '2d'
    patch_size: [2, 2]
    depth: 2
    num_heads: 4
    hidden_size: 128

Prediction:
  name: 'Attnv2'
  params:
    seqmodel: 'TFM'
    input_size: 128
    hidden_size: 128
    kernel_size: 2
    kernel_dim: 64
    embed_target: True
    enc_init: True
    attn_type: 'coverage'
    droprate: 0.1

criterion:
  name: 'entropy'

optimizer:
  opt: 'adamw'
  lr: 0.0003
  weight_decay: 0.000002

grad_clip: 5.0
logInterval: 20
manualSeed: 1111
"""


def train_config(work: str, steps: int, vocab: str, config: str | None = None,
                 val_interval: int | None = None) -> str:
    """Write ``train_realdata.yaml``: the JAX tool's small config, or
    ``config``'s text, with the store as ``train_data`` (and
    ``lmdb_valid/``, where the lmdb stage wrote it, as ``valid_data``),
    ``vocab`` and ``steps`` iterations, validating every ``val_interval``
    (by default at half and at the end) and at the end.  Returns its path."""
    lmdb_path = os.path.join(work, "lmdb")
    valid = os.path.join(work, "lmdb_valid")
    overrides = dict(train_data=lmdb_path, valid_data=valid if os.path.isdir(valid) else lmdb_path,
                     vocab=vocab, num_iter=steps, early_stop=steps,
                     valInterval=val_interval or max(steps // 2, 1))
    text = SMALL_CONFIG
    if config:
        with open(config) as f:
            text = f.read()
    path = os.path.join(work, "train_realdata.yaml")
    with open(path, "w") as f:
        f.write(override_yaml(text, overrides))
    return path


def stage_train(work: str, steps: int, vocab: str, config: str | None = None,
                device: str = "cuda", val_interval: int | None = None,
                in_process: bool = False) -> None:
    """Train on the store through ``python -m doc2tex_tpu_torch.api.train``
    (in a child process, or with ``in_process`` through its ``main``)."""
    if not os.path.isdir(os.path.join(work, "lmdb")):
        sys.exit("train: no LMDB yet; run the lmdb stage first")
    cfg_path = train_config(work, steps, vocab, config, val_interval)
    argv = ["--config", cfg_path, "--log_dir", os.path.join(work, "run"), "--device", device]
    print(f"train: {cfg_path} ({os.path.relpath(config, REPO) if config else 'small config'}, "
          f"{steps} steps, {device})")
    t0 = time.time()
    if in_process:
        from ..api import train

        train.main(argv)
        rc = 0
    else:
        rc = subprocess.call([sys.executable, "-m", "doc2tex_tpu_torch.api.train", *argv],
                             cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    print(f"train: rc={rc} in {time.time() - t0:.0f}s -> {os.path.join(work, 'run')}")
    if rc:
        sys.exit(rc)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default="all",
                    choices=["all", "fetch", "mine", "render", "package", "lmdb", "train"])
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "realdata"))
    ap.add_argument("--tex_glob", default=os.path.join(REPO, "tools", "data", "*.tex"))
    ap.add_argument("--im2markup_dir", default=None,
                    help="directory with preprocessed im2markup lists; package converts them "
                    "instead of local renders")
    ap.add_argument("--synthetic_fallback", action="store_true",
                    help="package synthetic stand-in images (validates plumbing, NOT real "
                    "accuracy)")
    ap.add_argument("--n", type=int, default=512, help="synthetic fallback images")
    ap.add_argument("--valid_n", type=int, default=0,
                    help="also store the manifest's first N rows as the validation store")
    ap.add_argument("--config", default=None,
                    help="train this config (its data, vocab and iteration keys replaced) "
                    "instead of the small one")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for train")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--val_interval", type=int, default=None,
                    help="validate every N steps (default: at half and at the end)")
    ap.add_argument("--vocab", default=os.path.join(REPO, "saved_models", "math_recog",
                                                    "version2", "vocab.txt"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    w, stage = args.work, args.stage
    report = {}
    if stage in ("all", "fetch"):
        report["fetch"] = "ran" if stage_fetch(w) else "BLOCKED(network)"
    if stage in ("all", "mine"):
        stage_mine(w, args.tex_glob)
        report["mine"] = "ran"
    if stage == "render":
        stage_render(w, os.path.join(w, "formulas.norm.lst"))
    if stage == "all":
        report["render"] = "not ported (ROADMAP A11)"
    if stage in ("all", "package"):
        if args.im2markup_dir:
            stage_package_im2markup(w, args.im2markup_dir)
            report["package"] = "ran(im2markup)"
        elif os.path.exists(os.path.join(w, "labels.tsv")):
            report["package"] = "ran(rendered)"
        elif args.synthetic_fallback:
            stage_package_fallback(w, args.n)
            report["package"] = "ran(SYNTHETIC-FALLBACK)"
        else:
            print("package: no rendered images and no --im2markup_dir; pass "
                  "--synthetic_fallback to exercise the downstream stages")
            report["package"] = "skipped"
    if stage in ("all", "lmdb"):
        if os.path.exists(os.path.join(w, "labels.tsv")):
            stage_lmdb(w, args.valid_n)
            report["lmdb"] = "ran"
        else:
            report["lmdb"] = "skipped(no images)"
    if stage in ("all", "train"):
        if os.path.isdir(os.path.join(w, "lmdb")):
            stage_train(w, args.steps, args.vocab, args.config, args.device,
                        args.val_interval)
            report["train"] = "ran"
        else:
            report["train"] = "skipped(no lmdb)"
    print("REALDATA REPORT " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
