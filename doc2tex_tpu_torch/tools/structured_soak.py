"""Convergence soak of the port (twin of ``tools/structured_soak.py``): trains
a recognizer on generated data from device pools and logs a held-out beam-5
exact-match curve at checkpoints.

    python -m doc2tex_tpu_torch.tools.structured_soak [--hard] [--family attn|tfm]
        [--attn coverage|loc_aware] [--big] [--long] [--steps N] [--resume]
        [--init_from saved_models/math_recog/synthetic/best_weights.msgpack]
        [--lr 1e-4] [--ckpt_dir DIR] [--tag_suffix S] [--device cpu]

Without ``--hard`` it is the structured arm: the ``structured`` grammar
(``data.synthetic.synth_structured_dataset``: nested frac/sqrt/scripts/
matrix over the flat vocabulary) on 160x448 canvases, ``batch_max_length``
48, batch 48, the train augmentation on.  ``--hard`` is the recipe of the
shipped ``synthetic`` release
(``demo/recog_cfg.yaml``: ViT 128x3 on a 128-channel ResNet, the ``Attnv2``
coverage head at hidden 128 and ``kernel_dim`` 64, batch 32, 224x704,
``batch_max_length`` 150, the hard vocabulary); ``--family tfm``, ``--big``
and ``--long`` are the other arms, ``build`` copies their configs.  The
run: generate ``--n_train`` and ``--n_eval`` samples (seeds 31 and 32),
upload each bucket's samples to the device once (``data.device_pool``), take
one training step per pool in pool order (the JAX soak's precompile pass;
the steps train, so they stay), then steps on the pools' schedule, with a
beam-5 validation (``engine.inferencing.validation``) every
``--eval_every`` steps and at the end.  Each validation prints a ``CURVE``
line, appends it to ``<tag>_curve.jsonl`` in the checkpoint directory
(default ``/tmp/<tag>_soak_torch``), and saves ``last.msgpack`` there
(``best.msgpack`` when the exact match is the best so far); ``--resume``
continues from ``last.msgpack``.  ``--init_from`` loads the parameters and
the BatchNorm statistics of a weights file (the optimizer starts fresh);
``--eval_first`` validates once before the first step.

Not ported: ``--gcb`` (the GlobalContext backbone) raises naming ROADMAP
A6.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import make_config
from ..data.device_pool import build_device_pools, make_pool_step, pool_schedule
from ..data.loader import ArrayDataset, BucketLoader
from ..data.synthetic import (SYNTH_VOCAB, hard_vocab, synth_hard_dataset,
                              synth_long_dataset, synth_structured_dataset)
from ..decode.runner import make_decode_fn
from ..engine.inferencing import validation
from ..models import build_model
from ..tokenizer.converters import AttnLabelConverter, TFMLabelConverter
from ..train.checkpoint import load_checkpoint, load_pretrained_variables, save_checkpoint
from ..train.trainer import create_train_state, criterion_from_config, make_train_step

HARD_KW = {"min_len": 8, "max_len": 150, "max_h": 220, "max_w": 696, "scale_range": (3, 5)}
STRUCTURED_KW = {"min_len": 4, "max_len": 44, "max_h": 156, "max_w": 440}


def build(steps: int, hard: bool = False, attn: str = "coverage", gcb: bool = False,
          family: str = "attn", big: bool = False, long: bool = False) -> dict:
    """The soak's config, as ``tools/structured_soak.build`` makes it."""
    return make_config(dict(
        max_dimension=[448, 960] if long else [224, 704] if hard else [160, 448],
        min_dimension=[32, 32],
        batch_max_length=500 if long else 150 if hard else 48,
        batch_size=16 if long else 32 if hard else 48,
        augment=not hard,
        keep_smaller_batches=False,
        bucket_growth=4.0 if long else 2.2,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1,
                         "output_channel": 256 if big else 128, "gcb": gcb},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 6 if big else 3,
            "num_heads": 8 if big else 4,
            "hidden_size": 256 if big else 128}},
        Prediction=(
            {"name": "TFM", "params": {
                "d_model": 256 if big else 128, "nhead": 8 if big else 4,
                "num_decoder_layers": 6 if big else 3,
                "dim_feedforward": 1024 if big else 512, "dropout": 0.1}}
            if family == "tfm" else
            {"name": "Attnv2", "params": {
                "seqmodel": "TFM",
                "input_size": 256 if big else 128,
                "hidden_size": 256 if big else 128,
                "kernel_size": 2, "kernel_dim": 64, "embed_target": True,
                "enc_init": True, "attn_type": attn, "droprate": 0.1}}
        ),
        criterion={"name": "entropy"},
        optimizer={"opt": "adamw", "lr": 0.0005 if big else 0.001,
                   "weight_decay": 0.000002},
        num_iter=steps, valInterval=min(25000, max(steps // 4, 500)),
        warmup_epochs=0.4 if hard else 1,
        min_lr=0.0001, beam_size=5,
    ))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600000)
    ap.add_argument("--n_train", type=int, default=16384)
    ap.add_argument("--n_eval", type=int, default=256)
    ap.add_argument("--eval_every", type=int, default=25000)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--hard", action="store_true",
                    help="the hard benchmark: the hard vocabulary, 3 fonts, render noise, "
                    "len <= 150, 224x704 canvases (the shipped synthetic recipe)")
    ap.add_argument("--attn", default="coverage", choices=["coverage", "loc_aware"])
    ap.add_argument("--gcb", action="store_true", help="not ported (ROADMAP A6)")
    ap.add_argument("--family", default="attn", choices=["attn", "tfm"])
    ap.add_argument("--big", action="store_true",
                    help="256x6 encoder and a 6-layer TFM head (or width-256 LSTM head)")
    ap.add_argument("--long", action="store_true",
                    help="448x960 canvases, batch_max_length 500, half multi-line long "
                    "samples (with --hard --family tfm --big)")
    ap.add_argument("--overpad_prob", type=float, default=0.0)
    ap.add_argument("--overpad_ratio", type=float, default=4.0)
    ap.add_argument("--pad_jitter", type=int, default=0)
    ap.add_argument("--lr", type=float, default=None,
                    help="override the arm's base lr (fine-tunes want ~1e-4)")
    ap.add_argument("--init_from", default=None,
                    help="warm start: parameters and BatchNorm statistics of a weights file")
    ap.add_argument("--ckpt_dir", default=None,
                    help="checkpoint directory (default /tmp/<tag>_soak_torch)")
    ap.add_argument("--tag_suffix", default="")
    ap.add_argument("--eval_first", action="store_true",
                    help="validate once before the first step (a warm start's baseline)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run_tag(args) -> str:
    if args.gcb:
        raise NotImplementedError("--gcb: the GlobalContext backbone is not ported yet "
                                  "(ROADMAP A6)")
    if not args.hard:     # the structured arm: one tag whatever its family or size
        return "structured" + args.tag_suffix
    tag = "hard" + ("" if args.attn == "coverage" else "_" + args.attn)
    if args.family == "tfm":
        tag = "hard_tfm"
    if args.big:
        tag += "_big"
    if args.long:
        tag += "_long"
    return tag + args.tag_suffix


def arm_config(args) -> dict:
    """``build``'s config with the command line's overrides."""
    cfg = build(args.steps, hard=args.hard, attn=args.attn, gcb=args.gcb, family=args.family,
                big=args.big, long=args.long)
    if args.lr is not None:
        cfg["optimizer"]["lr"] = args.lr
        cfg["min_lr"] = min(cfg.get("min_lr", args.lr), args.lr / 5)
    if args.overpad_prob > 0:
        cfg["overpad_prob"] = args.overpad_prob
        cfg["overpad_ratio"] = args.overpad_ratio
    if args.pad_jitter > 0:
        cfg["pad_jitter"] = args.pad_jitter
    return cfg


def soak_data(args):
    """(train images, labels, eval images, labels) of the arm."""
    if args.long:
        n_half = args.n_train // 2
        li, ll = synth_long_dataset(n_half, seed=31)
        hi, hl = synth_hard_dataset(args.n_train - n_half, seed=31, **HARD_KW)
        ev_images, ev_labels = synth_long_dataset(args.n_eval, seed=32)
        return li + hi, ll + hl, ev_images, ev_labels
    gen, kw = ((synth_hard_dataset, HARD_KW) if args.hard
               else (synth_structured_dataset, STRUCTURED_KW))
    tr_images, tr_labels = gen(args.n_train, seed=31, **kw)
    ev_images, ev_labels = gen(args.n_eval, seed=32, **kw)
    return tr_images, tr_labels, ev_images, ev_labels


def run(args) -> dict:
    """The soak; returns its curve rows (with each validation's sample
    count ``n``) and the pools."""
    tag = run_tag(args)
    ckpt_dir = args.ckpt_dir or f"/tmp/{tag}_soak_torch"
    curve_path = os.path.join(ckpt_dir, f"{tag}_curve.jsonl")
    device = args.device
    cfg = arm_config(args)
    tr_images, tr_labels, ev_images, ev_labels = soak_data(args)
    vocab = hard_vocab() if (args.hard or args.long) else list(SYNTH_VOCAB)
    conv = TFMLabelConverter(vocab) if args.family == "tfm" else AttnLabelConverter(vocab)
    loader = BucketLoader(ArrayDataset(tr_images, tr_labels), cfg, converter=conv, train=True)
    print(f"train {loader.num_samples} samples / {len(loader.table)} buckets; "
          f"vocab {conv.num_classes}", flush=True)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg, conv.num_classes)
    state, tx = create_train_state(model.to(device), cfg)
    if args.init_from:
        info = load_pretrained_variables(args.init_from, state.model)
        print(f"warm-started from {args.init_from}: {info}", flush=True)
    start = 0
    ckpt = os.path.join(ckpt_dir, "last.msgpack")
    if args.resume and os.path.exists(ckpt):
        state, meta = load_checkpoint(ckpt, state)
        start = int(meta.get("iter", 0))
        print(f"resumed from {ckpt} @ {start}", flush=True)
    step = make_train_step(state.model, criterion_from_config(cfg), tx, cfg)
    eval_loader = BucketLoader(ArrayDataset(ev_images, ev_labels), cfg, converter=conv)
    decode_fn = make_decode_fn(state.model, cfg, beam_size=5, device=device)
    os.makedirs(ckpt_dir, exist_ok=True)

    best_em = -1.0
    if args.resume and os.path.exists(curve_path):
        with open(curve_path) as f:
            for line in f:
                try:
                    best_em = max(best_em, json.loads(line).get("em", -1.0))
                except ValueError:
                    pass
    curve: list[dict] = []

    def run_eval(it, t0, save=True):
        nonlocal best_em
        res = validation(decode_fn, conv, eval_loader, cfg)
        row = {"step": it, "em": round(res["accuracy"], 4), "bleu": round(res["bleu"], 4),
               "char": round(res["ED"], 4), "word": round(res["word_ED"], 4),
               "elapsed_s": round(time.time() - t0)}
        print("CURVE " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        curve.append(dict(row, n=res["n_samples"]))
        with open(curve_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if not save:
            return
        save_checkpoint(ckpt, state, {"iter": it, "best_bleu": res["bleu"],
                                      "best_acc": res["accuracy"]})
        if res["accuracy"] > best_em:
            best_em = res["accuracy"]
            save_checkpoint(os.path.join(ckpt_dir, "best.msgpack"), state,
                            {"iter": it, "best_acc": res["accuracy"]})

    if args.eval_first:
        run_eval(start, time.time(), save=False)
    t0 = time.time()
    pools = build_device_pools(loader, conv, cfg, device=device)
    print(f"device pools: {len(pools)} buckets, {sum(p.n for p in pools)} samples, "
          f"{sum(p.images.numel() for p in pools) / 1e6:.0f} MB pixels, "
          f"upload {time.time() - t0:.0f}s", flush=True)
    pool_step = make_pool_step(step, cfg["batch_size"])

    # one real step per pool, in pool order (the JAX soak's precompile pass)
    gen = torch.Generator(device=device).manual_seed(7)
    t0 = time.time()
    for i, p in enumerate(pools):
        tc = time.time()
        float(pool_step(state, gen, p.images, p.text))
        print(f"precompile {p.bucket} pool={p.n}: {time.time() - tc:.0f}s "
              f"({i + 1}/{len(pools)})", flush=True)
    print(f"precompile done in {time.time() - t0:.0f}s", flush=True)

    t0 = time.time()
    it = start
    for bi in pool_schedule(pools, cfg["batch_size"], np.random.default_rng(5)):
        p = pools[int(bi)]
        pending = pool_step(state, gen, p.images, p.text)
        it += 1
        if it % 100 == 0:
            rate = (it - start) / max(time.time() - t0, 1e-9)
            print(f"[{it}] loss {float(pending):.4f} ({rate:.1f} steps/s)", flush=True)
        if it % 5000 == 0 and it % args.eval_every:
            save_checkpoint(ckpt, state, {"iter": it})
        if it % args.eval_every == 0:
            run_eval(it, t0)
        if it >= args.steps:
            break
    if it % args.eval_every:
        run_eval(it, t0)
    print("DONE", flush=True)
    return {"curve": curve, "pools": pools}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
