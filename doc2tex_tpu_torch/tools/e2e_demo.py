"""End-to-end demonstration on the card: train, keep the best checkpoint,
reload it through the infer path, batched beam decode (the port's twin of
the repository's ``tools/e2e_demo.py``).

    python -m doc2tex_tpu_torch.tools.e2e_demo [--steps 16000] [--n_train 4096]
        [--n_eval 64] [--log_dir build/e2e_demo] [--device cuda]

The same model as the JAX tool's: a hybrid ViT 128x3 over a ResNet
backbone and the ``Attnv2`` coverage head (hidden 128, kernel_dim 64), 64x512
crops, ``batch_max_length`` 24, batch 32 with augmentation, adamw (lr
1e-3, weight decay 2e-6, a one-epoch warmup to ``min_lr`` 1e-4) for
``--steps`` steps on ``synth_dataset(n_train, seed=21)``, validated every
``steps // 8`` steps (greedy, on ``synth_dataset(n_eval, seed=22)``) by the
best-metric keeper (``train/checkpoint.BestCheckpointKeeper``).  Its best
checkpoint by exact match is reloaded into a fresh model
(``load_pretrained_variables``) and decoded: the train subset greedily,
the held-out set with beam 5, reporting exact match, BLEU, character
match and crops/s (host clock around the decode, after a warm-up pass).
On the card every decode step of the coverage head runs B2, and every
training step its backward; the launches are printed.  JAX's own record
(200k steps on a TPU) is a different run, not a target.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..config import make_config
from ..data.loader import ArrayDataset, BucketLoader
from ..data.synthetic import SYNTH_VOCAB, synth_dataset
from ..decode.runner import make_decode_fn
from ..engine.inferencing import validation
from ..models import build_model
from ..ops import attention_step as b2
from ..tokenizer.converters import AttnLabelConverter
from ..train.checkpoint import BestCheckpointKeeper, load_pretrained_variables
from ..train.trainer import create_train_state, criterion_from_config, make_train_step
from .release_eval import card

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOG_DIR = os.path.join(_ROOT, "build", "e2e_demo")
SAMPLE_KW = {"max_len": 12, "max_h": 56}


def demo_config(steps: int):
    """The JAX tool's configuration for a run of ``steps`` steps."""
    return make_config(dict(
        max_dimension=[64, 512], min_dimension=[32, 32], batch_max_length=24,
        batch_size=32, augment=True,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1,
                         "output_channel": 128, "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 3, "num_heads": 4,
            "hidden_size": 128}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 128, "hidden_size": 128,
            "kernel_size": 2, "kernel_dim": 64, "embed_target": True,
            "enc_init": True, "attn_type": "coverage", "droprate": 0.1}},
        criterion={"name": "entropy"},
        optimizer={"opt": "adamw", "lr": 0.001, "weight_decay": 0.000002},
        num_iter=steps, valInterval=max(steps // 8, 1),
        warmup_epochs=1, min_lr=0.0001, beam_size=5,
    ))


def b2_launches() -> tuple[int, int]:
    """(forward, backward) launches of B2's coverage form so far."""
    return (b2.coverage_attention_step.launches + b2.coverage_attention_step.int8_launches,
            b2.coverage_attention_step_backward.launches)


def run(steps: int = 16000, n_train: int = 4096, n_eval: int = 64, device: str = "cuda",
        log_dir: str = LOG_DIR, reload: str = "best_accuracy", cfg=None) -> dict:
    """Train, keep, reload and evaluate (see the module docstring).  ``cfg``
    replaces the demo's configuration (a test's tiny one); ``reload`` names
    the kept file to reload.  Returns the result dict, with the in-memory
    and the reloaded models under ``"models"``."""
    cfg = cfg or demo_config(steps)
    tr_images, tr_labels = synth_dataset(n_train, seed=21, **SAMPLE_KW)
    ev_images, ev_labels = synth_dataset(n_eval, seed=22, **SAMPLE_KW)
    conv = AttnLabelConverter(SYNTH_VOCAB)
    loader = BucketLoader(ArrayDataset(tr_images, tr_labels), cfg, conv, train=True)
    print(f"train {loader.num_samples} samples / {len(loader.table)} buckets", flush=True)
    tr_eval = BucketLoader(ArrayDataset(tr_images[:64], tr_labels[:64]), cfg, conv)
    eval_loader = BucketLoader(ArrayDataset(ev_images, ev_labels), cfg, conv)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg, conv.num_classes)
    model.to(device)
    state, tx = create_train_state(model, cfg)
    step = make_train_step(model, criterion_from_config(cfg), tx, cfg)
    greedy = make_decode_fn(model, cfg, beam_size=1, device=device)
    keeper = BestCheckpointKeeper(log_dir)
    generator = torch.Generator().manual_seed(7)
    fwd0, bwd0 = b2_launches()
    t0, it, losses = time.time(), 0, []
    for batch in loader.infinite():
        m = step(state, batch.images, batch.text, generator)
        it += 1
        if it % 500 == 0 or it == 1:
            losses.append((it, float(m["loss"])))
            print(f"[{it}] loss {losses[-1][1]:.4f} tok_acc {float(m['token_acc']):.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if it % cfg["valInterval"] == 0 or it == steps:
            val = validation(greedy, conv, eval_loader, cfg)
            saved = keeper.update(state, it, val)
            print(f"validation @ {it}: greedy EM {val['accuracy']:.3f} BLEU {val['bleu']:.3f}; "
                  f"saved {saved}", flush=True)
        if it >= steps:
            break
    if device != "cpu":
        torch.cuda.synchronize()
    train_s = time.time() - t0
    fwd, bwd = (a - b for a, b in zip(b2_launches(), (fwd0, bwd0)))

    path = os.path.join(log_dir, f"{reload}.msgpack")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)    # another init: the reload must overwrite every leaf
        fresh = build_model(cfg, conv.num_classes)
    info = load_pretrained_variables(path, fresh)
    fresh.to(device)
    print(f"reload {path}: {info}", flush=True)
    res_tr = validation(make_decode_fn(fresh, cfg, beam_size=1, device=device), conv,
                        tr_eval, cfg)
    print(f"TRAIN-SUBSET greedy: EM {res_tr['accuracy']:.3f}", flush=True)
    beam = make_decode_fn(fresh, cfg, beam_size=5, device=device)
    validation(beam, conv, eval_loader, cfg)   # warm-up: each bucket's first call
    if device != "cpu":
        torch.cuda.synchronize()
    b2_before = b2_launches()[0]
    t = time.time()
    res = validation(beam, conv, eval_loader, cfg)
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.time() - t
    result = {
        "steps": it, "train_s": round(train_s, 1), "steps_per_s": round(it / train_s, 2),
        "losses": losses, "reloaded": path, "train_subset_greedy_em": round(res_tr["accuracy"], 4),
        "n_eval": res["n_samples"], "em": round(res["accuracy"], 4),
        "bleu": round(res["bleu"], 4), "char": round(res["ED"], 4),
        "crops_per_s": round(res["n_samples"] / dt, 2),
        "b2_forward_launches_train": fwd, "b2_backward_launches_train": bwd,
        "b2_launches_beam_eval": b2_launches()[0] - b2_before, **card()}
    print(f"HELD-OUT beam=5: EM {res['accuracy']:.3f} BLEU {res['bleu']:.3f} charNED "
          f"{res['ED']:.3f} ({res['n_samples']} samples, {res['n_samples'] / dt:.1f} img/s)",
          flush=True)
    print("E2E DEMO OK" if res["accuracy"] > 0.5 else
          "E2E DEMO INCOMPLETE (needs more steps; see the module docstring)", flush=True)
    return dict(result, models=(model, fresh), config=cfg, converter=conv,
                eval_images=ev_images)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16000)
    ap.add_argument("--n_train", type=int, default=4096)
    ap.add_argument("--n_eval", type=int, default=64)
    ap.add_argument("--log_dir", default=LOG_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("e2e_demo: no CUDA card; pass --device cpu to run on the CPU")
    out = run(args.steps, args.n_train, args.n_eval, args.device, args.log_dir)
    result = {k: v for k, v in out.items()
              if k not in ("models", "config", "converter", "eval_images")}
    print(json.dumps(result), file=sys.stdout, flush=True)
    return result


if __name__ == "__main__":
    main()
