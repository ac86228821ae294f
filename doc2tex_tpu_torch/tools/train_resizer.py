"""Train the learned width-bucket resizer on synthetic supervision (the
port's twin of the repository's ``tools/train_resizer.py``).

    python -m doc2tex_tpu_torch.tools.train_resizer [--steps 3000] [--n_train 8192]
        [--n_eval 512] [--batch 256] [--lr 1e-3] [--ordinal_tau 0.7] [--ab_n 128]
        [--out W.msgpack] [--result result.json] [--device cuda]

A hard-benchmark formula is rendered at its native width (the scale the
recognizers were trained at), rescaled by a random factor in 0.4-2.5, and
``models.extras.LearnedResizer`` learns to name the native width bucket
(``round(w / 32) - 1``, 21 buckets) from a 64x64 area probe of the
rescaled crop (``build_dataset``).  The loss is the cross entropy against
Gaussian soft targets over the bucket distance (``--ordinal_tau`` buckets
wide; 0 is the plain one-hot loss); the optimizer optax's ``adamw(lr,
weight_decay=1e-5)`` (``train/optim.py``), the minibatches drawn from a
pool on the device by numpy's seed 5, as the JAX tool draws them.  The
weights start from flax's default initialisers, drawn from numpy's seed 0
(``flax_init``).

Then the held-out bucket accuracy at 2x, the export (float16 parameters,
float32 BatchNorm statistics: the release format; to ``--out``, by default
``build/resizer/best_weights.msgpack``, so that no run changes
``saved_models/``) and the A/B the resizer exists for: ``--ab_n`` held-out
hard crops rescaled 2x, recognised by the released ``synthetic_tfm_big``
(beam 5, as shipped) without and with the resizer's loop.  The result
goes to ``--result`` (default
``doc2tex_tpu_torch/tools/resizer_eval_cuda.json``) with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import _msgpack
from ..data.synthetic import synth_hard_dataset, synth_hard_sample
from ..models.extras import LearnedResizer
from ..train.optim import create_optimizer
from ..transforms.preprocess import _resize_area, learned_resize
from ..weights import load_variables, to_variables
from .release_eval import card

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_PATH = os.path.join(_ROOT, "build", "resizer", "best_weights.msgpack")
RESULT_PATH = os.path.join(_ROOT, "doc2tex_tpu_torch", "tools", "resizer_eval_cuda.json")
BUCKET_PX = 32
N_BUCKETS = 21


def native_bucket(w: int) -> int:
    return int(np.clip(round(w / BUCKET_PX) - 1, 0, N_BUCKETS - 1))


def build_dataset(n: int, seed: int, scale_lo: float = 0.4, scale_hi: float = 2.5):
    """(probes (N, 64, 64, 1) float32, labels (N,) int32, rescaled crops,
    native widths), drawn as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    probes = np.zeros((n, 64, 64, 1), np.float32)
    labels = np.zeros((n,), np.int32)
    crops, widths = [], []
    for i in range(n):
        img, _ = synth_hard_sample(rng, min_len=8, max_len=60, max_h=220, max_w=660,
                                   scale_range=(3, 5))
        h, w = img.shape
        f = float(rng.uniform(scale_lo, scale_hi))
        nh, nw = max(int(round(h * f)), 8), max(int(round(w * f)), 8)
        scaled = _resize_area(img, nh, nw)
        probes[i, ..., 0] = _resize_area(scaled, 64, 64).astype(np.float32)
        labels[i] = native_bucket(w)
        crops.append(scaled)
        widths.append(w)
    return probes, labels, crops, widths


def flax_init(tree: dict, rng: np.random.Generator) -> dict:
    """Variables shaped as ``tree`` (``weights.to_variables``) as flax's
    defaults draw them, from ``rng``: kernels lecun-normal (a normal
    truncated at two standard deviations, variance 1 / fan-in), biases 0,
    BatchNorm scales 1, means 0, variances 1."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = flax_init(leaf, rng)
        elif name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            draw = rng.standard_normal(leaf.shape)
            while (bad := np.abs(draw) > 2).any():
                draw[bad] = rng.standard_normal(int(bad.sum()))
            out[name] = (draw * std).astype(np.float32)
        else:
            fill = 1.0 if name in ("scale", "var") else 0.0
            out[name] = np.full(leaf.shape, fill, np.float32)
    return out


def resizer_loss(model, x: torch.Tensor, y: torch.Tensor, ordinal_tau: float) -> torch.Tensor:
    """The mean training loss of ``model`` (in train mode: batch statistics,
    the running ones updated) on probes ``x`` and buckets ``y``."""
    logits = model(x, train=True)
    logp = F.log_softmax(logits, dim=-1)
    if ordinal_tau > 0:
        d = (torch.arange(N_BUCKETS, device=x.device)[None, :] - y[:, None]).float()
        target = torch.softmax(-(d * d) / (2 * ordinal_tau ** 2), dim=-1)
        return -(target * logp).sum(-1).mean()
    return F.nll_loss(logp, y.long())


def make_step(model, lr: float, ordinal_tau: float):
    """``(step(x, y) -> loss tensor, optimizer state holder)``: one adamw
    update of ``model``'s parameters in place."""
    params = {k: p for k, p in model.named_parameters()}
    tx = create_optimizer({k: p.detach() for k, p in params.items()}, "adamw", lr,
                          weight_decay=1e-5, filter_bias_and_bn=False)
    state = [tx.init({k: p.detach() for k, p in params.items()})]

    def step(x, y):
        loss = resizer_loss(model, x, y, ordinal_tau)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            detached = {k: p.detach() for k, p in params.items()}
            updates, state[0] = tx.update(dict(zip(params, grads)), state[0], detached)
            keys = list(params)
            torch._foreach_add_([detached[k] for k in keys], [updates[k] for k in keys])
        return loss.detach()

    return step, state


def export(model, path: str, steps: int, extra: dict) -> int:
    """Float16 parameters and float32 BatchNorm statistics to ``path`` (flax
    msgpack) and a ``.json`` sidecar; returns the parameter count."""
    variables = to_variables(model)

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.astype(np.float16)
                for k, v in tree.items()}

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _msgpack.save(path, {"step": np.asarray(steps), "params": cast(variables["params"]),
                         "batch_stats": variables["batch_stats"]})
    n_params = sum(p.numel() for p in model.parameters())
    with open(path + ".json", "w") as f:
        json.dump({"params": n_params, "dtype": "float16", **extra}, f, indent=2)
    return n_params


def ab_eval(predict, ab_n: int, device: str) -> dict:
    """EM of the released ``synthetic_tfm_big`` (beam 5) on ``ab_n`` held-out
    crops small enough that twice their size still fits its (224, 704)
    ladder: native, rescaled 2x, and rescaled 2x through
    ``learned_resize(crop, predict)``."""
    from ..recognition.flow import MathRecognition, load_recog_config, postprocess_prediction

    imgs, labels = synth_hard_dataset(ab_n, seed=43, min_len=8, max_len=40, max_h=110,
                                      max_w=340, scale_range=(3, 5))
    scaled = [_resize_area(im, im.shape[0] * 2, im.shape[1] * 2) for im in imgs]
    gts = [postprocess_prediction(label) for label in labels]
    cfg, weights = load_recog_config(version="synthetic_tfm_big")
    recog = MathRecognition(cfg, weights_path=weights, beam_size=5, device=device)

    def em_of(crops):
        preds = []
        for i in range(0, len(crops), 64):
            preds.extend(recog(crops[i:i + 64]))
        return sum(p == g for p, g in zip(preds, gts)) / len(gts)

    return {"n": ab_n, "em_native": round(em_of(imgs), 4),
            "em_2x_plain": round(em_of(scaled), 4),
            "em_2x_resizer": round(em_of([learned_resize(im, predict) for im in scaled]), 4)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--ordinal_tau", type=float, default=0.7,
                    help="Gaussian soft-target width in buckets for the ordinal loss; 0 = "
                         "plain one-hot cross entropy")
    ap.add_argument("--n_train", type=int, default=8192)
    ap.add_argument("--n_eval", type=int, default=512)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=OUT_PATH,
                    help="the exported weights (saved_models/resizer/best_weights.msgpack "
                         "ships them)")
    ap.add_argument("--ab_n", type=int, default=128,
                    help="held-out crops for the recognition EM A/B (0 skips it)")
    ap.add_argument("--result", default=RESULT_PATH)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("train_resizer: no CUDA card; pass --device cpu to run on the CPU")
    device = args.device

    t0 = time.time()
    tx_probe, tx_label, _, _ = build_dataset(args.n_train, seed=41)
    ev_probe, ev_label, _, _ = build_dataset(args.n_eval, seed=42, scale_lo=2.0, scale_hi=2.0)
    data_s = time.time() - t0
    print(f"data built in {data_s:.0f}s; label hist "
          f"{np.bincount(tx_label, minlength=N_BUCKETS)}", file=sys.stderr, flush=True)

    model = LearnedResizer(num_buckets=N_BUCKETS)
    load_variables(model, flax_init(to_variables(model), np.random.default_rng(0)))
    model.to(device)
    step, _ = make_step(model, args.lr, args.ordinal_tau)
    xd = torch.from_numpy(tx_probe).to(device)
    yd = torch.from_numpy(tx_label).to(device)
    rng = np.random.default_rng(5)
    losses = []
    t0 = time.time()
    for it in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, len(tx_label), args.batch)).to(device)
        loss = step(xd[idx], yd[idx])
        if it == 0 or (it + 1) % 500 == 0:
            losses.append((it + 1, float(loss)))
            print(f"[{it + 1}] loss {losses[-1][1]:.4f} "
                  f"({(it + 1) / (time.time() - t0):.1f} steps/s)", flush=True)
    if device != "cpu":
        torch.cuda.synchronize()
    train_s = time.time() - t0

    model.eval()

    @torch.inference_mode()
    def infer(x: np.ndarray) -> np.ndarray:
        return model(torch.from_numpy(x).to(device)).argmax(-1).cpu().numpy()

    pred = np.concatenate([infer(ev_probe[i:i + 256]) for i in range(0, len(ev_probe), 256)])
    acc = float((pred == ev_label).mean())
    acc1 = float((np.abs(pred - ev_label) <= 1).mean())
    print(f"eval@2x: bucket acc {acc:.4f}, ±1-bucket {acc1:.4f}", flush=True)
    n_params = export(model, args.out, args.steps,
                      {"bucket_acc_2x": acc, "bucket_acc1_2x": acc1, "steps": args.steps,
                       "n_train": args.n_train})
    print(f"exported {args.out} ({n_params} params)", flush=True)

    result = {"bucket_acc_2x": round(acc, 4), "bucket_acc1_2x": round(acc1, 4)}
    if args.ab_n:
        def predict(img):
            return int(infer(_resize_area(img, 64, 64).astype(np.float32)[None, ..., None])[0])

        t = time.time()
        result.update(ab_eval(predict, args.ab_n, device))
        result["ab_s"] = round(time.time() - t, 1)
        print(f"A/B: native {result['em_native']:.4f} | 2x plain {result['em_2x_plain']:.4f} "
              f"| 2x + resizer {result['em_2x_resizer']:.4f}", flush=True)
    result.update(ordinal_tau=args.ordinal_tau, steps=args.steps, batch=args.batch,
                  losses=losses, data_s=round(data_s, 1), train_s=round(train_s, 2),
                  steps_per_s=round(args.steps / train_s, 2) if train_s else None, **card())
    if args.result:
        os.makedirs(os.path.dirname(args.result) or ".", exist_ok=True)
        with open(args.result, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
