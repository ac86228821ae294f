"""SSD detection soak of the port (twin of ``tools/detection_soak.py``):
trains SSD512 with the MultiBox train step on generated GTDB-style pages,
then scores held-out pages through detect (and, for ``bars``/``mixed``,
the voting stitch) with CROHME's coarse/fine detection scores.

    python -m doc2tex_tpu_torch.tools.detection_soak [--steps 400] [--batch 8]
        [--n_eval 8] [--save PATH] [--style bars|mixed|windows] [--neg_frac 0.18]
        [--init_from saved_models/math_detect/best_weights.msgpack] [--device cuda]

As the JAX tool: SSD512 from a seeded init (or ``--init_from``'s
parameters), Adam at 1e-4 (``train.optim.adam``, optax's arithmetic), a pool
of 256 windows (``build_pool``, generator seed 0) made on the host as float32
(N, 512, 512, 3) with the mean pixel taken off and uploaded to the device
once (805 MB), and each step's batch drawn on the device from the pool.
The pool's windows are ``synth_page`` pages (``bars``: noise bars;
``mixed``: hard and structured formula renders) or, with ``windows``,
random 512x512 windows cut from 1024x1280 labelled pages
(``window_sample``), ``--neg_frac`` of them without a box.  The train step
(``detection.data.make_detection_train_step``) takes the mean pixel off
again, as the JAX tool's step does with the same pool.  The held-out
evaluation (generator seed 99, ``conf_thresh`` 0.3, NMS IoU 0.3) scores
each window (``windows``) or each page after ``stitch_page(algorithm="max",
thresh_votes=0.5)``.  ``--save`` writes a flax msgpack with a ``.json``
sidecar (``train.checkpoint.save_checkpoint``, the JAX tool's keys), which
the JAX package's ``MathDetector(weights_path=...)`` loads.

The batch indices are a ``torch.Generator``'s draws on the device (seed
1), not ``jax.random``'s: the same seed gives other batches than the JAX
tool's.  The pool, the held-out set and the seeded init's role are the
same; the init itself is torch's.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..data.synthetic import synth_hard_sample, synth_structured_sample
from ..detection.boxes import batched_detect
from ..detection.data import detection_input, make_detection_train_step, window_targets
from ..detection.evaluate import crohme_detection_scores
from ..detection.priors import MATH_GTDB_512, make_priors
from ..detection.ssd import SSD512
from ..detection.stitch import stitch_page
from ..train.checkpoint import load_pretrained_params, save_checkpoint
from ..train.optim import adam
from ..train.trainer import TrainState, named_params, param_count
from .page_eval import synth_labelled_page

N_POOL = 256
WINDOW = 512
POOL_SEED, STEP_SEED, EVAL_SEED = 0, 1, 99
LR = 1e-4
EVAL_CONF, EVAL_IOU = 0.3, 0.3
DEFAULT_SAVE = os.path.join(tempfile.gettempdir(), "det_soak_torch", "last.msgpack")


def synth_page(rng: np.random.Generator, size: int = WINDOW, max_regions: int = 4,
               style: str = "bars"):
    """One (image uint8 (S, S), boxes (K, 4) normalized corner) page.
    ``bars``: dense noise bars of ink; ``mixed``: hard-benchmark and
    structured formula renders, half and half, 8 px apart."""
    img = np.full((size, size), 255, np.uint8)
    boxes = []
    k = int(rng.integers(1, max_regions + 1))
    for _ in range(k):
        if style == "mixed":
            if rng.random() < 0.5:
                patch_img, _ = synth_hard_sample(rng, min_len=4, max_len=22, max_h=120,
                                                 max_w=400, scale_range=(3, 5))
            else:
                patch_img, _ = synth_structured_sample(rng, min_len=3, max_len=20, max_h=120,
                                                       max_w=400)
            h, w = patch_img.shape
            if h > size - 8 or w > size - 8:
                continue
            placed = False
            for _try in range(10):
                y = int(rng.integers(0, size - h))
                x = int(rng.integers(0, size - w))
                box = (x, y, x + w, y + h)
                if all(box[2] + 8 <= b[0] or box[0] >= b[2] + 8
                       or box[3] + 8 <= b[1] or box[1] >= b[3] + 8
                       for b in (tuple(int(v * size) for v in bb) for bb in boxes)):
                    placed = True
                    break
            if not placed:
                continue
            img[y:y + h, x:x + w] = np.minimum(img[y:y + h, x:x + w], patch_img)
        else:
            h = int(rng.integers(20, 60))
            w = int(rng.integers(80, 300))
            y = int(rng.integers(0, size - h))
            x = int(rng.integers(0, size - w))
            # formula-ish ink: a dense bar with random gaps
            patch = (rng.random((h, w)) < 0.6).astype(np.uint8)
            img[y:y + h, x:x + w][patch > 0] = int(rng.integers(0, 60))
        boxes.append([x / size, y / size, (x + w) / size, (y + h) / size])
    return img, np.asarray(boxes, np.float32)


def window_sample(rng: np.random.Generator):
    """8 random-offset 512x512 training windows of one labelled page
    (1024x1280, 2-8 hard or structured renders): windows see formulas
    clipped at their edges, as the detector's windows do on a page; a box
    joins a window when >= 25 % of it is inside (``window_targets``).
    Returns (windows uint8 (8, 512, 512), gt (8, 8, 4), valid (8, 8))."""
    page_style = "hard" if rng.random() < 0.5 else "structured"
    n_regions = int(rng.integers(2, 9))
    page, boxes, _labels = synth_labelled_page(rng, n_regions=n_regions, style=page_style)
    H, W = page.shape
    info = [(int(rng.integers(0, W - WINDOW + 1)), int(rng.integers(0, H - WINDOW + 1)),
             WINDOW, WINDOW) for _ in range(8)]
    gt, valid = window_targets(np.asarray(boxes, np.float32).reshape(-1, 4), info, max_boxes=8)
    wins = np.stack([page[y0:y0 + WINDOW, x0:x0 + WINDOW] for x0, y0, _, _ in info])
    return wins, gt, valid


def _model_input(window: np.ndarray, mean_px: np.ndarray) -> np.ndarray:
    """uint8 (S, S) -> float32 (S, S, 3) with the mean pixel taken off."""
    return np.repeat(window[..., None], 3, -1).astype(np.float32) - mean_px


def build_pool(style: str = "bars", neg_frac: float = 0.18, n_pool: int = N_POOL,
               seed: int = POOL_SEED, first: int | None = None) -> dict:
    """The training pool on the host: ``images`` float32 (n, 512, 512, 3)
    with the mean pixel taken off, ``gt`` (n, MAXB, 4), ``valid`` (n, MAXB)
    (MAXB 8 for ``windows``, else 4), and for ``windows`` the positive and
    negative window counts.  ``first``: only the pool's first windows (n =
    ``first``), as an ``n_pool`` pool holds them."""
    rng = np.random.default_rng(seed)
    maxb = 8 if style == "windows" else 4
    n = min(first or n_pool, n_pool)
    mean_px = np.asarray(MATH_GTDB_512["mean_pixel"], np.float32)
    imgs = np.empty((n, WINDOW, WINDOW, 3), np.float32)
    gts = np.zeros((n, maxb, 4), np.float32)
    valid = np.zeros((n, maxb), bool)
    n_pos = n_neg = 0
    if style == "windows":
        n_neg_target = int(round(neg_frac * n_pool))
        i = 0
        while i < n:
            wins, wgt, wvalid = window_sample(rng)
            for w, g, v in zip(wins, wgt, wvalid):
                if i >= n:
                    break
                if v.any():
                    if n_pos >= n_pool - n_neg_target:
                        continue
                    n_pos += 1
                else:
                    if n_neg >= n_neg_target:
                        continue
                    n_neg += 1
                imgs[i] = _model_input(w, mean_px)
                gts[i] = g
                valid[i] = v
                i += 1
    else:
        for i in range(n):
            img, boxes = synth_page(rng, style=style)
            imgs[i] = _model_input(img, mean_px)
            k = min(len(boxes), maxb)
            gts[i, :k] = boxes[:k]
            valid[i, :k] = True
    return {"images": imgs, "gt": gts, "valid": valid, "n_pos": n_pos, "n_neg": n_neg}


def eval_set(style: str, n_eval: int, seed: int = EVAL_SEED):
    """The held-out set: [(uint8 window or page, truth boxes in pixels)];
    for ``bars``/``mixed`` the pages (stitched), for ``windows`` the
    windows of ``window_sample``."""
    rng = np.random.default_rng(seed)
    out = []
    if style == "windows":
        while len(out) < n_eval:
            wins, wgt, wvalid = window_sample(rng)
            for w, g, v in zip(wins, wgt, wvalid):
                if len(out) >= n_eval:
                    break
                out.append((w, np.asarray(g[v], np.float32).reshape(-1, 4) * WINDOW))
    else:
        for _ in range(n_eval):
            img, boxes = synth_page(rng, style=style)
            out.append((img, boxes * WINDOW))
    return out


@torch.no_grad()
def evaluate(model, priors, style: str, n_eval: int, device) -> dict:
    """Held-out detection: per-window boxes (``windows``) or stitched page
    boxes, CROHME coarse/fine scores.  Returns {"preds", "pred_scores"
    (each box's score; 1 for a stitched box), "truths", "scores"}; SSD runs
    in float32 with TF32 off."""
    mean = torch.tensor(MATH_GTDB_512["mean_pixel"], dtype=torch.float32, device=device)
    preds, pred_scores, truths = [], [], []
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for img, truth in eval_set(style, n_eval):
            x = detection_input(torch.from_numpy(img[None]).to(device), mean)
            db, ds = batched_detect(*model(x), priors, conf_thresh=EVAL_CONF,
                                    iou_thresh=EVAL_IOU)
            db, ds = db[0].cpu().numpy() * WINDOW, ds[0].cpu().numpy()
            keep = ds > EVAL_CONF
            if style == "windows":
                preds.append(db[keep].reshape(-1, 4))
                pred_scores.append(ds[keep])
            else:
                bs = np.concatenate([db[keep], ds[keep][:, None]], axis=1)
                stitched = stitch_page(bs, (WINDOW, WINDOW), page_image=img, thresh_votes=0.5,
                                       algorithm="max")
                preds.append(np.asarray(stitched, np.float32).reshape(-1, 4))
                pred_scores.append(np.ones(len(preds[-1]), np.float32))
            truths.append(truth)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return {"preds": preds, "pred_scores": pred_scores, "truths": truths,
            "scores": crohme_detection_scores(preds, truths)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n_eval", type=int, default=8)
    ap.add_argument("--save", default=DEFAULT_SAVE,
                    help="checkpoint path of the trained SSD parameters ('' to skip)")
    ap.add_argument("--style", default="bars", choices=["bars", "mixed", "windows"],
                    help="page regions: noise bars, formula renders, or windows of big "
                    "labelled pages with clipped-formula negatives")
    ap.add_argument("--neg_frac", type=float, default=0.18,
                    help="windows style: share of the pool kept as windows without a box")
    ap.add_argument("--init_from", default=None,
                    help="warm start from a released weights file (fine-tune)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train_on_pool(model, args, device) -> dict:
    """``args.steps`` Adam steps of ``args.batch`` windows drawn on the
    device from the uploaded pool; returns the losses (floats, one a step),
    the pool's statistics and the timings (host clock, synchronised)."""
    priors = make_priors()
    params = named_params(model)
    tx = adam(LR)
    opt_state = tx.init(params)
    step = make_detection_train_step(model, priors, tx)
    cuda = device.type == "cuda"
    t0 = time.time()
    pool = build_pool(args.style, args.neg_frac, N_POOL)
    build_s = time.time() - t0
    if args.style == "windows":
        print(f"window pool: {pool['n_pos']} positive / {pool['n_neg']} negative windows, "
              f"{int(pool['valid'].sum())} boxes ({build_s:.1f} s on the host)", flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
    t0 = time.time()
    imgs_d = torch.from_numpy(pool["images"]).to(device)
    gts_d = torch.from_numpy(pool["gt"]).to(device)
    valid_d = torch.from_numpy(pool["valid"]).to(device)
    if cuda:
        torch.cuda.synchronize(device)
    upload_s = time.time() - t0
    pool_mb = pool["images"].nbytes / 1e6
    print(f"pool upload {pool_mb:.0f}MB in {upload_s:.2f}s", flush=True)

    gen = torch.Generator(device=device).manual_seed(STEP_SEED)
    losses = []
    t0 = time.time()
    for it in range(1, args.steps + 1):
        idx = torch.randint(0, imgs_d.shape[0], (args.batch,), generator=gen, device=device)
        params, opt_state, metrics = step(params, opt_state, imgs_d[idx], gts_d[idx],
                                          valid_d[idx])
        losses.append(metrics["loss"])
        if it in (1, 10) or it % 100 == 0:
            print(f"[{it}] loss {float(metrics['loss']):.4f} "
                  f"({it / max(time.time() - t0, 1e-9):.1f} steps/s)", flush=True)
    if cuda:
        torch.cuda.synchronize(device)
    train_s = time.time() - t0
    losses = [float(v) for v in torch.stack(losses).cpu()]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}", flush=True)
    return {"losses": losses, "n_pos": pool["n_pos"], "n_neg": pool["n_neg"],
            "pool_build_s": build_s, "pool_mb": pool_mb, "upload_s": upload_s,
            "train_s": train_s, "steps_per_s": args.steps / train_s,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None}


def run(args) -> dict:
    """The soak; returns ``train_on_pool``'s record (no pool is built at
    ``--steps 0``), the evaluation and the model."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("detection_soak: no CUDA card; pass --device cpu to run on the CPU")
    t0 = time.time()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SSD512(num_classes=2)
    if args.init_from:
        info = load_pretrained_params(args.init_from, model)
        print(f"warm-started from {args.init_from}: {info}", flush=True)
    model.to(device).train()
    print(f"init {time.time() - t0:.0f}s; params {param_count(model) / 1e6:.1f}M", flush=True)
    out = train_on_pool(model, args, device) if args.steps > 0 else {"losses": []}

    model.eval()
    ev = evaluate(model, torch.from_numpy(make_priors()).to(device), args.style, args.n_eval,
                  device)
    print("CROHME scores:", ev["scores"], flush=True)
    final_loss = out["losses"][-1] if out["losses"] else float("nan")
    if args.save:
        save_checkpoint(args.save, TrainState(args.steps, model, {}),
                        {"iter": args.steps, "final_loss": final_loss, **ev["scores"]})
        print(f"saved {args.save}", flush=True)
    print("DETECTION SOAK DONE", flush=True)
    return {**out, **ev, "model": model}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
