"""GTDB-style detection data and the detector's train step (counterpart of
``doc2tex_tpu.detection.data``).

Page images with ``.pmath`` box annotations (one ``x1,y1,x2,y2`` per
line) are cut into 512x512 training windows whose targets are the
window-normalized math boxes that overlap each window enough
(ScanSSD's ``gtdb_new.py``).  Pages are PNGs read by ``utils/png.py``, or
``.jpg``/``.jpeg`` pages read by ``utils/jpeg.py``, as PIL's
``convert("L")`` reads them.

``make_detection_train_step`` is ScanSSD's ``train.py`` loop body: uint8
windows to float32, grey repeated to 3 channels, the mean pixel taken off,
SSD512's forward, the MultiBox (or focal) loss, the backward and an
optax-equal update (``train/optim.py``), in float32 with TF32 off.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..utils.jpeg import decode_jpeg
from ..utils.png import decode_png
from .loss import focal_loss, multibox_loss
from .priors import MATH_GTDB_512
from .windows import rolling_windows


def read_pmath(path: str) -> np.ndarray:
    """Parse a .pmath annotation file -> (N, 4) float32 boxes (page pixels)."""
    boxes = []
    with open(path) as f:
        for line in f:
            parts = [p for p in line.replace(",", " ").split() if p]
            if len(parts) >= 4:
                boxes.append([float(v) for v in parts[:4]])
    return np.asarray(boxes, np.float32).reshape(-1, 4)


def window_targets(
    boxes: np.ndarray,
    info: Sequence[tuple[int, int, int, int]],
    window: int = 512,
    min_overlap: float = 0.25,
    max_boxes: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Assign page boxes to windows.

    Returns (gt (W, max_boxes, 4) window-normalized corner boxes,
    valid (W, max_boxes) bool).  A box joins a window when >= min_overlap
    of its area falls inside."""
    W = len(info)
    gt = np.zeros((W, max_boxes, 4), np.float32)
    valid = np.zeros((W, max_boxes), bool)
    if len(boxes) == 0:
        return gt, valid
    area = np.maximum(boxes[:, 2] - boxes[:, 0], 1e-6) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 1e-6
    )
    for wi, (x0, y0, w, h) in enumerate(info):
        xc, yc = (window - w) // 2, (window - h) // 2
        ix1 = np.maximum(boxes[:, 0], x0)
        iy1 = np.maximum(boxes[:, 1], y0)
        ix2 = np.minimum(boxes[:, 2], x0 + w)
        iy2 = np.minimum(boxes[:, 3], y0 + h)
        inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
        keep = np.flatnonzero(inter / area >= min_overlap)[:max_boxes]
        for j, bi in enumerate(keep):
            gt[wi, j] = [
                (np.clip(boxes[bi, 0] - x0, 0, w) + xc) / window,
                (np.clip(boxes[bi, 1] - y0, 0, h) + yc) / window,
                (np.clip(boxes[bi, 2] - x0, 0, w) + xc) / window,
                (np.clip(boxes[bi, 3] - y0, 0, h) + yc) / window,
            ]
            valid[wi, j] = True
    return gt, valid


def read_page(path: str) -> np.ndarray:
    """A ``.png``, ``.jpg`` or ``.jpeg`` page image -> (H, W) uint8 grey,
    as PIL's ``convert("L")``; another extension raises
    ``NotImplementedError``."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".png", ".jpg", ".jpeg"):
        raise NotImplementedError(f"{path}: only PNG and JPEG pages are read without PIL "
                                  "(ROADMAP A12)")
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data) if ext == ".png" else decode_jpeg(data)


class GTDBDetectionDataset:
    """Page-image + .pmath directory -> (window, gt, valid) samples."""

    def __init__(
        self,
        image_dir: str,
        anno_dir: str,
        window: int = 512,
        stride: tuple[int, int] = (128, 128),
        positive_only: bool = True,
    ):
        self.samples: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for fname in sorted(os.listdir(image_dir)):
            stem, ext = os.path.splitext(fname)
            if ext.lower() not in (".png", ".jpg", ".jpeg"):
                continue
            anno = os.path.join(anno_dir, stem + ".pmath")
            if not os.path.exists(anno):
                continue
            page = read_page(os.path.join(image_dir, fname))
            boxes = read_pmath(anno)
            windows, info = rolling_windows(page, stride, window)
            gt, valid = window_targets(boxes, info, window)
            for i in range(len(windows)):
                if positive_only and not valid[i].any():
                    continue
                self.samples.append((windows[i], gt[i], valid[i]))

    def __len__(self) -> int:
        return len(self.samples)

    def batches(self, batch_size: int, seed: int = 0):
        """Shuffled full batches (uint8 windows, gt, valid); the order is
        numpy's permutation of ``seed``, as in the JAX package."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.samples))
        for s in range(0, len(order), batch_size):
            idx = order[s : s + batch_size]
            if len(idx) < batch_size:
                continue
            imgs = np.stack([self.samples[i][0] for i in idx])
            gt = np.stack([self.samples[i][1] for i in idx])
            valid = np.stack([self.samples[i][2] for i in idx])
            yield imgs, gt, valid


def detection_input(images: torch.Tensor, mean_pixel: torch.Tensor) -> torch.Tensor:
    """(B, H, W[, C]) windows, uint8 or already float -> SSD512's float32
    (B, 3, H, W) input: grey repeated to 3 channels, the mean pixel off."""
    x = images.float()
    if x.dim() == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    return (x - mean_pixel).permute(0, 3, 1, 2)


def make_detection_train_step(model, priors, tx, use_focal: bool = False):
    """``step(params, opt_state, images, gt, valid) -> (params, opt_state,
    metrics)``, the JAX package's signature: ``params`` is the model's
    parameter tree (``train.trainer.named_params``), updated in place and
    returned; ``opt_state`` the optimizer's (``tx.init(params)``);
    ``images`` uint8 (B, 512, 512[, 1 or 3]) windows, ``gt`` (B, M, 4)
    window-normalized corner boxes, ``valid`` (B, M); numpy or tensors.
    ``metrics`` holds 0-d device tensors ``loss``, ``loss_loc`` and
    ``loss_conf``.  Float32 only: cuDNN's and the matmuls' TF32 are off for
    the step, whatever the process sets."""
    loss_impl = focal_loss if use_focal else multibox_loss
    device = next(model.parameters()).device
    priors = torch.as_tensor(np.asarray(priors, np.float32)).to(device)
    mean = torch.tensor(MATH_GTDB_512["mean_pixel"], dtype=torch.float32, device=device)
    named = dict(model.named_parameters())

    def step(params, opt_state, images, gt, valid):
        x = detection_input(torch.as_tensor(images).to(device), mean)
        gt = torch.as_tensor(gt).to(device, torch.float32)
        valid = torch.as_tensor(valid).to(device, torch.bool)
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            loc, conf = model(x)
            ll, lc = loss_impl(loc, conf, gt, valid, priors)
            loss = ll + lc
            grads = torch.autograd.grad(loss, list(named.values()))
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        with torch.no_grad():
            updates, opt_state = tx.update(dict(zip(named, grads)), opt_state, params)
            keys = list(params)
            torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])
        return params, opt_state, {"loss": loss.detach(), "loss_loc": ll.detach(),
                                   "loss_conf": lc.detach()}

    return step
