"""Full-page math detection (counterpart of
``doc2tex_tpu.detection.flow``).

A page (already resized to width 1280 by the caller, ``app.App``) is cut
into 512x512 windows at stride 128, mean-subtracted (246, 246, 246), run
through SSD512 as one batch in float32 (cuDNN's TF32 off, whatever the
process sets; ``quantize="bf16"`` computes it in bfloat16, ``"int8"``
sends its gated convolutions through the int8 op, whose activation scale
is the abs-max of the whole window batch), decoded and NMS'd per window on
the device in float32;
the boxes come to the host once, are un-mapped to page pixels, page-level
NMS'd at IoU 0.1 (on the device, top 200 of at most 512) and grown by 5 %.

With ``device_windows`` (the default) the page is uploaded once as uint8,
white-padded up to a 256-pixel ladder (at least 512), and the windows are
cut from it on the device; boxes are clipped back to the original page.
Near the page's border this differs from the host path (``rolling_windows``
center-pads the last windows), as it does in the JAX package.

With a mesh (``parallel.mesh``, single controller) rank 0 detects: the
window batch, its count padded with white windows to the data axis (the
host path's ``batch_size`` rounded up to it), is broadcast, every rank runs
SSD512 on its windows (int8's abs-max is the whole batch's, maxed over the
ranks) and the boxes are gathered; white windows detect nothing and their
rows are dropped, so the boxes are the single-device ones.  The other ranks
build the same ``MathDetector`` and run ``mesh.follow()``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import activation_mesh, pad_rows, shard_batch
from ..weights import load_weights
from .boxes import batched_detect, nms_fixed
from .data import detection_input
from .priors import MATH_GTDB_512, make_priors
from .ssd import SSD512
from .windows import expand_boxes, rolling_windows, unmap_boxes

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHIPPED_WEIGHTS = os.path.join(_ROOT, "saved_models", "math_detect", "best_weights.msgpack")


class MathDetector:
    """Page image -> math region boxes, on ``device``."""

    def __init__(
        self,
        weights_path: Optional[str] = None,
        conf_thresh: float = 0.5,
        iou_thresh: float = 0.1,
        window: int = 512,
        stride: tuple[int, int] = (128, 128),
        batch_size: int = 32,
        seed: int = 0,
        device_windows: bool = True,
        mesh=None,
        quantize: Optional[str] = None,
        expand_frac: float = 0.05,
        device="cuda",
    ):
        """``weights_path``: a flax msgpack of the detector (every leaf must
        fill the model); None gives a random init from ``seed``.
        ``batch_size`` is the window chunk of the host path
        (``device_windows=False``; a short last chunk is padded with white
        windows, as in JAX, so int8's per-batch scale sees the same batch).
        ``quantize``: None, ``bf16`` or ``int8`` (``SSD512.set_quantize``).
        ``mesh``: shard the window batch over the mesh's data axis (see the
        module's docstring)."""
        with torch.random.fork_rng(devices=[]):  # seeds the init without touching the caller's RNG
            torch.manual_seed(seed)
            self.model = SSD512(num_classes=2)
        self.quantize = quantize
        self.int8_layers = self.model.set_quantize(quantize)
        if weights_path:
            load_weights(self.model, weights_path)
        self.device = torch.device(device)
        self.model.to(self.device).eval()
        self.priors = torch.from_numpy(make_priors(MATH_GTDB_512)).to(self.device)
        self.mean = torch.tensor(MATH_GTDB_512["mean_pixel"], dtype=torch.float32,
                                 device=self.device)
        self.conf_thresh = conf_thresh
        self.iou_thresh = iou_thresh
        self.expand_frac = expand_frac
        self.window = window
        self.stride = stride
        self.mesh = mesh
        if mesh is not None:   # host-window chunks pad to batch_size, so it must divide
            batch_size = -(-batch_size // mesh.nd) * mesh.nd
            self._sharded = mesh.register("MathDetector", self._detect_sharded)
        self.batch_size = batch_size
        self.device_windows = device_windows
        self._nms_cap = 512

    def model_input(self, windows: torch.Tensor) -> torch.Tensor:
        """uint8 (n, win, win, C) windows -> SSD512's float32 (n, 3, win,
        win) input: grey repeated to 3 channels, the mean pixel taken off."""
        return detection_input(windows, self.mean).contiguous()

    def ssd(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """SSD512's forward in float32: cuDNN's TF32 is off for the call,
        whatever the process's setting (TF32 moves scores near
        ``conf_thresh``, and with them boxes).  The flag is global, so a
        float32 convolution of another thread running meanwhile runs
        without TF32 as well."""
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self.model(x)
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    @torch.inference_mode()
    def detect_windows(self, windows: torch.Tensor):
        """uint8 (n, win, win, C) windows on the device -> (boxes (n, 200, 4),
        scores (n, 200)) on the device, window-normalized."""
        loc, conf = self.ssd(self.model_input(windows))
        # decode and NMS in float32 whatever the trunk's compute type
        loc, conf = loc.float(), conf.float()
        return batched_detect(loc, conf, self.priors, conf_thresh=self.conf_thresh,
                              iou_thresh=self.iou_thresh)

    @torch.inference_mode()
    def _detect_sharded(self, windows: torch.Tensor):
        """Every rank of the mesh: the global window batch -> every rank's
        (boxes, scores), gathered in window order."""
        with activation_mesh(self.mesh):
            boxes, scores = self.detect_windows(shard_batch(windows, self.mesh).to(self.device))
        return self.mesh.gather_rows(boxes), self.mesh.gather_rows(scores)

    def _detect(self, windows: torch.Tensor):
        """``detect_windows``, over the mesh when there is one (the
        window count padded with white windows to the data axis)."""
        if self.mesh is None:
            return self.detect_windows(windows)
        n = windows.shape[0]
        boxes, scores = self._sharded(pad_rows(windows, self.mesh.nd, 255))
        return boxes[:n], scores[:n]

    def page_windows(self, page: np.ndarray) -> tuple[torch.Tensor, list]:
        """The device path's windows: the page white-padded up to the
        256-pixel ladder (at least one window), uploaded once as uint8 and
        cut on the device -> (uint8 (n, win, win, C), [(x0, y0, w, h), ...]).
        A stride that does not tile the ladder gets ``rolling_windows``'s
        center-padded windows of the padded page instead, as in JAX."""
        padded = self._snap_page(page)
        if padded.ndim == 2:
            padded = padded[..., None]
        H, W, C = padded.shape
        win, (sy, sx) = self.window, self.stride
        if (H - win) % sy or (W - win) % sx:
            windows, info = rolling_windows(padded, self.stride, win)
            return torch.from_numpy(windows).to(self.device), info
        page_u8 = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
        grid = page_u8.unfold(0, win, sy).unfold(1, win, sx)     # (ny, nx, C, win, win)
        ny, nx = grid.shape[:2]
        info = [(j * sx, i * sy, win, win) for i in range(ny) for j in range(nx)]
        return grid.permute(0, 1, 3, 4, 2).reshape(ny * nx, win, win, C), info

    @staticmethod
    def _snap_page(page: np.ndarray, quantum: int = 256, min_dim: int = 512):
        """White-pad page dims up to multiples of ``quantum``, at least the
        window size."""
        H, W = page.shape[:2]
        Hp = max(min_dim, -(-H // quantum) * quantum)
        Wp = max(min_dim, -(-W // quantum) * quantum)
        if (Hp, Wp) == (H, W):
            return page
        pad = [(0, Hp - H), (0, Wp - W)] + ([(0, 0)] if page.ndim == 3 else [])
        return np.pad(page, pad, constant_values=255)

    def _window_detections(self, page: np.ndarray):
        """(boxes (n, 200, 4), scores (n, 200), grid info) on the host."""
        if self.device_windows:
            windows, info = self.page_windows(page)
            boxes, scores = self._detect(windows)
            out = torch.cat([boxes, scores[..., None]], -1).cpu().numpy()
            return out[..., :4], out[..., 4], info
        windows, info = rolling_windows(page, self.stride, self.window)
        outs = []
        B = self.batch_size
        for s in range(0, len(windows), B):
            chunk = windows[s:s + B]
            n = len(chunk)
            if n < B:   # white windows up to the chunk size; their rows are dropped
                chunk = np.concatenate([chunk, np.full((B - n, *chunk.shape[1:]), 255, np.uint8)])
            boxes, scores = self._detect(torch.from_numpy(chunk).to(self.device))
            outs.append(torch.cat([boxes, scores[..., None]], -1)[:n].cpu().numpy())
        out = np.concatenate(outs)
        return out[..., :4], out[..., 4], info

    @torch.inference_mode()
    def detect_page(self, page: np.ndarray, raw: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """(H, W) or (H, W, C) uint8 page -> (boxes (K, 4) in page pixels,
        scores (K,)), page-level NMS'd and expanded by ``expand_frac``.
        ``raw=True`` returns ``page_candidates`` as they are (every
        window's kept boxes, clipped to the page; no page NMS, no top-200
        cap, no expansion): the voting stitch's input."""
        candidates = self.page_candidates(page)
        if raw:
            return candidates
        return self.page_nms(*candidates, page.shape[:2])

    def page_candidates(self, page: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Every window's kept boxes in page pixels (the page NMS's input)."""
        H, W = page.shape[:2]
        boxes, scores, info = self._window_detections(page)
        page_boxes, page_scores = unmap_boxes(boxes, scores, info, self.window, score_thresh=0.0)
        if self.device_windows and len(page_boxes):
            # clip to the original page and drop boxes that live in the pad
            page_boxes[:, 0::2] = np.clip(page_boxes[:, 0::2], 0, W)
            page_boxes[:, 1::2] = np.clip(page_boxes[:, 1::2], 0, H)
            keep = ((page_boxes[:, 2] - page_boxes[:, 0] >= 2)
                    & (page_boxes[:, 3] - page_boxes[:, 1] >= 2))
            page_boxes, page_scores = page_boxes[keep], page_scores[keep]
        return page_boxes, page_scores

    @torch.inference_mode()
    def page_nms(self, page_boxes: np.ndarray, page_scores: np.ndarray,
                 page_hw: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
        """Page-level NMS on the device over the top 512 candidates (in
        numpy's order), at most 200 kept, then the expansion."""
        if len(page_boxes) == 0:
            return page_boxes, page_scores
        H, W = page_hw
        cap = self._nms_cap
        if len(page_boxes) > cap:
            order = np.argsort(page_scores)[::-1][:cap]
            page_boxes, page_scores = page_boxes[order], page_scores[order]
        nb = np.zeros((cap, 4), np.float32)
        ns = np.zeros((cap,), np.float32)
        scale = np.array([W, H, W, H], np.float32)
        nb[: len(page_boxes)] = page_boxes / scale
        ns[: len(page_scores)] = page_scores
        kb, ks = nms_fixed(torch.from_numpy(nb)[None].to(self.device),
                           torch.from_numpy(ns)[None].to(self.device), self.iou_thresh, 200)
        kept = torch.cat([kb[0], ks[0, :, None]], -1).cpu().numpy()
        kb, ks = kept[:, :4], kept[:, 4]
        keep = ks > 0
        boxes = expand_boxes(kb[keep] * scale, (H, W), frac=self.expand_frac)
        return boxes, ks[keep]

    def crop_regions(self, page: np.ndarray, boxes: np.ndarray) -> list[np.ndarray]:
        """The page's pixels inside each box, corners truncated to int."""
        return [page[y1:y2, x1:x2] for x1, y1, x2, y2 in boxes.astype(int)]
