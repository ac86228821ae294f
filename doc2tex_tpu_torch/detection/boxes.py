"""Box decode and greedy NMS for the math detector, batched on the device
(counterpart of ``doc2tex_tpu.detection.boxes``).

- decode with variances [0.1, 0.2] (ScanSSD's ``decode``);
- NMS over the top-k scoring boxes of each window at IoU 0.1, suppressed
  and unused entries scored 0, so callers threshold once at the end.

NMS is plain PyTorch on the device: a stable descending sort (the order
``jax.lax.top_k`` gives: the lower index first among equal scores), a K x K
IoU matrix and a keep loop over K, as the reference's fixed-count loop.  The
loop stops after the last box that scored above 0 in any window: the steps
after it change nothing, since a box with score 0 suppresses nothing.
"""

from __future__ import annotations

import torch


def decode_boxes(loc, priors, variances=(0.1, 0.2)):
    """loc (..., N, 4) offsets + priors (N, 4) cxcywh -> (..., N, 4)
    corner-form (x1, y1, x2, y2), normalized."""
    pxy, pwh = priors[..., :2], priors[..., 2:]
    cxy = pxy + loc[..., :2] * variances[0] * pwh
    wh = pwh * torch.exp(loc[..., 2:] * variances[1])
    return torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)


def _iou_matrix(boxes):
    """(..., K, 4) corner boxes -> (..., K, K) IoU."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (
        boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms_fixed(boxes, scores, iou_thresh: float = 0.1, top_k: int = 200):
    """Greedy NMS over each row's top_k boxes.

    boxes (B, N, 4), scores (B, N) -> (boxes (B, k, 4), scores (B, k)),
    k = min(top_k, N), where suppressed and unused entries score 0: what
    torchvision's ``nms`` followed by truncation to top_k keeps."""
    k = min(top_k, scores.shape[-1])
    top_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    later = torch.ones(k, k, dtype=torch.bool, device=scores.device).triu_(1)
    suppresses = (_iou_matrix(top_boxes) > iou_thresh) & later   # [b, i, j]: i suppresses j
    keep = top_scores > 0
    # one read of the device: how far the keep loop has to go
    for i in range(int(keep.sum(-1).max())):
        keep &= ~(suppresses[:, i] & keep[:, i, None])
    return top_boxes, top_scores * keep


def batched_detect(loc, conf, priors, cls: int = 1, conf_thresh: float = 0.5,
                   iou_thresh: float = 0.1, top_k: int = 200):
    """Test-phase detection for a batch of windows.

    loc (B, N, 4), conf (B, N, C) logits -> (boxes (B, top_k, 4),
    scores (B, top_k)); scores already thresholded (0 below conf_thresh)."""
    probs = torch.softmax(conf.float(), dim=-1)[..., cls]
    decoded = decode_boxes(loc.float(), priors)
    scores = torch.where(probs >= conf_thresh, probs, torch.zeros_like(probs))
    return nms_fixed(decoded, scores, iou_thresh, top_k)
