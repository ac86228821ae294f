"""MultiBox and focal losses of the math detector (counterpart of
``doc2tex_tpu.detection.loss``).

Each prior is matched to its best ground-truth box by IoU (threshold 0.5),
each box's best prior is forced positive, the regression targets are
encoded with variances (0.1, 0.2); smooth-L1 on the positives and
cross-entropy with 3:1 hard-negative mining (``multibox_loss``) or focal
cross-entropy over every prior (``focal_loss``), each normalized by the
positive count, then averaged over the images.

Everything is batched over the images (the JAX function ``vmap``s one
image's loss): no Python loop over images, no host synchronisation.  The
matching reproduces the JAX package's on the CPU, ties and padding
included:

- a padding row writes ``False`` at prior 0 in the forced-positive
  scatter, and a later write to a prior wins over an earlier one (XLA's
  CPU scatter applies the updates in order), so a real box whose best prior
  is 0 loses its forced flag to a padding row after it;
- among boxes sharing a best prior, the lowest box index is matched there
  (``argmax`` takes the first maximum, in both packages);
- mining keeps every negative whose loss reaches the ``n_neg``-th largest
  negative loss (ties take in every equal negative), ``n_neg`` = min(3
  ``n_pos``, N - 1) with ``n_pos`` at least 1.

The positive mask and the mining carry no gradient.
"""

from __future__ import annotations

import torch


def encode_boxes(matched, priors, variances=(0.1, 0.2)):
    """Corner-form gt (..., N, 4) + priors (N, 4) cxcywh -> loc targets."""
    g_cxy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[:, :2]
    g_cxy = g_cxy / (variances[0] * priors[:, 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[:, 2:]
    g_wh = torch.log(torch.clamp(g_wh, min=1e-8)) / variances[1]
    return torch.cat([g_cxy, g_wh], -1)


def _point_form(priors):
    return torch.cat([priors[:, :2] - priors[:, 2:] / 2, priors[:, :2] + priors[:, 2:] / 2], 1)


def _jaccard(a, b):
    """a (N, 4), b (..., M, 4) corner form -> IoU (..., N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[:, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[:, None] + area_b[..., None, :] - inter, min=1e-9)


@torch.no_grad()
def match_priors(gt_boxes, gt_valid, priors, iou_thresh: float = 0.5):
    """Assign each prior its best gt (ScanSSD's ``match``).

    gt_boxes (B, M, 4) corner form, padded; gt_valid (B, M) bool.
    Returns (loc_targets (B, N, 4), pos_mask (B, N))."""
    N = priors.shape[0]
    iou = _jaccard(_point_form(priors), gt_boxes)                  # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_gt_iou, best_gt_idx = iou.max(dim=2)[0], iou.argmax(dim=2)
    best_prior_idx = iou.argmax(dim=1)                             # (B, M)
    # the forced-positive scatter: row m writes gt_valid[m] at its target,
    # the last write to a prior wins
    target = torch.where(gt_valid, best_prior_idx, torch.zeros_like(best_prior_idx))
    arange = torch.arange(N, device=priors.device)
    hits = arange[None, :, None] == target[:, None, :]             # (B, N, M)
    M = gt_valid.shape[1]
    last = (M - 1) - hits.flip(2).to(torch.uint8).argmax(dim=2)    # the last row writing there
    forced = hits.any(dim=2) & torch.gather(gt_valid, 1, last)
    # a forced prior takes the first valid gt whose best prior it is
    owner = (arange[None, :, None] == torch.where(
        gt_valid, best_prior_idx, torch.full_like(best_prior_idx, -2))[:, None, :])
    best_gt_idx = torch.where(forced, owner.to(torch.uint8).argmax(dim=2), best_gt_idx)
    pos = (best_gt_iou >= iou_thresh) | forced
    matched = torch.gather(gt_boxes, 1, best_gt_idx[..., None].expand(-1, -1, 4))
    return encode_boxes(matched, priors), pos


def _smooth_l1(loc_pred, loc_t, pos, n_pos):
    diff = torch.abs(loc_pred - loc_t)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    return torch.where(pos, sl1, torch.zeros_like(sl1)).sum(-1) / n_pos


def _class_ce(conf_pred, pos):
    logp = torch.log_softmax(conf_pred.float(), -1)
    return -torch.gather(logp, -1, pos.long()[..., None])[..., 0]


def multibox_loss(loc_pred, conf_pred, gt_boxes, gt_valid, priors,
                  neg_pos_ratio: float = 3.0):
    """Batched SSD loss.  loc_pred (B, N, 4), conf_pred (B, N, C),
    gt_boxes (B, M, 4), gt_valid (B, M).  Returns (loss_l, loss_c), each
    the mean over the images."""
    loc_t, pos = match_priors(gt_boxes, gt_valid, priors)
    N = pos.shape[1]
    n_pos = torch.clamp(pos.sum(-1), min=1)                        # (B,) int
    loss_l = _smooth_l1(loc_pred, loc_t, pos, n_pos)
    ce = _class_ce(conf_pred, pos)
    with torch.no_grad():
        neg_ce = torch.where(pos, torch.full_like(ce, float("-inf")), ce)
        n_neg = torch.clamp((neg_pos_ratio * n_pos).long(), max=N - 1)
        sorted_neg = torch.sort(neg_ce, dim=-1, descending=True)[0]
        thresh = torch.gather(sorted_neg, 1, torch.clamp(n_neg - 1, min=0)[:, None])
        neg = (~pos) & (ce >= thresh) & torch.isfinite(ce)
    loss_c = torch.where(pos | neg, ce, torch.zeros_like(ce)).sum(-1) / n_pos
    return loss_l.mean(), loss_c.mean()


def focal_loss(loc_pred, conf_pred, gt_boxes, gt_valid, priors,
               alpha: float = 0.25, gamma: float = 2.0):
    """Focal-loss alternative to hard-negative mining (ScanSSD's
    ``focal_loss``): smooth-L1 on the positives and focal cross-entropy over
    every prior.  Returns (loss_l, loss_c), each the mean over the images."""
    loc_t, pos = match_priors(gt_boxes, gt_valid, priors)
    n_pos = torch.clamp(pos.sum(-1), min=1)
    loss_l = _smooth_l1(loc_pred, loc_t, pos, n_pos)
    ce = _class_ce(conf_pred, pos)
    pt = torch.exp(-ce)
    a_t = torch.where(pos, torch.full_like(ce, alpha), torch.full_like(ce, 1.0 - alpha))
    loss_c = (a_t * (1.0 - pt) ** gamma * ce).sum(-1) / n_pos
    return loss_l.mean(), loss_c.mean()
