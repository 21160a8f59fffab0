"""Detection losses in plain PyTorch, float32 (counterpart of
``oneshotdet_tpu/ops/losses.py``): the same formulas, reductions and masks.

  - sigmoid_focal_loss: EPSILON = 1e-6 inside the logs, class channel d is
    positive for target d + 1, negative targets ignored; summed;
  - softmax_focal_loss: (C+1)-way softmax incl. background channel 0; summed;
  - iou_loss: FCOS ltrb IoU / linear IoU / GIoU with the +1 smoothing of the
    IoU ratio, weighted mean; zero-weight rows are replaced by pred = target
    = 1 before the loss, so their gradient is 0 and never NaN;
  - smooth_l1_loss, bce_with_logits: elementwise, no reduction;
  - cross_entropy: mean over valid elements weighted by per-class weights,
    sum(w_t * nll) / sum(w_t).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

EPSILON = 1e-6


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (N, C); targets (N,) int: 0 background, t in [1..C] class t,
    negative ignored; valid (N,) bool or None. Returns the scalar sum."""
    c = logits.shape[1]
    class_range = torch.arange(1, c + 1, dtype=targets.dtype, device=targets.device)[None, :]
    t = targets[:, None]
    p = torch.sigmoid(logits)
    term1 = (1 - p) ** gamma * torch.log(p + EPSILON)
    term2 = p ** gamma * torch.log(1 - p + EPSILON)
    pos = (t == class_range).to(logits.dtype)
    neg = ((t != class_range) & (t >= 0)).to(logits.dtype)
    loss = -pos * term1 * alpha - neg * term2 * (1 - alpha)
    if valid is not None:
        loss = loss * valid[:, None].to(loss.dtype)
    return loss.sum()


def softmax_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-alpha_t (1 - p_t)^gamma log p_t over a softmax, summed; negative
    targets ignored."""
    c = logits.shape[1]
    logp = F.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    t = torch.clamp(targets, 0, c - 1).long()
    p_t = torch.gather(p, 1, t[:, None])[:, 0]
    logp_t = torch.gather(logp, 1, t[:, None])[:, 0]
    alpha_t = torch.where(targets > 0, alpha, 1 - alpha)
    loss = -alpha_t * (1 - p_t) ** gamma * logp_t
    loss = torch.where(targets >= 0, loss, 0.0)
    if valid is not None:
        loss = loss * valid.to(loss.dtype)
    return loss.sum()


def iou_loss(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor,
             weight: Optional[torch.Tensor] = None, loss_type: str = "giou") -> torch.Tensor:
    """(N, 4) positive (l, t, r, b) distances; weight (N,) or None. Returns
    (loss * w).sum() / w.sum() (0 when w sums to 0), or the mean."""
    if weight is not None:
        safe = (weight > 0)[..., None]
        pred_ltrb = torch.where(safe, pred_ltrb, 1.0)
        target_ltrb = torch.where(safe, target_ltrb, 1.0)
    pl, pt, pr, pb = pred_ltrb.unbind(-1)
    tl, tt, tr, tb = target_ltrb.unbind(-1)

    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_intersect = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    g_w_intersect = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    h_intersect = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_h_intersect = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w_intersect * g_h_intersect + 1e-7
    area_intersect = w_intersect * h_intersect
    area_union = target_area + pred_area - area_intersect
    ious = (area_intersect + 1.0) / (area_union + 1.0)
    gious = ious - (ac_union - area_union) / ac_union

    if loss_type == "iou":
        losses = -torch.log(ious)
    elif loss_type == "linear_iou":
        losses = 1 - ious
    elif loss_type == "giou":
        losses = 1 - gious
    else:
        raise NotImplementedError(loss_type)

    if weight is not None:
        losses = torch.where(weight > 0, losses, 0.0)
        wsum = weight.sum()
        return torch.where(wsum > 0, (losses * weight).sum() / torch.clamp(wsum, min=EPSILON),
                           0.0)
    return losses.mean()


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1, no reduction."""
    n = torch.abs(pred - target)
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise max(x, 0) - x t + log(1 + exp(-|x|)), no reduction."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax cross-entropy, sum(w_t * nll) / max(sum(w_t), EPSILON) with
    w_t the class weight of each target (1 without ``weight``) times
    ``valid``."""
    logp = F.log_softmax(logits, dim=-1)
    t = torch.clamp(targets, 0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    w = torch.ones_like(nll) if weight is None else weight.to(nll.dtype)[t]
    if valid is not None:
        w = w * valid.to(w.dtype)
    return (nll * w).sum() / torch.clamp(w.sum(), min=EPSILON)
