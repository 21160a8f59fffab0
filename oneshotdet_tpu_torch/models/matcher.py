"""IoU matcher and balanced positive/negative sampler (counterpart of
``oneshotdet_tpu/models/matcher.py``).

The random draw is split from its use: ``balanced_sample`` takes one
uniform number per proposal, which the caller draws from an explicit
``torch.Generator`` (or, in the tests, takes from JAX's own draws).
Sorts are stable, so equal priorities keep their index order, as JAX's
``argsort`` and ``lax.top_k`` do.
"""

from __future__ import annotations

from typing import Tuple

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_boxes(iou_gt_pred: torch.Tensor, gt_valid: torch.Tensor, high_threshold: float,
                low_threshold: float, allow_low_quality_matches: bool = False) -> torch.Tensor:
    """(..., G, N) quality matrix and (..., G) valid flags -> (..., N) int32
    matched GT index, or BELOW_LOW_THRESHOLD / BETWEEN_THRESHOLDS. Invalid
    GT rows never match; with no valid GT every prediction is below the low
    threshold."""
    quality = torch.where(gt_valid[..., None], iou_gt_pred, -1.0)
    matched_vals, matches = quality.max(dim=-2)
    matches = matches.to(torch.int32)
    below = matched_vals < low_threshold
    between = (matched_vals >= low_threshold) & (matched_vals < high_threshold)
    out = torch.where(below, BELOW_LOW_THRESHOLD, matches)
    out = torch.where(between, BETWEEN_THRESHOLDS, out).to(torch.int32)
    if allow_low_quality_matches:
        # each GT's best predictions (ties included) keep their match
        highest_per_gt = quality.max(dim=-1, keepdim=True).values
        is_best = (quality == highest_per_gt) & gt_valid[..., None] & (highest_per_gt > -1.0)
        out = torch.where(is_best.any(dim=-2), matches, out)
    return out


def _rank(priority: torch.Tensor) -> torch.Tensor:
    """Rank of each entry along the last axis by descending priority, 0 =
    highest; ties by index."""
    order = torch.sort(-priority, dim=-1, stable=True).indices
    return torch.sort(order, dim=-1).indices


def balanced_sample(u: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                    batch_size: int, positive_fraction: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed ``batch_size`` proposal slots per row: up to ``batch_size *
    positive_fraction`` positives, negatives filling the rest, each chosen
    by random priority ``u`` (..., N) in [0, 1); positives first.

    labels (..., N) int: -1 ignore, 0 negative, > 0 positive; valid (..., N)
    bool. Returns (indices (..., batch_size) int64, sampled_valid
    (..., batch_size) bool).
    """
    pos = (labels >= 1) & valid
    neg = (labels == 0) & valid
    num_pos = torch.clamp(pos.sum(-1, keepdim=True), max=int(batch_size * positive_fraction))
    num_neg = torch.minimum(neg.sum(-1, keepdim=True), batch_size - num_pos)

    pos_selected = pos & (_rank(torch.where(pos, u, -1.0)) < num_pos)
    neg_selected = neg & (_rank(torch.where(neg, u, -1.0)) < num_neg)

    combined = torch.where(pos_selected, 2.0 + u, torch.where(neg_selected, 1.0 + u, -1.0))
    idx = torch.sort(-combined, dim=-1, stable=True).indices[..., :batch_size]
    return idx, torch.gather(combined, -1, idx) > 0.0
