"""Anchor-based RPN, the stage-1 alternative to FCOS with MODEL.FCOS_ON False
(counterpart of ``oneshotdet_tpu/models/rpn.py``).

  - head: a shared 3x3 conv + ReLU, then 1x1 ``cls_logits`` (A objectness
    logits a cell) and 1x1 ``bbox_pred`` (4 A deltas), the same convs over
    every level; outputs NHWC float32;
  - targets: anchors matched to the GT boxes at IoU 0.7 / 0.3 with the
    low-quality matches kept; label 1, 0, or -1 (between the thresholds, or
    an anchor straddling its image's border); deltas by BoxCoder(1, 1, 1, 1);
  - losses: a balanced sample of 256 anchors an image (half positive at
    most) by one uniform priority per anchor, BCE objectness over the
    sample and smooth-L1 (beta 1/9) over its positives, both over the
    sample's size; the detector scales them x10 and x500;
  - postprocess: per level the top ``pre_nms_top_n`` objectness, decoded,
    clipped, the boxes under ``min_size`` dropped, NMS, the top
    ``post_nms_top_n``; then the top ``fpn_post_nms_top_n`` over the levels.
    The output keeps the JAX package's capacity: min(fpn_post_nms_top_n,
    the levels' kept capacities), fields 'objectness' and 'scores' (the
    sigmoid of the logit, 0 in invalid slots).

The random draws are an input (``u`` of ``rpn_losses``): the detector
takes them as ``forward_train(rpn_draws=)`` or draws them from its
generator.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.box_coder import BoxCoder
from ..ops.losses import bce_with_logits, smooth_l1_loss
from ..ops.nms import nms_keep_mask, top_k
from ..structures.boxes import Boxes, clip_to_image, masked_box_iou
from .anchor_generator import rpn_anchor_generator
from .layers import Conv2d
from .matcher import BELOW_LOW_THRESHOLD, balanced_sample, match_boxes

RPN_BOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class RPNHead(nn.Module):
    """SingleConvRPNHead: 3x3 conv + ReLU, 1x1 cls_logits and bbox_pred."""

    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1)
        self.relu = nn.ReLU()
        self.cls_logits = Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = Conv2d(in_channels, 4 * num_anchors, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        """NCHW levels -> per level NHWC float32 (objectness (B, H, W, A),
        deltas (B, H, W, 4A))."""
        objectness, box_reg = [], []
        for f in features:
            t = self.relu(self.conv(f))
            objectness.append(_nhwc(self.cls_logits(t)).float())
            box_reg.append(_nhwc(self.bbox_pred(t)).float())
        return objectness, box_reg


class RPNModule(nn.Module):
    """Holds the head under the reference's ``rpn.head`` name, the anchor
    generator and the box coder."""

    def __init__(self, in_channels: int, anchor_sizes: Sequence[float],
                 aspect_ratios: Sequence[float], anchor_strides: Sequence[int],
                 straddle_thresh: float = 0.0):
        super().__init__()
        self.generator = rpn_anchor_generator(anchor_sizes, aspect_ratios, anchor_strides,
                                              straddle_thresh)
        self.head = RPNHead(in_channels, len(aspect_ratios))
        self.box_coder = BoxCoder(RPN_BOX_WEIGHTS)


def rpn_targets(
    anchors: torch.Tensor,       # (N, 4) every level's, concatenated
    visibility: torch.Tensor,    # (B, N) bool
    gt_xyxy: torch.Tensor,       # (B, G, 4)
    gt_valid: torch.Tensor,      # (B, G)
    box_coder: BoxCoder,
    fg_iou: float = 0.7,
    bg_iou: float = 0.3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels (B, N) int32: 1 foreground, 0 background, -1 discarded;
    regression targets (B, N, 4) to the matched GT)."""
    b = gt_xyxy.shape[0]
    anchors_b = anchors[None].expand(b, -1, -1)
    ones = torch.ones(anchors_b.shape[:2], dtype=torch.bool, device=anchors.device)
    iou = masked_box_iou(gt_xyxy.to(torch.float32), gt_valid, anchors_b, ones)
    matched = match_boxes(iou, gt_valid, fg_iou, bg_iou, allow_low_quality_matches=True)
    labels = (matched >= 0).to(torch.int32)
    labels = torch.where(matched == BELOW_LOW_THRESHOLD, 0, labels)
    labels = torch.where((matched < 0) & (matched != BELOW_LOW_THRESHOLD), -1, labels)
    labels = torch.where(visibility, labels, -1).to(torch.int32)
    idx = torch.clamp(matched, min=0).long()
    matched_gt = torch.gather(gt_xyxy.to(torch.float32), 1, idx[..., None].expand(-1, -1, 4))
    return labels, box_coder.encode(matched_gt, anchors_b)


def rpn_losses(
    u: torch.Tensor,                  # (B, N) sampling priorities in [0, 1)
    objectness: List[torch.Tensor],   # per level (B, H, W, A)
    box_reg: List[torch.Tensor],      # per level (B, H, W, 4A)
    labels: torch.Tensor,             # (B, N)
    reg_targets: torch.Tensor,        # (B, N, 4)
    batch_per_image: int = 256,
    positive_fraction: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(objectness loss, box loss), unscaled."""
    b, n = labels.shape
    obj_flat = torch.cat([o.reshape(b, -1) for o in objectness], dim=1).reshape(-1)
    reg_flat = torch.cat([r.reshape(b, -1, 4) for r in box_reg], dim=1).reshape(-1, 4)
    labels_flat = labels.reshape(-1)

    ones = torch.ones_like(labels, dtype=torch.bool)
    idx, valid = balanced_sample(u, labels, ones, batch_per_image, positive_fraction)
    sampled = torch.zeros_like(ones).scatter(1, idx, valid).reshape(-1)
    pos = sampled & (labels_flat == 1)
    denom = torch.clamp(sampled.sum(), min=1)

    box_l = smooth_l1_loss(reg_flat, reg_targets.reshape(-1, 4), beta=1.0 / 9).sum(-1)
    box_loss = (box_l * pos).sum() / denom
    obj_l = bce_with_logits(obj_flat, (labels_flat == 1).to(torch.float32))
    obj_loss = (obj_l * sampled).sum() / denom
    return obj_loss, box_loss


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, k) -> (B, k, D)."""
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + (x.shape[-1],)))


def rpn_postprocess(
    anchors_per_level: List[torch.Tensor],
    objectness: List[torch.Tensor],
    box_reg: List[torch.Tensor],
    image_sizes_wh: torch.Tensor,
    box_coder: BoxCoder,
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    fpn_post_nms_top_n: int,
    min_size: float = 0.0,
) -> Boxes:
    """Per-level top-k, decode, clip, min-size, NMS and top-k, then the
    FPN-wide top ``fpn_post_nms_top_n`` by objectness."""
    b = objectness[0].shape[0]
    sizes_wh = image_sizes_wh.to(torch.float32)
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for anchors, obj, reg in zip(anchors_per_level, objectness, box_reg):
        n = anchors.shape[0]
        scores = torch.sigmoid(obj.reshape(b, n))
        k = min(pre_nms_top_n, n)
        top_scores, top_idx = top_k(scores, k)
        deltas = _take(reg.reshape(b, n, 4), top_idx)
        decoded = clip_to_image(box_coder.decode(deltas, anchors[top_idx]), sizes_wh)
        ws = decoded[..., 2] - decoded[..., 0] + 1
        hs = decoded[..., 3] - decoded[..., 1] + 1
        valid = (ws >= min_size) & (hs >= min_size)
        keep = nms_keep_mask(decoded, top_scores, valid, nms_thresh)
        ranked = torch.where(keep, top_scores, -torch.inf)
        s2, i2 = top_k(ranked, min(post_nms_top_n, k))
        kept = s2 > -torch.inf
        lvl_boxes.append(_take(decoded, i2))
        lvl_scores.append(torch.where(kept, s2, 0.0))
        lvl_valid.append(kept)

    boxes = torch.cat(lvl_boxes, dim=1)
    scores = torch.cat(lvl_scores, dim=1)
    valid = torch.cat(lvl_valid, dim=1)
    top_scores, top_idx = top_k(torch.where(valid, scores, -torch.inf),
                                min(fpn_post_nms_top_n, boxes.shape[1]))
    out_valid = top_scores > -torch.inf
    out_scores = torch.where(out_valid, top_scores, 0.0)
    return Boxes(xyxy=_take(boxes, top_idx), valid=out_valid, size=sizes_wh,
                 fields={"objectness": out_scores, "scores": out_scores})
