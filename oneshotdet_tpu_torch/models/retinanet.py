"""RetinaNet, the one-stage alternative with MODEL.FCOS_ON False and
MODEL.RETINANET_ON (counterpart of ``oneshotdet_tpu/models/retinanet.py``).

  - head: twin towers of 4 x (3x3 conv + ReLU), no GroupNorm, shared over
    the levels; 3x3 ``cls_logits`` (A * C logits a cell, the prior bias
    -log((1 - 0.01) / 0.01)) and 3x3 ``bbox_pred`` (4 A deltas); outputs
    NHWC float32; under TPU.QUANT ('int8', 'int8_weight') the eight tower
    convs are int8 (``ops.quant.make_conv``: under 'int8' one activation
    scale per conv call, so per level) and the two predictors stay in the
    compute dtype, as the JAX package's;
  - anchors: 3 octave scales x 3 ratios a cell (A = 9), BoxCoder(10, 10, 5, 5);
  - losses: anchors matched at IoU 0.5 / 0.4 with the low-quality matches
    kept; sigmoid focal loss (gamma 2, alpha 0.25) over every anchor with a
    label >= 0, over (num_pos + B); smooth-L1 (beta 0.11) over the
    positives, over num_pos, x4;
  - inference: per level the top ``pre_nms_top_n`` of the best class's
    sigmoid, decoded and clipped, those above ``inference_th`` valid; then
    one NMS over every level's candidates and the top
    ``detections_per_img``, field 'scores'.

As in the JAX package, the head's depth, prior, focal and smooth-L1
settings are these constants, not MODEL.RETINANET's NUM_CONVS, PRIOR_PROB,
LOSS_GAMMA / ALPHA, BBOX_REG_BETA and BBOX_REG_WEIGHT.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.box_coder import BoxCoder
from ..ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ..ops.nms import nms_keep_mask, top_k
from ..structures.boxes import Boxes, clip_to_image, masked_box_iou
from .anchor_generator import retinanet_anchor_generator
from ..ops.quant import make_conv
from .layers import Conv2d
from .matcher import BELOW_LOW_THRESHOLD, match_boxes

NUM_CONVS = 4
PRIOR_PROB = 0.01
FOCAL_GAMMA, FOCAL_ALPHA = 2.0, 0.25
BOX_BETA, BOX_WEIGHT = 0.11, 4.0
RETINA_BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _tower(channels: int, quant: str = "none") -> nn.Sequential:
    """Convs at 2i, ReLUs at 2i + 1: the reference's indices."""
    return nn.Sequential(*[m for _ in range(NUM_CONVS)
                           for m in (make_conv(quant, channels, channels, 3, padding=1),
                                     nn.ReLU())])


class RetinaNetHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 1, num_anchors: int = 9,
                 quant: str = "none"):
        super().__init__()
        self.cls_tower = _tower(in_channels, quant)
        self.bbox_tower = _tower(in_channels, quant)
        self.cls_logits = Conv2d(in_channels, num_anchors * num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, 3, padding=1)

    def forward(self, features: Sequence[torch.Tensor]):
        """NCHW levels -> per level NHWC float32 (logits (B, H, W, A C),
        deltas (B, H, W, 4A))."""
        logits, bbox_reg = [], []
        for f in features:
            logits.append(_nhwc(self.cls_logits(self.cls_tower(f))).float())
            bbox_reg.append(_nhwc(self.bbox_pred(self.bbox_tower(f))).float())
        return logits, bbox_reg


class RetinaNetModule(nn.Module):
    """Holds the head under the reference's ``rpn.head`` name, the octave
    anchor generator and the box coder."""

    def __init__(self, in_channels: int, num_classes: int, anchor_sizes: Sequence[float],
                 anchor_strides: Sequence[int], aspect_ratios: Sequence[float],
                 octave: float = 2.0, scales_per_octave: int = 3, quant: str = "none"):
        super().__init__()
        self.generator = retinanet_anchor_generator(anchor_sizes, aspect_ratios, anchor_strides,
                                                    octave, scales_per_octave)
        self.head = RetinaNetHead(in_channels, num_classes,
                                  len(aspect_ratios) * scales_per_octave, quant)
        self.box_coder = BoxCoder(RETINA_BOX_WEIGHTS)


def retina_prior_bias() -> float:
    return -math.log((1 - PRIOR_PROB) / PRIOR_PROB)


def retinanet_losses(
    anchors_all: torch.Tensor,      # (N, 4)
    logits: List[torch.Tensor],     # per level (B, H, W, A C)
    bbox_reg: List[torch.Tensor],   # per level (B, H, W, 4A)
    gt_xyxy: torch.Tensor,          # (B, G, 4)
    gt_labels: torch.Tensor,        # (B, G)
    gt_valid: torch.Tensor,         # (B, G)
    box_coder: BoxCoder,
    num_classes: int,
    fg_iou: float = 0.5,
    bg_iou: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(classification loss, box loss)."""
    b = gt_xyxy.shape[0]
    anchors_b = anchors_all[None].expand(b, -1, -1)
    ones = torch.ones(anchors_b.shape[:2], dtype=torch.bool, device=anchors_all.device)
    gt = gt_xyxy.to(torch.float32)
    iou = masked_box_iou(gt, gt_valid, anchors_b, ones)
    matched = match_boxes(iou, gt_valid, fg_iou, bg_iou, allow_low_quality_matches=True)
    idx = torch.clamp(matched, min=0).long()
    labels = torch.gather(gt_labels.long(), 1, idx)
    labels = torch.where(matched == BELOW_LOW_THRESHOLD, 0, labels)
    labels = torch.where((matched < 0) & (matched != BELOW_LOW_THRESHOLD), -1, labels)
    reg_t = box_coder.encode(torch.gather(gt, 1, idx[..., None].expand(-1, -1, 4)), anchors_b)

    cls_flat = torch.cat([x.reshape(b, -1, num_classes) for x in logits],
                         dim=1).reshape(-1, num_classes)
    reg_flat = torch.cat([x.reshape(b, -1, 4) for x in bbox_reg], dim=1).reshape(-1, 4)
    labels_flat = labels.reshape(-1)

    pos = labels_flat > 0
    num_pos = torch.clamp(pos.sum(), min=1)
    cls_loss = sigmoid_focal_loss(cls_flat, labels_flat, FOCAL_GAMMA, FOCAL_ALPHA) / (num_pos + b)
    box_l = smooth_l1_loss(reg_flat, reg_t.reshape(-1, 4), beta=BOX_BETA).sum(-1)
    box_loss = (box_l * pos).sum() / num_pos * BOX_WEIGHT
    return cls_loss, box_loss


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + (x.shape[-1],)))


def retinanet_postprocess(
    anchors_per_level: List[torch.Tensor],
    logits: List[torch.Tensor],
    bbox_reg: List[torch.Tensor],
    image_sizes_wh: torch.Tensor,
    box_coder: BoxCoder,
    num_classes: int,
    pre_nms_top_n: int,
    inference_th: float,
    nms_thresh: float,
    detections_per_img: int,
) -> Boxes:
    """Per-level top-k and decode, one cross-level NMS, the top
    ``detections_per_img``: Boxes of capacity min(detections_per_img, the
    candidates) with the field 'scores'."""
    b = logits[0].shape[0]
    sizes_wh = image_sizes_wh.to(torch.float32)
    lvl_boxes, lvl_scores = [], []
    for anchors, lg, br in zip(anchors_per_level, logits, bbox_reg):
        n = anchors.shape[0]
        scores = torch.sigmoid(lg.reshape(b, n, num_classes)).amax(-1)
        top_scores, top_idx = top_k(scores, min(pre_nms_top_n, n))
        deltas = _take(br.reshape(b, n, 4), top_idx)
        lvl_boxes.append(clip_to_image(box_coder.decode(deltas, anchors[top_idx]), sizes_wh))
        lvl_scores.append(top_scores)
    boxes = torch.cat(lvl_boxes, dim=1)
    scores = torch.cat(lvl_scores, dim=1)
    keep = nms_keep_mask(boxes, scores, scores > inference_th, nms_thresh)
    ranked = torch.where(keep, scores, -torch.inf)
    top_scores, top_idx = top_k(ranked, min(detections_per_img, ranked.shape[1]))
    out_valid = top_scores > -torch.inf
    return Boxes(xyxy=_take(boxes, top_idx), valid=out_valid, size=sizes_wh,
                 fields={"scores": torch.where(out_valid, top_scores, 0.0)})
