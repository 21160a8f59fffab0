"""FCOS proposal network (counterpart of ``models/fcos.py``).

  - head: NUM_CONVS x (3x3 conv + GN32 + ReLU) twin towers shared over the
    levels; cls_logits (one class), centerness from the cls tower,
    bbox_pred = exp(Scale_l(conv)); logits, deltas and centerness in float32;
  - locations: x = i * stride + stride // 2;
  - postprocess: sigmoid(cls) * sigmoid(centerness), locations outside the
    true image masked, per-level top-k (``level_topk``) or one global top
    ``nms_pre_topk``, ltrb decode, clip, class-agnostic NMS, top
    ``post_top_n``;
  - training: target assignment (size-of-interest buckets, center sampling
    in a radius * stride box clamped inside the GT, min-area tie-break with
    the +1 area, 100000000 = no match), centerness targets, and the three
    losses: focal / (num_pos + B), GIoU weighted by centerness targets, and
    BCE centerness over positives.

Head outputs are NHWC, flattened per level as (B, H*W) in y*W + x order, as
in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.losses import bce_with_logits, iou_loss, sigmoid_focal_loss, softmax_focal_loss
from ..ops.nms import nms_keep_mask
from ..structures.boxes import Boxes, clip_to_image
from .layers import Conv2d, Scale, conv_gn_relu

INF = 100000000.0

# per-level regression ranges
OBJECT_SIZES_OF_INTEREST = ((-1.0, 64.0), (64.0, 128.0), (128.0, 256.0), (256.0, 512.0),
                            (512.0, INF))


class FCOSHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_convs: int = 4, num_levels: int = 5):
        super().__init__()
        self.cls_tower = nn.Sequential(*[m for _ in range(num_convs) for m in conv_gn_relu(in_channels)])
        self.bbox_tower = nn.Sequential(*[m for _ in range(num_convs) for m in conv_gn_relu(in_channels)])
        self.cls_logits = Conv2d(in_channels, 1, 3, padding=1)   # one class
        self.bbox_pred = Conv2d(in_channels, 4, 3, padding=1)
        self.centerness = Conv2d(in_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList([Scale() for _ in range(num_levels)])

    def forward(self, features: Sequence[torch.Tensor]):
        """NCHW levels -> per-level NHWC float32 (logits, bbox_reg, ctrness)."""
        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        logits, bbox_reg, ctrness = [], [], []
        for lvl, feat in enumerate(features):
            t = self.cls_tower(feat)
            logits.append(nhwc(self.cls_logits(t)).float())
            ctrness.append(nhwc(self.centerness(t)).float())
            bt = self.bbox_tower(feat)
            bbox_reg.append(torch.exp(nhwc(self.scales[lvl](self.bbox_pred(bt))).float()))
        return logits, bbox_reg, ctrness


class FCOSModule(nn.Module):
    """Holds the head under the reference's ``rpn.head`` name."""

    def __init__(self, **head_kwargs):
        super().__init__()
        self.head = FCOSHead(**head_kwargs)


def compute_locations(feature_shapes: Sequence[Tuple[int, int]],
                      strides: Sequence[int], device=None) -> List[torch.Tensor]:
    """Per-level (H*W, 2) float32 (x, y) grids in y*W + x order."""
    out = []
    for (h, w), stride in zip(feature_shapes, strides):
        xs = torch.arange(w, dtype=torch.float32, device=device) * stride + stride // 2
        ys = torch.arange(h, dtype=torch.float32, device=device) * stride + stride // 2
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
    return out


def _flat_level_info(locations: List[torch.Tensor], strides: Sequence[int]):
    """The levels' grids concatenated (P, 2), with each point's stride and
    size-of-interest range (P,)."""
    pts = torch.cat(locations, dim=0)

    def per_point(values):
        return torch.cat([torch.full((loc.shape[0],), float(v), dtype=torch.float32,
                                     device=pts.device) for loc, v in zip(locations, values)])

    return (pts, per_point(strides), per_point(r[0] for r in OBJECT_SIZES_OF_INTEREST),
            per_point(r[1] for r in OBJECT_SIZES_OF_INTEREST))


def fcos_targets(
    locations: List[torch.Tensor],
    strides: Sequence[int],
    gt_xyxy: torch.Tensor,      # (B, G, 4)
    gt_labels: torch.Tensor,    # (B, G) int, 0 = padding
    gt_valid: torch.Tensor,     # (B, G) bool
    center_sample: bool = True,
    radius: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point target assignment: labels (B, P) int32 and reg_targets
    (B, P, 4) float32 (l, t, r, b) to the smallest GT that holds the point
    (in its center-sampling box) and whose largest side distance lies in the
    point's level range; label 0 where none does."""
    pts, stride_pt, lo, hi = _flat_level_info(locations, strides)
    xs, ys = pts[None, :, 0, None], pts[None, :, 1, None]      # (1, P, 1)
    x1, y1, x2, y2 = (gt_xyxy[:, None, :, i] for i in range(4))  # (B, 1, G)

    reg = torch.stack([xs - x1, ys - y1, x2 - xs, y2 - ys], dim=-1)   # (B, P, G, 4)
    if center_sample:
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        rad = (stride_pt * radius)[None, :, None]
        sx1 = torch.maximum(cx - rad, x1)
        sy1 = torch.maximum(cy - rad, y1)
        sx2 = torch.minimum(cx + rad, x2)
        sy2 = torch.minimum(cy + rad, y2)
        inside = (xs - sx1 > 0) & (sy2 - ys > 0) & (sx2 - xs > 0) & (ys - sy1 > 0)
    else:
        inside = reg.min(dim=-1).values > 0

    max_reg = reg.max(dim=-1).values
    cared = (max_reg >= lo[None, :, None]) & (max_reg <= hi[None, :, None])
    area = (gt_xyxy[..., 2] - gt_xyxy[..., 0] + 1.0) * (gt_xyxy[..., 3] - gt_xyxy[..., 1] + 1.0)
    area = torch.where(inside & cared & gt_valid[:, None, :], area[:, None, :], INF)
    min_area, min_idx = area.min(dim=-1)                       # (B, P)

    labels = torch.gather(gt_labels, 1, min_idx)
    labels = torch.where(min_area == INF, 0, labels).to(torch.int32)
    reg_targets = torch.gather(reg, 2, min_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    return labels, reg_targets


def centerness_targets(reg_targets: torch.Tensor) -> torch.Tensor:
    """sqrt((min(l, r) / max(l, r)) * (min(t, b) / max(t, b)))."""
    lr = reg_targets[..., 0::2]
    tb = reg_targets[..., 1::2]
    c = (lr.min(-1).values / torch.clamp(lr.max(-1).values, min=1e-9)) * (
        tb.min(-1).values / torch.clamp(tb.max(-1).values, min=1e-9))
    return torch.sqrt(torch.clamp(c, min=0.0))


def fcos_losses(
    logits: List[torch.Tensor],       # per level (B, H, W, C)
    bbox_reg: List[torch.Tensor],     # per level (B, H, W, 4)
    ctrness: List[torch.Tensor],      # per level (B, H, W, 1)
    labels: torch.Tensor,             # (B, P)
    reg_targets: torch.Tensor,        # (B, P, 4)
    gamma: float = 2.0,
    alpha: float = 0.25,
    loc_loss_type: str = "giou",
    focal_mode: str = "SIGMOID",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cls_loss, reg_loss, centerness_loss) over the levels flattened in
    y * W + x order."""
    n, c = logits[0].shape[0], logits[0].shape[-1]
    cls_flat = torch.cat([x.reshape(n, -1, c) for x in logits], dim=1).reshape(-1, c)
    reg_flat = torch.cat([x.reshape(n, -1, 4) for x in bbox_reg], dim=1).reshape(-1, 4)
    ctr_flat = torch.cat([x.reshape(n, -1) for x in ctrness], dim=1).reshape(-1)
    labels_flat = labels.reshape(-1)
    reg_t_flat = reg_targets.reshape(-1, 4)

    pos = labels_flat > 0
    num_pos = pos.sum()
    focal = sigmoid_focal_loss if focal_mode == "SIGMOID" else softmax_focal_loss
    cls_loss = focal(cls_flat, labels_flat, gamma, alpha) / (num_pos + n)

    ctr_t = centerness_targets(reg_t_flat)
    reg_loss = iou_loss(reg_flat, reg_t_flat, torch.where(pos, ctr_t, 0.0), loc_loss_type)
    ctr_bce = bce_with_logits(ctr_flat, ctr_t)
    ctr_loss = torch.where(num_pos > 0, (ctr_bce * pos).sum() / torch.clamp(num_pos, min=1),
                           0.0)
    return cls_loss, reg_loss, ctr_loss


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, k) -> (B, k, D)."""
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + (x.shape[-1],)))


def fcos_postprocess(
    locations: List[torch.Tensor],
    logits: List[torch.Tensor],
    bbox_reg: List[torch.Tensor],
    ctrness: List[torch.Tensor],
    image_sizes_wh: torch.Tensor,
    pre_nms_top_n: int,
    nms_thresh: float,
    post_top_n: int,
    nms_pre_topk: int = 8192,
    pre_nms_thresh: float = 0.0,
    score_mode: str = "BINARY",
    level_topk: bool = True,
) -> Boxes:
    """Decode + top-k + cross-level NMS -> padded proposal Boxes with
    xyxy (B, post_top_n, 4) and fields 'scores' and 'objectness'."""
    b = logits[0].shape[0]
    sizes_wh = image_sizes_wh.to(torch.float32)

    def level_scores(loc, lg, ct):
        c = lg.shape[-1]
        if score_mode == "BINARY":
            cls = torch.sigmoid(lg.reshape(b, -1, c))[..., 0]
        else:
            cls = torch.softmax(lg.reshape(b, -1, c)[..., :2], dim=-1)[..., 1]
        ctr = torch.sigmoid(ct.reshape(b, -1))
        in_img = (loc[None, :, 0] < sizes_wh[:, 0:1]) & (loc[None, :, 1] < sizes_wh[:, 1:2])
        return torch.where((cls > pre_nms_thresh) & in_img, cls * ctr, -1.0)

    def decode(loc_k, reg_k):
        return torch.stack([
            loc_k[..., 0] - reg_k[..., 0],
            loc_k[..., 1] - reg_k[..., 1],
            loc_k[..., 0] + reg_k[..., 2],
            loc_k[..., 1] + reg_k[..., 3],
        ], dim=-1)

    if level_topk:
        per_boxes, per_scores = [], []
        for loc, lg, br, ct in zip(locations, logits, bbox_reg, ctrness):
            score = level_scores(loc, lg, ct)
            top_scores, top_idx = torch.topk(score, min(pre_nms_top_n, score.shape[1]), dim=1)
            per_boxes.append(decode(loc[top_idx], _take(br.reshape(b, -1, 4), top_idx)))
            per_scores.append(top_scores)
        boxes = torch.cat(per_boxes, dim=1)
        scores = torch.cat(per_scores, dim=1)
    else:
        all_scores = torch.cat([level_scores(loc, lg, ct)
                                for loc, lg, ct in zip(locations, logits, ctrness)], dim=1)
        all_reg = torch.cat([br.reshape(b, -1, 4) for br in bbox_reg], dim=1)
        all_loc = torch.cat(locations, dim=0)
        scores, top_idx = torch.topk(all_scores, min(nms_pre_topk, all_scores.shape[1]), dim=1)
        boxes = decode(all_loc[top_idx], _take(all_reg, top_idx))
    valid = scores > max(pre_nms_thresh, 0.0)

    boxes = clip_to_image(boxes, sizes_wh)

    if boxes.shape[1] > nms_pre_topk:
        scores, cap_idx = torch.topk(torch.where(valid, scores, -1.0), nms_pre_topk, dim=1)
        boxes = _take(boxes, cap_idx)
        valid = torch.gather(valid, 1, cap_idx) & (scores > -0.5)

    keep = nms_keep_mask(boxes, scores, valid, nms_thresh)
    ranked = torch.where(keep, scores, -torch.inf)
    top_scores, top_idx = torch.topk(ranked, min(post_top_n, ranked.shape[1]), dim=1)
    out_boxes = _take(boxes, top_idx)
    out_valid = top_scores > -torch.inf
    out_scores = torch.where(out_valid, top_scores, 0.0)

    pad = post_top_n - out_boxes.shape[1]
    if pad > 0:
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    return Boxes(xyxy=out_boxes, valid=out_valid, size=sizes_wh,
                 fields={"scores": out_scores, "objectness": out_scores})
