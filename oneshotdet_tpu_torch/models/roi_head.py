"""Stage-2 relation head, 'concat' method (counterpart of ``models/roi_head.py``).

  - compress_dim_conv: [1x1 conv 2C->2C + GN32 + LeakyReLU(0.2),
    1x1 conv 2C->C + GN32 + LeakyReLU(0.2)] over the channel concat of the
    7x7 query ROI features and the 7x7 whole-support features;
  - feature_aggreg: 3x3 conv C->C/2 + GN32 + LeakyReLU(0.2);
  - fc6 (C/2*49 -> 1024) and fc7 (1024 -> 1024), ReLU after each, over the
    channel-major flatten;
  - predictor: cls_score and bbox_pred (logits and deltas in float32);
  - eval postprocess: class-1 softmax (or sigmoid) score, BoxCoder decode of
    the class-1 slot, clip, per-image NMS, top-k, the episode's label.

ROI features are NHWC (N, 7, 7, C); the 1x1 convs run as matmuls over the
last axis, the 3x3 conv on the channels_last NCHW view of the same memory.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_coder import BoxCoder
from ..ops.nms import nms_keep_mask
from ..structures.boxes import Boxes, clip_to_image
from .layers import Conv2d, GroupNorm, Linear


def predictor_num_classes(method: str, cls_loss: str, neg_supp: bool) -> Tuple[int, int]:
    """(num_classes, num_bbox_reg_classes) decision table."""
    if method == "rn":
        num_classes = 1 if cls_loss == "focal_loss" else 2
    elif method == "concat":
        if cls_loss == "focal_loss":
            num_classes = 2 if neg_supp else 1
        elif cls_loss in ("ce_loss", "cxe_loss"):
            num_classes = 2
        elif cls_loss in ("mse_loss", "l1_loss"):
            num_classes = 1
        else:
            raise ValueError(f"unsupported SECOND_STAGE_CLS_LOSS {cls_loss}")
    else:
        raise ValueError(f"unsupported SECOND_STAGE_METHOD {method}")
    if cls_loss in ("focal_loss", "mse_loss", "l1_loss"):
        return num_classes, num_classes + 1
    return num_classes, num_classes


def _nhwc_apply(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW module (GN, 3x3 conv) to an NHWC tensor, NHWC out."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class FPNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int, num_bbox_reg: int):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes)
        self.bbox_pred = Linear(in_features, 4 * num_bbox_reg)


class ROIBoxHead(nn.Module):
    def __init__(self, in_channels: int = 256, resolution: int = 7,
                 representation_size: int = 1024, num_classes: int = 2,
                 num_bbox_reg: int = 2):
        super().__init__()
        c = in_channels
        self.in_channels = c
        self.compress_dim_conv = nn.Sequential(
            Conv2d(2 * c, 2 * c, 1), GroupNorm(32, 2 * c, eps=1e-5), nn.LeakyReLU(0.2),
            Conv2d(2 * c, c, 1), GroupNorm(32, c, eps=1e-5), nn.LeakyReLU(0.2),
        )
        self.feature_aggreg = nn.Sequential(
            Conv2d(c, c // 2, 3, padding=1), GroupNorm(32, c // 2, eps=1e-5), nn.LeakyReLU(0.2),
        )
        self.fc6 = Linear(c // 2 * resolution * resolution, representation_size)
        self.fc7 = Linear(representation_size, representation_size)
        self.predictor = FPNPredictor(representation_size, num_classes, num_bbox_reg)

    def forward(self, roi_feats: torch.Tensor, supp_feats: torch.Tensor):
        """roi_feats (N, 7, 7, C); supp_feats (N, 7, 7, C), or (B, 7, 7, C)
        with B dividing N (one support per image, image-major ROIs).
        Returns float32 logits (N, ncls) and deltas (N, 4 * nreg)."""
        c = self.in_channels
        conv0, gn0, act0, conv1, gn1, act1 = self.compress_dim_conv
        w0 = conv0.weight.to(roi_feats.dtype)[:, :, 0, 0]        # (2C out, 2C in)
        # conv(cat(q, s)) = q @ Wq + (s @ Ws + bias): the concat is never built
        # and the support half is computed once per image
        ya = roi_feats @ w0[:, :c].t()
        yb = supp_feats @ w0[:, c:].t() + conv0.bias.to(roi_feats.dtype)
        n, b = ya.shape[0], yb.shape[0]
        x = (ya.view(b, n // b, *ya.shape[1:]) + yb[:, None]).view(ya.shape)
        x = act0(_nhwc_apply(gn0, x))
        x = F.linear(x, conv1.weight.to(x.dtype)[:, :, 0, 0], conv1.bias.to(x.dtype))
        x = act1(_nhwc_apply(gn1, x))

        x = self.feature_aggreg(x.permute(0, 3, 1, 2))          # (N, C/2, 7, 7)
        x = F.relu(self.fc6(x.flatten(1)))                       # channel-major
        x = F.relu(self.fc7(x))
        logits = self.predictor.cls_score(x).float()
        deltas = self.predictor.bbox_pred(x).float()
        return logits, deltas


class ROIHeads(nn.Module):
    """Holds the box head under the reference's ``roi_heads.box`` name."""

    def __init__(self, **box_kwargs):
        super().__init__()
        self.box = ROIBoxHead(**box_kwargs)


def roi_head_postprocess(
    logits: torch.Tensor,       # (B*P, num_classes)
    deltas: torch.Tensor,       # (B*P, 4*num_reg)
    proposals: Boxes,           # (B, P)
    target_ids: torch.Tensor,   # (B,)
    box_coder: BoxCoder,
    score_thresh: float = 0.0,
    nms_thresh: float = 0.5,
    detections_per_img: int = 2000,
    cls_loss_type: str = "ce_loss",
) -> Boxes:
    """Class-1 scores and boxes -> NMS -> top-k padded detections with fields
    'scores' and 'labels'."""
    b, p = proposals.valid.shape
    deltas = deltas[:, :8]
    if cls_loss_type in ("focal_loss", "mse_loss", "l1_loss"):
        fg = torch.sigmoid(logits)[:, 0]
    else:
        fg = torch.softmax(logits[:, :2], dim=-1)[:, 1]
    scores = fg.reshape(b, p)

    decoded = box_coder.decode(deltas, proposals.xyxy.reshape(-1, 4))
    boxes_fg = clip_to_image(decoded.reshape(b, p, -1)[..., 4:8], proposals.size)

    valid = proposals.valid & (scores > score_thresh)
    keep = nms_keep_mask(boxes_fg, scores, valid, nms_thresh)
    ranked = torch.where(keep, scores, -torch.inf)
    k = min(detections_per_img, p)
    top_scores, top_idx = torch.topk(ranked, k, dim=1)
    out_boxes = torch.gather(boxes_fg, 1, top_idx[..., None].expand(b, k, 4))
    out_valid = top_scores > -torch.inf
    out_scores = torch.where(out_valid, top_scores, 0.0)
    labels = target_ids.to(torch.int32)[:, None].expand(b, k)
    return Boxes(xyxy=out_boxes, valid=out_valid, size=proposals.size,
                 fields={"scores": out_scores, "labels": labels})
