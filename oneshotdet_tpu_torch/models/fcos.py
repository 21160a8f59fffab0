"""FCOS proposal network, eval side (counterpart of ``models/fcos.py``).

  - head: NUM_CONVS x (3x3 conv + GN32 + ReLU) twin towers shared over the
    levels; cls_logits (one class), centerness from the cls tower,
    bbox_pred = exp(Scale_l(conv)); logits, deltas and centerness in float32;
  - locations: x = i * stride + stride // 2;
  - postprocess: sigmoid(cls) * sigmoid(centerness), locations outside the
    true image masked, per-level top-k (``level_topk``) or one global top
    ``nms_pre_topk``, ltrb decode, clip, class-agnostic NMS, top
    ``post_top_n``.

Head outputs are NHWC, flattened per level as (B, H*W) in y*W + x order, as
in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.nms import nms_keep_mask
from ..structures.boxes import Boxes, clip_to_image
from .layers import Conv2d, Scale, conv_gn_relu


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
