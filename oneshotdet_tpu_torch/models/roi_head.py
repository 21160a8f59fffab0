"""Stage-2 relation head, 'concat' method (counterpart of ``models/roi_head.py``).

  - compress_dim_conv: [1x1 conv 2C->2C + GN32 + LeakyReLU(0.2),
    1x1 conv 2C->C + GN32 + LeakyReLU(0.2)] over the channel concat of the
    7x7 query ROI features and the 7x7 whole-support features;
  - feature_aggreg: 3x3 conv C->C/2 + GN32 + LeakyReLU(0.2);
  - fc6 (C/2*49 -> 1024) and fc7 (1024 -> 1024), ReLU after each, over the
    channel-major flatten;
  - predictor: cls_score and bbox_pred (logits and deltas in float32);
  - eval postprocess: class-1 softmax (or sigmoid) score, BoxCoder decode of
    the class-1 slot, clip, per-image NMS, top-k, the episode's label;
  - training: IoU matching of the proposals to the GT, labels, BoxCoder
    targets and balanced sampling (``prepare_roi_targets``), and the CE
    class loss with smooth-L1 over the positives' regression slots
    (``roi_head_loss``).

ROI features are NHWC (N, 7, 7, C); the 1x1 convs run as matmuls over the
last axis, the 3x3 conv on the channels_last NCHW view of the same memory.
With ``use_fused`` (the eval opt-in) the whole head runs as one fused op,
``ops.roi_head_fused`` (the CUDA kernel on the card), wherever the JAX
package would take its fused kernel; otherwise it runs through the layers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_coder import BoxCoder
from ..ops.losses import cross_entropy, smooth_l1_loss
from ..ops.nms import nms_keep_mask
from ..ops.roi_head_fused import (check_kernel_widths, fused_head_applies, fused_roi_head,
                                  kernel_operands, pack_roi_head_params)
from ..structures.boxes import Boxes, clip_to_image, masked_box_iou
from .layers import Conv2d, GroupNorm, Linear
from .matcher import BELOW_LOW_THRESHOLD, BETWEEN_THRESHOLDS, balanced_sample, match_boxes


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
        self.resolution = resolution
        self._fused_cache = {}         # dtype -> (parameter key, operands)
        # set by ``export`` while it traces: the operands the exported
        # program holds as its own buffers
        self.operands_override = None
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

    def _fused_operands(self, dtype: torch.dtype):
        """Kernel operands of the current parameters for ``dtype``, packed
        once per dtype and packed again after any parameter changes
        (load_state_dict, in-place edits); ``operands_override`` where set."""
        if self.operands_override is not None:
            return self.operands_override
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        cached = self._fused_cache.get(dtype)
        if cached is None or cached[0] != key:
            cached = (key, kernel_operands(pack_roi_head_params(self), dtype))
            self._fused_cache[dtype] = cached
        return cached[1]

    def forward(self, roi_feats: torch.Tensor, supp_feats: torch.Tensor,
                use_fused: bool = False):
        """roi_feats (N, 7, 7, C); supp_feats (N, 7, 7, C), or (B, 7, 7, C)
        with B dividing N (one support per image, image-major ROIs).
        Returns float32 logits (N, ncls) and deltas (N, 4 * nreg).

        ``use_fused`` (the eval path with the fused head switched on) runs
        the fused head where the JAX package's gate takes its kernel:
        resolution 7, one support per image (B != N, B divides N) and a
        per-image ROI count that is a positive multiple of 8. Off the CPU it
        raises NotImplementedError first where the kernel does not take the
        head's widths (``check_kernel_widths``)."""
        n, b = roi_feats.shape[0], supp_feats.shape[0]
        if (use_fused and self.resolution == 7 and b != n and n % b == 0
                and fused_head_applies(n // b)):
            if roi_feats.device.type != "cpu":
                check_kernel_widths(self.in_channels, self.in_channels // 2,
                                    self.fc7.out_features)
            return fused_roi_head(roi_feats, supp_feats,
                                  self._fused_operands(roi_feats.dtype), n // b)
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


def prepare_roi_targets(
    u: torch.Tensor,           # (B, N) uniform sampling priorities
    proposals: Boxes,          # batched (B, N)
    gt: Boxes,                 # batched (B, G), field 'labels'
    box_coder: BoxCoder,
    batch_size_per_image: int = 128,
    positive_fraction: float = 0.25,
    fg_iou_threshold: float = 0.5,
    bg_iou_threshold: float = 0.5,
):
    """Match, label, encode and sample S = ``batch_size_per_image``
    proposals per image. Labels: the matched GT's label, 0 below the low
    threshold, -1 between the thresholds and on padding. Returns
    (sampled_idx (B, S), sampled_valid (B, S), labels (B, S), reg_targets
    (B, S, 4), matched_gt_idx (B, S), the clamped index of each sampled
    proposal's GT)."""
    iou = masked_box_iou(gt.xyxy, gt.valid, proposals.xyxy, proposals.valid)   # (B, G, N)
    matched = match_boxes(iou, gt.valid, fg_iou_threshold, bg_iou_threshold)
    clamped = torch.clamp(matched, min=0).long()
    labels = torch.gather(gt.get_field("labels"), 1, clamped).to(torch.int32)
    labels = torch.where(matched == BELOW_LOW_THRESHOLD, 0, labels)
    labels = torch.where(matched == BETWEEN_THRESHOLDS, -1, labels)
    labels = torch.where(proposals.valid, labels, -1).to(torch.int32)
    matched_gt = torch.gather(gt.xyxy, 1, clamped[..., None].expand(-1, -1, 4))
    reg_targets = box_coder.encode(matched_gt, proposals.xyxy)
    idx, s_valid = balanced_sample(u, labels, proposals.valid, batch_size_per_image,
                                   positive_fraction)
    return (idx, s_valid, torch.gather(labels, 1, idx),
            torch.gather(reg_targets, 1, idx[..., None].expand(-1, -1, 4)),
            torch.gather(clamped, 1, idx))


def roi_head_loss(
    logits: torch.Tensor,         # (B*S, num_classes)
    deltas: torch.Tensor,         # (B*S, 4*num_reg)
    labels: torch.Tensor,         # (B, S)
    reg_targets: torch.Tensor,    # (B, S, 4)
    sampled_valid: torch.Tensor,  # (B, S)
    cls_loss_type: str = "ce_loss",
    cls_agnostic_bbox_reg: bool = False,
    loss_weighted: bool = False,
    soft_labels: Optional[torch.Tensor] = None,
    neg_logits: Optional[torch.Tensor] = None,
    rev_logits: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls_loss, box_loss): softmax CE over the valid sampled slots (class
    weights 0.25 / 0.75 with ``loss_weighted``), and smooth-L1 (beta 1) of
    the positives' regression slot 4 * label + [0..3] (slot 1 when
    class-agnostic) over the valid count. The other class losses, soft
    labels, the neg-support and the reverse-order terms are not ported."""
    if cls_loss_type != "ce_loss" or soft_labels is not None:
        raise NotImplementedError(f"roi_head_loss: {cls_loss_type} / soft labels not ported")
    if neg_logits is not None or rev_logits is not None:
        raise NotImplementedError("roi_head_loss: neg-support / reverse-order terms not ported")
    labels_flat = labels.reshape(-1)
    valid_flat = sampled_valid.reshape(-1) & (labels_flat >= 0)
    pos = (labels_flat > 0) & valid_flat

    weight = None
    if loss_weighted:
        weight = torch.tensor([0.25] + [0.75] * (logits.shape[-1] - 1), device=logits.device)
    cls_loss = cross_entropy(logits, labels_flat, weight=weight, valid=valid_flat)

    d = deltas.reshape(deltas.shape[0], -1, 4)
    if cls_agnostic_bbox_reg:
        slot = torch.ones_like(labels_flat)
    else:
        slot = torch.clamp(labels_flat, min=0)
    slot = torch.clamp(slot, max=d.shape[1] - 1).long()
    picked = torch.gather(d, 1, slot[:, None, None].expand(-1, 1, 4))[:, 0]
    box_l = smooth_l1_loss(picked, reg_targets.reshape(-1, 4), beta=1.0).sum(-1)
    box_loss = (box_l * pos).sum() / torch.clamp(valid_flat.sum(), min=1)
    return cls_loss, box_loss


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
