"""Faster-RCNN box encode/decode (counterpart of the JAX ``BoxCoder``).

TO_REMOVE=1 widths, weighted deltas, log-ratio clip at log(1000/16), and the
reference's ``- 1`` on decoded x2/y2 ("-1 is correct").
"""

from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)
TO_REMOVE = 1.0


class BoxCoder:
    def __init__(self, weights=(10.0, 10.0, 5.0, 5.0), bbox_xform_clip=BBOX_XFORM_CLIP):
        self.weights = weights
        self.bbox_xform_clip = bbox_xform_clip

    def encode(self, reference_boxes: torch.Tensor, proposals: torch.Tensor) -> torch.Tensor:
        """(..., 4), (..., 4) -> (..., 4) deltas."""
        ex_w = proposals[..., 2] - proposals[..., 0] + TO_REMOVE
        ex_h = proposals[..., 3] - proposals[..., 1] + TO_REMOVE
        ex_cx = proposals[..., 0] + 0.5 * ex_w
        ex_cy = proposals[..., 1] + 0.5 * ex_h
        gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + TO_REMOVE
        gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + TO_REMOVE
        gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
        gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
        wx, wy, ww, wh = self.weights
        return torch.stack(
            [
                wx * (gt_cx - ex_cx) / ex_w,
                wy * (gt_cy - ex_cy) / ex_h,
                ww * torch.log(gt_w / ex_w),
                wh * torch.log(gt_h / ex_h),
            ],
            dim=-1,
        )

    def decode(self, rel_codes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Decode (..., 4*C) interleaved per-class deltas around (..., 4)
        boxes -> (..., 4*C)."""
        boxes = boxes.to(rel_codes.dtype)
        widths = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
        heights = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        dx = rel_codes[..., 0::4] / wx
        dy = rel_codes[..., 1::4] / wy
        dw = torch.clamp(rel_codes[..., 2::4] / ww, max=self.bbox_xform_clip)
        dh = torch.clamp(rel_codes[..., 3::4] / wh, max=self.bbox_xform_clip)

        pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
        pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]

        x1 = pred_ctr_x - 0.5 * pred_w
        y1 = pred_ctr_y - 0.5 * pred_h
        x2 = pred_ctr_x + 0.5 * pred_w - 1
        y2 = pred_ctr_y + 0.5 * pred_h - 1
        out = torch.stack([x1, y1, x2, y2], dim=-1)   # (..., C, 4)
        return out.reshape(out.shape[:-2] + (-1,))
