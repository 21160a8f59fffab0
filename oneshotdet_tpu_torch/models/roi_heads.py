"""Combined ROI heads (counterpart of ``oneshotdet_tpu/models/roi_heads.py``).

``CombinedROIHeads`` chains the relation box head with the optional mask
and keypoint heads, each over the features the caller pooled for it (the
box head's 7x7 ROI features where none are given).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .keypoint_head import KeypointHead
from .mask_head import MaskHead
from .roi_head import ROIBoxHead


class CombinedROIHeads(nn.Module):
    """Box (+ mask, + keypoint) heads under the names ``box``, ``mask`` and
    ``keypoint``."""

    def __init__(self, box_num_classes: int = 2, box_num_bbox_reg: int = 2,
                 in_channels: int = 256, mask_on: bool = False, keypoint_on: bool = False,
                 num_keypoints: int = 17):
        super().__init__()
        self.box = ROIBoxHead(in_channels=in_channels, num_classes=box_num_classes,
                              num_bbox_reg=box_num_bbox_reg)
        if mask_on:
            self.mask = MaskHead(in_channels, num_classes=box_num_classes)
        if keypoint_on:
            self.keypoint = KeypointHead(in_channels, num_keypoints=num_keypoints)

    def forward(self, roi_feats: torch.Tensor, supp_feats: torch.Tensor,
                mask_feats: Optional[torch.Tensor] = None,
                keypoint_feats: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        logits, deltas = self.box(roi_feats, supp_feats)
        out = {"class_logits": logits, "box_deltas": deltas}
        if hasattr(self, "mask"):
            out["mask_logits"] = self.mask(roi_feats if mask_feats is None else mask_feats)
        if hasattr(self, "keypoint"):
            out["keypoint_logits"] = self.keypoint(
                roi_feats if keypoint_feats is None else keypoint_feats)
        return out
