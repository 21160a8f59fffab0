"""Keypoint R-CNN head (counterpart of ``oneshotdet_tpu/models/keypoint_head.py``).

  - KeypointRCNNFeatureExtractor: ``conv_fcn1..`` 3x3 convs (512 wide) +
    ReLU over the 14x14 pooled ROI features;
  - KeypointRCNNPredictor: ``kps_score_lowres``, a 4x4 stride-2 transposed
    conv to K heatmap logits, then a 2x bilinear upsample (float32);
  - training: each visible keypoint of a positive ROI's matched GT as a
    flat heatmap index (``keypoints_to_heatmap_targets``), softmax
    cross-entropy over the heatmap's positions (``keypoint_head_loss``);
  - eval: the argmax of each heatmap mapped back into the box
    (``heatmaps_to_keypoints``), with the heatmap's maximum as its score.

NHWC in, NHWC float32 heatmaps (N, 4P, 4P, K) out, as in the JAX package.
flax's 4x4 stride-2 ``ConvTranspose`` (SAME) is ``conv_transpose2d`` with
padding 1 on its kernel flipped in both spatial axes; ``jax.image.resize``
bilinear x2 is ``F.interpolate(scale_factor=2, mode="bilinear",
align_corners=False)``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvTranspose2d
from .mask_head import clamped_index


class KeypointRCNNFeatureExtractor(nn.Module):
    def __init__(self, in_channels: int, layers: Sequence[int] = (512,) * 8):
        super().__init__()
        for i, ch in enumerate(layers):
            self.add_module(f"conv_fcn{i + 1}", Conv2d(in_channels, ch, 3, padding=1))
            in_channels = ch
        self.num_layers = len(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in and out."""
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        return x


class KeypointRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int, num_keypoints: int = 17):
        super().__init__()
        self.kps_score_lowres = ConvTranspose2d(in_channels, num_keypoints, 4, stride=2,
                                                padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in, NHWC float32 heatmap logits at 4x the input side out."""
        x = self.kps_score_lowres(x).float()
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1)


class KeypointHead(nn.Module):
    """Feature extractor + predictor: (N, P, P, C) NHWC -> (N, 4P, 4P, K)."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 conv_layers: Sequence[int] = (512,) * 8):
        super().__init__()
        self.feature_extractor = KeypointRCNNFeatureExtractor(in_channels, conv_layers)
        self.predictor = KeypointRCNNPredictor(conv_layers[-1], num_keypoints)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        return self.predictor(self.feature_extractor(roi_feats.permute(0, 3, 1, 2)))


def keypoints_to_heatmap_targets(keypoints: torch.Tensor, boxes: torch.Tensor,
                                 heatmap_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K, 3) keypoints in image coordinates and (N, 4) boxes -> (N, K)
    int32 flat heatmap indices (y * size + x, clamped; NaN as 0) and their
    validity: visible and inside the box's heatmap."""
    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    sx = heatmap_size / torch.clamp(boxes[:, 2:3] - x1, min=1.0)
    sy = heatmap_size / torch.clamp(boxes[:, 3:4] - y1, min=1.0)
    px = torch.floor((keypoints[..., 0] - x1) * sx)
    py = torch.floor((keypoints[..., 1] - y1) * sy)
    inside = (px >= 0) & (px < heatmap_size) & (py >= 0) & (py < heatmap_size)
    valid = inside & (keypoints[..., 2] > 0)
    px = clamped_index(px, heatmap_size - 1)
    py = clamped_index(py, heatmap_size - 1)
    return (py * heatmap_size + px).to(torch.int32), valid


def keypoint_head_loss(kp_logits: torch.Tensor, heatmap_idx: torch.Tensor,
                       kp_valid: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy over each (N, H, W, K) heatmap's positions at
    its target index, averaged over the valid keypoints."""
    n, h, w, k = kp_logits.shape
    logits = kp_logits.permute(0, 3, 1, 2).reshape(n * k, h * w)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, heatmap_idx.reshape(n * k, 1).long())[:, 0]
    wv = kp_valid.reshape(n * k).to(torch.float32)
    return (nll * wv).sum() / torch.clamp(wv.sum(), min=1.0)


def heatmaps_to_keypoints(kp_logits: torch.Tensor, boxes: torch.Tensor):
    """Argmax decode of (N, H, W, K) heatmaps into their (N, 4) boxes:
    ((N, K, 2) image (x, y) at the arg max cell's centre, (N, K) the max)."""
    n, h, w, k = kp_logits.shape
    flat = kp_logits.permute(0, 3, 1, 2).reshape(n, k, h * w)
    scores = flat.amax(dim=-1)
    idx = torch.argmax(flat, dim=-1)     # the first maximum, as jnp.argmax
    py = torch.div(idx, w, rounding_mode="floor").to(torch.float32) + 0.5
    px = (idx % w).to(torch.float32) + 0.5
    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    sx = torch.clamp(boxes[:, 2:3] - x1, min=1.0) / w
    sy = torch.clamp(boxes[:, 3:4] - y1, min=1.0) / h
    return torch.stack([x1 + px * sx, y1 + py * sy], dim=-1), scores
