"""Mask R-CNN mask head (counterpart of ``oneshotdet_tpu/models/mask_head.py``).

  - MaskRCNNFPNFeatureExtractor: ``mask_fcn1..`` 3x3 convs (256 wide) + ReLU
    over the 14x14 pooled ROI features;
  - MaskRCNNPredictor: ``conv5_mask``, a 2x2 stride-2 transposed conv + ReLU,
    then ``mask_fcn_logits``, a 1x1 conv to per-class 28x28 logits;
  - training: each sampled ROI's target is its matched GT's mask raster
    (``TPU.MASK_RASTER``^2 over the GT box) resampled bilinearly under the
    ROI -> GT box map (``project_gt_rasters``), and the loss is the BCE of
    the matched class's channel over the positives (``mask_head_loss``);
  - eval: the sigmoid of the foreground channel, pasted into the image on
    the host (``paste_mask_in_image``, numpy).

ROI features come in NHWC (N, P, P, C) and logits leave NHWC (N, 2P, 2P,
ncls) in float32, as in the JAX package. The convs run on the
channels_last NCHW view of the same memory. flax's ``ConvTranspose`` (no
kernel transpose, SAME padding) is ``conv_transpose2d`` with padding 0 on
its kernel flipped in both spatial axes, (in, out, kh, kw) here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.image_io import resize_bilinear
from ..ops.losses import bce_with_logits
from ..ops.quant import make_conv
from .layers import Conv2d, ConvTranspose2d


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def clamped_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """Float indices clamped to [0, hi] as int64, NaN taken as 0: where a
    box holds NaN (a diverged step) the JAX package's gathers clamp their
    indices into range, and an index out of range must not reach a CUDA
    gather."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0, hi).long()


class MaskRCNNFPNFeatureExtractor(nn.Module):
    """``quant`` (TPU.QUANT) makes the fcn convs int8."""

    def __init__(self, in_channels: int, layers: Sequence[int] = (256, 256, 256, 256),
                 quant: str = "none"):
        super().__init__()
        self.out_channels = layers[-1]
        for i, ch in enumerate(layers):
            self.add_module(f"mask_fcn{i + 1}", make_conv(quant, in_channels, ch, 3, padding=1))
            in_channels = ch
        self.num_layers = len(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in and out."""
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return x


class MaskRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 2, dim_reduced: int = 256):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2, stride=2, padding=0)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in, NHWC float32 logits out."""
        x = F.relu(self.conv5_mask(x))
        return self.mask_fcn_logits(x).permute(0, 2, 3, 1).float()


class MaskHead(nn.Module):
    """Feature extractor + predictor: (N, P, P, C) NHWC -> (N, 2P, 2P,
    num_classes) float32 logits."""

    def __init__(self, in_channels: int, num_classes: int = 2,
                 conv_layers: Sequence[int] = (256, 256, 256, 256), quant: str = "none"):
        super().__init__()
        self.feature_extractor = MaskRCNNFPNFeatureExtractor(in_channels, conv_layers, quant)
        self.predictor = MaskRCNNPredictor(conv_layers[-1], num_classes)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        return self.predictor(self.feature_extractor(_nchw(roi_feats)))


def project_masks_on_boxes(gt_masks: torch.Tensor, boxes: torch.Tensor,
                           mask_size: int) -> torch.Tensor:
    """(N, H, W) masks in image coordinates, aligned with (N, 4) xyxy boxes
    -> (N, mask_size, mask_size): the nearest pixel at ``mask_size``
    evenly spaced points from each box's corner to corner (extent at least
    one pixel)."""
    n, h, w = gt_masks.shape
    t = torch.linspace(0.0, 1.0, mask_size, device=boxes.device)
    gy = boxes[:, 1:2] + t[None] * torch.clamp(boxes[:, 3:4] - boxes[:, 1:2], min=1.0)
    gx = boxes[:, 0:1] + t[None] * torch.clamp(boxes[:, 2:3] - boxes[:, 0:1], min=1.0)
    yi = clamped_index(torch.round(gy), h - 1)
    xi = clamped_index(torch.round(gx), w - 1)
    rows = torch.gather(gt_masks, 1, yi[:, :, None].expand(n, mask_size, w))
    return torch.gather(rows, 2, xi[:, None, :].expand(n, mask_size, mask_size))


def project_gt_rasters(rasters: torch.Tensor, gt_boxes: torch.Tensor,
                       prop_boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Mask targets of the sampled ROIs: (N, S, S) rasters of their matched
    GT masks over the GT boxes (N, 4), resampled bilinearly at the
    ``out_size`` x ``out_size`` cell centres of the ROI boxes (N, 4), zero
    outside the GT box. Returns (N, out_size, out_size) in [0, 1]."""
    n, s, _ = rasters.shape
    rasters = rasters.to(torch.float32)
    grid = (torch.arange(out_size, dtype=torch.float32, device=rasters.device) + 0.5) / out_size

    def axis(p0, p1, g0, g1):
        pos = p0[:, None] + grid[None] * torch.clamp(p1 - p0, min=1.0)[:, None]
        c = (pos - g0[:, None]) / torch.clamp(g1 - g0, min=1.0)[:, None] * s - 0.5
        inside = (c > -0.5) & (c < s - 0.5)
        lo = torch.clamp(torch.floor(c), 0, s - 1)
        hi = torch.clamp(lo + 1, 0, s - 1)
        f = torch.clamp(c - lo, 0.0, 1.0)
        return inside, clamped_index(lo, s - 1), clamped_index(hi, s - 1), f

    iy, y0, y1, fy = axis(prop_boxes[:, 1], prop_boxes[:, 3], gt_boxes[:, 1], gt_boxes[:, 3])
    ix, x0, x1, fx = axis(prop_boxes[:, 0], prop_boxes[:, 2], gt_boxes[:, 0], gt_boxes[:, 2])

    def at(yi, xi):
        rows = torch.gather(rasters, 1, yi[:, :, None].expand(n, out_size, s))
        return torch.gather(rows, 2, xi[:, None, :].expand(n, out_size, out_size))

    top = at(y0, x0) * (1 - fx)[:, None, :] + at(y0, x1) * fx[:, None, :]
    bot = at(y1, x0) * (1 - fx)[:, None, :] + at(y1, x1) * fx[:, None, :]
    out = top * (1 - fy)[:, :, None] + bot * fy[:, :, None]
    return out * (iy[:, :, None] & ix[:, None, :])


def mask_head_loss(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
                   labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """BCE of each ROI's matched-class channel of (N, M, M, ncls) logits
    against its (N, M, M) target, averaged over the valid positives."""
    cls = torch.clamp(labels, 0, mask_logits.shape[-1] - 1).long()
    picked = torch.gather(mask_logits, 3,
                          cls[:, None, None, None].expand(*mask_logits.shape[:3], 1))[..., 0]
    loss = bce_with_logits(picked, mask_targets).mean(dim=(1, 2))
    w = (valid & (labels > 0)).to(torch.float32)
    return (loss * w).sum() / torch.clamp(w.sum(), min=1.0)


def paste_mask_in_image(mask: np.ndarray, box, im_h: int, im_w: int,
                        thresh: float = 0.5, padding: int = 1) -> np.ndarray:
    """A (M, M) mask probability grid pasted into an (im_h, im_w) uint8
    image of 0/1: padded by ``padding`` zeros, scaled to uint8, resized to
    the box's rounded extent with Pillow's bilinear filter (numpy,
    ``data.image_io.resize_bilinear``) and thresholded; the part of the box
    outside the image is dropped."""
    mask = np.pad(np.asarray(mask), padding)
    x1, y1, x2, y2 = [int(round(float(v))) for v in box]
    w = max(x2 - x1 + 1, 1)
    h = max(y2 - y1 + 1, 1)
    resized = resize_bilinear((mask * 255).astype(np.uint8), (w, h)).astype(np.float32) / 255.0
    out = np.zeros((im_h, im_w), np.uint8)
    xs1, ys1 = max(x1, 0), max(y1, 0)
    xs2, ys2 = min(x2 + 1, im_w), min(y2 + 1, im_h)
    out[ys1:ys2, xs1:xs2] = (resized[ys1 - y1:ys2 - y1, xs1 - x1:xs2 - x1] > thresh)
    return out
