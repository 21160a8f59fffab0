"""Feature Pyramid Network, P3-P7 (counterpart of ``models/fpn.py``).

Lateral 1x1 convs on C3..C5 (``fpn_inner2..4``), top-down 2x nearest
upsampling + add, 3x3 output convs (``fpn_layer2..4``) -> P3..P5, then
``top_blocks``: P6 = 3x3/2 conv on P5 (or C5 with USE_C5) and P7 = 3x3/2
conv on relu(P6). Outputs are channels_last NCHW tensors, so each level's
NHWC view (``permute(0, 2, 3, 1)``) is contiguous.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d
from .resnet import ResNet


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class LastLevelP6P7(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.p6 = Conv2d(in_channels, out_channels, 3, stride=2, padding=1)
        self.p7 = Conv2d(out_channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x):
        p6 = self.p6(x)
        return p6, self.p7(F.relu(p6))


class FPN(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), out_channels: int = 256,
                 use_c5_for_p6: bool = False):
        super().__init__()
        for idx, cin in zip((2, 3, 4), in_channels):
            setattr(self, f"fpn_inner{idx}", Conv2d(cin, out_channels, 1))
            setattr(self, f"fpn_layer{idx}", Conv2d(out_channels, out_channels, 3, padding=1))
        self.use_c5_for_p6 = use_c5_for_p6
        self.top_blocks = LastLevelP6P7(
            in_channels[-1] if use_c5_for_p6 else out_channels, out_channels)

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        _, c3, c4, c5 = features
        last = self.fpn_inner4(c5)
        p5 = self.fpn_layer4(last)
        outs = [p5]
        for lateral_conv, out_conv, c in ((self.fpn_inner3, self.fpn_layer3, c4),
                                          (self.fpn_inner2, self.fpn_layer2, c3)):
            lateral = lateral_conv(c)
            # crop to the lateral's extent for inputs not divisible by 32
            up = upsample_nearest_2x(last)[:, :, : lateral.shape[2], : lateral.shape[3]]
            last = lateral + up
            outs.insert(0, out_conv(last))
        p6, p7 = self.top_blocks(c5 if self.use_c5_for_p6 else p5)
        return tuple(p.contiguous(memory_format=torch.channels_last)
                     for p in (*outs, p6, p7))


class ResNetFPN(nn.Module):
    """``body`` + ``fpn``: NHWC-viewed pixels in, P3..P7 out."""

    def __init__(self, depth: int = 50, out_channels: int = 256,
                 use_c5_for_p6: bool = False):
        super().__init__()
        self.body = ResNet(depth=depth)
        self.fpn = FPN(out_channels=out_channels, use_c5_for_p6=use_c5_for_p6)

    def forward(self, x: torch.Tensor):
        """x: (B, 3, H, W), best in channels_last."""
        return self.fpn(self.body(x))
