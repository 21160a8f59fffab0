"""ResNet backbone, Caffe2 convention (counterpart of ``models/resnet.py``).

  - stem: 7x7/2 conv (no bias), pad 3 + FrozenBN + ReLU + 3x3/2 max pool;
  - Bottleneck: 1x1 (strided when STRIDE_IN_1X1) + 3x3 + 1x1x4, FrozenBN
    after each, ReLU after the residual add; a 1x1-strided FrozenBN
    downsample on the first block of a stage;
  - every BN statistic is frozen;
  - TPU.QUANT (``quant``) makes every bottleneck conv int8
    (``ops.quant.make_conv``); the stem stays in the compute dtype.

The stem is a plain 7x7/2 conv on the same (64, 3, 7, 7) weight; the JAX
package's space-to-depth form of it (``_StemConv``) is an equivalent
regrouping for the TPU's matrix unit and is not carried over.
Module names follow the reference (``stem``, ``layer1``..``layer4``,
``conv1``..``conv3``, ``bn1``..``bn3``, ``downsample``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import make_conv
from .layers import Conv2d, FrozenBatchNorm

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    """The stride sits in the first 1x1 conv (STRIDE_IN_1X1, Caffe2)."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, quant: str = "none"):
        super().__init__()
        self.conv1 = make_conv(quant, in_channels, bottleneck_channels, 1, stride=stride,
                               bias=False)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = make_conv(quant, bottleneck_channels, bottleneck_channels, 3, padding=1,
                               bias=False)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = make_conv(quant, bottleneck_channels, out_channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_channels)
        self.downsample = None
        if in_channels != out_channels or stride != 1:
            self.downsample = nn.Sequential(
                make_conv(quant, in_channels, out_channels, 1, stride=stride, bias=False),
                FrozenBatchNorm(out_channels),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class ResNet(nn.Module):
    """NCHW input -> (C2, C3, C4, C5); widths 64 -> 256/512/1024/2048."""

    def __init__(self, depth: int = 50, quant: str = "none"):
        super().__init__()
        self.stem = Stem()
        in_ch = 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth], start=1):
            mult = 2 ** (stage - 1)
            out_ch = 256 * mult
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(in_ch, 64 * mult, out_ch,
                                         stride=(1 if stage == 1 or b > 0 else 2),
                                         quant=quant))
                in_ch = out_ch
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        outputs = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            outputs.append(x)
        return tuple(outputs)


def frozen_param_paths(freeze_at: int = 2) -> Tuple[str, ...]:
    """The body's stages to freeze (FREEZE_CONV_BODY_AT): 'stem' for stage 0
    and 'layer<i>' for stage i, below ``freeze_at``."""
    return tuple("stem" if i == 0 else f"layer{i}" for i in range(freeze_at))
