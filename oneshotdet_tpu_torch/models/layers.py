"""Small shared layers (counterpart of ``oneshotdet_tpu/models/layers.py``).

Parameters live in float32 under the reference's names; each layer casts
them to the dtype of its input, so a bf16 activation runs a bf16 conv on the
float32 weights, as flax's ``dtype`` does in the JAX package.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import make_conv


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, _cast(self.weight, x), _cast(self.bias, x), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(x, self.num_groups, _cast(self.weight, x),
                            _cast(self.bias, x), self.eps)


class FusedGroupNorm(nn.Module):
    """GroupNorm + optional activation over channels-last ``(B, ..., C)``
    input, run by ``ops/group_norm.py`` (the CUDA kernels on the card, the
    plain version on the CPU): the counterpart of the JAX package's
    ``FusedGroupNorm``. ``act`` is ``""``, ``"relu"`` or ``"leaky"`` (slope
    ``negative_slope``). A channels-last NCHW tensor permuted to NHWC is
    contiguous, so an NCHW caller pays no copy. Load flax weights through
    ``utils.weights.group_norm_params_from_flax``."""

    def __init__(self, features: int, num_groups: int = 32, eps: float = 1e-5,
                 act: str = "", negative_slope: float = 0.2):
        super().__init__()
        if act not in ("", "relu", "leaky"):
            raise ValueError(f"FusedGroupNorm: act {act!r} ('', 'relu' or 'leaky')")
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.negative_slope = negative_slope
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        from ..ops.group_norm import group_norm_act

        return group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps,
                              self.act or None, self.negative_slope)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, over NCHW.

    ``scale = weight * rsqrt(running_var)`` with NO epsilon and
    ``shift = bias - running_mean * scale``, formed in float32 and then cast
    to the input's dtype (layers/batch_norm.py in the reference).
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Scale(nn.Module):
    """Per-level learnable scalar multiplier; the parameter has shape (1,)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


def conv_gn_relu(channels: int, quant: str = "none") -> List[nn.Module]:
    """3x3 conv + GroupNorm(32) + ReLU as three modules, so a ``nn.Sequential``
    of them keeps the reference's indices (conv at 3i, GN at 3i + 1): the FCOS
    tower block. ``quant`` (TPU.QUANT) picks the conv (``ops.quant.make_conv``)."""
    return [make_conv(quant, channels, channels, 3, padding=1),
            GroupNorm(32, channels, eps=1e-5), nn.ReLU()]
