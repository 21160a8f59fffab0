"""Padded image batches (counterpart of the JAX package's ``ImageBatch``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ImageBatch:
    """A batch of images padded to one static shape.

    pixels: (B, H, W, 3) float, normalized, zero-padded (NHWC, as in the JAX
      package; the backbone views it as a channels_last NCHW tensor).
    sizes: (B, 2) float, true (height, width) of each image before padding.
    """

    pixels: torch.Tensor
    sizes: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.pixels.shape[0]

    def sizes_wh(self) -> torch.Tensor:
        """(B, 2) as (width, height), the BoxList.size convention."""
        return self.sizes.flip(-1)
