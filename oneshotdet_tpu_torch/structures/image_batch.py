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


def round_up(x: int, divisor: int) -> int:
    return int(-(-x // divisor) * divisor)


def to_image_batch(images, bucket_hw=None, size_divisible: int = 32,
                   device=None) -> ImageBatch:
    """Pad (h, w, 3) normalized images (numpy arrays or tensors) into one
    batch on ``device`` (default "cuda"): into ``bucket_hw`` if given, else
    the batch's largest sides rounded up to ``size_divisible``."""
    device = torch.device("cuda" if device is None else device)
    if bucket_hw is None:
        max_h = round_up(max(im.shape[0] for im in images), size_divisible)
        max_w = round_up(max(im.shape[1] for im in images), size_divisible)
    else:
        max_h, max_w = bucket_hw
    batch = torch.zeros((len(images), max_h, max_w, 3), dtype=torch.float32, device=device)
    sizes = torch.zeros((len(images), 2), dtype=torch.float32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        if h > max_h or w > max_w:
            raise ValueError(f"image ({h},{w}) exceeds bucket ({max_h},{max_w})")
        batch[i, :h, :w] = torch.as_tensor(im, dtype=torch.float32)
        sizes[i, 0], sizes[i, 1] = h, w
    return ImageBatch(pixels=batch, sizes=sizes.to(device))
