"""Host-side transforms of the data path (counterpart of
``oneshotdet_tpu/data/transforms.py``: ``get_resize_size``,
``FusedHostPreprocess`` and ``build_fused_transforms``).

The port has one route, the one the JAX package takes whenever its native
library loads: a transform resizes and flips the boxes and returns the
decoded uint8 pixels with their resample target; the pixels are resized,
normalized and padded later, a batch at a time, by
``ops.resize.resize_normalize_pad`` (on the card, a CUDA kernel).

A transform's random draws are split from its work: ``draw(rng)`` takes
them from the caller's ``random.Random`` in the JAX package's order (the
short side, then the flip where ``flip_prob > 0``), and ``apply`` uses them,
so a loader can draw in one thread and decode in others.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np


def get_resize_size(image_wh: Tuple[int, int], min_size: int,
                    max_size: Optional[int]) -> Tuple[int, int]:
    """Target (h, w) of the aspect-preserving resize: the short side to
    ``min_size`` unless the long side would then pass ``max_size``."""
    w, h = image_wh
    size = min_size
    if max_size is not None:
        min_orig = float(min(w, h))
        max_orig = float(max(w, h))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        return (int(size * h / w), size)
    return (size, int(size * w / h))


class FusedPreprocess:
    """Resize target + box resize + horizontal flip of one image; the pixel
    work is deferred to the batch's ``resize_normalize_pad``."""

    def __init__(self, min_size, max_size, flip_prob, mean, std, to_bgr255=True):
        if not isinstance(min_size, (list, tuple)):
            min_size = (min_size,)
        self.min_size = tuple(min_size)
        self.max_size = max_size
        self.flip_prob = flip_prob
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr255 = to_bgr255

    def draw(self, rng: random.Random) -> Tuple[int, bool]:
        """(short side, flip) drawn from ``rng`` as the JAX transform draws
        them from the global stream (``choice`` draws even for one size)."""
        size = rng.choice(self.min_size)
        flip = self.flip_prob > 0 and rng.random() < self.flip_prob
        return size, flip

    def apply(self, arr: np.ndarray, boxes, draws):
        """(item, boxes): item = {"u8", "out_hw", "mean", "std",
        "to_bgr255"} with the pixels flipped if drawn; boxes (N, 4) xyxy
        float32 resized (and flipped with the TO_REMOVE convention)."""
        size, flip = draws
        h0, w0 = arr.shape[:2]
        oh, ow = get_resize_size((w0, h0), size, self.max_size)
        if boxes is not None and len(boxes):
            boxes = boxes.astype(np.float32).copy()
            boxes[:, 0::2] *= ow / w0
            boxes[:, 1::2] *= oh / h0
        if flip:
            arr = arr[:, ::-1]
            if boxes is not None and len(boxes):
                x1 = ow - boxes[:, 2] - 1.0
                x2 = ow - boxes[:, 0] - 1.0
                boxes = boxes.copy()
                boxes[:, 0], boxes[:, 2] = x1, x2
        item = {
            "u8": np.ascontiguousarray(arr),
            "out_hw": (oh, ow),
            "mean": self.mean,
            "std": self.std,
            "to_bgr255": self.to_bgr255,
        }
        return item, boxes


def build_fused_transforms(cfg, is_train: bool = True):
    """[query transform, support transform] from the cfg's INPUT section."""
    if is_train:
        min_size = cfg.INPUT.MIN_SIZE_TRAIN
        supp_min_size = cfg.INPUT.SUPP_MIN_SIZE_TRAIN
        max_size = cfg.INPUT.MAX_SIZE_TRAIN
        supp_max_size = cfg.INPUT.SUPP_MAX_SIZE_TRAIN
        flip_prob = 0.5
    else:
        min_size = cfg.INPUT.MIN_SIZE_TEST
        supp_min_size = cfg.INPUT.SUPP_MIN_SIZE_TEST
        max_size = cfg.INPUT.MAX_SIZE_TEST
        supp_max_size = cfg.INPUT.SUPP_MAX_SIZE_TEST
        flip_prob = 0.0
    args = (cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD, cfg.INPUT.TO_BGR255)
    return [
        FusedPreprocess(min_size, max_size, flip_prob, *args),
        FusedPreprocess(supp_min_size, supp_max_size, flip_prob, *args),
    ]
