"""Host-side transforms of the data path (counterpart of
``oneshotdet_tpu/data/transforms.py``: ``get_resize_size``,
``FusedHostPreprocess``, ``build_fused_transforms`` and ``color_jitter``).

The port has one route, the one the JAX package takes whenever its native
library loads: a transform resizes and flips the boxes and returns the
decoded uint8 pixels with their resample target; the pixels are resized,
normalized and padded later, a batch at a time, by
``ops.resize.resize_normalize_pad`` (on the card, a CUDA kernel).

A transform's random draws are split from its work: ``draw(rng)`` takes
them from the caller's ``random.Random`` in the JAX package's order (the
short side, then the flip where ``flip_prob > 0``), and ``apply`` uses them,
so a loader can draw in one thread and decode in others.

``color_jitter`` is the support augmentation's PIL ``ImageEnhance`` chain
(Color, Brightness, Contrast, Sharpness) in numpy, byte for byte: its four
factors are arguments (``draw_jitter`` takes them from a ``random.Random``),
where the JAX function draws them from the global ``np.random``.
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

    def apply(self, arr: np.ndarray, boxes, draws, extras=None):
        """(item, boxes): item = {"u8", "out_hw", "mean", "std",
        "to_bgr255"} with the pixels flipped if drawn; boxes (N, 4) xyxy
        float32 resized (and flipped with the TO_REMOVE convention). With
        ``extras``, a list of per-object geometry (``PolygonInstance``,
        ``PersonKeypoints``: ``resize((w, h))`` and ``transpose(0)``), each
        resized and flipped the same way: returns (item, boxes, extras)."""
        size, flip = draws
        h0, w0 = arr.shape[:2]
        oh, ow = get_resize_size((w0, h0), size, self.max_size)
        if boxes is not None and len(boxes):
            boxes = boxes.astype(np.float32).copy()
            boxes[:, 0::2] *= ow / w0
            boxes[:, 1::2] *= oh / h0
        if extras is not None:
            extras = [e.resize((ow, oh)) for e in extras]
            if flip:
                extras = [e.transpose(0) for e in extras]     # FLIP_LEFT_RIGHT
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
        if extras is not None:
            return item, boxes, extras
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


# -- the support augmentation's colour jitter ---------------------------------

JITTER_RANGE = (0.1, 2.0)      # each factor ~ U(0.1, 2)


def draw_jitter(rng: random.Random) -> Tuple[float, float, float, float]:
    """The jitter's (Color, Brightness, Contrast, Sharpness) factors, drawn
    from ``rng`` in that order."""
    return tuple(rng.uniform(*JITTER_RANGE) for _ in range(4))


def _luma(arr: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L: fixed-point ITU-R 601-2 luma, (H, W) uint8."""
    a = arr.astype(np.int32)
    return ((a[..., 0] * 19595 + a[..., 1] * 38470 + a[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _blend(degenerate: np.ndarray, image: np.ndarray, factor: float) -> np.ndarray:
    """PIL's ``Image.blend(degenerate, image, factor)``: in1 + alpha * (in2 -
    in1) in float32, truncated; clipped to [0, 255] only when alpha (a
    float32) lies outside [0, 1]."""
    alpha = np.float32(factor)
    out = degenerate.astype(np.float32) + alpha * (
        image.astype(np.int16) - degenerate.astype(np.int16)).astype(np.float32)
    if 0.0 <= alpha <= 1.0:
        return out.astype(np.uint8)
    return np.where(out <= 0, 0, np.where(out >= 255, 255, out)).astype(np.uint8)


def _smooth(arr: np.ndarray) -> np.ndarray:
    """PIL's ``filter(ImageFilter.SMOOTH)``: the 3 x 3 kernel [1 1 1; 1 5 1;
    1 1 1] / 13 in float32 with 0.5 added and truncated, the border rows
    and columns copied; an image under 3 x 3 is returned unchanged."""
    h, w = arr.shape[:2]
    if h < 3 or w < 3:
        return arr.copy()
    f = arr.astype(np.float32)
    k1 = np.float32(1) / np.float32(13)
    k5 = np.float32(5) / np.float32(13)

    def row(r, mid):
        return (r[:, :-2] * k1 + r[:, 1:-1] * mid) + r[:, 2:] * k1

    ss = np.float32(0.5) + row(f[2:], k1)
    ss = ss + row(f[1:-1], k5)
    ss = ss + row(f[:-2], k1)
    out = arr.copy()
    out[1:-1, 1:-1] = np.where(ss <= 0, 0, np.where(ss >= 255, 255, ss)).astype(np.uint8)
    return out


def color_jitter(arr: np.ndarray, factors) -> np.ndarray:
    """The support jitter on (H, W, 3) uint8 RGB: ``ImageEnhance`` Color,
    Brightness, Contrast and Sharpness with the four ``factors``, in that
    order, each a blend of the image with its degenerate (its luma as RGB,
    black, the luma's mean rounded, the smoothed image)."""
    f_color, f_bright, f_contrast, f_sharp = factors
    arr = np.asarray(arr, np.uint8)
    arr = _blend(np.repeat(_luma(arr)[..., None], 3, axis=-1), arr, f_color)
    arr = _blend(np.zeros_like(arr), arr, f_bright)
    luma = _luma(arr)
    mean = int(float(luma.sum(dtype=np.int64)) / luma.size + 0.5) if luma.size else 0
    arr = _blend(np.full_like(arr, mean), arr, f_contrast)
    return _blend(_smooth(arr), arr, f_sharp)
