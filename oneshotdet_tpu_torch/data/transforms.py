"""Image-size rule shared by the predictor and the eval data path."""

from __future__ import annotations

from typing import Optional, Tuple


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
