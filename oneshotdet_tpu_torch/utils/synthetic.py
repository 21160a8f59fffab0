"""Synthetic episodic batches (the port's copy of
``oneshotdet_tpu/utils/synthetic.py::make_episodic_batch``): query images
holding coloured rectangles, the GT boxes of those rectangles, and support
crops of the same colour, in the data pipeline's layout. The same seed gives
the same numpy arrays as the JAX package's copy.
"""

from __future__ import annotations

import numpy as np


def make_episodic_batch(batch_size: int = 2, query_hw=(128, 128), supp_hw=(64, 64),
                        max_gt: int = 8, num_shot: int = 1, seed: int = 0):
    """A flat batch dict: query_pixels (B, H, W, 3), query_sizes (B, 2) as
    (h, w), supp_pixels (B * shot, h, w, 3), supp_sizes, gt_xyxy (B, G, 4),
    gt_valid (B, G), gt_labels (B, G) (1 to 4 boxes of label 1 per image)
    and target_ids (B,)."""
    rng = np.random.RandomState(seed)
    qh, qw = query_hw
    sh, sw = supp_hw
    query = rng.randn(batch_size, qh, qw, 3).astype(np.float32) * 10
    supp = rng.randn(batch_size * num_shot, sh, sw, 3).astype(np.float32) * 10
    gt_xyxy = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_valid = np.zeros((batch_size, max_gt), bool)
    gt_labels = np.zeros((batch_size, max_gt), np.int32)

    for b in range(batch_size):
        color = rng.uniform(50, 255, 3).astype(np.float32)
        n = rng.randint(1, min(4, max_gt) + 1)
        for g in range(n):
            w = rng.randint(qw // 8, qw // 2)
            h = rng.randint(qh // 8, qh // 2)
            x1 = rng.randint(0, qw - w)
            y1 = rng.randint(0, qh - h)
            query[b, y1:y1 + h, x1:x1 + w] = color + rng.randn(h, w, 3) * 5
            gt_xyxy[b, g] = (x1, y1, x1 + w - 1, y1 + h - 1)
            gt_valid[b, g] = True
            gt_labels[b, g] = 1
        for s in range(num_shot):
            supp[b * num_shot + s, 4:-4, 4:-4] = color + rng.randn(sh - 8, sw - 8, 3) * 5

    return {
        "query_pixels": query,
        "query_sizes": np.tile(np.array([[qh, qw]], np.float32), (batch_size, 1)),
        "supp_pixels": supp,
        "supp_sizes": np.tile(np.array([[sh, sw]], np.float32), (batch_size * num_shot, 1)),
        "gt_xyxy": gt_xyxy,
        "gt_valid": gt_valid,
        "gt_labels": gt_labels,
        "target_ids": np.ones((batch_size,), np.int32),
    }
