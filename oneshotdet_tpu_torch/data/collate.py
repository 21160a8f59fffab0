"""Batch collation into fixed resolution buckets (counterpart of
``oneshotdet_tpu/data/collate.py``).

Per batch the collator picks the smallest query bucket of
``cfg.TPU.QUERY_BUCKETS`` that holds every image (else the batch maximum
rounded up to 32), puts the supports in ``cfg.TPU.SUPP_BUCKET`` and pads the
GT boxes to ``cfg.TPU.MAX_GT_BOXES`` with validity masks.

The query and support pixels of a batch come from one
``resize_normalize_pad_slots`` call on the collator's device (default
"cuda"; on the card, one kernel launch for both, fed by one pinned upload
of the batch's uint8 sources and their meta).
``query_pixels`` and ``supp_pixels`` are torch tensors on that device;
sizes, ids and GT stay numpy arrays on the host. ``TPU.HOST_S2D`` is
ignored: the port's stem takes (B, H, W, 3) pixels.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.resize import pack_images, resize_normalize_pad_slots, slot


def _pick_bucket(shapes, buckets):
    """Smallest-area bucket covering all (h, w) shapes, else max-rounded."""
    fitting = [b for b in buckets if all(h <= b[0] and w <= b[1] for h, w in shapes)]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    max_h = max(h for h, _ in shapes)
    max_w = max(w for _, w in shapes)
    r = lambda x: int(-(-x // 32) * 32)  # noqa: E731
    return (r(max_h), r(max_w))


def _pixels(kinds: List[List[dict]], buckets, device) -> Tuple[torch.Tensor, ...]:
    """One resize_normalize_pad_slots call for the batch's images of every
    kind, each kind into its bucket (one transform made a kind's images, so
    its first gives the normalization)."""
    imgs = [im for kind in kinds for im in kind]
    packed = pack_images([im["u8"] for im in imgs], [im["out_hw"] for im in imgs], device,
                         outputs=[o for o, kind in enumerate(kinds) for _ in kind])
    slots = [slot(bucket, kind[0]["mean"], kind[0]["std"], kind[0]["to_bgr255"])
             for kind, bucket in zip(kinds, buckets)]
    return resize_normalize_pad_slots(packed, slots)


class BatchCollator:
    def __init__(self, cfg, device=None):
        self.query_buckets = tuple(tuple(b) for b in cfg.TPU.QUERY_BUCKETS)
        self.supp_bucket = tuple(cfg.TPU.SUPP_BUCKET)
        self.max_gt = cfg.TPU.MAX_GT_BOXES
        self.device = torch.device("cuda" if device is None else device)

    def query_bucket_for(self, shapes) -> tuple:
        return _pick_bucket(shapes, self.query_buckets)

    def _gt(self, it: dict):
        gt_xyxy = np.zeros((self.max_gt, 4), np.float32)
        gt_valid = np.zeros((self.max_gt,), bool)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        n = min(len(it["boxes"]), self.max_gt)
        if n:
            gt_xyxy[:n] = it["boxes"][:n]
            gt_valid[:n] = True
            gt_labels[:n] = it["labels"][:n]
        return gt_xyxy, gt_valid, gt_labels

    def __call__(self, items: List[dict]) -> Dict[str, object]:
        queries = [it["img"] for it in items]
        query_hw = self.query_bucket_for([q["out_hw"] for q in queries])
        supports = [s for it in items for s in it["img_supp"]]
        supp_hw = _pick_bucket([s["out_hw"] for s in supports], [self.supp_bucket])
        gts = [self._gt(it) for it in items]
        query_pixels, supp_pixels = _pixels([queries, supports], [query_hw, supp_hw], self.device)
        return {
            "query_pixels": query_pixels,
            "query_sizes": np.array([q["out_hw"] for q in queries], np.float32),
            "supp_pixels": supp_pixels,
            "supp_sizes": np.array([s["out_hw"] for s in supports], np.float32),
            "gt_xyxy": np.stack([g[0] for g in gts]),
            "gt_valid": np.stack([g[1] for g in gts]),
            "gt_labels": np.stack([g[2] for g in gts]),
            "target_ids": np.array([it["target_id"] for it in items], np.int32),
            "img_ids": np.array([it["img_id"] for it in items], np.int64),
            "idxs": np.array([it["idx"] for it in items], np.int64),
        }
