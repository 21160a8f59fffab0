"""Synthetic data.

``make_episodic_batch`` (the port's copy of
``oneshotdet_tpu/utils/synthetic.py::make_episodic_batch``): query images
holding coloured rectangles, the GT boxes of those rectangles, and support
crops of the same colour, in the data pipeline's layout. The same seed gives
the same numpy arrays as the JAX package's copy.

``write_synthetic_coco``: a COCO-style dataset on disk (binary PPM images
and an instances JSON) for the data path, made with numpy from a seed.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.image_io import write_ppm


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


def write_synthetic_coco(root, num_images: int = 24, sizes=((375, 500), (500, 375)),
                         num_categories: int = 3, box_side=(90.0, 300.0), seed: int = 0):
    """Write ``num_images`` binary PPM images (sizes (h, w) taken in turn)
    with 1-4 boxes each and the instances JSON under ``root``. Boxes are
    rectangles of their category's colour on noise, with sides drawn from
    ``box_side`` (capped by the image), corners on a half-pixel grid, and
    one box in eight running past the right or bottom edge. Every category
    has at least one box. Returns (image directory, annotation file)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(str(root), "images")
    os.makedirs(img_dir, exist_ok=True)
    colors = rng.randint(40, 256, (num_categories, 3))
    images, annotations = [], []
    for i in range(num_images):
        h, w = sizes[i % len(sizes)]
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(1, 5)):
            cat = rng.randint(1, num_categories + 1)
            if len(annotations) < num_categories:
                cat = len(annotations) + 1
            bw = round(min(rng.uniform(*box_side), w - 2) * 2) / 2
            bh = round(min(rng.uniform(*box_side), h - 2) * 2) / 2
            x = round(rng.uniform(0, w - bw) * 2) / 2
            y = round(rng.uniform(0, h - bh) * 2) / 2
            if rng.randint(8) == 0:     # past the right or bottom edge
                if rng.randint(2):
                    x = w - bw / 2
                else:
                    y = h - bh / 2
            x0, y0 = int(x), int(y)
            patch = arr[y0:int(y + bh), x0:int(x + bw)]
            patch[:] = np.clip(colors[cat - 1] + rng.randint(-20, 21, patch.shape), 0, 255)
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": int(cat), "bbox": [x, y, bw, bh],
                                "area": bw * bh, "iscrowd": 0})
        name = f"{i:06d}.ppm"
        write_ppm(os.path.join(img_dir, name), arr)
        images.append({"id": i + 1, "file_name": name, "width": w, "height": h})
    ann_file = os.path.join(str(root), "instances.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"class{c}"}
                                  for c in range(1, num_categories + 1)]}, f)
    return img_dir, ann_file
