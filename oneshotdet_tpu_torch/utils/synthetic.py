"""Synthetic data.

``make_episodic_batch`` (the port's copy of
``oneshotdet_tpu/utils/synthetic.py::make_episodic_batch``): query images
holding coloured rectangles, the GT boxes of those rectangles, and support
crops of the same colour, in the data pipeline's layout. The same seed gives
the same numpy arrays as the JAX package's copy.

``write_synthetic_coco``: a COCO-style dataset on disk (binary PPM images
and an instances JSON, optionally with polygon segmentations) for the data
path, made with numpy from a seed.

``write_synthetic_c2_resnet``: a Detectron-style pickle of ResNet blobs
(``{"blobs": {"conv1_w": ..., "res2_0_branch2a_w": ...}}``, with the
``*_momentum`` and ``fc1000`` blobs an ImageNet file also holds), made with
numpy from a seed, for the Caffe2 import.
"""

from __future__ import annotations

import json
import os
import pickle
import re

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


def _polygon_rings(rng, x, y, w, h):
    """The segmentation of a box (x, y, w, h): one convex ring, one concave
    (a star) or two rings, their vertices inside the box on a half-pixel
    grid."""
    def ring(cx, cy, rx, ry, n, concave):
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(0.6, 1.0, n)
        if concave:
            rad[1::2] *= 0.45
        px = np.clip(np.round((cx + rx * rad * np.cos(ang)) * 2) / 2, x, x + w)
        py = np.clip(np.round((cy + ry * rad * np.sin(ang)) * 2) / 2, y, y + h)
        return [float(v) for xy in zip(px, py) for v in xy]

    kind = rng.randint(3)
    if kind < 2:
        return [ring(x + w / 2, y + h / 2, w / 2, h / 2, rng.randint(5, 11), kind == 1)]
    return [ring(x + w / 4, y + h / 2, w / 4, h / 2, rng.randint(3, 7), False),
            ring(x + 3 * w / 4, y + h / 2, w / 4, h / 2, rng.randint(6, 11), True)]


def write_synthetic_coco(root, num_images: int = 24, sizes=((375, 500), (500, 375)),
                         num_categories: int = 3, box_side=(90.0, 300.0), seed: int = 0,
                         segmentation: bool = False):
    """Write ``num_images`` binary PPM images (sizes (h, w) taken in turn)
    with 1-4 boxes each and the instances JSON under ``root``. Boxes are
    rectangles of their category's colour on noise, with sides drawn from
    ``box_side`` (capped by the image), corners on a half-pixel grid, and
    one box in eight running past the right or bottom edge. Every category
    has at least one box. With ``segmentation``, each annotation also gets
    polygons inside its box (one convex ring, a concave one, or two rings;
    half-pixel vertices) from a stream of their own, so images and boxes are
    those of the same seed without them. Returns (image directory,
    annotation file)."""
    rng = np.random.RandomState(seed)
    seg_rng = np.random.RandomState(seed + 1) if segmentation else None
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
            ann = {"id": len(annotations) + 1, "image_id": i + 1, "category_id": int(cat),
                   "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0}
            if seg_rng is not None:
                ann["segmentation"] = _polygon_rings(seg_rng, x, y, bw, bh)
            annotations.append(ann)
        name = f"{i:06d}.ppm"
        write_ppm(os.path.join(img_dir, name), arr)
        images.append({"id": i + 1, "file_name": name, "width": w, "height": h})
    ann_file = os.path.join(str(root), "instances.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"class{c}"}
                                  for c in range(1, num_categories + 1)]}, f)
    return img_dir, ann_file


_C2_BRANCH = {"conv1": "2a", "bn1": "2a", "conv2": "2b", "bn2": "2b", "conv3": "2c", "bn3": "2c",
              "downsample.0": "1", "downsample.1": "1"}


def c2_blob_name(name: str):
    """A ResNet body state-dict name -> its Caffe2 blob name, or None for
    the running statistics (folded into the scale and bias in Caffe2)."""
    if name == "stem.conv1.weight":
        return "conv1_w"
    if name.startswith("stem.bn1."):
        return {"weight": "res_conv1_bn_s", "bias": "res_conv1_bn_b"}.get(name.rsplit(".", 1)[1])
    m = re.match(r"^layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.[01])\.(weight|bias|running_\w+)$",
                 name)
    if m is None or m.group(4).startswith("running_"):
        return None
    stage, block, part, leaf = m.groups()
    head = f"res{int(stage) + 1}_{block}_branch{_C2_BRANCH[part]}"
    if part.startswith("conv") or part == "downsample.0":
        return head + "_w"
    return head + ("_bn_s" if leaf == "weight" else "_bn_b")


def write_synthetic_c2_resnet(path, body_shapes, seed: int = 0):
    """Write blobs for ``body_shapes`` (body state-dict name -> shape):
    convolution weights N(0, 2 / fan_in), BN scales 1 + 0.1 N, BN biases
    0.1 N, in float32, drawn in sorted name order; plus a momentum blob per
    weight and an fc1000 classifier."""
    rng = np.random.RandomState(seed)
    blobs = {}
    for name in sorted(body_shapes):
        blob = c2_blob_name(name)
        if blob is None:
            continue
        shape = tuple(body_shapes[name])
        n = rng.standard_normal(shape).astype(np.float32)
        if blob.endswith("_w"):
            val = n * np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
            blobs[blob + "_momentum"] = np.zeros(shape, np.float32)
        elif blob.endswith("_s"):
            val = 1.0 + 0.1 * n
        else:
            val = 0.1 * n
        blobs[blob] = val.astype(np.float32)
    blobs["fc1000_w"] = rng.standard_normal((1000, 2048)).astype(np.float32) * np.float32(0.01)
    blobs["fc1000_b"] = np.zeros(1000, np.float32)
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    return path
