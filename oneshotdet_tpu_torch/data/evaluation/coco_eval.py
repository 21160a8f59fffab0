"""One-shot COCO-protocol evaluation (counterpart of
``oneshotdet_tpu/data/evaluation/coco_eval.py``, boxes only: the port has no
mask or keypoint head).

Reimplements do_coco_evaluation + prepare_for_coco_detection
(data/datasets/evaluation/coco/coco_eval.py:14-177): each episode (query
image, class) is evaluated against a *custom* ground truth that contains only
that image's annotations of the episode class, with image ids remapped to the
episode index. Unlike the reference, the GT source is the evaluated
dataset's own annotation file rather than a hardcoded absolute path
(coco_eval.py:78 — an acknowledged wart).

``predictions`` is a list aligned with dataset order; each element is a dict
  {"boxes": (N, 4) xyxy at network input scale, "scores": (N,),
   "input_size": (w, h) the size the boxes live in}
or None for skipped images.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .coco_metrics import COCOEvalNumpy


def _xyxy_to_xywh(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    out[:, 2] = boxes[:, 2] - boxes[:, 0] + 1  # TO_REMOVE convert (BoxList)
    out[:, 3] = boxes[:, 3] - boxes[:, 1] + 1
    return out


def evaluate_box_proposals(
    predictions: List[Optional[dict]],
    dataset,
    thresholds=None,
    area: str = "all",
    limit: Optional[int] = None,
):
    """Proposal recall (reference coco_eval.py:265-383).

    Greedy one-to-one matching: repeatedly take the best-covered GT, record
    its IoU, retire its proposal and itself. NOTE the reference overwrites
    its 0.5:0.95 threshold ramp with a single 0.5 threshold (:368-369 — the
    second arange wins), so "AR" is recall@0.5; preserved verbatim.
    """
    area_ranges = {
        "all": (0.0, 1e10), "small": (0.0, 32.0 ** 2),
        "medium": (32.0 ** 2, 96.0 ** 2), "large": (96.0 ** 2, 1e10),
        "96-128": (96.0 ** 2, 128.0 ** 2), "128-256": (128.0 ** 2, 256.0 ** 2),
        "256-512": (256.0 ** 2, 512.0 ** 2), "512-inf": (512.0 ** 2, 1e10),
    }
    lo, hi = area_ranges[area]
    gt_overlaps = []
    num_pos = 0

    for episode_id, prediction in enumerate(predictions):
        original_id = dataset.id_to_img_map[episode_id]
        img_info, cur_cat = dataset.get_img_info(episode_id)
        width, height = img_info["width"], img_info["height"]

        anns = dataset.coco.loadAnns(
            dataset.coco.getAnnIds(imgIds=original_id, catIds=cur_cat, iscrowd=False)
        )
        gt_xywh = np.array(
            [a["bbox"] for a in anns if a.get("iscrowd", 0) == 0], np.float64
        ).reshape(-1, 4)
        gt_areas = np.array(
            [a.get("area", a["bbox"][2] * a["bbox"][3]) for a in anns
             if a.get("iscrowd", 0) == 0], np.float64,
        )
        if len(gt_xywh) == 0:
            continue
        keep = (gt_areas >= lo) & (gt_areas <= hi)
        # xywh -> xyxy, TO_REMOVE convention (BoxList.convert)
        gt = gt_xywh[keep].copy()
        gt[:, 2] = gt[:, 0] + np.maximum(gt_xywh[keep][:, 2] - 1, 0)
        gt[:, 3] = gt[:, 1] + np.maximum(gt_xywh[keep][:, 3] - 1, 0)
        num_pos += len(gt)
        if len(gt) == 0 or prediction is None or len(prediction["boxes"]) == 0:
            continue

        boxes = np.asarray(prediction["boxes"], np.float64)
        scores = np.asarray(prediction["scores"], np.float64)
        order = np.argsort(-scores, kind="stable")
        boxes = boxes[order]
        in_w, in_h = prediction["input_size"]
        boxes = boxes * np.array([width / in_w, height / in_h] * 2)
        if limit is not None and len(boxes) > limit:
            boxes = boxes[:limit]

        overlaps = _pairwise_iou(boxes, gt)  # (P, G), TO_REMOVE convention
        covered = np.zeros(len(gt))
        for j in range(min(len(boxes), len(gt))):
            max_over_props = overlaps.max(axis=0)        # best proposal per gt
            gt_ind = int(max_over_props.argmax())        # best-covered gt
            box_ind = int(overlaps[:, gt_ind].argmax())
            covered[j] = overlaps[box_ind, gt_ind]
            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
        gt_overlaps.append(covered)

    gt_overlaps = (
        np.sort(np.concatenate(gt_overlaps)) if gt_overlaps else np.zeros((0,))
    )
    if thresholds is None:
        thresholds = np.arange(0.5, 0.5 + 1e-5, 0.05)  # the reference's quirk
    thresholds = np.asarray(thresholds, np.float64)
    recalls = np.array(
        [(gt_overlaps >= t).sum() / max(num_pos, 1) for t in thresholds]
    )
    return {
        "ar": float(recalls.mean()),
        "recalls": recalls,
        "thresholds": thresholds,
        "gt_overlaps": gt_overlaps,
        "num_pos": num_pos,
    }


def _pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """boxlist_iou (structures/boxlist_ops.py:221-267), TO_REMOVE = 1."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def do_coco_evaluation(
    dataset,
    predictions: List[Optional[dict]],
    output_folder: Optional[str] = None,
    logger=None,
    box_only: bool = False,
    iou_types=None,
):
    if box_only:
        # RPN_ONLY proposal-recall table (reference coco_eval.py:25-40)
        results = {}
        for limit in [100, 1000, 4000, 5000, 8000, 10000]:
            for area, suffix in {"all": "", "small": "s", "medium": "m",
                                 "large": "l"}.items():
                stats = evaluate_box_proposals(
                    predictions, dataset, area=area, limit=limit
                )
                results[f"AR{suffix}@{limit}"] = stats["ar"]
        msg = "  ".join(f"{k}={v:.4f}" for k, v in results.items())
        if logger:
            logger.info("box_proposal eval: " + msg)
        else:
            print("box_proposal eval: " + msg, flush=True)
        if output_folder:
            os.makedirs(output_folder, exist_ok=True)
            with open(os.path.join(output_folder, "box_proposals.json"), "w") as f:
                json.dump(results, f, indent=2)
        return results
    return _do_coco_detection_evaluation(dataset, predictions, output_folder,
                                         logger, iou_types)


def _do_coco_detection_evaluation(
    dataset,
    predictions: List[Optional[dict]],
    output_folder: Optional[str] = None,
    logger=None,
    iou_types=None,
):
    if iou_types is not None and tuple(iou_types) != ("bbox",):
        raise NotImplementedError(
            f"iou_types {iou_types}: only 'bbox' is ported to oneshotdet_tpu_torch")
    gt: Dict = defaultdict(list)
    dt: Dict = defaultdict(list)
    custom_gt = {"images": [], "annotations": [], "categories": []}
    coco_results = []
    img_ids = []
    seen_cats = set()

    for episode_id, prediction in enumerate(predictions):
        original_id = dataset.id_to_img_map[episode_id]
        img_info, cur_cat = dataset.get_img_info(episode_id)
        width, height = img_info["width"], img_info["height"]
        seen_cats.add(cur_cat)
        img_ids.append(episode_id)

        info = dict(img_info)
        info["id"] = episode_id
        custom_gt["images"].append(info)

        ann_ids = dataset.coco.getAnnIds(
            imgIds=original_id, catIds=cur_cat, iscrowd=False
        )
        for ann in dataset.coco.loadAnns(ann_ids):
            item = dict(ann)
            item["image_id"] = episode_id
            item["category_id"] = cur_cat
            custom_gt["annotations"].append(item)
            gt[(episode_id, cur_cat)].append(
                {
                    "bbox": list(map(float, ann["bbox"])),
                    "area": float(ann.get("area", ann["bbox"][2] * ann["bbox"][3])),
                    "iscrowd": int(ann.get("iscrowd", 0)),
                }
            )

        if prediction is None or len(prediction["boxes"]) == 0:
            continue

        boxes = np.asarray(prediction["boxes"], np.float64)
        scores = np.asarray(prediction["scores"], np.float64)
        in_w, in_h = prediction["input_size"]
        # resize back to original image size (coco_eval.py:144)
        sx, sy = width / in_w, height / in_h
        boxes = boxes * np.array([sx, sy, sx, sy])
        xywh = _xyxy_to_xywh(boxes)
        for k in range(len(xywh)):
            rec = {
                "image_id": episode_id,
                "category_id": int(cur_cat),
                "bbox": [float(v) for v in xywh[k]],
                "score": float(scores[k]),
            }
            coco_results.append(rec)
            dt[(episode_id, cur_cat)].append(rec)

    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, "coco_custom_gt.json"), "w") as f:
            json.dump(custom_gt, f)
        with open(os.path.join(output_folder, "coco_custom_result.json"), "w") as f:
            json.dump(coco_results, f)
        with open(os.path.join(output_folder, "coco_ids.json"), "w") as f:
            json.dump(img_ids, f)

    evaluator = COCOEvalNumpy(gt, dt, sorted(seen_cats), img_ids)
    results = evaluator.evaluate_and_accumulate().summarize()

    msg = "  ".join(f"{k}={v:.4f}" for k, v in results.items())
    if logger:
        logger.info("COCO-style one-shot eval: " + msg)
    else:
        print("COCO-style one-shot eval: " + msg, flush=True)
    if output_folder:
        with open(os.path.join(output_folder, "coco_results.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


def compute_thresholds_for_classes(gt, dt, cat_ids, img_ids) -> np.ndarray:
    """Score threshold per class at the best F-measure: from the precision
    at IoU 0.5, all areas, the largest maxDets, over the 101 recall points
    (the per-class thresholds ``OneShotPredictor`` takes)."""
    ev = COCOEvalNumpy(gt, dt, cat_ids, img_ids).evaluate_and_accumulate()
    precision = ev.eval["precision"][0, :, :, 0, -1]
    recall = np.linspace(0, 1, precision.shape[0])[:, None]
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-6)
    return f1.max(axis=0)
