"""Streaming single-image predictor (counterpart of ``oneshotdet_tpu/predictor.py``).

``set_support(image)`` runs the support branch once per class and caches its
features on the device; each ``run_on_image(frame)`` then resizes, normalizes
and pads the frame on the device, runs the query branch against the cached
support, and returns (boxes, scores) in the frame's own coordinates, with
MODEL.MASK_ON and ``return_masks`` also each detection's 28x28 mask
probabilities over its box. ``run_on_opencv_image`` draws them on a BGR
frame (PIL, imported there), the masks as contours (numpy, PIL's bilinear
resize by ``data.image_io.resize_bilinear``).

``ArtifactPredictor`` serves the same API from a serving bundle written by
``export.export_serving``: no model-building Python and no config system.
"""

from __future__ import annotations

import json
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .data.image_io import resize_bilinear
from .data.transforms import get_resize_size
from .models import build_detection_model
from .structures.image_batch import ImageBatch


def preprocess_frame(pixels_u8: torch.Tensor, in_hw, out_hw, pixel_mean,
                     pixel_std, to_bgr255: bool) -> torch.Tensor:
    """uint8 RGB (H0, W0, 3) -> normalized, zero-padded float32 (outH, outW, 3).

    Bilinear resize to ``in_hw`` with the JAX package's filter: antialiased
    (triangle kernel widened by the scale) when an axis shrinks, plain
    bilinear when both grow.
    """
    oh, ow = in_hw
    h0, w0 = pixels_u8.shape[:2]
    x = pixels_u8.to(torch.float32).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False,
                      antialias=(oh < h0 or ow < w0))
    img = x[0].permute(1, 2, 0)
    img = img.flip(-1) if to_bgr255 else img / 255.0
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(pixel_std, dtype=torch.float32, device=img.device)
    out = torch.zeros((*out_hw, 3), dtype=torch.float32, device=img.device)
    out[:oh, :ow] = (img - mean) / std
    return out


def _select_threshold(thr, class_id: int) -> float:
    """Scalar threshold, or the class's entry of a per-class vector."""
    if np.ndim(thr) == 0:
        return float(thr)
    thr = np.asarray(thr, np.float32)
    if not 0 <= class_id < thr.shape[0]:
        raise IndexError(
            f"support class_id {class_id} outside the "
            f"{thr.shape[0]}-entry per-class threshold vector")
    return float(thr[class_id])


class OneShotPredictor:
    def __init__(
        self,
        cfg,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        confidence_threshold=0.0,
        query_bucket: Optional[Tuple[int, int]] = None,
        supp_bucket: Optional[Tuple[int, int]] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        """``state_dict``: reference-keyed weights (``utils.weights``); without
        it the weights are drawn from ``generator``. ``confidence_threshold``
        is a scalar or a per-class vector indexed by ``set_support``'s
        ``class_id``. ``device`` defaults to "cuda"."""
        self.cfg = cfg
        self.model = build_detection_model(cfg, device=device, generator=generator)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.device = next(self.model.parameters()).device
        self.confidence_threshold = confidence_threshold
        self.query_bucket = tuple(query_bucket or cfg.TPU.QUERY_BUCKETS[0])
        self.supp_bucket = tuple(supp_bucket or cfg.TPU.SUPP_BUCKET)
        self._supp_cache = None
        self._supp_class_id = 1

    def _batch(self, image_rgb_u8: np.ndarray, min_size: int, max_size: int,
               bucket) -> Tuple[ImageBatch, Tuple[int, int]]:
        h0, w0 = image_rgb_u8.shape[:2]
        oh, ow = get_resize_size((w0, h0), min_size, max_size)
        oh, ow = min(oh, bucket[0]), min(ow, bucket[1])
        pixels = torch.from_numpy(np.ascontiguousarray(image_rgb_u8)).to(self.device)
        c = self.cfg.INPUT
        padded = preprocess_frame(pixels, (oh, ow), bucket, c.PIXEL_MEAN,
                                  c.PIXEL_STD, c.TO_BGR255)
        sizes = torch.tensor([[oh, ow]], dtype=torch.float32, device=self.device)
        return ImageBatch(pixels=padded[None], sizes=sizes), (oh, ow)

    def set_support(self, image_rgb_u8: np.ndarray, class_id: int = 1):
        """Compute and cache the support features of one support crop."""
        self._supp_class_id = int(class_id)
        batch, _ = self._batch(image_rgb_u8, self.cfg.INPUT.SUPP_MIN_SIZE_TEST,
                               self.cfg.INPUT.SUPP_MAX_SIZE_TEST, self.supp_bucket)
        self._supp_cache = self.model.compute_support_features(batch, 1)
        return self._supp_cache

    def run_on_image(self, image_rgb_u8: np.ndarray, return_masks: bool = False):
        """Detect the cached support class in one frame: (boxes_xyxy, scores)
        as numpy arrays in the frame's coordinates, by descending score;
        with ``return_masks`` (MODEL.MASK_ON) also the detections' (N, 28,
        28) mask probabilities over their boxes."""
        if self._supp_cache is None:
            raise RuntimeError("call set_support() first")
        if return_masks and not self.cfg.MODEL.MASK_ON:
            raise ValueError("return_masks needs MODEL.MASK_ON")
        h0, w0 = image_rgb_u8.shape[:2]
        batch, (oh, ow) = self._batch(image_rgb_u8, self.cfg.INPUT.MIN_SIZE_TEST,
                                      self.cfg.INPUT.MAX_SIZE_TEST, self.query_bucket)
        supp_pooled, supp_7x7 = self._supp_cache
        dets = self.model.detect_with_support(batch, supp_pooled, supp_7x7)
        boxes = dets.xyxy[0].float().cpu().numpy()
        scores = dets.get_field("scores")[0].float().cpu().numpy()
        valid = dets.valid[0].cpu().numpy()
        masks = dets.get_field("mask_probs")[0].cpu().numpy() if return_masks else None
        return _select(boxes, scores, valid, self.confidence_threshold, self._supp_class_id,
                       (h0, w0), (oh, ow), masks)

    # -- the annotated-frame API ------------------------------------------------

    def overlay_boxes(self, image_rgb_u8: np.ndarray, boxes: np.ndarray,
                      color=(255, 40, 40), width: int = 3) -> np.ndarray:
        """Draw detection boxes on an RGB frame (PIL)."""
        return overlay_boxes(image_rgb_u8, boxes, color, width)

    def overlay_scores(self, image_rgb_u8: np.ndarray, boxes: np.ndarray,
                       scores: np.ndarray, label: str = "match",
                       color=(255, 255, 0)) -> np.ndarray:
        """Write ``label: score`` at each box's top-left corner (PIL)."""
        return overlay_scores(image_rgb_u8, boxes, scores, label, color)

    def overlay_mask_contours(self, image_rgb_u8: np.ndarray, boxes: np.ndarray,
                              mask_probs: np.ndarray, color=(40, 255, 80),
                              thresh: float = 0.5) -> np.ndarray:
        """Each detection's mask contour drawn on an RGB frame
        (``overlay_mask_contours``)."""
        return overlay_mask_contours(image_rgb_u8, boxes, mask_probs, color, thresh)

    def run_on_opencv_image(self, image_bgr_u8: np.ndarray) -> np.ndarray:
        """BGR frame in, annotated BGR frame out: the cached support class's
        boxes and scores, and with MODEL.MASK_ON their masks' contours."""
        if not self.cfg.MODEL.MASK_ON:
            return annotate_bgr(self.run_on_image, image_bgr_u8)
        rgb = np.ascontiguousarray(image_bgr_u8[:, :, ::-1])
        boxes, scores, masks = self.run_on_image(rgb, return_masks=True)
        out = overlay_boxes(overlay_mask_contours(rgb, boxes, masks), boxes)
        out = overlay_scores(out, boxes, scores)
        return np.ascontiguousarray(out[:, :, ::-1])


def overlay_boxes(image_rgb_u8: np.ndarray, boxes: np.ndarray, color=(255, 40, 40),
                  width: int = 3) -> np.ndarray:
    """Detection boxes drawn on an RGB frame (PIL, imported here)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image_rgb_u8)
    draw = ImageDraw.Draw(img)
    for box in boxes:
        draw.rectangle([float(v) for v in box], outline=color, width=width)
    return np.asarray(img)


def overlay_scores(image_rgb_u8: np.ndarray, boxes: np.ndarray, scores: np.ndarray,
                   label: str = "match", color=(255, 255, 0)) -> np.ndarray:
    """``label: score`` written at each box's top-left corner (PIL, imported
    here; one-shot detection has the single class 'match')."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image_rgb_u8)
    draw = ImageDraw.Draw(img)
    for box, score in zip(boxes, scores):
        draw.text((float(box[0]) + 2, float(box[1]) + 2), f"{label}: {score:.2f}", fill=color)
    return np.asarray(img)


def overlay_mask_contours(image_rgb_u8: np.ndarray, boxes: np.ndarray, mask_probs: np.ndarray,
                          color=(40, 255, 80), thresh: float = 0.5) -> np.ndarray:
    """Each detection's mask probabilities resized into its rounded box
    (clipped to the frame; boxes of at most 2 pixels on a side skipped),
    thresholded, and the boundary (the mask less its 4-neighbour erosion),
    grown by one pixel, painted ``color``."""
    out = image_rgb_u8.copy()
    h, w = out.shape[:2]
    for box, mp in zip(boxes, mask_probs):
        x1 = max(int(round(float(box[0]))), 0)
        y1 = max(int(round(float(box[1]))), 0)
        x2 = min(int(round(float(box[2]))), w - 1)
        y2 = min(int(round(float(box[3]))), h - 1)
        bw, bh = x2 - x1 + 1, y2 - y1 + 1
        if bw <= 2 or bh <= 2:
            continue
        grid = resize_bilinear((np.asarray(mp, np.float32) * 255).astype(np.uint8), (bw, bh))
        m = grid.astype(np.float32) / 255.0 >= thresh
        er = m.copy()
        er[1:] &= m[:-1]
        er[:-1] &= m[1:]
        er[:, 1:] &= m[:, :-1]
        er[:, :-1] &= m[:, 1:]
        edge = m & ~er
        thick = edge.copy()
        thick[1:] |= edge[:-1]
        thick[:-1] |= edge[1:]
        thick[:, 1:] |= edge[:, :-1]
        thick[:, :-1] |= edge[:, 1:]
        out[y1:y2 + 1, x1:x2 + 1][thick] = color
    return out


def annotate_bgr(run_on_image, image_bgr_u8: np.ndarray) -> np.ndarray:
    """A BGR frame with ``run_on_image``'s boxes and scores drawn on it."""
    rgb = np.ascontiguousarray(image_bgr_u8[:, :, ::-1])
    boxes, scores = run_on_image(rgb)
    out = overlay_scores(overlay_boxes(rgb, boxes), boxes, scores)
    return np.ascontiguousarray(out[:, :, ::-1])


def _select(boxes, scores, valid, threshold, class_id, frame_hw, resized_hw, masks=None):
    """The valid detections above the (class's) threshold, by descending
    score, rescaled from the resized frame to the frame's own coordinates
    (and their masks, where given)."""
    (h0, w0), (oh, ow) = frame_hw, resized_hw
    valid = valid & (scores > _select_threshold(threshold, class_id))
    boxes, scores = boxes[valid], scores[valid]
    order = np.argsort(-scores, kind="stable")
    boxes, scores = boxes[order], scores[order]
    boxes = boxes * np.array([w0 / ow, h0 / oh, w0 / ow, h0 / oh])
    if masks is None:
        return boxes, scores
    return boxes, scores, masks[valid][order]


class ArtifactPredictor:
    """``OneShotPredictor``'s streaming API served from a serving bundle
    (``export.export_serving``): the AOTInductor pair where the bundle has
    one for ``device`` (``used_executable``), else the ExportedProgram pair,
    which must have been exported on ``device``'s type. ``device`` defaults
    to "cuda". Preprocessing is ``preprocess_frame`` on that device, by the
    bundle's meta."""

    def __init__(self, path: str, confidence_threshold=0.0, device=None):
        from . import export as oexport

        with open(path + ".meta.json") as f:
            self.meta = json.load(f)
        self.device = torch.device("cuda" if device is None else device)
        sup = oexport.load_compiled(path + ".support", device=self.device)
        det = oexport.load_compiled(path + ".detect", device=self.device)
        self.used_executable = sup is not None and det is not None
        if not self.used_executable:
            if self.meta["device"] != self.device.type:
                raise ValueError(f"{path}: exported on {self.meta['device']}, has no compiled "
                                 f"pair for {self.device.type}")
            sup = oexport.load(path + ".support").module()
            det = oexport.load(path + ".detect").module()
        self._sup_call, self._det_call = sup, det
        self.confidence_threshold = confidence_threshold
        self.query_bucket = tuple(self.meta["query_bucket"])
        self.supp_bucket = tuple(self.meta["supp_bucket"])
        self._supp_cache = None
        self._supp_class_id = 1

    def _pixels(self, image_rgb_u8: np.ndarray, min_size: int, max_size: int, bucket):
        """Resize + normalize + pad -> ((1, H, W, 3) pixels, (1, 2) sizes,
        the resized (h, w))."""
        m = self.meta
        h0, w0 = image_rgb_u8.shape[:2]
        oh, ow = get_resize_size((w0, h0), min_size, max_size)
        oh, ow = min(oh, bucket[0]), min(ow, bucket[1])
        pixels = torch.from_numpy(np.ascontiguousarray(image_rgb_u8)).to(self.device)
        padded = preprocess_frame(pixels, (oh, ow), bucket, m["pixel_mean"], m["pixel_std"],
                                  m["to_bgr255"])
        sizes = torch.tensor([[oh, ow]], dtype=torch.float32, device=self.device)
        return padded[None], sizes, (oh, ow)

    def set_support(self, image_rgb_u8: np.ndarray, class_id: int = 1):
        """Compute and cache the support features of one support crop."""
        self._supp_class_id = int(class_id)
        m = self.meta
        pixels, sizes, _ = self._pixels(image_rgb_u8, m["supp_min_size_test"],
                                        m["supp_max_size_test"], self.supp_bucket)
        with torch.inference_mode():
            self._supp_cache = self._sup_call(pixels, sizes)
        return self._supp_cache

    def run_on_image(self, image_rgb_u8: np.ndarray):
        """Detect the cached support class in one frame: (boxes_xyxy, scores)
        as numpy arrays in the frame's coordinates, by descending score."""
        if self._supp_cache is None:
            raise RuntimeError("call set_support() first")
        m = self.meta
        h0, w0 = image_rgb_u8.shape[:2]
        pixels, sizes, (oh, ow) = self._pixels(image_rgb_u8, m["min_size_test"],
                                               m["max_size_test"], self.query_bucket)
        pooled, supp_7x7 = self._supp_cache
        target_ids = torch.full((1,), self._supp_class_id, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            xyxy, scores, valid = self._det_call(pixels, sizes, pooled, supp_7x7, target_ids)
        return _select(xyxy[0].float().cpu().numpy(), scores[0].float().cpu().numpy(),
                       valid[0].cpu().numpy(), self.confidence_threshold, self._supp_class_id,
                       (h0, w0), (oh, ow))

    def run_on_opencv_image(self, image_bgr_u8: np.ndarray) -> np.ndarray:
        """BGR frame in, annotated BGR frame out (``OneShotPredictor``'s)."""
        return annotate_bgr(self.run_on_image, image_bgr_u8)
