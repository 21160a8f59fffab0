"""Anchor generation (counterpart of ``oneshotdet_tpu/models/anchor_generator.py``).

Cell anchors follow Caffe2's ``_generate_anchors``: the base box [0, 0,
stride - 1, stride - 1], the ratio enumeration with rounded widths and
heights, then the scale enumeration about the centre, in float64 and cast
to float32. Grid anchors per level are (H * W * A, 4) float32 in
(y * W + x) * A + a order: the cell's shift (x * stride, y * stride) added to
each of its A cell anchors, as the heads' NHWC outputs hold A values per
cell. ``visibility`` is the straddle mask: an anchor reaching more than
STRADDLE_THRESH beyond the image is not visible (all are, with a negative
threshold).

``grid_anchors`` keeps the grids it built by (level, H, W, device), so a
predictor that sees frames of a few sizes builds each grid once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def generate_cell_anchors(stride: int, sizes: Sequence[float],
                          aspect_ratios: Sequence[float]) -> np.ndarray:
    """(len(ratios) * len(sizes), 4) float32 anchors of one cell, ratio-major."""
    base = np.array([1, 1, stride, stride], np.float64) - 1
    anchors = _ratio_enum(base, np.asarray(aspect_ratios, np.float64))
    anchors = np.vstack([_scale_enum(anchors[i, :], np.asarray(sizes, np.float64) / stride)
                         for i in range(anchors.shape[0])])
    return anchors.astype(np.float32)


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack((x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)))


def _ratio_enum(anchor, ratios):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    return _mkanchors(w * scales, h * scales, x_ctr, y_ctr)


class AnchorGenerator:
    """Per-level cell anchors, grid anchors and the straddle mask."""

    def __init__(self, cell_anchors: Sequence[np.ndarray], strides: Sequence[int],
                 straddle_thresh: float = 0.0):
        if len(cell_anchors) != len(strides):
            raise ValueError(f"{len(cell_anchors)} levels of cell anchors, {len(strides)} strides")
        self.cell_anchors = [np.asarray(a, np.float32) for a in cell_anchors]
        self.strides = tuple(int(s) for s in strides)
        self.straddle_thresh = float(straddle_thresh)
        self._grids: Dict[Tuple, torch.Tensor] = {}

    @property
    def num_anchors_per_location(self) -> List[int]:
        return [a.shape[0] for a in self.cell_anchors]

    def grid_anchors(self, feature_shapes: Sequence[Tuple[int, int]], device=None
                     ) -> List[torch.Tensor]:
        """[(H * W * A, 4) float32] per level on ``device``."""
        device = torch.device("cpu" if device is None else device)
        out = []
        for lvl, ((h, w), stride, cell) in enumerate(zip(feature_shapes, self.strides,
                                                         self.cell_anchors)):
            key = (lvl, int(h), int(w), device)
            if key not in self._grids:
                shift_x = torch.arange(w, dtype=torch.float32) * stride
                shift_y = torch.arange(h, dtype=torch.float32) * stride
                sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
                sx, sy = sx.reshape(-1), sy.reshape(-1)
                shifts = torch.stack([sx, sy, sx, sy], dim=1)
                grid = (shifts[:, None, :] + torch.from_numpy(cell)[None]).reshape(-1, 4)
                self._grids[key] = grid.to(device)
            out.append(self._grids[key])
        return out

    def visibility(self, anchors: torch.Tensor, image_sizes_wh: torch.Tensor) -> torch.Tensor:
        """(N, 4) anchors, (B, 2) image (w, h) -> (B, N) bool straddle mask."""
        b = image_sizes_wh.shape[0]
        if self.straddle_thresh < 0:
            return torch.ones((b, anchors.shape[0]), dtype=torch.bool, device=anchors.device)
        t = self.straddle_thresh
        w = image_sizes_wh[:, 0:1].to(torch.float32)
        h = image_sizes_wh[:, 1:2].to(torch.float32)
        return ((anchors[None, :, 0] >= -t) & (anchors[None, :, 1] >= -t)
                & (anchors[None, :, 2] < w + t) & (anchors[None, :, 3] < h + t))


def rpn_anchor_generator(sizes: Sequence[float], aspect_ratios: Sequence[float],
                         strides: Sequence[int], straddle_thresh: float = 0.0
                         ) -> AnchorGenerator:
    """One size per level (the FPN RPN): a level's cells hold len(ratios)
    anchors. Raises ValueError where the sizes and strides differ in count
    (MODEL.RPN.ANCHOR_STRIDE's default (16,) is the single-level C4 RPN's)."""
    if len(sizes) != len(strides):
        raise ValueError(
            f"MODEL.RPN.ANCHOR_SIZES has {len(sizes)} entries and MODEL.RPN.ANCHOR_STRIDE "
            f"{len(strides)}: the FPN RPN takes one size and one stride per pyramid level "
            f"(set MODEL.RPN.ANCHOR_STRIDE to (8, 16, 32, 64, 128))")
    return AnchorGenerator([generate_cell_anchors(s, (size,), aspect_ratios)
                            for s, size in zip(strides, sizes)], strides, straddle_thresh)


def retinanet_anchor_generator(sizes: Sequence[float], aspect_ratios: Sequence[float],
                               strides: Sequence[int], octave: float = 2.0,
                               scales_per_octave: int = 3,
                               straddle_thresh: float = 0.0) -> AnchorGenerator:
    """Octave scales per level: size * octave ** (i / scales_per_octave)."""
    cells = [generate_cell_anchors(stride, [size * octave ** (i / scales_per_octave)
                                            for i in range(scales_per_octave)], aspect_ratios)
             for stride, size in zip(strides, sizes)]
    return AnchorGenerator(cells, strides, straddle_thresh)


def make_anchor_generator(cfg) -> AnchorGenerator:
    """The RPN's anchors from MODEL.RPN: one size per level with USE_FPN,
    else every size at the one stride."""
    r = cfg.MODEL.RPN
    if r.USE_FPN:
        return rpn_anchor_generator(r.ANCHOR_SIZES, r.ASPECT_RATIOS, r.ANCHOR_STRIDE,
                                    r.STRADDLE_THRESH)
    if len(r.ANCHOR_STRIDE) != 1:
        raise ValueError(f"MODEL.RPN.ANCHOR_STRIDE has {len(r.ANCHOR_STRIDE)} entries: "
                         "without MODEL.RPN.USE_FPN the RPN has one level")
    return AnchorGenerator([generate_cell_anchors(r.ANCHOR_STRIDE[0], r.ANCHOR_SIZES,
                                                  r.ASPECT_RATIOS)],
                           r.ANCHOR_STRIDE, r.STRADDLE_THRESH)


def make_anchor_generator_retinanet(cfg) -> AnchorGenerator:
    """RetinaNet's anchors from MODEL.RETINANET."""
    r = cfg.MODEL.RETINANET
    return retinanet_anchor_generator(r.ANCHOR_SIZES, r.ASPECT_RATIOS, r.ANCHOR_STRIDES,
                                      r.OCTAVE, r.SCALES_PER_OCTAVE, r.STRADDLE_THRESH)
