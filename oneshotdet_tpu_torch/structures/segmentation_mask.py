"""Segmentation mask containers (counterpart of
``oneshotdet_tpu/structures/segmentation_mask.py``).

  - ``PolygonInstance`` / ``PolygonList``: one object's polygons, [x0, y0,
    x1, y1, ...] per ring, with transpose, crop, resize and rasterization;
  - ``BinaryMaskList``: (N, H, W) uint8 masks with the same operations;
  - ``SegmentationMask``: the mode-dispatching wrapper ('poly' | 'mask').

Everything is numpy; no PIL. The JAX package draws a polygon with PIL
(``ImageDraw.polygon(..., outline=1, fill=1)``) and resizes a mask with
PIL's nearest filter; ``fill_polygons`` and ``resize_nearest`` give PIL's
pixels exactly (Pillow 12.1's ``libImaging``):

  - vertices truncated toward zero to integers; an edge per pair of
    consecutive vertices and a closing edge (runs of collinear horizontal
    edges merged), horizontal edges drawn as rows of their own;
  - one scanline per integer row from the lowest to the highest edge row
    (clipped to [0, H]): each edge crossing the row gives x = (y - y0) * dx
    + x0 in float32, an edge ending on the row gives it twice unless the row
    is the last; at an edge's end row, a crossing that rounds to another
    edge's end there and lies more than a pixel beyond both edges' crossings
    of the neighbouring row moves to one past them ("discontiguous
    corners"); the sorted crossings are filled in pairs from the first
    rounded half up to the second rounded half down.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1

_F32 = np.float32


def _decode_uncompressed_rle(rle: dict) -> np.ndarray:
    """(h, w) uint8 of a COCO uncompressed RLE (counts column-major)."""
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in rle["counts"]:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T


def _roundf(x: np.ndarray) -> np.ndarray:
    """C ``roundf`` (half away from zero) of float32 values."""
    x = x.astype(np.float64)
    return (np.sign(x) * np.floor(np.abs(x) + 0.5)).astype(_F32)


def _round_up(x: np.ndarray) -> np.ndarray:
    """libImaging's ROUND_UP of float32 values: floor(x + 0.5f) in float32
    for x >= 0, -floor(|x| + 0.5) in double otherwise."""
    x = np.asarray(x, _F32)
    pos = np.floor(x + _F32(0.5)).astype(np.int64)
    neg = -np.floor(np.abs(x).astype(np.float64) + 0.5).astype(np.int64)
    return np.where(x >= 0, pos, neg)


def _round_down(x: np.ndarray) -> np.ndarray:
    """libImaging's ROUND_DOWN: ceil(x - 0.5f) in float32 for x >= 0,
    -ceil(|x| - 0.5) in double otherwise."""
    x = np.asarray(x, _F32)
    pos = np.ceil(x - _F32(0.5)).astype(np.int64)
    neg = -np.ceil(np.abs(x).astype(np.float64) - 0.5).astype(np.int64)
    return np.where(x >= 0, pos, neg)


def _edges(xy: np.ndarray):
    """The edge list of integer vertices (n, 2): per edge (x0, y0, xmin,
    ymin, xmax, ymax) int64 and dx float32, consecutive horizontal edges
    going the same way merged into one."""
    rows = []
    n = len(xy)
    for i in range(n - 1):
        x0, y0 = xy[i]
        x1, y1 = xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            last = rows[-1]
            if x1 > x0 > xy[i - 1][0]:
                last[4] = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                last[2] = x1
                continue
        rows.append([x0, y0, min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1), x1, y1])
    if tuple(xy[n - 1]) != tuple(xy[0]):
        (x0, y0), (x1, y1) = xy[n - 1], xy[0]
        rows.append([x0, y0, min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1), x1, y1])
    e = np.asarray(rows, np.int64).reshape(-1, 8)
    dy = e[:, 7] - e[:, 1]
    dx = np.zeros(len(e), _F32)
    sloped = dy != 0
    dx[sloped] = (e[sloped, 6] - e[sloped, 0]).astype(_F32) / dy[sloped].astype(_F32)
    return e[:, :6], dx


def _x_at(x0, y0, dx, y):
    """An edge's float32 crossing of row y: float(y - y0) * dx + float(x0)."""
    return (y - y0).astype(_F32) * dx + x0.astype(_F32)


def _polygon_spans(xy: np.ndarray, h: int):
    """(rows, starts, ends) of the horizontal runs that fill one ring of
    integer vertices on an image of height ``h`` (not yet clipped)."""
    e, dx = _edges(xy)
    if not len(e):
        return (np.zeros(0, np.int64),) * 3
    x0, y0, xmin, ymin, xmax, ymax = e.T
    flat = ymin == ymax
    rows_out = [ymin[flat]]
    starts, ends = [xmin[flat]], [xmax[flat]]
    y_lo = max(0, min(h - 1, int(ymin.min())))
    y_hi = min(h, max(0, int(ymax.max())))
    keep = ~flat
    x0, y0, ymin, ymax, dx = x0[keep], y0[keep], ymin[keep], ymax[keep], dx[keep]
    if len(dx) and y_lo <= y_hi:
        ys = np.arange(y_lo, y_hi + 1, dtype=np.int64)
        active = (ys[None] >= ymin[:, None]) & (ys[None] <= ymax[:, None])   # (E, R)
        edge_i, row_i = np.nonzero(active)
        y = ys[row_i]
        x = _x_at(x0[edge_i], y0[edge_i], dx[edge_i], y)
        twice = (y == ymax[edge_i]) & (y < y_hi)
        corner = ((y == ymin[edge_i]) | (y == ymax[edge_i])) & ~twice & (dx[edge_i] != 0)
        if corner.any():
            x = x.copy()
            x[corner] = _corners(x[corner], edge_i[corner], y[corner],
                                 x0, y0, ymin, ymax, dx)
        y = np.concatenate([y, y[twice]])
        x = np.concatenate([x, x[twice]])
        order = np.lexsort((x, y))
        y, x = y[order], x[order]
        # rank within the row: crossings 2k and 2k + 1 bound a run
        first = np.searchsorted(y, y, side="left")
        rank = np.arange(len(y)) - first
        count = np.searchsorted(y, y, side="right") - first
        lead = (rank % 2 == 0) & (rank + 1 < count)
        idx = np.nonzero(lead)[0]
        rows_out.append(y[idx])
        starts.append(_round_up(x[idx]))
        ends.append(_round_down(x[idx + 1]))
    return np.concatenate(rows_out), np.concatenate(starts), np.concatenate(ends)


def _corners(x, cur, y, x0, y0, ymin, ymax, dx):
    """The crossings of edges ``cur`` at their end rows ``y`` after the
    corner rule: the first earlier edge k that also ends on the row, is not
    vertical, rounds to the same x and spans the neighbouring row (the next
    one from a top end, the previous one from a bottom end) decides; if x
    lies more than a pixel right of both edges' crossings of that row it
    becomes roundf(max) + 1, more than a pixel left of both roundf(min) - 1."""
    k = np.arange(len(dx))[None]                                   # (1, E)
    yo = np.where(y == ymax[cur], y - 1, y + 1)[:, None]           # (C, 1)
    yc = y[:, None]
    other_x = _x_at(x0[None], y0[None], dx[None], yc)              # (C, E)
    ok = ((k < cur[:, None]) & ((yc == ymin[None]) | (yc == ymax[None])) & (dx[None] != 0)
          & (_roundf(x)[:, None] == _roundf(other_x))
          & (yo >= ymin[None]) & (yo <= ymax[None]))
    out = x.copy()
    hit = ok.any(axis=1)
    if not hit.any():
        return out
    c = np.nonzero(hit)[0]
    kk = np.argmax(ok[c], axis=1)
    a = _x_at(x0[cur[c]], y0[cur[c]], dx[cur[c]], yo[c, 0])
    b = _x_at(x0[kk], y0[kk], dx[kk], yo[c, 0])
    xc, one = x[c], _F32(1)
    right = (xc > a + one) & (xc > b + one)
    left = ~right & (a - one > xc) & (b - one > xc)
    new = np.where(right, _roundf(np.maximum(a, b)) + one,
                   np.where(left, _roundf(np.minimum(a, b)) - one, xc))
    out[c] = new.astype(_F32)
    return out


def fill_polygons(rings: Sequence[np.ndarray], w: int, h: int) -> np.ndarray:
    """(h, w) uint8: 1 inside or on the border of any ring, as PIL's
    ``ImageDraw.polygon(ring, outline=1, fill=1)`` on an ``L`` image of that
    size draws them one after another. A ring is a flat [x0, y0, ...]."""
    rows, starts, ends = [], [], []
    for ring in rings:
        p = np.asarray(ring, np.float64).reshape(-1, 2)
        xy = np.trunc(p).astype(np.int64)
        r, s, t = _polygon_spans(xy, h)
        rows.append(r)
        starts.append(s)
        ends.append(t)
    out = np.zeros((h, w), np.uint8)
    if not rows:
        return out
    y, x0, x1 = np.concatenate(rows), np.concatenate(starts), np.concatenate(ends)
    x0, x1 = np.maximum(x0, 0), np.minimum(x1, w - 1)
    ok = (y >= 0) & (y < h) & (x0 < w) & (x1 >= 0) & (x0 <= x1)
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (y[ok], x0[ok]), 1)
    np.add.at(diff, (y[ok], x1[ok] + 1), -1)
    out[np.cumsum(diff[:, :w], axis=1) > 0] = 1
    return out


def resize_nearest(mask: np.ndarray, w: int, h: int) -> np.ndarray:
    """PIL's ``Image.resize((w, h), NEAREST)`` of an (H, W) uint8 mask: the
    source pixel of output column x is int(x0 + sx / 2 + x * sx), the
    position accumulated in double one step at a time as libImaging does."""
    src_h, src_w = mask.shape
    if (src_w, src_h) == (w, h):
        return mask.copy()

    def taps(n_out, n_in):
        step = n_in / n_out
        pos = step * 0.5
        out = np.empty(n_out, np.int64)
        for i in range(n_out):
            out[i] = -1 if pos < 0.0 else int(pos)
            pos += step
        return out

    xs, ys = taps(w, src_w), taps(h, src_h)
    out = np.zeros((h, w), mask.dtype)
    xin = (xs >= 0) & (xs < src_w)
    if xin.any():
        lo, hi = np.nonzero(xin)[0][[0, -1]]
        yin = (ys >= 0) & (ys < src_h)
        out[np.ix_(np.nonzero(yin)[0], np.arange(lo, hi + 1))] = \
            mask[np.ix_(ys[yin], xs[lo:hi + 1])]
    return out


class PolygonInstance:
    """One object's polygons: a list of [x0, y0, x1, y1, ...] rings."""

    def __init__(self, polygons: Sequence, size):
        if isinstance(polygons, PolygonInstance):
            polygons = [p.copy() for p in polygons.polygons]
        else:
            polygons = [np.asarray(p, np.float64).reshape(-1) for p in polygons]
        self.polygons = polygons
        self.size = tuple(size)  # (w, h)

    def transpose(self, method: int) -> "PolygonInstance":
        w, h = self.size
        flipped = []
        for p in self.polygons:
            p = p.copy()
            if method == FLIP_LEFT_RIGHT:
                p[0::2] = w - p[0::2] - 1
            else:
                p[1::2] = h - p[1::2] - 1
            flipped.append(p)
        return PolygonInstance(flipped, self.size)

    def crop(self, box) -> "PolygonInstance":
        x1, y1, x2, y2 = map(float, box)
        w, h = x2 - x1, y2 - y1
        cropped = []
        for p in self.polygons:
            p = p.copy()
            p[0::2] = np.clip(p[0::2] - x1, 0, w)
            p[1::2] = np.clip(p[1::2] - y1, 0, h)
            cropped.append(p)
        return PolygonInstance(cropped, (w, h))

    def resize(self, size) -> "PolygonInstance":
        rw = size[0] / self.size[0]
        rh = size[1] / self.size[1]
        out = []
        for p in self.polygons:
            p = p.copy()
            p[0::2] *= rw
            p[1::2] *= rh
            out.append(p)
        return PolygonInstance(out, size)

    def rasterize(self) -> np.ndarray:
        """(h, w) uint8 at the rounded size (at least 1 x 1); rings of fewer
        than 6 coordinates are skipped."""
        w, h = int(round(self.size[0])), int(round(self.size[1]))
        return fill_polygons([p for p in self.polygons if len(p) >= 6], max(w, 1), max(h, 1))

    def __len__(self):
        return len(self.polygons)


class PolygonList:
    def __init__(self, polygons: Sequence, size):
        self.instances = [
            p if isinstance(p, PolygonInstance) else PolygonInstance(p, size)
            for p in polygons
        ]
        self.size = tuple(size)

    def transpose(self, method):
        return PolygonList([i.transpose(method) for i in self.instances], self.size)

    def crop(self, box):
        w = box[2] - box[0]
        h = box[3] - box[1]
        return PolygonList([i.crop(box) for i in self.instances], (w, h))

    def resize(self, size):
        return PolygonList([i.resize(size) for i in self.instances], size)

    def convert_to_binarymask(self) -> "BinaryMaskList":
        if self.instances:
            masks = np.stack([i.rasterize() for i in self.instances])
        else:
            w, h = self.size
            masks = np.zeros((0, int(h), int(w)), np.uint8)
        return BinaryMaskList(masks, self.size)

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return PolygonList([self.instances[idx]], self.size)
        return PolygonList([self.instances[i] for i in idx], self.size)

    def __iter__(self):
        return iter(self.instances)


class BinaryMaskList:
    """(N, H, W) uint8 masks."""

    def __init__(self, masks: Union[np.ndarray, Sequence, dict], size):
        if isinstance(masks, dict):  # one RLE
            masks = _decode_uncompressed_rle(masks)[None]
        masks = np.asarray(masks, np.uint8)
        if masks.ndim == 2:
            masks = masks[None]
        self.masks = masks
        self.size = tuple(size)

    def transpose(self, method):
        axis = 2 if method == FLIP_LEFT_RIGHT else 1
        return BinaryMaskList(np.flip(self.masks, axis=axis).copy(), self.size)

    def crop(self, box):
        x1, y1, x2, y2 = [int(round(float(b))) for b in box]
        cropped = self.masks[:, max(y1, 0):y2 + 1, max(x1, 0):x2 + 1]
        return BinaryMaskList(cropped, (max(x2 - x1, 1), max(y2 - y1, 1)))

    def resize(self, size):
        w, h = int(size[0]), int(size[1])
        out = (np.stack([resize_nearest(m, w, h) for m in self.masks]) if len(self.masks)
               else np.zeros((0, h, w), np.uint8))
        return BinaryMaskList(out, size)

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return BinaryMaskList(self.masks[idx:idx + 1], self.size)
        return BinaryMaskList(self.masks[np.asarray(idx)], self.size)


class SegmentationMask:
    """Mode-dispatching wrapper over PolygonList ('poly') and
    BinaryMaskList ('mask')."""

    def __init__(self, instances, size, mode: str = "poly"):
        assert mode in ("poly", "mask")
        if mode == "poly":
            self.instances = (instances if isinstance(instances, PolygonList)
                              else PolygonList(instances, size))
        else:
            self.instances = (instances if isinstance(instances, BinaryMaskList)
                              else BinaryMaskList(instances, size))
        self.mode = mode
        self.size = tuple(size)

    def transpose(self, method):
        return SegmentationMask(self.instances.transpose(method), self.size, self.mode)

    def crop(self, box):
        inst = self.instances.crop(box)
        return SegmentationMask(inst, inst.size, self.mode)

    def resize(self, size):
        return SegmentationMask(self.instances.resize(size), size, self.mode)

    def convert(self, mode: str) -> "SegmentationMask":
        if mode == self.mode:
            return self
        assert self.mode == "poly" and mode == "mask"
        return SegmentationMask(self.instances.convert_to_binarymask(), self.size, "mask")

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, idx):
        return SegmentationMask(self.instances[idx], self.size, self.mode)
