"""Image decoding, PIL-exact cropping and PIL-exact bilinear resizing.

Binary PPM (P6, maxval 255) is read with numpy; any other file goes through
PIL, imported inside ``read_image_rgb`` only, so the port runs where PIL is
not installed on datasets stored as PPM. The format is chosen by the file's
magic bytes, never by what is installed.

``resize_bilinear`` is Pillow's 8-bit ``Image.resize(size, BILINEAR)`` of a
one-channel image in numpy (Pillow's ``libImaging/Resample.c``): the mask
paste-back and the predictor's mask contours resize uint8 grids with it.
"""

from __future__ import annotations

import math

import numpy as np

_WHITESPACE = b" \t\n\r\v\f"


def _ppm_raster(data: bytes):
    """(h, w, 3) uint8 of a binary PPM with maxval 255, or None for another
    maxval. Comments (# to end of line) may sit between header fields."""
    pos, fields = 2, []
    while len(fields) < 3:
        c = data[pos:pos + 1]
        if not c:
            raise ValueError("truncated PPM header")
        if c in _WHITESPACE:
            pos += 1
        elif c == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
        elif c.isdigit():
            start = pos
            while data[pos:pos + 1].isdigit():
                pos += 1
            fields.append(int(data[start:pos]))
        else:
            raise ValueError(f"bad PPM header byte {c!r} at {pos}")
    w, h, maxval = fields
    if maxval != 255:
        return None
    pos += 1                    # the one whitespace byte before the raster
    if len(data) - pos < h * w * 3:
        raise ValueError(f"truncated PPM raster: {len(data) - pos} of {h * w * 3} bytes")
    return np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos).reshape(h, w, 3)


def read_image_rgb(path) -> np.ndarray:
    """The (H, W, 3) uint8 RGB pixels of an image file, as PIL's
    ``Image.open(path).convert("RGB")`` gives them. A binary PPM (maxval 255)
    is read with numpy (a read-only array); any other file needs PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        arr = _ppm_raster(data)
        if arr is not None:
            return arr
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: not a binary PPM with maxval 255, and decoding it needs "
                          "PIL, which is not installed") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def crop(arr: np.ndarray, box) -> np.ndarray:
    """PIL's ``Image.crop(box)`` on an (H, W, 3) array: each coordinate
    rounded with Python's ``round`` (half to even), the part of the box
    outside the image filled with zeros."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    h, w = arr.shape[:2]
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0), 3), np.uint8)
    sx0, sy0, sx1, sy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = arr[sy0:sy1, sx0:sx1]
    return out


def write_ppm(path, arr: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a binary PPM (P6, maxval 255)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())


PRECISION_BITS = 32 - 8 - 2     # Resample.c's fixed-point coefficients


def _bilinear_coeffs(in_size: int, out_size: int):
    """Resample.c's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for
    the bilinear filter over a whole axis: per output index, the first input
    index and the int32 fixed-point weights (out_size, ksize), zero beyond
    each output's own span. Every float operation is the C code's, in
    double, in its order."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    t = np.abs(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where((x[None, :] < xmax[:, None]) & (t < 1.0), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):          # the C loop's order of the sum
        ww = ww + w[:, i]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    kk = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int64)
    return xmin, kk


def _resample_axis(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass (Resample.c's ``ImagingResample{Horizontal,Vertical}_8bpc``)
    of uint8 ``arr`` along ``axis``: exact integer sums, rounded by the half
    added first, shifted and clipped to uint8."""
    in_size = arr.shape[axis]
    xmin, kk = _bilinear_coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    a = np.moveaxis(arr, axis, -1).astype(np.int64)
    acc = (a[..., idx] * kk).sum(-1) + (1 << (PRECISION_BITS - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_bilinear(arr: np.ndarray, size) -> np.ndarray:
    """Pillow's ``Image.fromarray(arr).resize(size, Image.BILINEAR)`` of an
    (H, W) uint8 image to ``size`` = (width, height), byte for byte: the
    horizontal pass first, a uint8 image between the passes, each pass only
    where its axis changes."""
    arr = np.asarray(arr, np.uint8)
    w, h = int(size[0]), int(size[1])
    if arr.shape[1] != w:
        arr = _resample_axis(arr, w, 1)
    if arr.shape[0] != h:
        arr = _resample_axis(arr, h, 0)
    return np.array(arr, np.uint8)
