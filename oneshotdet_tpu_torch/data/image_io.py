"""Image decoding and PIL-exact cropping for the data path.

Binary PPM (P6, maxval 255) is read with numpy; any other file goes through
PIL, imported inside ``read_image_rgb`` only, so the port runs where PIL is
not installed on datasets stored as PPM. The format is chosen by the file's
magic bytes, never by what is installed.
"""

from __future__ import annotations

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
