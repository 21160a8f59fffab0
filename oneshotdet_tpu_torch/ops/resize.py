"""Resize + normalize + pad of a batch of uint8 RGB images: the plain
PyTorch version and the CUDA kernel's wrapper.

Counterpart of the JAX package's native host pass
``oneshotdet_tpu/csrc/fast_collate.cpp::resize_normalize_pad`` (one call
per image into its zero-padded batch slot, ``data/collate.py:48``): PIL's
triangle filter with its coefficients in float64 (the support widened by
the scale when downsampling), a horizontal pass summed in float64 and stored
as float32, a vertical pass in float64, one round half away from zero, a
clamp to 0..255, then BGR255 (or /255) and ``(c - mean) / std`` in float32.
That is the C++ pass's rounding, not PIL's own two-pass one.

``resize_normalize_pad`` dispatches on the device of the packed sources:
CPU tensors take ``resize_normalize_pad_plain``; CUDA tensors launch the
kernel of ``csrc/resize_normalize_pad.cu`` (one launch per batch) or raise.
The plain version repeats the kernel's operations in its order, one rounding
at a time, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

# Kernel launches since the count was last reset (set it to 0 to reset).
resize_launches = 0

META_FIELDS = 5           # per image: source byte offset, h0, w0, oh, ow
_SMEM_LIMIT = 232448 - 1024   # a block's shared memory on an H100, less the static part


@dataclasses.dataclass
class PackedImages:
    """A batch of uint8 RGB sources back to back on one device.

    pixels: (N,) uint8, image i at ``meta[i, 0]``, (h0, w0, 3) row-major.
    meta: (B, 5) int64 on the same device: offset, h0, w0, oh, ow.
    shapes: ((h0, w0, oh, ow), ...) on the host; (oh, ow) is the resample
      target of each image.
    """

    pixels: torch.Tensor
    meta: torch.Tensor
    shapes: Tuple[Tuple[int, int, int, int], ...]

    def __len__(self) -> int:
        return len(self.shapes)


def pack_images(images: Sequence[np.ndarray], out_hw: Sequence[Tuple[int, int]],
                device=None) -> PackedImages:
    """Pack (h0, w0, 3) uint8 arrays with their resample targets onto
    ``device`` (default "cuda"). For a CUDA device the sources go through one
    pinned host buffer and one asynchronous copy on the current stream."""
    device = torch.device("cuda" if device is None else device)
    if len(images) != len(out_hw) or not images:
        raise ValueError("pack_images: one (oh, ow) per image, at least one image")
    shapes, offsets, total = [], [], 0
    for im, (oh, ow) in zip(images, out_hw):
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"pack_images: need (h, w, 3) uint8, got {im.shape} {im.dtype}")
        h0, w0 = im.shape[:2]
        if min(h0, w0, oh, ow) < 1:
            raise ValueError(f"pack_images: empty source {im.shape[:2]} or target {(oh, ow)}")
        shapes.append((int(h0), int(w0), int(oh), int(ow)))
        offsets.append(total)
        total += im.size
    pin = device.type == "cuda"
    pixels = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    flat = pixels.numpy()
    for im, off in zip(images, offsets):
        flat[off:off + im.size] = np.ascontiguousarray(im).reshape(-1)
    meta = torch.tensor([(off,) + s for off, s in zip(offsets, shapes)], dtype=torch.int64)
    if pin:
        meta = meta.pin_memory()
    if device.type != "cpu":
        pixels = pixels.to(device, non_blocking=True)
        meta = meta.to(device, non_blocking=True)
    return PackedImages(pixels, meta, tuple(shapes))


def filter_size(in_size: int, out_size: int) -> int:
    """Taps of the widest filter of an in_size -> out_size resample."""
    return math.ceil(max(in_size / out_size, 1.0)) * 2 + 1


def filters(in_size: int, out_size: int, device=None):
    """PIL's precompute_coeffs for the triangle filter, in float64:
    (first tap (out,), tap count (out,), weights (out, ksize)); weights past
    a filter's count are 0."""
    f64 = torch.float64
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = filter_size(in_size, out_size)
    center = (torch.arange(out_size, dtype=f64, device=device) + 0.5) * scale
    first = (center - support + 0.5).to(torch.int64).clamp(min=0)
    count = (center + support + 0.5).to(torch.int64).clamp(max=in_size) - first
    taps = torch.arange(ksize, device=device)
    arg = ((taps[None, :] + first[:, None]).to(f64) - center[:, None] + 0.5) * ss
    w = torch.where(arg < 0, arg + 1.0, 1.0 - arg).clamp(min=0.0)
    w = torch.where(taps[None, :] < count[:, None], w, torch.zeros_like(w))
    ww = torch.zeros(out_size, dtype=f64, device=device)
    for i in range(ksize):          # the C++ sum, one tap at a time
        ww = ww + w[:, i]
    k = torch.where((ww != 0)[:, None], w / ww[:, None], w)
    return first, count, k


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


def _resample(src: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(h0, w0, 3) uint8 -> (oh, ow, 3) float64 before rounding."""
    h0, w0 = src.shape[:2]
    dev = src.device
    s = src.to(torch.float64)
    first, _, k = filters(w0, ow, dev)
    tmp = torch.zeros((h0, ow, 3), dtype=torch.float64, device=dev)
    for i in range(k.shape[1]):
        idx = (first + i).clamp(max=w0 - 1)
        tmp = tmp + k[:, i][None, :, None] * s[:, idx, :]
    tmp = tmp.to(torch.float32).to(torch.float64)
    first, _, k = filters(h0, oh, dev)
    acc = torch.zeros((oh, ow, 3), dtype=torch.float64, device=dev)
    for i in range(k.shape[1]):
        idy = (first + i).clamp(max=h0 - 1)
        acc = acc + k[:, i][:, None, None] * tmp[idy]
    return acc


def _check_norm(mean, std):
    mean = torch.as_tensor(np.asarray(mean, np.float32))
    std = torch.as_tensor(np.asarray(std, np.float32))
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("resize_normalize_pad: mean and std need 3 values each")
    return mean, std


def _check_slot(packed: PackedImages, pad_hw):
    pad_h, pad_w = (int(v) for v in pad_hw)
    for h0, w0, oh, ow in packed.shapes:
        if oh > pad_h or ow > pad_w:
            raise ValueError(f"resize_normalize_pad: target {(oh, ow)} exceeds the slot "
                             f"{(pad_h, pad_w)}")
    return pad_h, pad_w


def resize_normalize_pad_plain(packed: PackedImages, pad_hw, mean, std,
                               to_bgr255: bool = True) -> torch.Tensor:
    """The plain PyTorch version: (B, pad_h, pad_w, 3) float32 on the
    sources' device, each image resampled to its (oh, ow), normalized and
    zero-padded."""
    pad_h, pad_w = _check_slot(packed, pad_hw)
    mean, std = _check_norm(mean, std)
    dev = packed.pixels.device
    mean, std = mean.to(dev), std.to(dev)
    out = torch.zeros((len(packed), pad_h, pad_w, 3), dtype=torch.float32, device=dev)
    offsets = packed.meta[:, 0].tolist()
    inv255 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(255.0, dtype=torch.float32)
    for i, ((h0, w0, oh, ow), off) in enumerate(zip(packed.shapes, offsets)):
        src = packed.pixels[off:off + h0 * w0 * 3].reshape(h0, w0, 3)
        c = _round_half_away(_resample(src, oh, ow)).clamp(0.0, 255.0).to(torch.float32)
        c = c.flip(-1) if to_bgr255 else c * inv255.to(dev)
        out[i, :oh, :ow] = (c - mean) / std
    return out


def _kernel():
    from .. import csrc

    lib = csrc.load("resize_normalize_pad")
    fn = lib.oneshot_resize_normalize_pad
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, i, i, i, i, i, f, f, f, f, f, f, i, p, p]
        fn.restype = ctypes.c_int
        lib.oneshot_resize_smem_bytes.argtypes = [i, i]
        lib.oneshot_resize_smem_bytes.restype = ctypes.c_int
        lib.oneshot_resize_error_string.argtypes = [i]
        lib.oneshot_resize_error_string.restype = ctypes.c_char_p
    return lib


def resize_normalize_pad_cuda(packed: PackedImages, pad_hw, mean, std,
                              to_bgr255: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel (one launch for the batch); raises on any
    input it does not take."""
    global resize_launches
    dev = packed.pixels.device
    if dev.type != "cuda":
        raise ValueError("resize kernel: the packed sources must be on a CUDA device")
    pad_h, pad_w = _check_slot(packed, pad_hw)
    mean, std = _check_norm(mean, std)
    b = len(packed)
    if not (packed.pixels.dtype == torch.uint8 and packed.pixels.dim() == 1
            and packed.pixels.is_contiguous()):
        raise ValueError("resize kernel: pixels must be contiguous uint8 (N,)")
    if not (packed.meta.dtype == torch.int64 and packed.meta.shape == (b, META_FIELDS)
            and packed.meta.is_contiguous() and packed.meta.device == dev):
        raise ValueError(f"resize kernel: meta must be contiguous int64 ({b}, {META_FIELDS}) "
                         "on the pixels' device")
    if not (1 <= b <= 65535 and pad_h <= 8 * 65535):
        raise ValueError(f"resize kernel: batch {b} (1..65535), slot height {pad_h}")
    kw = max(filter_size(w0, ow) for _, w0, _, ow in packed.shapes)
    kh = max(filter_size(h0, oh) for h0, _, oh, _ in packed.shapes)
    lib = _kernel()
    smem = lib.oneshot_resize_smem_bytes(kw, kh)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"resize kernel: filters of {kw} x {kh} taps need {smem} bytes of "
                         f"shared memory (at most {_SMEM_LIMIT}): downscale too steep")
    out = torch.empty((b, pad_h, pad_w, 3), dtype=torch.float32, device=dev)
    m, s = mean.tolist(), std.tolist()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.oneshot_resize_normalize_pad(
            packed.pixels.data_ptr(), packed.meta.data_ptr(), b, pad_h, pad_w, kw, kh,
            *m, *s, int(bool(to_bgr255)), out.data_ptr(), stream)
    if rc != 0:
        err = lib.oneshot_resize_error_string(rc).decode()
        raise RuntimeError(f"resize kernel launch failed: {err} ({rc})")
    resize_launches += 1
    return out


def resize_normalize_pad(packed: PackedImages, pad_hw, mean, std,
                         to_bgr255: bool = True) -> torch.Tensor:
    """Every image of ``packed`` resampled to its target, normalized and
    written into its zero-padded (pad_h, pad_w) slot of one (B, pad_h,
    pad_w, 3) float32 tensor on the sources' device."""
    if packed.pixels.device.type == "cpu":
        return resize_normalize_pad_plain(packed, pad_hw, mean, std, to_bgr255)
    return resize_normalize_pad_cuda(packed, pad_hw, mean, std, to_bgr255)
