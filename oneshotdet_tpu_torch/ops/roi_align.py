"""ROIAlign: plain PyTorch versions and the CUDA kernel's wrapper.

Counterpart of ``oneshotdet_tpu/ops/roi_align.py`` (``roi_align``,
``fpn_level_map``, ``multilevel_roi_align``) and of the Pallas kernel
``oneshotdet_tpu/ops/pallas_roi_align.py::pallas_multilevel_roi_align``.
The layout is the JAX package's: features are NHWC ``(B, H, W, C)`` maps,
``rois`` are ``(R, 5)`` rows ``(batch, x1, y1, x2, y2)`` in image pixels and
the result is ``(R, pooled_h, pooled_w, C)``.

``multilevel_roi_align`` dispatches on the device of its inputs: CPU tensors
take the plain version (``multilevel_roi_align_plain``); CUDA tensors launch
the kernel of ``csrc/roi_align.cu`` or raise. Both compute the exact
bilinear ROIAlign of the JAX package's XLA version in float32 (bf16 inputs
are read as they are and the result is rounded once to the input dtype), and
both write zeros for slots whose ``valid`` flag is False.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

MAX_LEVELS = 5

# Kernel launches since the count was last reset (set it to 0 to reset).
roi_align_launches = 0


def fpn_level_map(
    xyxy: torch.Tensor,
    k_min: int,
    k_max: int,
    canonical_scale: float = 224.0,
    canonical_level: float = 4.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """FPN-paper level of each box, 0-based in [0, k_max - k_min]:
    floor(k0 + log2(sqrt(area) / 224 + eps)) clamped to [k_min, k_max], with
    the +1 pixel area convention."""
    area = (xyxy[..., 2] - xyxy[..., 0] + 1.0) * (xyxy[..., 3] - xyxy[..., 1] + 1.0)
    s = torch.sqrt(torch.clamp(area, min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale + eps))
    lvl = torch.clamp(lvl, k_min, k_max)
    return (lvl - k_min).to(torch.int32)


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n, correctly rounded on every device (CUDA turns division by a
    Python scalar into multiplication by its rounded reciprocal)."""
    return x / torch.full_like(x, float(n))


def _sample_fracs(pooled: int, g: int, device) -> torch.Tensor:
    """(pooled * g,) sample positions in bin units: bin + (i + 0.5) / g."""
    i = torch.arange(pooled * g, device=device)
    return (i // g).to(torch.float32) + _div((i % g).to(torch.float32) + 0.5, g)


def multilevel_roi_align_plain(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    scales: Sequence[float],
    sampling_ratio: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch multi-level ROIAlign (any device, autograd-safe).

    Each ROI is sampled on ``features[levels[r]]`` at ``scales[levels[r]]``;
    one gather pass over the concatenated pyramid, as in the JAX version.
    """
    if sampling_ratio <= 0:
        raise ValueError("sampling_ratio must be > 0 (static sample grid)")
    pooled_h, pooled_w = output_size
    g = sampling_ratio
    dev = rois.device
    b_dim, c = features[0].shape[0], features[0].shape[-1]
    levels = levels.long()

    heights = torch.tensor([f.shape[1] for f in features], device=dev)
    widths = torch.tensor([f.shape[2] for f in features], device=dev)
    sizes = [f.shape[1] * f.shape[2] for f in features]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    flat = torch.cat([f.reshape(b_dim, -1, c) for f in features], dim=1)

    scale_r = torch.tensor(list(scales), dtype=torch.float32, device=dev)[levels]
    h_r = heights[levels][:, None]
    w_r = widths[levels][:, None]
    batch_idx = rois[:, 0].long()

    rois = rois.to(torch.float32)
    start_w = rois[:, 1] * scale_r
    start_h = rois[:, 2] * scale_r
    roi_w = torch.clamp(rois[:, 3] * scale_r - start_w, min=1.0)
    roi_h = torch.clamp(rois[:, 4] * scale_r - start_h, min=1.0)
    bin_h = _div(roi_h, pooled_h)
    bin_w = _div(roi_w, pooled_w)

    ys = start_h[:, None] + _sample_fracs(pooled_h, g, dev)[None, :] * bin_h[:, None]
    xs = start_w[:, None] + _sample_fracs(pooled_w, g, dev)[None, :] * bin_w[:, None]
    yy = ys.repeat_interleave(pooled_w * g, dim=1)      # (R, P)
    xx = xs.repeat(1, pooled_h * g)

    hf = h_r.to(torch.float32)
    wf = w_r.to(torch.float32)
    in_range = (yy >= -1.0) & (yy <= hf) & (xx >= -1.0) & (xx <= wf)
    # clamping to <= H only touches masked samples and keeps indices small
    y = torch.minimum(torch.clamp(yy, min=0.0), hf)
    x = torch.minimum(torch.clamp(xx, min=0.0), wf)
    y_low = torch.minimum(torch.floor(y).long(), h_r - 1)
    x_low = torch.minimum(torch.floor(x).long(), w_r - 1)
    y_high = torch.minimum(y_low + 1, h_r - 1)
    x_high = torch.minimum(x_low + 1, w_r - 1)
    yv = torch.where(y_low >= h_r - 1, y_low.to(torch.float32), y)
    xv = torch.where(x_low >= w_r - 1, x_low.to(torch.float32), x)
    ly = yv - y_low
    lx = xv - x_low
    hy = 1.0 - ly
    hx = 1.0 - lx

    base = offsets[levels][:, None]
    bb = batch_idx[:, None]

    def corner(yi, xi):
        return flat[bb, base + yi * w_r + xi].to(torch.float32)   # (R, P, C)

    out = (
        (hy * hx)[..., None] * corner(y_low, x_low)
        + (hy * lx)[..., None] * corner(y_low, x_high)
        + (ly * hx)[..., None] * corner(y_high, x_low)
        + (ly * lx)[..., None] * corner(y_high, x_high)
    )
    out = torch.where(in_range[..., None], out, 0.0)
    r = rois.shape[0]
    out = out.reshape(r, pooled_h, g, pooled_w, g, c).mean(dim=(2, 4))
    if valid is not None:
        out = torch.where(valid[:, None, None, None], out, 0.0)
    return out.to(features[0].dtype)


class _Pyramid(ctypes.Structure):
    # mirrors `struct Pyramid` in csrc/roi_align.cu
    _fields_ = [
        ("data", ctypes.c_void_p * MAX_LEVELS),
        ("height", ctypes.c_int * MAX_LEVELS),
        ("width", ctypes.c_int * MAX_LEVELS),
        ("scale", ctypes.c_float * MAX_LEVELS),
        ("num_levels", ctypes.c_int),
    ]


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    from .. import csrc

    lib = csrc.load("roi_align")
    fn = lib.oneshot_roi_align_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.oneshot_cuda_error_string.argtypes = [ctypes.c_int]
        lib.oneshot_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"roi_align kernel: {msg}")


def multilevel_roi_align_cuda(features, rois, levels, output_size, scales,
                              sampling_ratio, valid=None) -> torch.Tensor:
    """Launch the CUDA kernel; raises on any input it does not take."""
    global roi_align_launches
    dev = rois.device
    _check(dev.type == "cuda", "rois must be a CUDA tensor")
    _check(1 <= len(features) <= MAX_LEVELS, f"1..{MAX_LEVELS} levels")
    _check(len(scales) == len(features), "one scale per level")
    _check(sampling_ratio > 0, "sampling_ratio must be > 0")
    dtype = features[0].dtype
    _check(dtype in _DTYPE_CODE, f"dtype {dtype} (float32 or bfloat16)")
    b, _, _, c = features[0].shape
    _check(c % 2 == 0, f"channel count {c} must be even")
    for f in features:
        _check(f.dim() == 4 and f.shape[0] == b and f.shape[3] == c,
               f"level shape {tuple(f.shape)} vs (B={b}, H, W, C={c})")
        _check(f.device == dev and f.dtype == dtype, "levels differ in device or dtype")
        _check(f.is_contiguous(), "levels must be contiguous NHWC")
    r = rois.shape[0]
    _check(rois.dtype == torch.float32 and rois.shape == (r, 5)
           and rois.is_contiguous(), "rois must be contiguous float32 (R, 5)")
    _check(levels.dtype == torch.int32 and levels.shape == (r,)
           and levels.is_contiguous() and levels.device == dev,
           "levels must be contiguous int32 (R,) on the rois' device")
    if valid is not None:
        _check(valid.dtype == torch.bool and valid.shape == (r,)
               and valid.is_contiguous() and valid.device == dev,
               "valid must be contiguous bool (R,) on the rois' device")
    pooled_h, pooled_w = output_size
    out = torch.empty((r, pooled_h, pooled_w, c), dtype=dtype, device=dev)
    if r == 0:
        return out

    pyr = _Pyramid()
    for i, (f, s) in enumerate(zip(features, scales)):
        pyr.data[i] = f.data_ptr()
        pyr.height[i] = f.shape[1]
        pyr.width[i] = f.shape[2]
        pyr.scale[i] = float(s)
    pyr.num_levels = len(features)

    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.oneshot_roi_align_forward(
            ctypes.addressof(pyr), b, c, _DTYPE_CODE[dtype], rois.data_ptr(),
            levels.data_ptr(), 0 if valid is None else valid.data_ptr(), r,
            pooled_h, pooled_w, sampling_ratio, out.data_ptr(), stream)
    if rc != 0:
        err = lib.oneshot_cuda_error_string(rc).decode()
        raise RuntimeError(f"roi_align kernel launch failed: {err} ({rc})")
    roi_align_launches += 1
    return out


def multilevel_roi_align(features, rois, levels, output_size, scales,
                         sampling_ratio, valid=None) -> torch.Tensor:
    """Multi-level ROIAlign: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if rois.device.type == "cpu" and all(f.device.type == "cpu" for f in features):
        return multilevel_roi_align_plain(features, rois, levels, output_size,
                                          scales, sampling_ratio, valid)
    return multilevel_roi_align_cuda(features, rois, levels, output_size,
                                     scales, sampling_ratio, valid)


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size,
              spatial_scale: float, sampling_ratio: int) -> torch.Tensor:
    """Single-level ROIAlign of NHWC ``features``: the one-level case of
    ``multilevel_roi_align`` (every ROI on level 0)."""
    levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device=rois.device)
    return multilevel_roi_align([features], rois, levels, output_size,
                                (spatial_scale,), sampling_ratio)
