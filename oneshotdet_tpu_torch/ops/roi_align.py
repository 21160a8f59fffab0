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

``roi_align_plan`` mirrors how the kernel stages a ROI: the distinct rows
and columns its samples touch, and the items (whole output rows x whole
output columns) whose pixels fit one shared-memory buffer.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

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


def _axis_samples(start: torch.Tensor, bin_size: torch.Tensor, size: torch.Tensor,
                  pooled: int, g: int):
    """One axis of every ROI's sample grid, each (R, pooled * g), sample
    ``p * g + i`` at ``start + (p + (i + 0.5) / g) * bin_size``: in range
    (inside [-1, size]), low and high cell (clamped to the level), and the
    weights of the high (``l``) and the low (``h``) cell. ``size`` is (R,)
    int64. The kernel computes the same float32 operations once per ROI."""
    pos = start[:, None] + _sample_fracs(pooled, g, start.device)[None, :] * bin_size[:, None]
    last = size[:, None] - 1
    sf = size[:, None].to(torch.float32)
    ok = (pos >= -1.0) & (pos <= sf)
    # clamping to <= size only touches masked samples and keeps indices small
    p = torch.minimum(torch.clamp(pos, min=0.0), sf)
    low = torch.minimum(torch.floor(p).long(), last)
    high = torch.minimum(low + 1, last)
    l = torch.where(low >= last, low.to(torch.float32), p) - low
    return ok, low, high, l, 1.0 - l


def _roi_axes(rois: torch.Tensor, levels: torch.Tensor, heights: torch.Tensor,
              widths: torch.Tensor, scales: Sequence[float], output_size, g: int):
    """(y axis, x axis) of ``_axis_samples`` for every ROI on its level."""
    pooled_h, pooled_w = output_size
    scale_r = torch.tensor(list(scales), dtype=torch.float32, device=rois.device)[levels]
    rois = rois.to(torch.float32)
    start_w = rois[:, 1] * scale_r
    start_h = rois[:, 2] * scale_r
    roi_w = torch.clamp(rois[:, 3] * scale_r - start_w, min=1.0)
    roi_h = torch.clamp(rois[:, 4] * scale_r - start_h, min=1.0)
    return (_axis_samples(start_h, _div(roi_h, pooled_h), heights[levels], pooled_h, g),
            _axis_samples(start_w, _div(roi_w, pooled_w), widths[levels], pooled_w, g))


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

    (oky, y_low, y_high, ly, hy), (okx, x_low, x_high, lx, hx) = _roi_axes(
        rois, levels, heights, widths, scales, output_size, g)
    # the (R, P) sample grid, y-major
    def rep(a):
        return a.repeat_interleave(pooled_w * g, dim=1)

    def til(a):
        return a.repeat(1, pooled_h * g)

    in_range = rep(oky) & til(okx)
    w_r = widths[levels][:, None]
    base = offsets[levels][:, None]
    bb = rois[:, 0].long()[:, None]

    def corner(yi, xi):
        return flat[bb, base + rep(yi) * w_r + til(xi)].to(torch.float32)   # (R, P, C)

    out = (
        (rep(hy) * til(hx))[..., None] * corner(y_low, x_low)
        + (rep(hy) * til(lx))[..., None] * corner(y_low, x_high)
        + (rep(ly) * til(hx))[..., None] * corner(y_high, x_low)
        + (rep(ly) * til(lx))[..., None] * corner(y_high, x_high)
    )
    out = torch.where(in_range[..., None], out, 0.0)
    r = rois.shape[0]
    out = out.reshape(r, pooled_h, g, pooled_w, g, c).mean(dim=(2, 4))
    if valid is not None:
        out = torch.where(valid[:, None, None, None], out, 0.0)
    return out.to(features[0].dtype)


# -- the kernel's plan (csrc/roi_align.cu, steps 2-3), mirrored --------------

STAGE_BYTES = 24 * 1024   # one staging buffer of the kernel (a block has two)
MAX_AXIS = 32             # pooled * sampling_ratio on one axis
MAX_ITEMS = 64            # pooled_h * pooled_w


@dataclasses.dataclass
class RoiPlan:
    """How the kernel stages one live ROI. ``rows`` and ``cols`` are the
    distinct cells its in-range samples touch, ascending; ``y_slots[s]`` and
    ``x_slots[s]`` index them with sample ``s``'s (low, high) cells (None:
    out of range); ``items`` are (ph0, ph1, pw0, pw1, r0, r1, c0, c1):
    output rows [ph0, ph1) x columns [pw0, pw1), staged as the pixels of
    ``rows[r0:r1]`` x ``cols[c0:c1]``."""

    rows: List[int]
    cols: List[int]
    y_slots: List[Optional[Tuple[int, int]]]
    x_slots: List[Optional[Tuple[int, int]]]
    items: List[Tuple[int, int, int, int, int, int, int, int]]

    @property
    def staged_pixels(self) -> int:
        return sum((r1 - r0) * (c1 - c0) for *_, r0, r1, c0, c1 in self.items)


def stage_budget(channels: int, dtype: torch.dtype) -> int:
    """Pixels that fit one staging buffer."""
    return STAGE_BYTES // (channels * torch.finfo(dtype).bits // 8)


def _axis_slots(ok, low, high, pooled: int, g: int):
    """Step 2 on one axis: the distinct cells of the in-range samples,
    ascending, each sample's (low, high) slots, and per output index p the
    slot range [first[p], end[p]) of its samples. An index without in-range
    samples gets the empty range at 0 before them and at the list's end
    after them, so that first and end are monotone."""
    cells, slots = [], []
    for s in range(pooled * g):
        if not ok[s]:
            slots.append(None)
            continue
        # the samples are monotone: a cell not above the last one listed is
        # listed already
        for cell in (low[s], high[s]):
            if not cells or cell > cells[-1]:
                cells.append(cell)
        slots.append((cells.index(low[s]), cells.index(high[s])))
    first, end = [], []
    for p in range(pooled):
        live = [sl for sl in slots[p * g:(p + 1) * g] if sl is not None]
        if live:
            first.append(live[0][0])
            end.append(live[-1][1] + 1)
        else:
            edge = len(cells) if any(ok[:p * g]) else 0
            first.append(edge)
            end.append(edge)
    return cells, slots, first, end


def _plan_items(y_span, x_span, pooled_h: int, pooled_w: int, budget: int):
    """Step 3: column chunks of whole output columns, each in bands of whole
    output rows, every item's pixels within ``budget``."""
    (yf, ye), (xf, xe) = y_span, x_span
    cols_limit = budget // max([1] + [ye[p] - yf[p] for p in range(pooled_h)])
    items, pw0 = [], 0
    while pw0 < pooled_w:
        pw1 = pw0 + 1
        while pw1 < pooled_w and xe[pw1] - xf[pw0] <= cols_limit:
            pw1 += 1
        c0, c1 = xf[pw0], xe[pw1 - 1]
        ph0 = 0
        while ph0 < pooled_h:
            ph1 = ph0 + 1
            while ph1 < pooled_h and (ye[ph1] - yf[ph0]) * (c1 - c0) <= budget:
                ph1 += 1
            items.append((ph0, ph1, pw0, pw1, yf[ph0], ye[ph1 - 1], c0, c1))
            ph0 = ph1
        pw0 = pw1
    return items


def roi_align_plan(features, rois, levels, output_size, scales, sampling_ratio,
                   valid=None) -> List[Optional[RoiPlan]]:
    """The kernel's plan for every ROI (None for a slot it only zeroes):
    which rows and columns its samples touch and how its bins are cut into
    items that fit the staging buffer. Only the features' shapes and dtype
    are read."""
    pooled_h, pooled_w = output_size
    g = sampling_ratio
    rois, levels = rois.detach().cpu().to(torch.float32), levels.detach().cpu().long()
    batch, nl = features[0].shape[0], len(features)
    heights = torch.tensor([f.shape[1] for f in features])
    widths = torch.tensor([f.shape[2] for f in features])
    live = (levels >= 0) & (levels < nl) & (rois[:, 0].long() >= 0) & (rois[:, 0].long() < batch)
    if valid is not None:
        live &= valid.detach().cpu()
    lv = torch.where(live, levels, 0)
    axes = [[t.tolist() for t in axis[:3]]
            for axis in _roi_axes(rois, lv, heights, widths, scales, output_size, g)]
    budget = stage_budget(features[0].shape[-1], features[0].dtype)
    plans = []
    for r in range(rois.shape[0]):
        if not live[r]:
            plans.append(None)
            continue
        (oky, ylo, yhi), (okx, xlo, xhi) = ([a[r] for a in axis] for axis in axes)
        rows, y_slots, yf, ye = _axis_slots(oky, ylo, yhi, pooled_h, g)
        cols, x_slots, xf, xe = _axis_slots(okx, xlo, xhi, pooled_w, g)
        plans.append(RoiPlan(rows, cols, y_slots, x_slots,
                             _plan_items((yf, ye), (xf, xe), pooled_h, pooled_w, budget)))
    return plans


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
        fn.argtypes = [p, i, i, i, p, p, p, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        lib.oneshot_cuda_error_string.argtypes = [ctypes.c_int]
        lib.oneshot_cuda_error_string.restype = ctypes.c_char_p
        limits = (ctypes.c_int * 3)()
        lib.oneshot_roi_align_limits(limits)
        if tuple(limits) != (STAGE_BYTES, MAX_AXIS, MAX_ITEMS):
            raise RuntimeError(f"roi_align.cu limits {tuple(limits)} differ from the "
                               f"plan's {(STAGE_BYTES, MAX_AXIS, MAX_ITEMS)}")
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"roi_align kernel: {msg}")


def multilevel_roi_align_cuda(features, rois, levels, output_size, scales,
                              sampling_ratio, valid=None, stats=None) -> torch.Tensor:
    """Launch the CUDA kernel; raises on any input it does not take.
    ``stats``, an int32 (R, 2) CUDA tensor, receives each ROI's (items,
    staged pixels) of its plan (``roi_align_plan``)."""
    global roi_align_launches
    dev = rois.device
    _check(dev.type == "cuda", "rois must be a CUDA tensor")
    _check(1 <= len(features) <= MAX_LEVELS, f"1..{MAX_LEVELS} levels")
    _check(len(scales) == len(features), "one scale per level")
    g = sampling_ratio
    pooled_h, pooled_w = output_size
    _check(g > 0 and pooled_h > 0 and pooled_w > 0,
           "sampling_ratio and the output size must be > 0")
    _check(pooled_h * g <= MAX_AXIS and pooled_w * g <= MAX_AXIS
           and pooled_h * pooled_w <= MAX_ITEMS,
           f"output {output_size} x sampling_ratio {g}: at most {MAX_AXIS} samples per "
           f"axis and {MAX_ITEMS} bins")
    dtype = features[0].dtype
    _check(dtype in _DTYPE_CODE, f"dtype {dtype} (float32 or bfloat16)")
    b, _, _, c = features[0].shape
    elt = torch.finfo(dtype).bits // 8
    _check(c > 0 and c * elt % 16 == 0,
           f"channel count {c} must fill 16-byte vectors ({16 // elt} {dtype} each)")
    _check(4 * g * g <= stage_budget(c, dtype),
           f"one bin's {2 * g} x {2 * g} pixels of {c} channels must fit {STAGE_BYTES} bytes")
    for f in features:
        _check(f.dim() == 4 and f.shape[0] == b and f.shape[3] == c,
               f"level shape {tuple(f.shape)} vs (B={b}, H, W, C={c})")
        _check(f.device == dev and f.dtype == dtype, "levels differ in device or dtype")
        _check(f.is_contiguous(), "levels must be contiguous NHWC")
        _check(f.data_ptr() % 16 == 0, "levels must be 16-byte aligned")
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
    if stats is not None:
        _check(stats.dtype == torch.int32 and stats.shape == (r, 2)
               and stats.is_contiguous() and stats.device == dev,
               "stats must be contiguous int32 (R, 2) on the rois' device")
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
            pooled_h, pooled_w, g, out.data_ptr(),
            0 if stats is None else stats.data_ptr(), stream)
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
