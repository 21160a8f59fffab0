"""Windowed cross-ROI ROIAlign (v4): the plain PyTorch version and the CUDA
kernel's wrapper.

Counterpart of ``oneshotdet_tpu/ops/pallas_roi_align_v4.py``
(``pallas_multilevel_roi_align_v4`` and ``_dense_weights``). It is ROIAlign
with dense interpolation weights: rows ``wy`` of shape ``(R, pooled, H)``
over the whole height of the ROI's level (exact for every height), and
columns ``wx`` of shape ``(R, pooled, WIN)`` over a window of ``WIN = 64``
columns from ``x0``:

    out[r, p, q, c] = sum_w wx[r, q, w] * sum_h wy[r, p, h] * F0[b, h, x0[r] + w, c],

with F0 the level zero-padded on the right. The window origin is the JAX
package's rule: ``x0 = floor8(clip(floor(start_w), 0, w_l_of - WIN))`` with
``w_l_of = min(max(ceil8(W_l), WIN + 8), w_pad)``. Sample columns outside the
window clamp to its edge, so the result equals ROIAlign only for ROIs whose
x-span fits in the window (up to 56 cells); that clamp is part of what v4
computes, and both versions here reproduce it. On a level narrower than the
window, columns past its true width read the zero padding.

``multilevel_roi_align_v4`` dispatches on the device of its inputs: CPU
tensors take ``multilevel_roi_align_v4_plain``, which builds the dense
weights (``window_operands``, the spec; the JAX package builds them in XLA,
outside its kernel); CUDA tensors launch the block sort of
``csrc/roi_align_v3.cu`` and the kernel of ``csrc/roi_align_v4.cu`` or raise.
The kernel writes no weights: it lists each ROI's non-zero ones itself,
with the very values the dense weights hold (``v4_roi_taps`` mirrors it for
the CPU tests). The TPU kernel's bf16 rounding of its weights and stage-A
product for bf16 inputs is not repeated: both versions accumulate in float32
and round once.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .roi_align import _DTYPE_CODE, _div
from .roi_align_v3 import (ROIS_PER_BLOCK, _compact, _roi_levels, axis_interp,
                           check_kernel_inputs, live_rois, pyramid_struct, roi_geometry,
                           slab_sort_cuda)

WIN = 64                  # column window (cells); x-spans <= WIN - 8 are exact
PLAIN_CHUNK = 1024        # ROIs per step of the plain version (bounds its memory)

# Kernel launches since the count was last reset (set it to 0 to reset).
roi_align_v4_launches = 0


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def window_widths(features):
    """Per level, ``w_l_of``: the padded width the window stays inside."""
    w_pad = max(max(_ceil8(f.shape[2]) for f in features), WIN + 8)
    return [min(max(_ceil8(f.shape[2]), WIN + 8), w_pad) for f in features]


def dense_weights(start, bin_sz, origin, true_dim, g: int, pooled: int, width: int):
    """``_dense_weights``: ``(R, pooled, width)`` float32 interpolation rows
    over cells ``origin .. origin + width - 1``; corners outside that range
    clamp to its edge; in-range mask, border clamp and 1/g bin mean folded
    in."""
    dev = start.device
    bins = torch.arange(pooled, dtype=torch.float32, device=dev)[None, :, None]
    cells = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    start, bin_sz = start[:, None, None], bin_sz[:, None, None]
    origin, true_dim = origin[:, None, None], true_dim[:, None, None]
    total = torch.zeros((start.shape[0], pooled, width), dtype=torch.float32, device=dev)
    for sub in range(g):
        pos = start + (bins + (sub + 0.5) / g) * bin_sz
        in_range = (pos >= -1.0) & (pos <= true_dim)
        posc = torch.clamp(pos, min=0.0)
        low = torch.minimum(torch.floor(posc), true_dim - 1.0)
        high = torch.minimum(low + 1.0, true_dim - 1.0)
        posf = torch.where(low >= true_dim - 1.0, low, posc)
        lfrac = posf - low
        m = ((cells == torch.clamp(low - origin, 0.0, width - 1.0)) * (1 - lfrac)
             + (cells == torch.clamp(high - origin, 0.0, width - 1.0)) * lfrac)
        total = total + m * in_range.to(torch.float32)
    return total * (1.0 / g)


def window_operands(features, rois, levels, output_size, scales, sampling_ratio, ok):
    """``(wy, wx, x0)``: dense row weights ``(R, pooled_h, max H)``, window
    column weights ``(R, pooled_w, WIN)`` (zeros where ``ok`` is False) and
    the int32 window origins ``(R,)``."""
    pooled_h, pooled_w = output_size
    dev = rois.device
    start_w, start_h, roi_w, roi_h, h_r, w_r = roi_geometry(features, rois, levels, scales)
    lv = levels.long().clamp(0, len(features) - 1)
    w_l_of = torch.tensor(window_widths(features), dtype=torch.float32, device=dev)[lv]
    x0 = torch.minimum(torch.clamp(torch.floor(start_w), min=0.0), w_l_of - WIN)
    x0 = torch.floor(_div(x0, 8)) * 8.0
    slab_h = max(f.shape[1] for f in features)
    wy = dense_weights(start_h, _div(roi_h, pooled_h), torch.zeros_like(start_h), h_r,
                       sampling_ratio, pooled_h, slab_h)
    wx = dense_weights(start_w, _div(roi_w, pooled_w), x0, w_r, sampling_ratio, pooled_w, WIN)
    okf = ok.to(torch.float32)[:, None, None]
    return wy * okf, wx * okf, x0.to(torch.int32)


def multilevel_roi_align_v4_plain(features, rois, levels, output_size, scales,
                                  sampling_ratio, valid=None):
    """The plain PyTorch version in float32 (``PLAIN_CHUNK`` ROIs at a time): for
    each output row, the dense row weights times the zero-padded level over
    the ROI's window (stage A), then the window column weights (stage B).
    A dense row has at most 2g non-zero weights, so stage A gathers only
    those rows, in increasing order; the zero weights it leaves out add
    nothing. Each sum runs over rows, then window columns, in increasing
    order, one multiply and one add at a time: the kernel's order, so the two
    agree bit for bit."""
    if sampling_ratio <= 0:
        raise ValueError("sampling_ratio must be > 0 (static sample grid)")
    pooled_h, pooled_w = output_size
    b_dim, c = features[0].shape[0], features[0].shape[-1]
    dev = rois.device
    ok = live_rois(rois, levels, valid, b_dim, len(features))
    wy, wx, x0 = window_operands(features, rois, levels, output_size, scales,
                                 sampling_ratio, ok)
    # the levels zero-padded to their window widths, as one (B, cells, C) map
    widths = window_widths(features)
    padded = [F.pad(f, (0, 0, 0, w_of - f.shape[2])).reshape(b_dim, -1, c)
              for f, w_of in zip(features, widths)]
    offsets = [0]
    for p in padded[:-1]:
        offsets.append(offsets[-1] + p.shape[1])
    flat = torch.cat(padded, dim=1)
    lv = torch.where(ok, levels.long(), 0)
    bb = torch.where(ok, rois[:, 0].long(), 0)
    base = torch.tensor(offsets, device=dev)[lv]
    pitch = torch.tensor(widths, device=dev)[lv]
    # the first 2g non-zero row weights of each output row, in increasing row
    # order (stable sort of "is zero"), then zero weights
    taps = 2 * sampling_ratio
    rows = torch.argsort((wy == 0).to(torch.int8), dim=2, stable=True)[:, :, :taps]
    wrow = torch.gather(wy, 2, rows)
    cols = torch.arange(WIN, device=dev)
    out = []
    for s in range(0, rois.shape[0], PLAIN_CHUNK):
        sl = slice(s, s + PLAIN_CHUNK)
        cells = (base[sl, None, None, None] + rows[sl, :, :, None] * pitch[sl, None, None, None]
                 + x0[sl].long()[:, None, None, None] + cols)               # (n, ph, 2g, WIN)
        vals = flat[bb[sl, None, None, None], cells].to(torch.float32)      # (n, ph, 2g, WIN, C)
        a = torch.zeros_like(vals[:, :, 0])                                 # (n, ph, WIN, C)
        for i in range(taps):
            a = a + wrow[sl, :, i, None, None] * vals[:, :, i]
        acc = torch.zeros((a.shape[0], pooled_h, pooled_w, c), dtype=torch.float32, device=dev)
        for w in range(WIN):
            acc = acc + wx[sl, None, :, w, None] * a[:, :, w, None, :]
        out.append(acc)
    if not out:
        return torch.zeros((0, pooled_h, pooled_w, c), dtype=features[0].dtype, device=dev)
    return torch.cat(out).to(features[0].dtype)


def _v4_axis(start, extent, dim, origin, span: int, limit, g: int, pooled: int):
    """K5's list for one axis: the distinct cells of the sub-samples' corners
    (clamped to ``span`` cells from ``origin``), ascending, each with the
    weight ``dense_weights`` sums for it, kept where it is not zero and its
    cell ``origin + c`` lies before ``limit``."""
    low, high, lfrac, in_range = axis_interp(start, _div(extent, pooled), dim, g, pooled)
    org = origin[:, None, None]
    lo = torch.clamp(low - org, 0.0, span - 1.0)
    hi = torch.clamp(high - org, 0.0, span - 1.0)
    cand, _ = torch.sort(torch.cat([lo, hi], -1), dim=-1)              # (R, n, 2g)
    first = torch.ones_like(cand, dtype=torch.bool)
    first[..., 1:] = cand[..., 1:] != cand[..., :-1]
    total = torch.zeros_like(cand)
    for s in range(g):
        m = (torch.where(cand == lo[..., s:s + 1], 1.0 - lfrac[..., s:s + 1], 0.0)
             + torch.where(cand == hi[..., s:s + 1], lfrac[..., s:s + 1], 0.0))
        total = total + m * in_range[..., s:s + 1]
    weights = total * torch.tensor(1.0 / g, dtype=torch.float32)
    cells = (org + cand).long()
    keep = first & (weights != 0) & (cells < limit[:, None, None])
    return _compact(cells, weights, keep)


def v4_roi_taps(features, rois, levels, output_size, scales, sampling_ratio, ok):
    """The taps K5's kernel builds for each ROI: the window origin ``x0``
    (R,) int64, then per output row the rows with a non-zero weight in
    ``dense_weights``' row, ascending, and per output column the window
    columns with a non-zero weight that lie inside the level (as global
    columns ``x0 + w``), ascending; each as ``(cells, weights, count)`` like
    ``v3_roi_taps``. The kernel's rule, mirrored on the CPU."""
    pooled_h, pooled_w = output_size
    g = sampling_ratio
    rois, levels = rois.cpu(), levels.cpu()
    start_w, start_h, roi_w, roi_h, heights, widths = _roi_levels(features, rois, levels, scales)
    lv = levels.long().clamp(0, len(features) - 1)
    w_l_of = torch.tensor(window_widths(features), dtype=torch.float32)[lv]
    x0 = torch.minimum(torch.clamp(torch.floor(start_w), min=0.0), w_l_of - WIN)
    x0 = torch.floor(_div(x0, 8)) * 8.0
    slab_h = max(f.shape[1] for f in features)
    y = _v4_axis(start_h, roi_h, heights, torch.zeros_like(start_h), slab_h, heights.long(),
                 g, pooled_h)
    x = _v4_axis(start_w, roi_w, widths, x0, WIN, widths.long(), g, pooled_w)
    okc = ok.cpu()[:, None]
    return x0.long(), (y[0], y[1], y[2] * okc), (x[0], x[1], x[2] * okc)


def bind(lib):
    """Set the argument types of ``roi_align_v4.cu``'s entry points on a loaded
    library (the built one, or a variant's copy); returns it."""
    fn = lib.oneshot_roi_align_v4_forward
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, i, i, i, i, p, q, q, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.oneshot_roi_align_v4_error_string.argtypes = [ctypes.c_int]
        lib.oneshot_roi_align_v4_error_string.restype = ctypes.c_char_p
    return lib


def _kernel():
    from .. import csrc

    return bind(csrc.load("roi_align_v4"))


def multilevel_roi_align_v4_cuda(features, rois, levels, output_size, scales,
                                 sampling_ratio, valid=None,
                                 rois_per_block: int = ROIS_PER_BLOCK) -> torch.Tensor:
    """Launch the block sort (``roi_align_v3.slab_sort_cuda``) and the CUDA
    kernel; raises on any input they do not take."""
    global roi_align_v4_launches
    b, c, r, dtype, vec = check_kernel_inputs("roi_align_v4", features, rois, levels, valid,
                                              output_size, sampling_ratio)
    if rois_per_block < 1:
        raise ValueError("roi_align_v4 kernel: rois_per_block must be >= 1")
    pooled_h, pooled_w = output_size
    dev = rois.device
    out = torch.empty((r, pooled_h, pooled_w, c), dtype=dtype, device=dev)
    if r == 0:
        return out
    block_group, slot_roi = slab_sort_cuda(rois, levels, valid, b, len(features), rois_per_block)
    pyr = pyramid_struct(features, scales)
    widths = (ctypes.c_int * len(features))(*window_widths(features))
    slab_h = max(f.shape[1] for f in features)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.oneshot_roi_align_v4_forward(
            ctypes.addressof(pyr), ctypes.addressof(widths), slab_h, b, c, _DTYPE_CODE[dtype],
            rois.data_ptr(), rois.stride(0), rois.stride(1), block_group.data_ptr(),
            slot_roi.data_ptr(), block_group.shape[0], rois_per_block, pooled_h, pooled_w,
            sampling_ratio, vec, out.data_ptr(), stream)
    if rc != 0:
        err = lib.oneshot_roi_align_v4_error_string(rc).decode()
        raise RuntimeError(f"roi_align_v4 kernel launch failed: {err} ({rc})")
    roi_align_v4_launches += 1
    return out


def multilevel_roi_align_v4(features, rois, levels, output_size, scales,
                            sampling_ratio, valid=None) -> torch.Tensor:
    """Windowed multi-level ROIAlign: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if rois.device.type == "cpu" and all(f.device.type == "cpu" for f in features):
        return multilevel_roi_align_v4_plain(features, rois, levels, output_size,
                                             scales, sampling_ratio, valid)
    return multilevel_roi_align_v4_cuda(features, rois, levels, output_size,
                                        scales, sampling_ratio, valid)
