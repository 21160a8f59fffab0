"""Cross-ROI separable ROIAlign (v3): the plain PyTorch version, the CUDA
kernel's wrapper and the set-up both share.

Counterpart of ``oneshotdet_tpu/ops/pallas_roi_align_v3.py``
(``pallas_multilevel_roi_align_v3`` and ``_interp_params``). It computes the
same function as ``ops/roi_align.py::multilevel_roi_align``, exact for every
aspect ratio, in its separable form: each output row ``p`` and column ``q``
has ``2 * sampling_ratio`` cell indices and weights (``interp_params``, the
bilinear corners of each sample with the in-range mask, border clamp and
``1 / g`` bin mean folded in), and

    out[r, p, q, c] = sum_j wy[r, p, j] * sum_k wx[r, q, k] * F[b, yi[r, p, j], xi[r, q, k], c].

As in the JAX package, the ROIs are grouped by (image, level) and sorted into
blocks of ``ROIS_PER_BLOCK`` that share one map (``slab_blocks``), in plain
PyTorch outside the kernel; slots whose ``valid`` flag is False get zero
weights and zero outputs. The layout is the port's: NHWC levels, ``(R, 5)``
rois, ``(R, pooled_h, pooled_w, C)`` out.

``multilevel_roi_align_v3`` dispatches on the device of its inputs: CPU
tensors take ``multilevel_roi_align_v3_plain``; CUDA tensors launch the
kernel of ``csrc/roi_align_v3.cu`` or raise. Where the TPU kernel rounds its
interpolation weights and its stage-A product to bf16 for bf16 inputs, both
versions here keep them in float32 and round once, at the output.
"""

from __future__ import annotations

import ctypes

import torch

from .roi_align import _DTYPE_CODE, MAX_LEVELS, _div, _Pyramid

ROIS_PER_BLOCK = 16       # ROIs of one (image, level) map per kernel block
MAX_POOLED_W = 8          # output columns a kernel thread accumulates
MAX_TAPS = 8              # 2 * sampling_ratio
PLAIN_CHUNK = 2048        # ROIs per step of the plain version (bounds its memory)

# Kernel launches since the count was last reset (set it to 0 to reset).
roi_align_v3_launches = 0


def roi_geometry(features, rois, levels, scales):
    """Per-ROI float32 ``(start_w, start_h, roi_w, roi_h, height, width)`` on
    its own level: the ROI in cells of that level, at least one cell on each
    axis, and the level's true size."""
    dev = rois.device
    lv = levels.long().clamp(0, len(features) - 1)
    scale_r = torch.tensor(list(scales), dtype=torch.float32, device=dev)[lv]
    heights = torch.tensor([f.shape[1] for f in features], dtype=torch.float32, device=dev)
    widths = torch.tensor([f.shape[2] for f in features], dtype=torch.float32, device=dev)
    rois = rois.to(torch.float32)
    start_w = rois[:, 1] * scale_r
    start_h = rois[:, 2] * scale_r
    roi_w = torch.clamp(rois[:, 3] * scale_r - start_w, min=1.0)
    roi_h = torch.clamp(rois[:, 4] * scale_r - start_h, min=1.0)
    return start_w, start_h, roi_w, roi_h, heights[lv], widths[lv]


def live_rois(rois, levels, valid, batch: int, n_levels: int) -> torch.Tensor:
    """(R,) bool: the slot is valid and names an existing image and level."""
    b = rois[:, 0].long()
    lv = levels.long()
    ok = (b >= 0) & (b < batch) & (lv >= 0) & (lv < n_levels)
    return ok if valid is None else ok & valid


def interp_params(start, bin_sz, true_dim, g: int, pooled: int):
    """``_interp_params``: float32 ``(idx, w)`` of shape ``(R, pooled, 2g)``,
    the low and high corner cell of each sub-sample and their weights, with
    the in-range mask, the border clamp and the 1/g bin mean folded in."""
    bins = torch.arange(pooled, dtype=torch.float32, device=start.device)[None, :]
    start, bin_sz, true_dim = start[:, None], bin_sz[:, None], true_dim[:, None]
    idxs, ws = [], []
    for sub in range(g):
        pos = start + (bins + (sub + 0.5) / g) * bin_sz
        in_range = ((pos >= -1.0) & (pos <= true_dim)).to(torch.float32)
        posc = torch.clamp(pos, min=0.0)
        low = torch.minimum(torch.floor(posc), true_dim - 1.0)
        high = torch.minimum(low + 1.0, true_dim - 1.0)
        posf = torch.where(low >= true_dim - 1.0, low, posc)
        lfrac = posf - low
        idxs += [low, high]
        ws += [_div((1.0 - lfrac) * in_range, g), _div(lfrac * in_range, g)]
    return torch.stack(idxs, dim=-1), torch.stack(ws, dim=-1)


def separable_params(features, rois, levels, output_size, scales, sampling_ratio, ok):
    """``(yi, yw, xi, xw)``: ``interp_params`` of the rows and the columns,
    with zero weights where ``ok`` is False."""
    pooled_h, pooled_w = output_size
    start_w, start_h, roi_w, roi_h, h_r, w_r = roi_geometry(features, rois, levels, scales)
    yi, yw = interp_params(start_h, _div(roi_h, pooled_h), h_r, sampling_ratio, pooled_h)
    xi, xw = interp_params(start_w, _div(roi_w, pooled_w), w_r, sampling_ratio, pooled_w)
    okf = ok.to(torch.float32)[:, None, None]
    return yi, yw * okf, xi, xw * okf


def slab_blocks(rois, levels, ok, batch: int, n_levels: int, t: int):
    """Sort the ROI slots into blocks of ``t`` that share one (image, level)
    map, as the JAX package's compaction does, without a host sync.

    Returns ``block_group`` (nb,) int32 and ``slot_roi`` (nb * t,) int32 with
    nb = ceil(R / t) + B * L + 1, a static bound. Group ``b * L + l`` is image
    b's level l; group ``B * L`` holds the slots that are not ``ok`` (their
    outputs are zeros); ``B * L + 1`` marks an unused block. ``slot_roi`` is
    the ROI of each slot, -1 for padding."""
    dev = rois.device
    r = rois.shape[0]
    ng = batch * n_levels
    key = torch.where(ok, rois[:, 0].long() * n_levels + levels.long(),
                      torch.full_like(levels, ng, dtype=torch.long))
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(ng + 1, dtype=torch.long, device=dev).index_add_(
        0, key, torch.ones_like(key))
    blocks = (counts + t - 1) // t
    incl = torch.cumsum(blocks, 0)
    nb = -(-r // t) + ng + 1
    block_group = torch.searchsorted(incl, torch.arange(nb, device=dev), right=True)
    sorted_key = key[order]
    rank = torch.arange(r, device=dev) - (torch.cumsum(counts, 0) - counts)[sorted_key]
    slot = (incl - blocks)[sorted_key] * t + rank
    slot_roi = torch.full((nb * t,), -1, dtype=torch.int32, device=dev)
    slot_roi[slot] = order.to(torch.int32)
    return block_group.to(torch.int32), slot_roi


def _flat_pyramid(features):
    """The levels as one ``(B, sum H*W, C)`` map and each level's offset."""
    b, c = features[0].shape[0], features[0].shape[-1]
    sizes = [f.shape[1] * f.shape[2] for f in features]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                           device=features[0].device)
    return torch.cat([f.reshape(b, -1, c) for f in features], dim=1), offsets


def multilevel_roi_align_v3_plain(features, rois, levels, output_size, scales,
                                  sampling_ratio, valid=None):
    """The plain PyTorch version: gather the 2g x 2g taps of every bin,
    contract the x taps, then the y taps, in float32 (``PLAIN_CHUNK`` ROIs at
    a time). Each sum runs over its taps in order, one multiply and one add at
    a time: the kernel's order, so the two agree bit for bit."""
    if sampling_ratio <= 0:
        raise ValueError("sampling_ratio must be > 0 (static sample grid)")
    pooled_h, pooled_w = output_size
    b_dim, c = features[0].shape[0], features[0].shape[-1]
    ok = live_rois(rois, levels, valid, b_dim, len(features))
    yi, yw, xi, xw = separable_params(features, rois, levels, output_size, scales,
                                      sampling_ratio, ok)
    flat, offsets = _flat_pyramid(features)
    dev = rois.device
    lv = torch.where(ok, levels.long(), 0)
    bb = torch.where(ok, rois[:, 0].long(), 0)
    widths = torch.tensor([f.shape[2] for f in features], device=dev)[lv]
    base = offsets[lv]
    out = []
    for s in range(0, rois.shape[0], PLAIN_CHUNK):
        sl = slice(s, s + PLAIN_CHUNK)
        row = base[sl, None, None] + yi[sl].long() * widths[sl, None, None]   # (n, ph, 2g)
        cells = row[:, :, :, None, None] + xi[sl].long()[:, None, None]      # (n, ph, 2g, pw, 2g)
        taps = flat[bb[sl, None, None, None, None], cells].to(torch.float32)
        acc = torch.zeros_like(taps[:, :, 0, :, 0])                         # (n, ph, pw, C)
        for j in range(yw.shape[2]):
            tx = torch.zeros_like(acc)
            for k in range(xw.shape[2]):
                tx = tx + xw[sl, None, :, k, None] * taps[:, :, j, :, k]
            acc = acc + yw[sl, :, j, None, None] * tx
        out.append(acc)
    if not out:
        return torch.zeros((0, pooled_h, pooled_w, c), dtype=features[0].dtype, device=dev)
    return torch.cat(out).to(features[0].dtype)


def _kernel():
    from .. import csrc

    lib = csrc.load("roi_align_v3")
    fn = lib.oneshot_roi_align_v3_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, p, p, p, p, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.oneshot_roi_align_v3_error_string.argtypes = [ctypes.c_int]
        lib.oneshot_roi_align_v3_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_inputs(name, features, rois, levels, valid, output_size, sampling_ratio):
    """The checks the v3 and v4 wrappers share; returns (B, C, R, dtype)."""
    def check(cond, msg):
        if not cond:
            raise ValueError(f"{name} kernel: {msg}")

    dev = rois.device
    check(dev.type == "cuda", "rois must be a CUDA tensor")
    check(1 <= len(features) <= MAX_LEVELS, f"1..{MAX_LEVELS} levels")
    check(sampling_ratio > 0 and 2 * sampling_ratio <= MAX_TAPS,
          f"sampling_ratio must be in 1..{MAX_TAPS // 2}")
    check(1 <= output_size[1] <= MAX_POOLED_W and output_size[0] >= 1,
          f"output width must be in 1..{MAX_POOLED_W}")
    dtype = features[0].dtype
    check(dtype in _DTYPE_CODE, f"dtype {dtype} (float32 or bfloat16)")
    b, _, _, c = features[0].shape
    check(c % 2 == 0, f"channel count {c} must be even")
    for f in features:
        check(f.dim() == 4 and f.shape[0] == b and f.shape[3] == c,
              f"level shape {tuple(f.shape)} vs (B={b}, H, W, C={c})")
        check(f.device == dev and f.dtype == dtype, "levels differ in device or dtype")
        check(f.is_contiguous(), "levels must be contiguous NHWC")
    r = rois.shape[0]
    check(rois.dtype == torch.float32 and rois.shape == (r, 5), "rois must be float32 (R, 5)")
    check(levels.shape == (r,) and levels.device == dev,
          "levels must be (R,) on the rois' device")
    check(valid is None or (valid.dtype == torch.bool and valid.shape == (r,)
                            and valid.device == dev),
          "valid must be bool (R,) on the rois' device")
    return b, c, r, dtype


def pyramid_struct(features, scales) -> _Pyramid:
    pyr = _Pyramid()
    for i, (f, s) in enumerate(zip(features, scales)):
        pyr.data[i] = f.data_ptr()
        pyr.height[i] = f.shape[1]
        pyr.width[i] = f.shape[2]
        pyr.scale[i] = float(s)
    pyr.num_levels = len(features)
    return pyr


def multilevel_roi_align_v3_cuda(features, rois, levels, output_size, scales,
                                 sampling_ratio, valid=None,
                                 rois_per_block: int = ROIS_PER_BLOCK) -> torch.Tensor:
    """Launch the CUDA kernel; raises on any input it does not take."""
    global roi_align_v3_launches
    b, c, r, dtype = check_kernel_inputs("roi_align_v3", features, rois, levels, valid,
                                         output_size, sampling_ratio)
    if rois_per_block < 1:
        raise ValueError("roi_align_v3 kernel: rois_per_block must be >= 1")
    pooled_h, pooled_w = output_size
    dev = rois.device
    out = torch.empty((r, pooled_h, pooled_w, c), dtype=dtype, device=dev)
    if r == 0:
        return out
    ok = live_rois(rois, levels, valid, b, len(features))
    yi, yw, xi, xw = (v.contiguous() for v in separable_params(
        features, rois, levels, output_size, scales, sampling_ratio, ok))
    block_group, slot_roi = slab_blocks(rois, levels, ok, b, len(features), rois_per_block)
    pyr = pyramid_struct(features, scales)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.oneshot_roi_align_v3_forward(
            ctypes.addressof(pyr), b, c, _DTYPE_CODE[dtype], yi.data_ptr(), yw.data_ptr(),
            xi.data_ptr(), xw.data_ptr(), block_group.data_ptr(), slot_roi.data_ptr(),
            block_group.shape[0], rois_per_block, pooled_h, pooled_w, 2 * sampling_ratio,
            out.data_ptr(), stream)
    if rc != 0:
        err = lib.oneshot_roi_align_v3_error_string(rc).decode()
        raise RuntimeError(f"roi_align_v3 kernel launch failed: {err} ({rc})")
    roi_align_v3_launches += 1
    return out


def multilevel_roi_align_v3(features, rois, levels, output_size, scales,
                            sampling_ratio, valid=None) -> torch.Tensor:
    """Separable multi-level ROIAlign: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if rois.device.type == "cpu" and all(f.device.type == "cpu" for f in features):
        return multilevel_roi_align_v3_plain(features, rois, levels, output_size,
                                             scales, sampling_ratio, valid)
    return multilevel_roi_align_v3_cuda(features, rois, levels, output_size,
                                        scales, sampling_ratio, valid)
