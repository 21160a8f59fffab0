"""Cross-ROI separable ROIAlign (v3): the plain PyTorch version, the CUDA
kernel's wrapper, and the block sort and checks that v4 shares.

Counterpart of ``oneshotdet_tpu/ops/pallas_roi_align_v3.py``
(``pallas_multilevel_roi_align_v3`` and ``_interp_params``). It computes the
same function as ``ops/roi_align.py::multilevel_roi_align``, exact for every
aspect ratio, in its separable form: each output row ``p`` and column ``q``
has ``2 * sampling_ratio`` cell indices and weights (``interp_params``, the
bilinear corners of each sample with the in-range mask, border clamp and
``1 / g`` bin mean folded in), and

    out[r, p, q, c] = sum_j wy[r, p, j] * sum_k wx[r, q, k] * F[b, yi[r, p, j], xi[r, q, k], c].

As in the JAX package, the ROIs are grouped by (image, level) and sorted into
blocks of ``ROIS_PER_BLOCK`` that share one map (``slab_blocks``); slots
whose ``valid`` flag is False get zero weights and zero outputs. The layout
is the port's: NHWC levels, ``(R, 5)`` rois, ``(R, pooled_h, pooled_w, C)``
out. ``roi_geometry``, ``live_rois``, ``interp_params``,
``separable_params`` and ``slab_blocks`` are the spec the plain version runs.

``multilevel_roi_align_v3`` dispatches on the device of its inputs: CPU
tensors take ``multilevel_roi_align_v3_plain``; CUDA tensors launch the
kernels of ``csrc/roi_align_v3.cu`` or raise: two launches, the block sort
(``slab_sort_cuda``, equal to ``slab_blocks``) and the body, which builds
each ROI's taps itself. ``v3_roi_taps`` and ``device_slab_sort`` mirror what
those kernels do, for the CPU tests. Where the TPU kernel rounds its
interpolation weights and its stage-A product to bf16 for bf16 inputs, both
versions here keep them in float32 and round once, at the output.
"""

from __future__ import annotations

import ctypes

import torch

from .roi_align import _DTYPE_CODE, MAX_LEVELS, _div, _Pyramid

ROIS_PER_BLOCK = 16       # ROIs of one (image, level) map per kernel block
MAX_POOLED_W = 8          # output columns whose taps a kernel warp lists
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


# ---- the kernels' own rules, mirrored on the CPU ---------------------------
# The CUDA kernels build each live ROI's taps themselves, once per ROI, and
# sort the slots into blocks on the card. The functions below repeat those
# rules in PyTorch (float32 operations in the kernel's order, one at a time)
# so that the CPU tests can hold them to the spec functions above bit for bit.

SORT_WARPS = 32           # warps of the block sort's one block, at most
_LEVEL_CODE = {torch.int32: 0, torch.int64: 1, torch.int16: 2, torch.int8: 3,
               torch.uint8: 4, torch.float32: 5}


def sample_fraction(sub: int, g: int) -> float:
    """``(sub + 0.5) / g`` as the spec forms it: in double, rounded once to
    float32 when it meets a float32 tensor."""
    return float(torch.tensor((sub + 0.5) / g, dtype=torch.float32))


def axis_interp(start, bin_sz, true_dim, g: int, pooled: int):
    """The kernel's ``interp`` for every (ROI, output index, sub-sample):
    float32 ``(low, high, lfrac, in_range)``, each ``(R, pooled, g)``."""
    i = torch.arange(pooled, dtype=torch.float32, device=start.device)[None, :, None]
    frac = torch.tensor([sample_fraction(s, g) for s in range(g)], dtype=torch.float32,
                        device=start.device)[None, None, :]
    start, bin_sz, dim = start[:, None, None], bin_sz[:, None, None], true_dim[:, None, None]
    pos = start + (i + frac) * bin_sz
    in_range = ((pos >= -1.0) & (pos <= dim)).to(torch.float32)
    posc = torch.clamp(pos, min=0.0)
    low = torch.minimum(torch.floor(posc), dim - 1.0)
    high = torch.minimum(low + 1.0, dim - 1.0)
    posf = torch.where(low >= dim - 1.0, low, posc)
    return low, high, posf - low, in_range


def _compact(cells, weights, keep):
    """The kept (cell, weight) pairs of each row moved to its front in their
    order, zeros behind; and the count of each row."""
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    cells = torch.where(keep, cells, 0).gather(-1, order)
    weights = torch.where(keep, weights, 0.0).gather(-1, order)
    return cells, weights, keep.sum(-1)


def _roi_levels(features, rois, levels, scales):
    """Per ROI: the geometry of ``roi_geometry`` taken as the kernel takes it,
    from its box and its level's scale, height and width."""
    lv = levels.long().clamp(0, len(features) - 1)
    scale = torch.tensor(list(scales), dtype=torch.float32)[lv]
    heights = torch.tensor([f.shape[1] for f in features], dtype=torch.float32)[lv]
    widths = torch.tensor([f.shape[2] for f in features], dtype=torch.float32)[lv]
    rois = rois.to(torch.float32)
    start_w = rois[:, 1] * scale
    start_h = rois[:, 2] * scale
    roi_w = torch.clamp(rois[:, 3] * scale - start_w, min=1.0)
    roi_h = torch.clamp(rois[:, 4] * scale - start_h, min=1.0)
    return start_w, start_h, roi_w, roi_h, heights, widths


def _v3_axis(start, extent, dim, g: int, pooled: int):
    low, high, lfrac, in_range = axis_interp(start, _div(extent, pooled), dim, g, pooled)
    wl = _div((1.0 - lfrac) * in_range, g)
    wh = _div(lfrac * in_range, g)
    last = dim.long()[:, None, None] - 1
    cells = torch.stack([low.long(), high.long()], -1).clamp(min=0)
    cells = torch.minimum(cells, last[..., None]).flatten(-2)
    weights = torch.stack([wl, wh], -1).flatten(-2)
    return _compact(cells, weights, weights != 0)


def v3_roi_taps(features, rois, levels, output_size, scales, sampling_ratio, ok):
    """The taps K4's kernel builds for each ROI: per output row ``(cells,
    weights, count)`` of shape ``(R, pooled_h, 2g)``, ``(R, pooled_h, 2g)``,
    ``(R, pooled_h)`` and the same per output column; the taps of
    ``interp_params`` in their order with the zero weights left out (the
    kernel skips them), none for a slot that is not ``ok``."""
    pooled_h, pooled_w = output_size
    g = sampling_ratio
    rois, levels = rois.cpu(), levels.cpu()
    start_w, start_h, roi_w, roi_h, heights, widths = _roi_levels(features, rois, levels, scales)
    y = _v3_axis(start_h, roi_h, heights, g, pooled_h)
    x = _v3_axis(start_w, roi_w, widths, g, pooled_w)
    okc = ok.cpu()[:, None]
    return (y[0], y[1], y[2] * okc), (x[0], x[1], x[2] * okc)


def slab_keys(rois, levels, valid, batch: int, n_levels: int) -> torch.Tensor:
    """(R,) int64: each slot's group as the block sort computes it, image b's
    level l at ``b * L + l``, ``B * L`` for a slot that is not live."""
    b = rois[:, 0].long()
    lv = levels.long()
    ok = (b >= 0) & (b < batch) & (lv >= 0) & (lv < n_levels)
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, b * n_levels + lv, batch * n_levels)


def device_slab_sort(rois, levels, valid, batch: int, n_levels: int, t: int,
                     warps: int = SORT_WARPS):
    """The block sort of ``csrc/roi_align_v3.cu`` (``roi_slab_sort_kernel``)
    step by step on the CPU: warp w takes the w-th of ``warps`` contiguous
    runs of slots and counts its keys; a scan over the warps gives each
    warp's first rank in each group, one over the groups each group's first
    block; block k's group is the number of groups that end at or before it;
    every slot is -1, then each warp walks its run again and puts each ROI at
    its group's first block times t plus its rank. Returns ``(block_group,
    slot_roi)`` int32 as ``slab_blocks`` does."""
    key = slab_keys(rois, levels, valid, batch, n_levels).cpu()
    r = key.shape[0]
    ng1 = batch * n_levels + 1
    nb = -(-r // t) + ng1
    per = -(-r // warps)
    runs = [key[min(w * per, r):min(w * per + per, r)] for w in range(warps)]
    cnt = torch.stack([torch.bincount(k, minlength=ng1) for k in runs])        # (warps, ng1)
    rank0 = torch.cumsum(cnt, 0) - cnt                                         # exclusive
    blocks = (cnt.sum(0) + t - 1) // t
    first = torch.cumsum(blocks, 0) - blocks
    ends = first + blocks
    block_group = (ends[None, :] <= torch.arange(nb)[:, None]).sum(1)
    slot_roi = torch.full((nb * t,), -1, dtype=torch.int32)
    for w, k in enumerate(runs):
        seen = torch.zeros(ng1, dtype=torch.long)
        for j, g in enumerate(k.tolist()):
            slot_roi[first[g] * t + rank0[w, g] + seen[g]] = min(w * per, r) + j
            seen[g] += 1
    return block_group.to(torch.int32), slot_roi


# ---- the CUDA kernel -----------------------------------------------------------

def bind(lib):
    """Set the argument types of ``roi_align_v3.cu``'s entry points on a loaded
    library (the built one, or a variant's copy); returns it."""
    fn = lib.oneshot_roi_align_v3_forward
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, i, i, p, q, q, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.oneshot_roi_slab_sort.argtypes = [p, q, q, p, i, q, p, q, i, i, i, i, i, p, p, p]
        lib.oneshot_roi_slab_sort.restype = ctypes.c_int
        lib.oneshot_roi_align_v3_error_string.argtypes = [ctypes.c_int]
        lib.oneshot_roi_align_v3_error_string.restype = ctypes.c_char_p
    return lib


def _kernel():
    from .. import csrc

    return bind(csrc.load("roi_align_v3"))


def raise_on(lib, rc: int, what: str):
    if rc != 0:
        err = lib.oneshot_roi_align_v3_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {err} ({rc})")


def check_kernel_inputs(name, features, rois, levels, valid, output_size, sampling_ratio):
    """The checks the v3 and v4 wrappers share; returns (B, C, R, dtype,
    channels per lane)."""
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
    check(levels.dtype in _LEVEL_CODE, f"levels dtype {levels.dtype}")
    check(valid is None or (valid.dtype == torch.bool and valid.shape == (r,)
                            and valid.device == dev),
          "valid must be bool (R,) on the rois' device")
    vec = vector_elems(c, dtype, [f.data_ptr() for f in features])
    check(vec > 0, "levels must start at a multiple of 2 channels' bytes (4 in float32)")
    return b, c, r, dtype, vec


def vector_elems(c: int, dtype, ptrs) -> int:
    """Channels a kernel lane moves at once: a 16-byte vector where C and
    every level's address allow it, else an 8- or 4-byte one of at least two
    channels; 0 if none fits."""
    esize = torch.finfo(dtype).bits // 8
    for nbytes in (16, 8, 4):
        n = nbytes // esize
        if n >= 2 and c % n == 0 and all(p % nbytes == 0 for p in ptrs):
            return n
    return 0


def pyramid_struct(features, scales) -> _Pyramid:
    pyr = _Pyramid()
    for i, (f, s) in enumerate(zip(features, scales)):
        pyr.data[i] = f.data_ptr()
        pyr.height[i] = f.shape[1]
        pyr.width[i] = f.shape[2]
        pyr.scale[i] = float(s)
    pyr.num_levels = len(features)
    return pyr


def slab_sort_cuda(rois, levels, valid, batch: int, n_levels: int, t: int):
    """``slab_blocks`` on the card in one launch (``roi_slab_sort_kernel``):
    the same ``(block_group, slot_roi)``, with no host sync. R >= 1."""
    r = rois.shape[0]
    nb = -(-r // t) + batch * n_levels + 1
    dev = rois.device
    block_group = torch.empty((nb,), dtype=torch.int32, device=dev)
    slot_roi = torch.empty((nb * t,), dtype=torch.int32, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.oneshot_roi_slab_sort(
            rois.data_ptr(), rois.stride(0), rois.stride(1), levels.data_ptr(),
            _LEVEL_CODE[levels.dtype], levels.stride(0),
            None if valid is None else valid.data_ptr(), 0 if valid is None else valid.stride(0),
            r, batch, n_levels, t, nb, block_group.data_ptr(), slot_roi.data_ptr(), stream)
    raise_on(lib, rc, "roi_slab_sort")
    return block_group, slot_roi


def multilevel_roi_align_v3_cuda(features, rois, levels, output_size, scales,
                                 sampling_ratio, valid=None,
                                 rois_per_block: int = ROIS_PER_BLOCK) -> torch.Tensor:
    """Launch the block sort and the CUDA kernel; raises on any input they do
    not take."""
    global roi_align_v3_launches
    b, c, r, dtype, vec = check_kernel_inputs("roi_align_v3", features, rois, levels, valid,
                                              output_size, sampling_ratio)
    if rois_per_block < 1:
        raise ValueError("roi_align_v3 kernel: rois_per_block must be >= 1")
    pooled_h, pooled_w = output_size
    dev = rois.device
    out = torch.empty((r, pooled_h, pooled_w, c), dtype=dtype, device=dev)
    if r == 0:
        return out
    block_group, slot_roi = slab_sort_cuda(rois, levels, valid, b, len(features), rois_per_block)
    pyr = pyramid_struct(features, scales)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.oneshot_roi_align_v3_forward(
            ctypes.addressof(pyr), b, c, _DTYPE_CODE[dtype], rois.data_ptr(), rois.stride(0),
            rois.stride(1), block_group.data_ptr(), slot_roi.data_ptr(), block_group.shape[0],
            rois_per_block, pooled_h, pooled_w, sampling_ratio, vec, out.data_ptr(), stream)
    raise_on(lib, rc, "roi_align_v3 kernel")
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
