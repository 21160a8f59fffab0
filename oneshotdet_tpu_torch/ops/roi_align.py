"""ROIAlign: plain PyTorch versions and the CUDA kernel's wrapper.

Counterpart of ``oneshotdet_tpu/ops/roi_align.py`` (``roi_align``,
``fpn_level_map``, ``multilevel_roi_align``) and of the Pallas kernel
``oneshotdet_tpu/ops/pallas_roi_align.py::pallas_multilevel_roi_align``.
The layout is the JAX package's: features are NHWC ``(B, H, W, C)`` maps,
``rois`` are ``(R, 5)`` rows ``(batch, x1, y1, x2, y2)`` in image pixels and
the result is ``(R, pooled_h, pooled_w, C)``.

``multilevel_roi_align`` calls the op ``oneshotdet::roi_align``
(``ops.library``), which dispatches on the device of its inputs: CPU tensors
take the plain version (``multilevel_roi_align_plain``) and, in the backward,
``multilevel_roi_align_backward_plain``'s sums; CUDA tensors launch the kernel
of ``csrc/roi_align.cu`` and, in the backward, ``csrc/roi_align_bwd.cu``, or
raise. Both compute the exact bilinear ROIAlign of the JAX package's XLA
version in float32 (bf16 inputs are read as they are and the result is
rounded once to the input dtype), and both write zeros for slots whose
``valid`` flag is False. The gradient reaches the features only: the ROIs
of the detector are proposals under ``no_grad``, GT boxes and the constant
support boxes, as in the JAX package.

``multilevel_roi_align_backward_plain`` is the backward kernel's plain
version: the explicit scatter-add of every sample's four bilinear corners,
``w_corner / g^2 * grad``, into a float32 workspace, then a cast to each
level's dtype.

``roi_align_plan`` mirrors how the kernel stages a ROI: the distinct rows
and columns its samples touch, and the items (whole output rows x whole
output columns) whose pixels fit one shared-memory buffer, one channel
slice at a time where a bin of all C channels does not (``channel_slices``:
C = 512 in float32, the hoisted compress_0 query half's maps).
``roi_align_bwd_plan`` mirrors the backward kernel's tile lists: which ROIs
each pixel tile of each (level, image) map sums, in ascending order; and
``multilevel_roi_align_backward_tiled`` repeats the backward kernel's
formulation (per tile, per ROI in list order, separable weights) in plain
PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

MAX_LEVELS = 5

# Kernel launches since the count was last reset (set them to 0 to reset):
# the forward (csrc/roi_align.cu) and the backward (csrc/roi_align_bwd.cu).
roi_align_launches = 0
roi_align_bwd_launches = 0


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


def _live_levels(shapes, rois, levels, valid):
    """K1's rule for a live ROI (valid, level and image in range), and the
    levels with the dead ones' set to 0 (so that they can be indexed)."""
    batch, nl = shapes[0][0], len(shapes)
    b = rois[:, 0].long()
    live = (levels >= 0) & (levels < nl) & (b >= 0) & (b < batch)
    if valid is not None:
        live &= valid.detach().cpu()
    return live, torch.where(live, levels, 0)


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


def _level_offsets(shapes) -> List[int]:
    """Row offset of each level in the level-major workspace (sum over the
    levels of B * H * W rows of C), and the total row count last."""
    offsets = [0]
    for b, h, w, _ in shapes:
        offsets.append(offsets[-1] + b * h * w)
    return offsets


def _split_workspace(ws: torch.Tensor, shapes, dtype) -> List[torch.Tensor]:
    """The level-major float32 workspace -> one (B, H, W, C) gradient per
    level in ``dtype`` (views of it in float32)."""
    offsets = _level_offsets(shapes)
    return [ws[offsets[i]:offsets[i + 1]].view(shape).to(dtype)
            for i, shape in enumerate(shapes)]


def multilevel_roi_align_backward_plain(
    grad_out: torch.Tensor,
    feature_shapes: Sequence[Tuple[int, int, int, int]],
    dtype: torch.dtype,
    rois: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    scales: Sequence[float],
    sampling_ratio: int,
    valid: Optional[torch.Tensor] = None,
    work_dtype: torch.dtype = torch.float32,
) -> List[torch.Tensor]:
    """d(multilevel ROIAlign)/d(features) for ``grad_out`` (R, ph, pw, C):
    one (B, H, W, C) gradient per level in ``dtype``. Every in-range sample
    of a bin carries ``grad / g^2`` to its four corners with the bilinear
    weights (clamped corners land twice on one pixel); out-of-range samples
    and ``valid=False`` ROIs carry nothing. Sums in a ``work_dtype`` (float32;
    float64 gives the exact sum of the float32 terms, whatever the order)
    workspace that holds the levels one after another, each as a contiguous
    (B, H, W, C) block, and casts once."""
    shapes = [tuple(s) for s in feature_shapes]
    ws = multilevel_roi_align_backward_workspace(grad_out, shapes, rois, levels, output_size,
                                                 scales, sampling_ratio, valid, work_dtype)
    return _split_workspace(ws, shapes, dtype)


def multilevel_roi_align_backward_workspace(grad_out, feature_shapes, rois, levels,
                                            output_size, scales, sampling_ratio,
                                            valid=None, work_dtype=torch.float32) -> torch.Tensor:
    """``multilevel_roi_align_backward_plain``'s workspace (float32 unless
    ``work_dtype``), before its cast: (rows of all levels, C), level-major."""
    pooled_h, pooled_w = output_size
    g = sampling_ratio
    dev = rois.device
    c = grad_out.shape[-1]
    shapes = [tuple(s) for s in feature_shapes]
    levels = levels.long()
    heights = torch.tensor([s[1] for s in shapes], device=dev)
    widths = torch.tensor([s[2] for s in shapes], device=dev)
    offsets = torch.tensor(_level_offsets(shapes)[:-1], device=dev)
    ws = torch.zeros((_level_offsets(shapes)[-1], c), dtype=work_dtype, device=dev)
    r = rois.shape[0]
    if r == 0:
        return ws

    (oky, y_low, y_high, ly, hy), (okx, x_low, x_high, lx, hx) = _roi_axes(
        rois, levels, heights, widths, scales, output_size, g)

    def rep(a):
        return a.repeat_interleave(pooled_w * g, dim=1)

    def til(a):
        return a.repeat(1, pooled_h * g)

    live = rep(oky) & til(okx)
    if valid is not None:
        live = live & valid[:, None]
    # each sample's share of its bin's gradient, (R, P, C) in the sample grid
    gq = _div(grad_out.to(torch.float32), g * g)
    gq = gq.repeat_interleave(g, dim=1).repeat_interleave(g, dim=2).reshape(r, -1, c)
    w_r = widths[levels][:, None]
    base = offsets[levels][:, None] + rois[:, 0].long()[:, None] * heights[levels][:, None] * w_r
    for wy, wx, yi, xi in ((hy, hx, y_low, x_low), (hy, lx, y_low, x_high),
                           (ly, hx, y_high, x_low), (ly, lx, y_high, x_high)):
        w = torch.where(live, rep(wy) * til(wx), 0.0)
        idx = base + rep(yi) * w_r + til(xi)
        ws.index_add_(0, idx.reshape(-1), (w[..., None] * gq).reshape(-1, c).to(work_dtype))
    return ws


# -- the kernel's plan (csrc/roi_align.cu, steps 2-3), mirrored --------------

STAGE_BYTES = 24 * 1024   # one staging buffer of the kernel (a block has two)
MAX_AXIS = 32             # pooled * sampling_ratio on one axis
MAX_ITEMS = 256           # pooled_h * pooled_w (the 14x14 mask/keypoint pools: 196)


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


def channel_slices(channels: int, dtype: torch.dtype, sampling_ratio: int = 2) -> int:
    """The equal channel slices the kernel cuts a pixel into (its step 6):
    the fewest s dividing C whose slices fill 16-byte vectors and of which
    one bin's (2 g)^2 pixels fit one staging buffer; 0 where none does. 1
    at C = 256 in both dtypes and at C = 512 in bf16, 2 at C = 512 in
    float32."""
    elt = torch.finfo(dtype).bits // 8
    for s in range(1, channels + 1):
        if channels % s or channels // s * elt % 16:
            continue
        if 4 * sampling_ratio * sampling_ratio * (channels // s) * elt <= STAGE_BYTES:
            return s
    return 0


def stage_budget(channels: int, dtype: torch.dtype, sampling_ratio: int = 2) -> int:
    """Pixels of one channel slice (``channel_slices``) that fit one staging
    buffer; 0 where no slicing fits."""
    s = channel_slices(channels, dtype, sampling_ratio)
    return STAGE_BYTES // (channels // s * torch.finfo(dtype).bits // 8) if s else 0


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
    items whose pixels, one channel slice of them (``channel_slices``), fit
    the staging buffer; the kernel stages and sums every item once per
    slice. Only the features' shapes and dtype are read."""
    pooled_h, pooled_w = output_size
    g = sampling_ratio
    rois, levels = rois.detach().cpu().to(torch.float32), levels.detach().cpu().long()
    heights = torch.tensor([f.shape[1] for f in features])
    widths = torch.tensor([f.shape[2] for f in features])
    live, lv = _live_levels([f.shape for f in features], rois, levels, valid)
    axes = [[t.tolist() for t in axis[:3]]
            for axis in _roi_axes(rois, lv, heights, widths, scales, output_size, g)]
    budget = stage_budget(features[0].shape[-1], features[0].dtype, g)
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


# -- the backward kernel's tile lists (csrc/roi_align_bwd.cu), mirrored -------

BWD_TILE = 16        # pixels on a side of a tile
BWD_MAX_TILES = 64   # tiles on one axis of a map
BWD_MAX_BINS = 256   # pooled_h * pooled_w (the 14x14 mask/keypoint pools: 196)


def bwd_tile_count(feature_shapes) -> int:
    """Tiles the backward kernel owns over all levels and images."""
    t = BWD_TILE
    return sum(b * -(-h // t) * -(-w // t) for b, h, w, _ in feature_shapes)


def bwd_scratch(num_rois: int, num_tiles: int, device) -> torch.Tensor:
    """Scratch of the backward kernel, int32: each ROI's 2 x MAX_AXIS samples
    (4 words each), then the tile bits (``bwd_tile_bits``)."""
    return torch.empty(num_rois * 8 * MAX_AXIS + -(-num_rois // 32) * num_tiles,
                       dtype=torch.int32, device=device)


def bwd_tile_bits(scratch: torch.Tensor, num_rois: int, num_tiles: int) -> torch.Tensor:
    """The tile bits in ``scratch``: int32 (ceil(R / 32), tiles), bit i of
    word j set when ROI 32 j + i is on the tile's list."""
    return scratch[num_rois * 8 * MAX_AXIS:].view(-(-num_rois // 32), num_tiles)


def bwd_tile_grid(feature_shapes) -> List[Tuple[int, int, int, int]]:
    """(level, image, tile row, tile column) of every tile the backward
    kernel owns, in its block order."""
    t = BWD_TILE
    return [(lvl, b, ty, tx) for lvl, (batch, h, w, _) in enumerate(feature_shapes)
            for b in range(batch) for ty in range(-(-h // t)) for tx in range(-(-w // t))]


@dataclasses.dataclass
class BwdPlan:
    """The backward kernel's tile lists. ``tiles`` as ``bwd_tile_grid``;
    ``lists[t]`` the ROIs that tile t sums, ascending; ``words`` the 32-bit
    words per tile of the kernel's bits (ceil(R / 32)); ``pair_capacity`` the
    most (tile, ROI) pairs the shapes allow: R x the most tiles a ROI can
    touch on any level, min(2 pooled_h g, tile rows) x min(2 pooled_w g, tile
    columns), since a ROI's samples put corners on at most 2 pooled g rows
    and as many columns."""

    tiles: List[Tuple[int, int, int, int]]
    lists: List[List[int]]
    words: int
    pair_capacity: int

    def bits(self) -> torch.Tensor:
        """The kernel's bits as it writes them: int32 (words, tiles), bit i of
        word j set when ROI 32 j + i is on the tile's list."""
        vals = torch.zeros((self.words, len(self.tiles)), dtype=torch.int64)
        for t, rois in enumerate(self.lists):
            for r in rois:
                vals[r // 32, t] += 1 << (r % 32)
        return torch.where(vals >= 2 ** 31, vals - 2 ** 32, vals).to(torch.int32)


def bwd_lists_from_bits(bits: torch.Tensor) -> List[List[int]]:
    """Per tile, the ROIs whose bits are set in the kernel's int32 (words,
    tiles) bits, ascending."""
    vals = bits.detach().cpu().to(torch.int64) & 0xFFFFFFFF
    lists = [[] for _ in range(vals.shape[1])]
    for j, t in (vals != 0).nonzero().tolist():
        w = int(vals[j, t])
        lists[t].extend(32 * j + i for i in range(32) if w >> i & 1)
    return [sorted(x) for x in lists]


def _bwd_axes(shapes, rois, levels, output_size, scales, g, valid):
    """CPU float32 rois, the live flags, the levels to index with and
    ``_roi_axes`` of every ROI."""
    rois = rois.detach().cpu().to(torch.float32)
    live, lv = _live_levels(shapes, rois, levels.detach().cpu().long(), valid)
    heights = torch.tensor([s[1] for s in shapes])
    widths = torch.tensor([s[2] for s in shapes])
    return rois, live, lv, _roi_axes(rois, lv, heights, widths, scales, output_size, g)


def roi_align_bwd_plan(feature_shapes, rois, levels, output_size, scales, sampling_ratio,
                       valid=None) -> BwdPlan:
    """The backward kernel's tile lists: a live ROI is on the list of each
    tile of its (level, image) map that holds an in-range sample's corner of
    non-zero weight. The weights are separable, so those are the tiles of
    (rows) x (columns) that carry weight: a sample's low cell always (its
    weight 1 - l is never 0), its high cell when l != 0."""
    shapes = [tuple(int(d) for d in s) for s in feature_shapes]
    pooled_h, pooled_w = output_size
    g, t = sampling_ratio, BWD_TILE
    r = rois.shape[0]
    tiles = bwd_tile_grid(shapes)
    index = {tile: i for i, tile in enumerate(tiles)}
    lists = [[] for _ in tiles]
    most = max(min(2 * pooled_h * g, -(-h // t)) * min(2 * pooled_w * g, -(-w // t))
               for _, h, w, _ in shapes)
    plan = BwdPlan(tiles, lists, -(-r // 32), r * most)
    if r == 0:
        return plan
    rois, live, lv, axes = _bwd_axes(shapes, rois, levels, output_size, scales, g, valid)
    sets = []
    for ok, low, high, l, _ in axes:
        cells = torch.where(ok, low, -1), torch.where(ok & (l != 0), high, -1)
        sets.append([sorted({c // t for c in lo + hi if c >= 0})
                     for lo, hi in zip(cells[0].tolist(), cells[1].tolist())])
    for i in range(r):
        if not live[i]:
            continue
        key = (int(lv[i]), int(rois[i, 0].long()))
        for ty in sets[0][i]:
            for tx in sets[1][i]:
                lists[index[key + (ty, tx)]].append(i)
    return plan


def _tile_weights(ok, low, high, l, h, first: int, pooled: int, g: int) -> torch.Tensor:
    """(pooled, BWD_TILE) weights of one ROI's axis on the tile's cells
    first..first + BWD_TILE - 1: per output index p, the weights of the
    corners that its in-range samples put on each cell."""
    cells = first + torch.arange(BWD_TILE)
    w = (torch.where((low[:, None] == cells) & ok[:, None], h[:, None], 0.0)
         + torch.where((high[:, None] == cells) & ok[:, None], l[:, None], 0.0))
    return w.reshape(pooled, g, BWD_TILE).sum(1)


def multilevel_roi_align_backward_tiled(grad_out, feature_shapes, dtype, rois, levels,
                                        output_size, scales, sampling_ratio, valid=None):
    """The backward kernel's formulation in plain PyTorch on the CPU (for the
    tests): for each tile of ``roi_align_bwd_plan``, for each ROI on its list
    in order, ``t[ph, x] = sum_pw xw[pw, x] G[ph, pw]`` and ``acc[y, x] +=
    sum_ph yw[ph, y] t[ph, x]`` with the separable weights of the tile's rows
    and columns, then ``acc / g^2`` rounded once to ``dtype``. Same
    arguments and result as ``multilevel_roi_align_backward_plain``."""
    shapes = [tuple(int(d) for d in s) for s in feature_shapes]
    pooled_h, pooled_w = output_size
    g, t = sampling_ratio, BWD_TILE
    plan = roi_align_bwd_plan(shapes, rois, levels, output_size, scales, g, valid)
    out = [torch.zeros(s, dtype=torch.float32) for s in shapes]
    if rois.shape[0]:
        _, _, _, ((oky, ylo, yhi, ly, hy), (okx, xlo, xhi, lx, hx)) = _bwd_axes(
            shapes, rois, levels, output_size, scales, g, valid)
        grad = grad_out.detach().cpu().to(torch.float32)
    for (lvl, b, ty, tx), rois_on in zip(plan.tiles, plan.lists):
        if not rois_on:
            continue
        acc = torch.zeros((t, t, shapes[lvl][3]))
        for r in rois_on:
            yw = _tile_weights(oky[r], ylo[r], yhi[r], ly[r], hy[r], ty * t, pooled_h, g)
            xw = _tile_weights(okx[r], xlo[r], xhi[r], lx[r], hx[r], tx * t, pooled_w, g)
            acc += torch.einsum("py,pxc->yxc", yw, torch.einsum("qx,pqc->pxc", xw, grad[r]))
        h, w = shapes[lvl][1:3]
        rows, cols = min(t, h - ty * t), min(t, w - tx * t)
        out[lvl][b, ty * t:ty * t + rows, tx * t:tx * t + cols] = _div(acc[:rows, :cols], g * g)
    return [o.to(dtype) for o in out]


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
    _check(channel_slices(c, dtype, g) > 0,
           f"one bin's {2 * g} x {2 * g} pixels of a slice of {c} channels must fit "
           f"{STAGE_BYTES} bytes")
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


def _bwd_kernel():
    from .. import csrc

    lib = csrc.load("roi_align_bwd")
    fn = lib.oneshot_roi_align_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, p, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        lib.oneshot_roi_align_bwd_error_string.argtypes = [ctypes.c_int]
        lib.oneshot_roi_align_bwd_error_string.restype = ctypes.c_char_p
        limits = (ctypes.c_int * 4)()
        lib.oneshot_roi_align_bwd_limits(limits)
        want = (BWD_TILE, BWD_MAX_TILES, MAX_AXIS, BWD_MAX_BINS)
        if tuple(limits) != want:
            raise RuntimeError(f"roi_align_bwd.cu limits {tuple(limits)} differ from the "
                               f"plan's {want}")
    return lib


@functools.lru_cache(maxsize=64)
def _bwd_geometry(shapes, scales, dtype, output_size, g):
    """The backward call's static arguments checked once per geometry: each
    level's element offset in the gradients' one allocation (the total
    last), the tile count, and a Pyramid with the levels' sizes and scales
    (its data pointers set per call)."""
    _check(1 <= len(shapes) <= MAX_LEVELS, f"1..{MAX_LEVELS} levels")
    _check(len(scales) == len(shapes), "one scale per level")
    _check(dtype in _DTYPE_CODE, f"dtype {dtype} (float32 or bfloat16)")
    pooled_h, pooled_w = output_size
    _check(g > 0 and pooled_h > 0 and pooled_w > 0 and pooled_h * g <= MAX_AXIS
           and pooled_w * g <= MAX_AXIS and pooled_h * pooled_w <= BWD_MAX_BINS,
           f"sampling_ratio {g} x output {output_size}: 1..{MAX_AXIS} samples per axis, "
           f"at most {BWD_MAX_BINS} bins")
    b, _, _, c = shapes[0]
    elt = torch.finfo(dtype).bits // 8
    _check(c > 0 and c * elt % 16 == 0,
           f"channel count {c} must fill 16-byte vectors ({16 // elt} {dtype} each)")
    side = BWD_TILE * BWD_MAX_TILES
    _check(all(len(s) == 4 and s[0] == b and s[3] == c and 0 < s[1] <= side
               and 0 < s[2] <= side for s in shapes),
           f"level shapes {shapes} vs (B={b}, 1..{side}, 1..{side}, C={c})")
    pyr = _Pyramid()
    for i, (shape, scale) in enumerate(zip(shapes, scales)):
        pyr.height[i] = shape[1]
        pyr.width[i] = shape[2]
        pyr.scale[i] = float(scale)
    pyr.num_levels = len(shapes)
    return [o * c for o in _level_offsets(shapes)], bwd_tile_count(shapes), pyr


def multilevel_roi_align_backward_cuda(grad_out, feature_shapes, dtype, rois, levels,
                                       output_size, scales, sampling_ratio, valid=None,
                                       scratch=None) -> List[torch.Tensor]:
    """Launch the backward kernel (``csrc/roi_align_bwd.cu``): the ROIs'
    samples and the tile bits (which ROIs each pixel tile sums,
    ``roi_align_bwd_plan``), then the body, whose blocks write each tile's
    gradient once. Same arguments and result as
    ``multilevel_roi_align_backward_plain``; raises on any input the kernel
    does not take. ``scratch`` (``bwd_scratch``) keeps the samples and bits
    for the caller (``bwd_tile_bits``). The gradients are views of one
    allocation (``multilevel_roi_align_backward_cuda_flat``); the static
    checks run once per geometry."""
    flat = multilevel_roi_align_backward_cuda_flat(grad_out, feature_shapes, dtype, rois,
                                                   levels, output_size, scales,
                                                   sampling_ratio, valid, scratch)
    shapes = tuple(map(tuple, feature_shapes))
    offsets = [o * shapes[0][3] for o in _level_offsets(shapes)]
    return [flat[offsets[i]:offsets[i + 1]].view(s) for i, s in enumerate(shapes)]


def multilevel_roi_align_backward_cuda_flat(grad_out, feature_shapes, dtype, rois, levels,
                                            output_size, scales, sampling_ratio, valid=None,
                                            scratch=None) -> torch.Tensor:
    """``multilevel_roi_align_backward_cuda``'s one allocation: the levels'
    gradients flat and level-major."""
    global roi_align_bwd_launches
    dev = rois.device
    _check(dev.type == "cuda", "rois must be a CUDA tensor")
    shapes = tuple(map(tuple, feature_shapes))
    g = sampling_ratio
    offsets, tiles, template = _bwd_geometry(shapes, tuple(scales), dtype, tuple(output_size),
                                             g)
    pooled_h, pooled_w = output_size
    b, _, _, c = shapes[0]
    r = rois.shape[0]
    _check(grad_out.shape == (r, pooled_h, pooled_w, c) and grad_out.dtype == dtype
           and grad_out.device == dev and grad_out.is_contiguous(),
           f"grad_out must be contiguous {dtype} (R, {pooled_h}, {pooled_w}, {c}) on the "
           f"rois' device")
    _check(rois.dtype == torch.float32 and rois.shape == (r, 5)
           and rois.is_contiguous(), "rois must be contiguous float32 (R, 5)")
    _check(levels.dtype == torch.int32 and levels.shape == (r,)
           and levels.is_contiguous() and levels.device == dev,
           "levels must be contiguous int32 (R,) on the rois' device")
    if valid is not None:
        _check(valid.dtype == torch.bool and valid.shape == (r,)
               and valid.is_contiguous() and valid.device == dev,
               "valid must be contiguous bool (R,) on the rois' device")
    if scratch is None:
        scratch = bwd_scratch(r, tiles, dev)
    words = r * 8 * MAX_AXIS + -(-r // 32) * tiles
    _check(scratch.dtype == torch.int32 and scratch.shape == (words,)
           and scratch.device == dev and scratch.data_ptr() % 16 == 0,
           f"scratch must be int32 ({words},) on the rois' device (bwd_scratch)")
    flat = torch.empty(offsets[-1], dtype=dtype, device=dev)
    pyr = _Pyramid.from_buffer_copy(template)
    base, elt = flat.data_ptr(), flat.element_size()
    for i, o in enumerate(offsets[:-1]):
        pyr.data[i] = base + o * elt

    lib = _bwd_kernel()
    args = (ctypes.addressof(pyr), b, c, _DTYPE_CODE[dtype], rois.data_ptr(), levels.data_ptr(),
            0 if valid is None else valid.data_ptr(), r, pooled_h, pooled_w, g,
            grad_out.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.oneshot_roi_align_backward(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.oneshot_roi_align_backward(*args)
    if rc != 0:
        err = lib.oneshot_roi_align_bwd_error_string(rc).decode()
        raise RuntimeError(f"roi_align backward kernel launch failed: {err} ({rc})")
    roi_align_bwd_launches += 1
    return flat


def multilevel_roi_align(features, rois, levels, output_size, scales,
                         sampling_ratio, valid=None) -> torch.Tensor:
    """Multi-level ROIAlign through the op ``oneshotdet::roi_align``: the
    kernels (K1 forward, K1b backward) for CUDA tensors, the plain versions
    for CPU tensors. Gradients reach the feature levels only."""
    from .library import roi_align as op

    return op(list(features), rois, levels, valid, [int(n) for n in output_size],
              [float(s) for s in scales], int(sampling_ratio))


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size,
              spatial_scale: float, sampling_ratio: int) -> torch.Tensor:
    """Single-level ROIAlign of NHWC ``features``: the one-level case of
    ``multilevel_roi_align`` (every ROI on level 0)."""
    levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device=rois.device)
    return multilevel_roi_align([features], rois, levels, output_size,
                                (spatial_scale,), sampling_ratio)
