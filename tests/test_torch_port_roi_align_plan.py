"""The staging plan of the ROIAlign kernel (oneshotdet_tpu_torch/csrc/roi_align.cu),
checked on the CPU through its Python mirror ``ops.roi_align.roi_align_plan``
on chip_smoke.py's ROI mix (sub-cell, over 5:1, degenerate, partly outside,
invalid; a whole P3 row, wholly outside, all invalid, one ROI) and the
model's support pools: every corner the plain version reads lies in its
sample's staged item, no item exceeds the staging buffer, and the items
cover every output bin, and the column chunks every output column, once.
The corners are computed here in numpy float32 by the plain version's rule,
independently of the mirror.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from oneshotdet_tpu_torch.ops import roi_align as ra

KERNEL_SRC = (Path(ra.__file__).resolve().parents[1] / "csrc" / "roi_align.cu").read_text()


def _define(name):
    m = re.search(rf"^#define {name} \(?([\d *]+)\)?", KERNEL_SRC, re.M)
    assert m, name
    return eval(m.group(1))   # a product of integer literals


def test_plan_constants_mirror_the_kernel():
    assert (ra.STAGE_BYTES, ra.MAX_AXIS, ra.MAX_ITEMS) == tuple(
        _define(n) for n in ("STAGE_BYTES", "MAX_AXIS", "MAX_ITEMS"))


def _pyramid(dtype, hw=chip_smoke.QUERY_HW):
    return [torch.empty((chip_smoke.BATCH, h, w, 256), dtype=dtype, device="meta")
            for h, w in chip_smoke.pyramid_shapes(*hw)]


def _cases():
    """(name, pyramid (H, W) input, rois, levels, valid, output size, scales)."""
    gen = torch.Generator().manual_seed(3)
    rois, valid = chip_smoke.random_rois(1024, chip_smoke.BATCH, chip_smoke.QUERY_HW, gen, "cpu")
    cases = [("random mix R=1024", chip_smoke.QUERY_HW, rois, None, valid, (7, 7),
              chip_smoke.SCALES_Q)]
    for name, r, lv, v in chip_smoke.edge_case_rois(gen, "cpu"):
        cases.append((name, chip_smoke.QUERY_HW, r, lv, v, (7, 7), chip_smoke.SCALES_Q))
    supp = torch.tensor([[i, 0.0, 0.0, 416.0 - 13 * i, 300.0 + 10 * i]
                         for i in range(chip_smoke.BATCH)])
    cases.append(("support 7x7 R=8", chip_smoke.SUPP_HW, supp, None, None, (7, 7),
                  chip_smoke.SCALES_Q))
    for lvl in range(5):
        cases.append((f"support 1x1 P{lvl + 3}", chip_smoke.SUPP_HW, supp,
                      torch.full((8,), lvl, dtype=torch.int32), None, (1, 1),
                      chip_smoke.SCALES_Q))
    return cases


CASES = _cases()


def _corners(start, end, size, pooled, g):
    """The plain version's rule in numpy float32 for one axis of one ROI:
    (in range, low cell, high cell) of each sample p * g + i."""
    f32 = np.float32
    extent = max(f32(end - start), f32(1.0))
    bin_size = f32(extent / f32(pooled))
    i = np.arange(pooled * g)
    frac = (i // g).astype(f32) + ((i % g).astype(f32) + f32(0.5)) / f32(g)
    pos = f32(start) + frac * bin_size
    ok = (pos >= -1) & (pos <= size)
    y = np.minimum(np.maximum(pos, f32(0)), f32(size))
    low = np.minimum(np.floor(y).astype(np.int64), size - 1)
    return ok, low, np.minimum(low + 1, size - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_stages_every_corner_within_budget(case, dtype):
    name, hw, rois, levels, valid, out_hw, scales = case
    if levels is None:
        levels = ra.fpn_level_map(rois[:, 1:], 3, 7)
    feats = _pyramid(dtype, hw)
    (ph_n, pw_n), g = out_hw, 2
    budget = ra.stage_budget(256, dtype)
    plans = ra.roi_align_plan(feats, rois, levels, out_hw, scales, g, valid)
    assert len(plans) == rois.shape[0]
    live = torch.ones(rois.shape[0], dtype=torch.bool) if valid is None else valid
    assert [p is not None for p in plans] == live.tolist()
    for r, plan in enumerate(plans):
        if plan is None:
            continue
        lvl = int(levels[r])
        _, h, w, _ = feats[lvl].shape
        s = np.float32(scales[lvl])
        x1, y1, x2, y2 = (np.float32(v) * s for v in rois[r, 1:].tolist())
        oky, ylo, yhi = _corners(y1, y2, h, ph_n, g)
        okx, xlo, xhi = _corners(x1, x2, w, pw_n, g)
        # the slots name the plain version's cells
        for ok, lo, hi, cells, slots in ((oky, ylo, yhi, plan.rows, plan.y_slots),
                                         (okx, xlo, xhi, plan.cols, plan.x_slots)):
            assert cells == sorted(set(cells))
            assert [sl is not None for sl in slots] == ok.tolist()
            for sample in np.flatnonzero(ok):
                assert (cells[slots[sample][0]], cells[slots[sample][1]]) == (lo[sample], hi[sample])
        cover = np.zeros((ph_n, pw_n), int)
        chunks = set()
        for ph0, ph1, pw0, pw1, r0, r1, c0, c1 in plan.items:
            assert (r1 - r0) * (c1 - c0) <= budget, (name, r, plan.items)
            cover[ph0:ph1, pw0:pw1] += 1
            chunks.add((pw0, pw1))
            rows, cols = plan.rows[r0:r1], plan.cols[c0:c1]
            ys = np.arange(ph0 * g, ph1 * g)
            xs = np.arange(pw0 * g, pw1 * g)
            # every corner of every in-range sample of the item's bins
            ys, xs = ys[oky[ys]], xs[okx[xs]]
            if len(ys) and len(xs):
                assert np.isin(np.r_[ylo[ys], yhi[ys]], rows).all(), (name, r)
                assert np.isin(np.r_[xlo[xs], xhi[xs]], cols).all(), (name, r)
        assert (cover == 1).all(), (name, r, plan.items)
        edges = sorted(chunks)
        assert edges[0][0] == 0 and edges[-1][1] == pw_n
        assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))


def test_wide_rois_split_and_small_ones_stage_once():
    """In bf16 (48 pixels a buffer): a whole P3 row needs several column
    chunks; a 5 x 5-cell ROI is one item of its 6 x 6 distinct pixels; a
    10 x 10-cell one is one column chunk cut into bands of output rows,
    which stage only the rows two bands share twice."""
    feats = _pyramid(torch.bfloat16)
    rois = torch.tensor([[0.0, 0.0, 80.0, 1216.0, 120.0], [1.0, 304.0, 200.0, 344.0, 240.0],
                         [1.0, 300.0, 200.0, 380.0, 280.0]])
    levels = torch.zeros(3, dtype=torch.int32)
    wide, small, fcos = ra.roi_align_plan(feats, rois, levels, (7, 7), chip_smoke.SCALES_Q, 2)
    assert len({(it[2], it[3]) for it in wide.items}) > 1
    assert len(wide.cols) == 28          # 7 bins x 2 samples x 2 cells, none shared
    assert len(small.items) == 1 and small.staged_pixels == len(small.rows) * len(small.cols) == 36
    assert len({(it[2], it[3]) for it in fcos.items}) == 1 and len(fcos.items) > 1
    distinct = len(fcos.rows) * len(fcos.cols)
    assert distinct < fcos.staged_pixels <= 1.4 * distinct


@pytest.mark.parametrize("dtype, channels, ok", [
    (torch.bfloat16, 256, True), (torch.float32, 256, True), (torch.bfloat16, 512, True),
    (torch.float32, 512, False), (torch.bfloat16, 1024, False)])
def test_budget_holds_one_bin(dtype, channels, ok):
    """The wrapper's rule: one bin's 2g x 2g pixels must fit the buffer."""
    assert (4 * 2 * 2 <= ra.stage_budget(channels, dtype)) == ok
