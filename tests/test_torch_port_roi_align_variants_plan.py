"""The rules the cross-ROI ROIAlign kernels K4 and K5 (oneshotdet_tpu_torch/csrc/
roi_align_v3.cu, roi_align_v4.cu) follow on the card, checked on the CPU
through their mirrors: the taps each kernel builds per ROI (``v3_roi_taps``,
``v4_roi_taps``) equal the spec's ``separable_params`` and ``window_operands``
bit for bit, with the zero weights left out; the block sort
(``device_slab_sort``) equals ``slab_blocks``; the mirrors' constants and
the lanes' vector widths are the kernels'. The cases are chip_smoke.py's:
K1's edge cases (one ROI, ROIs as wide as a P3 row, ROIs wholly outside, all
slots invalid) on the query pyramid, a mix of ordinary, wide, partly outside
and degenerate boxes, sub-cell boxes, and levels narrower than K5's window.
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from oneshotdet_tpu_torch.ops import roi_align as ra
from oneshotdet_tpu_torch.ops import roi_align_v3 as v3
from oneshotdet_tpu_torch.ops import roi_align_v4 as v4

CSRC = Path(v3.__file__).resolve().parents[1] / "csrc"


def _pyramid(hw=chip_smoke.QUERY_HW, batch=chip_smoke.BATCH):
    """Shapes are all the tap rules read of the maps."""
    return [torch.empty((batch, h, w, 8), device="meta") for h, w in chip_smoke.pyramid_shapes(*hw)]


def _cases():
    """(name, rois, levels, valid, image size of the pyramid)."""
    gen = torch.Generator().manual_seed(11)
    q = chip_smoke.QUERY_HW
    rois, valid = chip_smoke.random_rois(600, chip_smoke.BATCH, q, gen, "cpu")
    cases = [("random mix R=600", rois, ra.fpn_level_map(rois[:, 1:], 3, 7), valid, q)]
    for name, r, lv, v in chip_smoke.edge_case_rois(gen, "cpu"):
        cases.append((name, r, ra.fpn_level_map(r[:, 1:], 3, 7) if lv is None else lv, v, q))
    n = 64
    xy = torch.rand(n, 2, generator=gen) * torch.tensor([1200.0, 800.0])
    side = torch.rand(n, 2, generator=gen) * 6.0                  # under one P3 cell
    b = torch.randint(0, chip_smoke.BATCH, (n, 1), generator=gen).float()
    cases.append(("sub-cell R=64", torch.cat([b, xy, xy + side], 1),
                  torch.zeros(n, dtype=torch.int32), None, q))
    cases.append(("degenerate R=64", torch.cat([b, xy + 40, xy], 1),
                  torch.randint(0, 5, (n,), generator=gen, dtype=torch.int32), None, q))
    wide = torch.cat([b, xy * 0.2, xy * 0.2 + torch.tensor([900.0, 300.0])], 1)
    cases.append(("P6-P7 narrower than the window R=64", wide,
                  torch.randint(3, 5, (n,), generator=gen, dtype=torch.int32), None, q))
    # the support pyramid's P6 and P7 are 7 and 4 cells wide
    cases.append(("support P6-P7 R=64", torch.cat([b, xy * 0.3, xy * 0.3 + 60], 1),
                  torch.randint(3, 5, (n,), generator=gen, dtype=torch.int32), None,
                  chip_smoke.SUPP_HW))
    bad = rois[:n].clone()
    bad[::3, 0] = 9                                               # no such image
    lv = ra.fpn_level_map(bad[:, 1:], 3, 7)
    lv[1::3] = 5                                                  # no such level
    cases.append(("bad image or level R=64", bad, lv, None, q))
    return cases


CASES = _cases()
IDS = [c[0] for c in CASES]


def _live(rois, levels, valid, feats):
    return v3.live_rois(rois, levels, valid, feats[0].shape[0], len(feats))


def _compact(cells, weights, keep):
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    return cells.gather(-1, order), weights.gather(-1, order), keep.sum(-1)


def _assert_lists_equal(want, got, width):
    """Equal counts, and equal cells and weights (bit for bit) before them."""
    wc, ww, wn = want
    gc, gw, gn = got
    assert torch.equal(wn, gn)
    used = torch.arange(width) < wn[..., None]
    assert torch.equal(wc[..., :width][used], gc[used])
    assert torch.equal(ww[..., :width][used], gw[used])


@pytest.mark.parametrize("output_size, g", [((7, 7), 2), ((7, 7), 1), ((7, 7), 3),
                                            ((7, 7), 4), ((9, 8), 2), ((1, 1), 2)])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_v3_roi_taps_equal_separable_params(case, output_size, g):
    _, rois, levels, valid, hw = case
    feats = _pyramid(hw)
    ok = _live(rois, levels, valid, feats)
    yi, yw, xi, xw = v3.separable_params(feats, rois, levels, output_size, chip_smoke.SCALES_Q,
                                         g, ok)
    y, x = v3.v3_roi_taps(feats, rois, levels, output_size, chip_smoke.SCALES_Q, g, ok)
    for (idx, w), got in (((yi, yw), y), ((xi, xw), x)):
        _assert_lists_equal(_compact(idx.long(), w, w != 0), got, 2 * g)


@pytest.mark.parametrize("output_size, g", [((7, 7), 2), ((7, 7), 1), ((7, 7), 3),
                                            ((7, 7), 4), ((9, 8), 2), ((1, 1), 2)])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_v4_roi_taps_equal_window_operands(case, output_size, g):
    _, rois, levels, valid, hw = case
    feats = _pyramid(hw)
    ok = _live(rois, levels, valid, feats)
    wy, wx, x0 = v4.window_operands(feats, rois, levels, output_size, chip_smoke.SCALES_Q, g, ok)
    x0m, y, x = v4.v4_roi_taps(feats, rois, levels, output_size, chip_smoke.SCALES_Q, g, ok)
    assert torch.equal(x0m[ok], x0.long()[ok])
    assert bool(((wy != 0).sum(-1) <= 2 * g).all())
    rows = torch.arange(wy.shape[-1]).expand_as(wy)
    _assert_lists_equal(_compact(rows, wy, wy != 0), y, 2 * g)
    widths = torch.tensor([f.shape[2] for f in feats])[levels.long().clamp(0, len(feats) - 1)]
    cols = (x0.long()[:, None, None] + torch.arange(v4.WIN)).expand_as(wx)
    inside = cols < widths[:, None, None]
    _assert_lists_equal(_compact(cols, wx, (wx != 0) & inside), x, 2 * g)


def test_v4_roi_taps_clamp_wide_rois_to_the_window_edge():
    """A ROI of 152 cells on P3: its last output columns' corners clamp to
    window column 63, whose one entry carries their summed weight."""
    feats = _pyramid()
    rois = torch.tensor([[0.0, 0.0, 100.0, 1216.0, 300.0]])
    levels = torch.zeros(1, dtype=torch.int32)
    ok = torch.ones(1, dtype=torch.bool)
    _, wx, x0 = v4.window_operands(feats, rois, levels, (7, 7), chip_smoke.SCALES_Q, 2, ok)
    x0m, _, (cells, weights, count) = v4.v4_roi_taps(feats, rois, levels, (7, 7),
                                                     chip_smoke.SCALES_Q, 2, ok)
    assert int(x0m[0]) == int(x0[0]) == 0
    assert count[0, -1] == 1 and cells[0, -1, 0] == 63
    assert weights[0, -1, 0] == wx[0, -1, 63] == 1.0


def _sort_inputs(r):
    gen = torch.Generator().manual_seed(r + 1)
    rois, valid = chip_smoke.random_rois(max(r, 1), chip_smoke.BATCH, chip_smoke.QUERY_HW,
                                         gen, "cpu")
    levels = ra.fpn_level_map(rois[:, 1:], 3, 7)
    levels[5::17] = 7                                             # no such level
    return rois[:r], levels[:r], valid[:r]


@pytest.mark.parametrize("t", [1, 4, 16])
@pytest.mark.parametrize("r", [0, 1, 2000])
def test_device_slab_sort_equals_slab_blocks(r, t):
    rois, levels, valid = _sort_inputs(r)
    ok = v3.live_rois(rois, levels, valid, chip_smoke.BATCH, 5)
    want = v3.slab_blocks(rois, levels, ok, chip_smoke.BATCH, 5, t)
    got = v3.device_slab_sort(rois, levels, valid, chip_smoke.BATCH, 5, t)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


@pytest.mark.parametrize("warps", [1, 3, 7])
def test_device_slab_sort_is_stable_for_any_warp_count(warps):
    """The kernel takes fewer warps where B * L leaves less shared memory."""
    rois, levels, valid = _sort_inputs(2000)
    ok = v3.live_rois(rois, levels, valid, chip_smoke.BATCH, 5)
    want = v3.slab_blocks(rois, levels, ok, chip_smoke.BATCH, 5, 16)
    got = v3.device_slab_sort(rois, levels, valid, chip_smoke.BATCH, 5, 16, warps=warps)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def _define(path, name):
    m = re.search(rf"^#define {name} (\d+)", (CSRC / path).read_text(), re.M)
    assert m, name
    return int(m.group(1))


def test_mirrors_constants_are_the_kernels():
    assert v3.SORT_WARPS == _define("roi_align_v3.cu", "SORT_WARPS")
    assert v3.MAX_POOLED_W == _define("roi_align_taps.cuh", "MAX_POOLED_W")
    assert v3.MAX_TAPS == _define("roi_align_taps.cuh", "MAX_TAPS")
    assert v4.WIN == _define("roi_align_v4.cu", "WIN")
    codes = re.search(r"int level_code;\s*// (.*)", (CSRC / "roi_align_v3.cu").read_text())
    names = {f"{c} {str(d)[6:]}" for d, c in v3._LEVEL_CODE.items()}
    assert set(codes.group(1).split(", ")) == names


@pytest.mark.parametrize("c, dtype, ptrs, want", [
    (256, torch.bfloat16, [0, 1 << 20], 8), (68, torch.bfloat16, [0], 4),
    (66, torch.bfloat16, [0], 2), (256, torch.float32, [0], 4), (68, torch.float32, [0], 4),
    (66, torch.float32, [0], 2), (256, torch.bfloat16, [0, 8], 4),
    (256, torch.bfloat16, [4], 2), (256, torch.float32, [4], 0)])
def test_vector_width_follows_channels_and_alignment(c, dtype, ptrs, want):
    assert v3.vector_elems(c, dtype, ptrs) == want


def test_header_is_hashed_into_both_libraries(tmp_path, monkeypatch):
    """Editing the shared header renames both libraries, so neither is
    loaded stale."""
    from oneshotdet_tpu_torch import csrc

    for name in ("roi_align_v3.cu", "roi_align_v4.cu", "roi_align_taps.cuh"):
        (tmp_path / name).write_bytes((CSRC / name).read_bytes())
    monkeypatch.setattr(csrc, "_SRC_DIR", tmp_path)
    before = [csrc._library_path(n) for n in ("roi_align_v3", "roi_align_v4")]
    with open(tmp_path / "roi_align_taps.cuh", "a") as f:
        f.write("\n// edited\n")
    after = [csrc._library_path(n) for n in ("roi_align_v3", "roi_align_v4")]
    assert before[0] != after[0] and before[1] != after[1]
