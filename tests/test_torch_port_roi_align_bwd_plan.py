"""The rules the ROIAlign backward kernel K1b (oneshotdet_tpu_torch/csrc/
roi_align_bwd.cu) follows on the card, checked on the CPU through its
mirrors: the tile lists (``roi_align_bwd_plan``) against brute force -- a
ROI is on a tile's list exactly when one of its in-range samples' corners of
non-zero weight lies in the tile, the lists ascend, dead ROIs are on none,
and the pairs never exceed the capacity the shapes give; the kernel's bits
round trip to the lists; the mirror's constants are the kernel's; and the
tile gather in plain PyTorch (``multilevel_roi_align_backward_tiled``, the
kernel's formulation) equals the plain gradient
(``multilevel_roi_align_backward_plain``) within 1e-6 abs in float32, times
the largest gradient where that exceeds 1: pixels of the small maps that
hundreds of samples land on (gradients up to ~10) sum in another order, and
the plain version's own index-add order changes with its threads.

The plan's cases are chip_smoke.py's on the batch-8 832x1216 query pyramid
(random mixes, GT-clustered, K1's edge cases, the support 7x7 and 1x1 pools)
and sub-cell, degenerate, bad image or level and P6-P7 ROIs (P7 maps smaller
than one tile); the gather's are a batch-2 256x320 pyramid.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from oneshotdet_tpu_torch.ops import roi_align as ra

CSRC = Path(ra.__file__).resolve().parents[1] / "csrc"
SCALES = chip_smoke.SCALES_Q


def _shapes(hw, batch=chip_smoke.BATCH, c=8):
    return [(batch, h, w, c) for h, w in chip_smoke.pyramid_shapes(*hw)]


def _cases():
    """(name, rois, levels, valid, shapes, output size)."""
    gen = torch.Generator().manual_seed(23)
    q = _shapes(chip_smoke.QUERY_HW)
    fpn = lambda r: ra.fpn_level_map(r[:, 1:], 3, 7)  # noqa: E731
    rois, valid = chip_smoke.random_rois(600, chip_smoke.BATCH, chip_smoke.QUERY_HW, gen, "cpu")
    crowd = chip_smoke.clustered_rois(gen, "cpu")
    cases = [("random mix R=600", rois, fpn(rois), valid, q, (7, 7)),
             ("GT-clustered R=1024", crowd, fpn(crowd), None, q, (7, 7))]
    for name, r, lv, v in chip_smoke.edge_case_rois(gen, "cpu"):
        cases.append((name, r, fpn(r) if lv is None else lv, v, q, (7, 7)))
    supp = torch.tensor([[i, 0.0, 0.0, 416.0 - 13 * i, 300.0 + 10 * i]
                         for i in range(chip_smoke.BATCH)])
    s = _shapes(chip_smoke.SUPP_HW)
    cases.append(("support 7x7 R=8", supp, fpn(supp), None, s, (7, 7)))
    for lvl in (0, 4):
        cases.append((f"support 1x1 P{lvl + 3} R=8", supp,
                      torch.zeros(chip_smoke.BATCH, dtype=torch.int32), None, [s[lvl]], (1, 1)))
    n = 64
    xy = torch.rand(n, 2, generator=gen) * torch.tensor([1200.0, 800.0])
    b = torch.randint(0, chip_smoke.BATCH, (n, 1), generator=gen).float()
    side = torch.rand(n, 2, generator=gen) * 6.0                  # under one P3 cell
    cases.append(("sub-cell R=64", torch.cat([b, xy, xy + side], 1),
                  torch.zeros(n, dtype=torch.int32), None, q, (7, 7)))
    cases.append(("degenerate R=64", torch.cat([b, xy + 40, xy], 1),
                  torch.randint(0, 5, (n,), generator=gen, dtype=torch.int32), None, q, (7, 7)))
    wide = torch.cat([b, xy * 0.2, xy * 0.2 + torch.tensor([900.0, 300.0])], 1)
    cases.append(("P6-P7 R=64", wide, torch.randint(3, 5, (n,), generator=gen,
                                                     dtype=torch.int32), None, q, (7, 7)))
    bad = rois[:n].clone()
    bad[::3, 0] = 9                                               # no such image
    lv = fpn(bad)
    lv[1::3] = 5                                                  # no such level
    cases.append(("bad image or level R=64", bad, lv, None, q, (7, 7)))
    cases.append(("no ROIs", rois[:0], lv[:0], None, q, (7, 7)))
    return cases


CASES = _cases()
IDS = [c[0] for c in CASES]


def _brute_force_lists(rois, levels, valid, shapes, output_size, g):
    """Per tile of ``bwd_tile_grid``, the ROIs with an in-range sample whose
    corner of non-zero weight (the product of the two axes' weights) lies in
    it: every sample and every corner, one at a time."""
    tiles = ra.bwd_tile_grid(shapes)
    index = {t: i for i, t in enumerate(tiles)}
    lists = [[] for _ in tiles]
    heights = torch.tensor([s[1] for s in shapes])
    widths = torch.tensor([s[2] for s in shapes])
    batch = shapes[0][0]
    t = ra.BWD_TILE
    for r in range(rois.shape[0]):
        lvl, b = int(levels[r]), int(rois[r, 0].long())
        if not (0 <= lvl < len(shapes) and 0 <= b < batch) or (valid is not None
                                                               and not valid[r]):
            continue
        one = torch.tensor([lvl])
        (oky, ylo, yhi, ly, hy), (okx, xlo, xhi, lx, hx) = ra._roi_axes(
            rois[r:r + 1], one, heights, widths, SCALES[:len(shapes)], output_size, g)
        hit = set()
        for sy in range(oky.shape[1]):
            for sx in range(okx.shape[1]):
                if not (oky[0, sy] and okx[0, sx]):
                    continue
                for yc, wy in ((ylo, hy), (yhi, ly)):
                    for xc, wx in ((xlo, hx), (xhi, lx)):
                        if float(wy[0, sy] * wx[0, sx]) != 0.0:
                            hit.add((int(yc[0, sy]) // t, int(xc[0, sx]) // t))
        for ty, tx in hit:
            lists[index[(lvl, b, ty, tx)]].append(r)
    return lists


@pytest.mark.parametrize("g", [2, 1])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_plan_equals_brute_force(case, g):
    _, rois, levels, valid, shapes, out_hw = case
    plan = ra.roi_align_bwd_plan(shapes, rois, levels, out_hw, SCALES[:len(shapes)], g, valid)
    assert plan.tiles == ra.bwd_tile_grid(shapes)
    assert plan.lists == [sorted(x) for x in _brute_force_lists(rois, levels, valid, shapes,
                                                                 out_hw, g)]
    # ascending, and no dead ROI on any list
    assert all(x == sorted(set(x)) for x in plan.lists)
    live, _ = ra._live_levels(shapes, rois.float(), levels.long(), valid)
    on = {r for x in plan.lists for r in x}
    assert all(bool(live[r]) for r in on)
    # the pairs within the capacity the shapes give, and each ROI within its level's
    counts = np.bincount([r for x in plan.lists for r in x], minlength=rois.shape[0])
    assert counts.sum() <= plan.pair_capacity
    ph, pw = out_hw
    for r in on:
        _, h, w, _ = shapes[int(levels[r])]
        t = ra.BWD_TILE
        assert counts[r] <= min(2 * ph * g, -(-h // t)) * min(2 * pw * g, -(-w // t))
    # the kernel's bits hold the same lists
    bits = plan.bits()
    assert bits.shape == (-(-rois.shape[0] // 32), len(plan.tiles))
    assert ra.bwd_lists_from_bits(bits) == plan.lists


def test_bwd_plan_capacity_on_the_train_shapes():
    """R = 1024 over the batch-8 832x1216 pyramid, 7x7, g = 2: P3's 7 x 10
    tiles bound a ROI (28 rows and columns span more), 72 k pairs."""
    shapes = _shapes(chip_smoke.QUERY_HW)
    rois = torch.zeros((1024, 5))
    plan = ra.roi_align_bwd_plan(shapes, rois, torch.full((1024,), 9, dtype=torch.int32),
                                 (7, 7), SCALES, 2)
    assert plan.pair_capacity == 1024 * 70 and plan.words == 32
    assert len(plan.tiles) == 8 * (70 + 20 + 6 + 2 + 1)
    assert not any(plan.lists)


def _gather_inputs(mix, out_hw, seed):
    rng = np.random.RandomState(seed)
    shapes = _shapes((256, 320), batch=2)
    n, (h, w) = 60, (256, 320)
    b = rng.randint(0, 2, (n, 1)).astype(np.float32)
    xy = rng.uniform(-30, [w + 10, h + 10], (n, 2))
    wh = np.exp(rng.uniform(0, 5.5, (n, 2)))
    valid = np.ones(n, bool)
    if mix == "ordinary":
        wh[0::5, 0] *= 8                                   # over 5:1
        wh[1::5, 1] *= 8
    elif mix == "clustered":
        xy = np.repeat(rng.uniform(0, [w - 120, h - 120], (4, 2)), n // 4, 0)
        wh = np.repeat(rng.uniform(20, 120, (4, 2)), n // 4, 0)
        xy, wh = xy + rng.uniform(-4, 4, (n, 2)), wh * rng.uniform(0.9, 1.1, (n, 2))
    elif mix == "outside":
        xy[0::2, 0] = w + 40 + rng.uniform(0, 50, n // 2)
        xy[1::2, 1] = -(wh[1::2, 1] + 40)
    elif mix == "degenerate":
        wh *= -0.3
    elif mix == "subcell":
        wh = rng.uniform(0.05, 2.0, (n, 2))
    elif mix == "invalid":
        valid = rng.rand(n) > 0.4
    rois = torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32))
    levels = ra.fpn_level_map(rois[:, 1:], 3, 7)
    grad = torch.from_numpy(rng.randn(n, *out_hw, 8).astype(np.float32))
    return shapes, rois, levels, torch.from_numpy(valid), grad


@pytest.mark.parametrize("g", [2, 1])
@pytest.mark.parametrize("out_hw", [(7, 7), (1, 1)])
@pytest.mark.parametrize("mix", ["ordinary", "clustered", "outside", "degenerate", "subcell",
                                 "invalid"])
def test_tile_gather_equals_plain_gradient(mix, out_hw, g):
    shapes, rois, levels, valid, grad = _gather_inputs(mix, out_hw, seed=len(mix) + g)
    args = (grad, shapes, torch.float32, rois, levels, out_hw, SCALES, g, valid)
    want = ra.multilevel_roi_align_backward_plain(*args)
    got = ra.multilevel_roi_align_backward_tiled(*args)
    assert any(float(x.abs().max()) > 0 for x in want) or mix in ("outside",)
    atol = 1e-6 * max([1.0] + [float(x.abs().max()) for x in want])
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)


def test_tile_gather_single_level_and_bf16():
    """One level (the 1x1 pools' form) and the cast to bf16 at the end."""
    shapes, rois, levels, valid, grad = _gather_inputs("ordinary", (1, 1), seed=5)
    lv = torch.zeros_like(levels)
    args = (grad, shapes[:1], torch.bfloat16, rois, lv, (1, 1), SCALES[:1], 2, valid)
    want = ra.multilevel_roi_align_backward_plain(*args)
    got = ra.multilevel_roi_align_backward_tiled(*args)
    assert got[0].dtype == torch.bfloat16
    # one rounding each from float32 sums that agree within 1e-6
    np.testing.assert_allclose(got[0].float().numpy(), want[0].float().numpy(), rtol=2.0 ** -8,
                               atol=1e-6)


def _define(name):
    m = re.search(rf"^#define {name} (\d+)", (CSRC / "roi_align_bwd.cu").read_text(), re.M)
    assert m, name
    return int(m.group(1))


def test_mirror_constants_are_the_kernels():
    assert ra.BWD_TILE == _define("TILE")
    assert ra.BWD_MAX_TILES == _define("MAX_TILES")
    assert ra.BWD_MAX_BINS == _define("MAX_BINS")
    assert ra.MAX_AXIS == _define("MAX_AXIS")
    # one bit per ROI of a 32-bit word, one 64-bit mask per axis
    assert ra.BWD_MAX_TILES == 64


def test_backward_wrapper_refuses_cpu_tensors():
    shapes = _shapes((256, 320), batch=2)
    rois = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        ra.multilevel_roi_align_backward_cuda(torch.zeros(4, 7, 7, 8), shapes, torch.float32,
                                              rois, torch.zeros(4, dtype=torch.int32), (7, 7),
                                              SCALES, 2)
