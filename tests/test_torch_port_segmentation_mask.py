"""The port's ``structures/segmentation_mask.py`` against the JAX package's
on the CPU: ``PolygonInstance.rasterize`` (PIL's ``ImageDraw.polygon`` with
outline and fill in the JAX package, a numpy scanline fill in the port) bit
for bit on the synthetic dataset's polygons and on generated ones
(fractional, off the image, concave, self-intersecting, several rings, too
few coordinates, degenerate, on tiny and odd images), and the containers'
transpose, crop, resize (PIL's nearest filter in JAX) and convert.
"""

import json

import numpy as np
import pytest

from oneshotdet_tpu.structures import segmentation_mask as jsm
from oneshotdet_tpu_torch.structures import segmentation_mask as psm
from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco

CASES = {
    "triangle": ([[2.0, 1.0, 12.0, 4.0, 5.0, 11.0]], (15, 13)),
    "fractional": ([[1.4, 0.6, 9.5, 1.5, 10.49, 8.51, 0.5, 7.7]], (12, 10)),
    "off the image": ([[-6.5, -3.0, 20.2, 2.5, 14.0, 19.5, -2.5, 12.0]], (13, 11)),
    "wholly outside": ([[20.0, 20.0, 30.0, 21.0, 25.0, 29.0]], (10, 10)),
    "concave star": ([[8.0, 0.5, 9.5, 6.0, 15.5, 7.0, 10.5, 10.0, 12.5, 16.0, 8.0, 12.0,
                       3.5, 16.0, 5.5, 10.0, 0.5, 7.0, 6.5, 6.0]], (17, 17)),
    "self-intersecting bow tie": ([[1.0, 1.0, 11.0, 9.0, 11.0, 1.0, 1.0, 9.0]], (13, 11)),
    "self-intersecting pentagram": ([[7.0, 0.0, 11.5, 13.0, 0.5, 5.0, 13.5, 5.0, 2.5, 13.0]],
                                    (15, 14)),
    "two rings": ([[0.5, 0.5, 5.5, 0.5, 5.5, 6.5], [7.0, 2.0, 12.5, 3.5, 9.0, 9.5, 6.5, 7.0]],
                  (14, 11)),
    "overlapping rings": ([[1.0, 1.0, 9.0, 1.0, 9.0, 9.0, 1.0, 9.0],
                           [5.0, 5.0, 12.0, 5.0, 12.0, 12.0]], (14, 14)),
    "too few coordinates": ([[1.0, 1.0, 8.0, 8.0], [2.0, 2.0, 9.0, 3.0, 4.0, 9.0]], (11, 11)),
    "collinear horizontal runs": ([[1.0, 2.0, 4.0, 2.0, 7.0, 2.0, 10.0, 2.0, 10.0, 8.0,
                                    6.0, 8.0, 3.0, 8.0, 1.0, 8.0]], (12, 10)),
    "degenerate line": ([[1.0, 1.0, 5.0, 5.0, 9.0, 9.0]], (11, 11)),
    "repeated vertices": ([[2.0, 2.0, 2.0, 2.0, 9.0, 3.0, 9.0, 3.0, 5.0, 9.0, 2.0, 2.0]],
                          (11, 11)),
    "one pixel image": ([[-1.0, -1.0, 3.0, 0.0, 0.0, 3.0]], (1, 1)),
    "one row image": ([[0.5, -2.0, 9.5, 0.2, 3.0, 4.0]], (12, 1)),
    "one column image": ([[-2.0, 0.5, 0.2, 9.5, 4.0, 3.0]], (1, 12)),
    "odd size rounded": ([[0.0, 0.0, 9.7, 0.4, 8.2, 7.6]], (9.5, 7.5)),
    "corners on both sides": ([[0.0, 4.0, 4.0, 0.0, 8.0, 4.0, 12.0, 0.0, 12.0, 9.0, 8.0, 5.0,
                                4.0, 9.0, 0.0, 5.0]], (13, 10)),
}


def _both(polygons, size):
    return (psm.PolygonInstance(polygons, size).rasterize(),
            jsm.PolygonInstance(polygons, size).rasterize())


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_equals_jax(case):
    polygons, size = CASES[case]
    got, want = _both(polygons, size)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_rasterize_random_polygons_equal_jax(seed):
    """300 random instances a seed: 3-9 vertices, fractional, half-pixel or
    integer, reaching past the image, on images of 1 to 40 pixels a side,
    one in five with a second ring."""
    rng = np.random.RandomState(seed)
    for k in range(300):
        w, h = rng.randint(1, 41, 2)
        n = rng.randint(3, 10)
        p = rng.uniform(-5, max(w, h) + 5, 2 * n)
        if k % 3 == 1:
            p = np.round(p * 2) / 2
        elif k % 3 == 2:
            p = np.round(p)
        polygons = [p] + ([rng.uniform(-3, max(w, h) + 3, 8)] if k % 5 == 0 else [])
        got, want = _both(polygons, (w, h))
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}, instance {k}")


def test_rasterize_dataset_polygons_equal_jax(tmp_path):
    """Every annotation of ``write_synthetic_coco(segmentation=True)`` at
    the loader tests' size and at VOC size, on its image's size."""
    for kw in (dict(num_images=16, sizes=((60, 80), (80, 60), (60, 80)),
                    box_side=(12.0, 40.0)), dict(num_images=6)):
        root = tmp_path / str(len(kw))
        _, ann_file = write_synthetic_coco(root, segmentation=True, **kw)
        data = json.load(open(ann_file))
        sizes = {im["id"]: (im["width"], im["height"]) for im in data["images"]}
        kinds = set()
        for ann in data["annotations"]:
            kinds.add(len(ann["segmentation"]))
            got, want = _both(ann["segmentation"], sizes[ann["image_id"]])
            assert got.any()
            np.testing.assert_array_equal(got, want, err_msg=str(ann["id"]))
        assert kinds == {1, 2}


POLYS = [[1.5, 2.0, 11.5, 3.5, 8.0, 12.5, 2.5, 9.0], [13.0, 1.0, 17.5, 1.5, 15.0, 6.0]]


@pytest.mark.parametrize("op", ["transpose_lr", "transpose_tb", "crop", "crop_outside",
                                "resize", "chain"])
def test_polygon_ops_equal_jax(op):
    size = (19, 14)
    ops = {
        "transpose_lr": lambda m, p: p.transpose(m.FLIP_LEFT_RIGHT),
        "transpose_tb": lambda m, p: p.transpose(m.FLIP_TOP_BOTTOM),
        "crop": lambda m, p: p.crop((2.5, 1.0, 14.0, 11.5)),
        "crop_outside": lambda m, p: p.crop((-3.0, -2.0, 8.5, 20.0)),
        "resize": lambda m, p: p.resize((31, 9)),
        "chain": lambda m, p: p.crop((1.0, 0.5, 16.5, 13.0)).resize((23.5, 17.0))
        .transpose(m.FLIP_LEFT_RIGHT),
    }
    outs = [ops[op](m, m.PolygonInstance(POLYS, size)) for m in (psm, jsm)]
    assert outs[0].size == outs[1].size and len(outs[0]) == len(outs[1])
    for a, b in zip(outs[0].polygons, outs[1].polygons):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[0].rasterize(), outs[1].rasterize())


@pytest.mark.parametrize("size", [(19, 14), (7, 5), (40, 3), (3, 40), (1, 1), (23, 17)])
def test_binary_mask_list_equals_jax(size):
    """transpose, crop and resize by PIL's nearest filter (up, down, to one
    pixel, odd ratios), indexing and the RLE decoder."""
    rng = np.random.RandomState(size[0] * 7 + size[1])
    masks = (rng.rand(3, 17, 23) > 0.5).astype(np.uint8)
    p, j = psm.BinaryMaskList(masks, (23, 17)), jsm.BinaryMaskList(masks, (23, 17))
    pairs = [(p.transpose(psm.FLIP_LEFT_RIGHT), j.transpose(jsm.FLIP_LEFT_RIGHT)),
             (p.transpose(psm.FLIP_TOP_BOTTOM), j.transpose(jsm.FLIP_TOP_BOTTOM)),
             (p.crop((2.4, 3.6, 15.5, 12.0)), j.crop((2.4, 3.6, 15.5, 12.0))),
             (p.resize(size), j.resize(size)), (p[1], j[1]), (p[[2, 0]], j[[2, 0]]),
             (p.crop((1, 1, 9, 7)).resize(size), j.crop((1, 1, 9, 7)).resize(size))]
    for a, b in pairs:
        assert a.size == b.size
        np.testing.assert_array_equal(a.masks, b.masks)
    rle = {"size": [4, 5], "counts": [3, 4, 6, 2, 5]}
    np.testing.assert_array_equal(psm.BinaryMaskList(rle, (5, 4)).masks,
                                  jsm.BinaryMaskList(rle, (5, 4)).masks)


def test_segmentation_mask_equals_jax():
    """The mode wrapper: polygons through crop, resize, transpose and
    convert to masks; an empty list converts to (0, h, w)."""
    insts = [POLYS, [[3.0, 3.0, 9.5, 4.0, 6.0, 10.5]]]
    outs = []
    for m in (psm, jsm):
        s = m.SegmentationMask(insts, (19, 14))
        s = s.crop((1.0, 1.0, 18.0, 13.5)).resize((25, 20)).transpose(m.FLIP_TOP_BOTTOM)
        outs.append((s, s.convert("mask"), s[1].convert("mask"),
                     m.SegmentationMask([], (6, 4)).convert("mask")))
    for a, b in zip(*outs):
        assert a.size == b.size and a.mode == b.mode and len(a) == len(b)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(outs[0][k].instances.masks, outs[1][k].instances.masks)
