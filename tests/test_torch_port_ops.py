"""oneshotdet_tpu_torch ops against the JAX package on the CPU: ROIAlign
(single- and multi-level, plain version), FPN level map, NMS, BoxCoder, box
IoU, the FCOS and ROI-head postprocessing. Inputs are drawn with numpy from
a seed and handed to both sides in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.models.fcos import fcos_postprocess as jax_fcos_postprocess
from oneshotdet_tpu.models.roi_head import roi_head_postprocess as jax_roi_post
from oneshotdet_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from oneshotdet_tpu.ops.nms import nms as jax_nms
from oneshotdet_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from oneshotdet_tpu.ops.roi_align import fpn_level_map as jax_fpn_level_map
from oneshotdet_tpu.ops.roi_align import multilevel_roi_align as jax_multilevel_roi_align
from oneshotdet_tpu.ops.roi_align import roi_align as jax_roi_align
from oneshotdet_tpu.structures import Boxes as JaxBoxes
from oneshotdet_tpu.structures.boxes import box_iou as jax_box_iou
from oneshotdet_tpu_torch.models.fcos import compute_locations, fcos_postprocess
from oneshotdet_tpu_torch.models.roi_head import roi_head_postprocess
from oneshotdet_tpu_torch.ops import roi_align as ra
from oneshotdet_tpu_torch.ops.box_coder import BoxCoder
from oneshotdet_tpu_torch.ops.nms import nms, nms_keep_mask
from oneshotdet_tpu_torch.structures import Boxes, box_iou, cat_boxes, truncate_boxes

SCALES = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
LEVEL_HW = ((16, 20), (8, 10), (4, 5), (2, 3), (1, 2))   # a 128x160 image


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _rois(rng, n, batch, hw=(128, 160)):
    """Ordinary boxes, boxes over 5:1 (both ways), boxes partly outside the
    image and degenerate ones (x2 < x1)."""
    h, w = hw
    xy = rng.uniform(-30, [w + 10, h + 10], (n, 2))
    wh = np.exp(rng.uniform(0, 5, (n, 2)))
    wh[0::5, 0] *= 8
    wh[1::5, 1] *= 8
    wh[2::7] *= -0.3
    b = rng.randint(0, batch, (n, 1))
    return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)


@pytest.fixture(scope="module")
def pyramid():
    rng = np.random.RandomState(0)
    return [rng.randn(2, h, w, 8).astype(np.float32) for h, w in LEVEL_HW]


@pytest.mark.parametrize("out_hw, scale, level", [((7, 7), 0.125, 0), ((1, 1), 0.0625, 1),
                                                  ((7, 7), 0.03125, 2), ((1, 1), 0.0078125, 4)])
def test_roi_align_matches_jax(pyramid, out_hw, scale, level):
    rois = _rois(np.random.RandomState(1), 64, 2)
    feats = pyramid[level]
    ref = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), out_hw, scale, 2))
    out = ra.roi_align(_t(feats), _t(rois), out_hw, scale, 2)
    assert out.shape == (64, *out_hw, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_multilevel_roi_align_matches_jax(pyramid):
    rng = np.random.RandomState(2)
    rois = _rois(rng, 200, 2)
    levels = rng.randint(0, 5, 200).astype(np.int32)
    valid = rng.rand(200) > 0.2
    ref = np.asarray(jax_multilevel_roi_align(
        [jnp.asarray(f) for f in pyramid], jnp.asarray(rois), jnp.asarray(levels),
        (7, 7), SCALES, 2))
    feats = [_t(f) for f in pyramid]
    out = ra.multilevel_roi_align(feats, _t(rois), _t(levels), (7, 7), SCALES, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # with `valid`, live slots are unchanged and the others are zeros
    out_v = ra.multilevel_roi_align(feats, _t(rois), _t(levels), (7, 7), SCALES, 2, _t(valid))
    np.testing.assert_allclose(out_v.numpy()[valid], ref[valid], atol=1e-5, rtol=0)
    assert not out_v.numpy()[~valid].any()


def test_multilevel_roi_align_bf16_rounds_once(pyramid):
    """bf16 features: float32 arithmetic on the bf16 values, one rounding."""
    rng = np.random.RandomState(3)
    rois = _t(_rois(rng, 50, 2))
    levels = _t(rng.randint(0, 5, 50).astype(np.int32))
    feats = [_t(f).to(torch.bfloat16) for f in pyramid]
    out = ra.multilevel_roi_align(feats, rois, levels, (7, 7), SCALES, 2)
    ref = ra.multilevel_roi_align([f.float() for f in feats], rois, levels, (7, 7), SCALES, 2)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.to(torch.bfloat16))


def test_cpu_tensors_never_launch_and_kernel_wrapper_refuses_them(pyramid):
    rois = _t(_rois(np.random.RandomState(4), 10, 2))
    levels = torch.zeros(10, dtype=torch.int32)
    before = ra.roi_align_launches
    ra.multilevel_roi_align([_t(f) for f in pyramid], rois, levels, (7, 7), SCALES, 2)
    assert ra.roi_align_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ra.multilevel_roi_align_cuda([_t(f) for f in pyramid], rois, levels, (7, 7), SCALES, 2)


def test_fpn_level_map_matches_jax():
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 800, (500, 2))
    xyxy = np.concatenate([xy, xy + np.exp(rng.uniform(0, 7, (500, 2)))], 1).astype(np.float32)
    ref = np.asarray(jax_fpn_level_map(jnp.asarray(xyxy), 3, 7))
    out = ra.fpn_level_map(_t(xyxy), 3, 7)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def _random_boxes(rng, n, spread=200.0):
    xy = rng.uniform(0, spread, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, 80, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.8])
def test_nms_keep_mask_matches_jax(thresh):
    rng = np.random.RandomState(6)
    boxes = _random_boxes(rng, 300)
    scores = rng.rand(300).astype(np.float32)
    valid = rng.rand(300) > 0.1
    ref = np.asarray(jax_nms_keep_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(valid), thresh))
    out = nms_keep_mask(_t(boxes), _t(scores), _t(valid), thresh)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not (out.numpy() & ~valid).any()


def test_nms_batched_and_indices_match_jax():
    rng = np.random.RandomState(7)
    boxes = np.stack([_random_boxes(rng, 120, 100) for _ in range(3)])
    scores = rng.rand(3, 120).astype(np.float32)
    valid = rng.rand(3, 120) > 0.2
    keep = nms_keep_mask(_t(boxes), _t(scores), _t(valid), 0.5)
    for i in range(3):
        ref = np.asarray(jax_nms_keep_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                           jnp.asarray(valid[i]), 0.5))
        np.testing.assert_array_equal(keep[i].numpy(), ref)
        ridx, rvalid = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                               jnp.asarray(valid[i]), 0.5, 150)
        idx, ok = nms(_t(boxes[i]), _t(scores[i]), _t(valid[i]), 0.5, 150)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(rvalid))
        np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.asarray(ridx)[np.asarray(rvalid)])


def test_box_coder_matches_jax():
    rng = np.random.RandomState(8)
    props = _random_boxes(rng, 100)
    gts = _random_boxes(rng, 100)
    codes = (rng.randn(100, 8) * 2).astype(np.float32)
    jc, pc = JaxBoxCoder((10.0, 10.0, 5.0, 5.0)), BoxCoder((10.0, 10.0, 5.0, 5.0))
    np.testing.assert_allclose(pc.encode(_t(gts), _t(props)).numpy(),
                               np.asarray(jc.encode(jnp.asarray(gts), jnp.asarray(props))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pc.decode(_t(codes), _t(props)).numpy(),
                               np.asarray(jc.decode(jnp.asarray(codes), jnp.asarray(props))),
                               rtol=1e-5, atol=1e-4)


def test_box_iou_and_containers():
    rng = np.random.RandomState(9)
    a, b = _random_boxes(rng, 20), _random_boxes(rng, 30)
    np.testing.assert_allclose(box_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jax_box_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)
    x = Boxes(xyxy=_t(a[None]), valid=torch.ones(1, 20, dtype=torch.bool),
              size=torch.tensor([[200.0, 200.0]]), fields={"scores": torch.rand(1, 20)})
    y = cat_boxes(x, x)
    assert y.capacity == 40 and y.get_field("scores").shape == (1, 40)
    z = truncate_boxes(y, 25)
    assert z.capacity == 25 and torch.equal(z.xyxy, y.xyxy[:, :25])


@pytest.mark.parametrize("level_topk, score_mode", [(False, "BINARY"), (True, "BINARY"),
                                                   (False, "MULTI")])
def test_fcos_postprocess_matches_jax(level_topk, score_mode):
    rng = np.random.RandomState(10)
    b, strides = 2, (8, 16, 32, 64, 128)
    shapes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    ncls = 1 if score_mode == "BINARY" else 2
    logits = [rng.randn(b, h, w, ncls).astype(np.float32) for h, w in shapes]
    reg = [np.exp(rng.randn(b, h, w, 4)).astype(np.float32) * 8 for h, w in shapes]
    ctr = [rng.randn(b, h, w, 1).astype(np.float32) for h, w in shapes]
    sizes_wh = np.array([[160.0, 128.0], [120.0, 100.0]], np.float32)
    args = dict(pre_nms_top_n=50, nms_thresh=0.6, post_top_n=40, nms_pre_topk=96,
                level_topk=level_topk, score_mode=score_mode)
    from oneshotdet_tpu.models.fcos import compute_locations as jax_locations

    ref = jax_fcos_postprocess(jax_locations(shapes, strides), [jnp.asarray(x) for x in logits],
                               [jnp.asarray(x) for x in reg], [jnp.asarray(x) for x in ctr],
                               jnp.asarray(sizes_wh), **args)
    locs = compute_locations(shapes, strides)
    for mine, theirs in zip(locs, jax_locations(shapes, strides)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    out = fcos_postprocess(locs, [_t(x) for x in logits], [_t(x) for x in reg],
                           [_t(x) for x in ctr], _t(sizes_wh), **args)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    v = out.valid.numpy()
    np.testing.assert_allclose(out.get_field("scores").numpy()[v],
                               np.asarray(ref.fields["scores"])[v], rtol=1e-6)
    np.testing.assert_allclose(out.xyxy.numpy()[v], np.asarray(ref.xyxy)[v], rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("cls_loss", ["ce_loss", "focal_loss"])
def test_roi_head_postprocess_matches_jax(cls_loss):
    """Softmax class-1 score (ce_loss) or sigmoid of logit 0 (focal_loss)."""
    rng = np.random.RandomState(11)
    b, p = 2, 40
    props = np.stack([_random_boxes(rng, p, 100) for _ in range(b)])
    valid = rng.rand(b, p) > 0.2
    size = np.array([[150.0, 140.0], [120.0, 130.0]], np.float32)
    logits = rng.randn(b * p, 2).astype(np.float32)
    deltas = rng.randn(b * p, 8).astype(np.float32)
    tid = np.array([3, 7], np.int32)
    ref = jax_roi_post(jnp.asarray(logits), jnp.asarray(deltas),
                       JaxBoxes(jnp.asarray(props), jnp.asarray(valid), jnp.asarray(size)),
                       jnp.asarray(tid), JaxBoxCoder(), 0.0, 0.5, 30, cls_loss)
    out = roi_head_postprocess(_t(logits), _t(deltas),
                               Boxes(_t(props), _t(valid), _t(size)), _t(tid), BoxCoder(),
                               0.0, 0.5, 30, cls_loss)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    v = out.valid.numpy()
    np.testing.assert_allclose(out.get_field("scores").numpy()[v],
                               np.asarray(ref.fields["scores"])[v], rtol=1e-6)
    np.testing.assert_allclose(out.xyxy.numpy()[v], np.asarray(ref.xyxy)[v], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(out.get_field("labels").numpy(), np.asarray(ref.fields["labels"]))
