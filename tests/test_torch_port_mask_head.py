"""The mask and keypoint heads (``models/mask_head.py``,
``models/keypoint_head.py``, ``models/roi_heads.py``) against the JAX
package's flax modules and functions on the CPU, in float32: the heads and
``CombinedROIHeads`` on the same seeded weights at 7x7 and 14x14 pools
(flax's ConvTranspose kernels flipped into ``conv_transpose2d``'s layout by
``state_dict_from_flax``), the mask targets, the losses and their gradients
against ``jax.grad``, the keypoint targets and decode; the host paste-back
``paste_mask_in_image`` and the predictor's ``overlay_mask_contours``
byte for byte against the JAX package's PIL versions (numpy's copy of
Pillow's bilinear resize, ``data.image_io.resize_bilinear``); and the op
``oneshotdet::roi_align``'s fake at the heads' 14x14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch._subclasses.fake_tensor import FakeTensorMode

from oneshotdet_tpu.models import keypoint_head as jkp
from oneshotdet_tpu.models import mask_head as jmh
from oneshotdet_tpu.models.roi_heads import CombinedROIHeads as JaxCombined
from oneshotdet_tpu.predictor import OneShotPredictor as JaxPredictor
from oneshotdet_tpu_torch.data.image_io import resize_bilinear
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.models import keypoint_head as pkp
from oneshotdet_tpu_torch.models import mask_head as pmh
from oneshotdet_tpu_torch.models.roi_heads import CombinedROIHeads
from oneshotdet_tpu_torch.ops import library
from oneshotdet_tpu_torch.ops import roi_align as ra
from oneshotdet_tpu_torch.predictor import overlay_mask_contours
from torch_port_common import np_, random_tree, small_cfgs, state_dict_from_flax, t

HEAD_ATOL = 1e-4      # relative to the largest output magnitude


def _load(module, params, flax_name, prefix):
    sd = state_dict_from_flax({"params": {flax_name: params}})
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np_(got), want, rtol=0, atol=HEAD_ATOL * scale)


@pytest.mark.parametrize("pool", [7, 14])
def test_mask_head_against_flax(pool):
    rng = np.random.RandomState(pool)
    x = rng.randn(3, pool, pool, 32).astype(np.float32)
    net = jmh.MaskHead(num_classes=2, conv_layers=(24, 24))
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = random_tree(shapes["params"], rng)
    want = net.apply({"params": params}, jnp.asarray(x))
    head = _load(pmh.MaskHead(32, num_classes=2, conv_layers=(24, 24)), params, "mask_head",
                 "roi_heads.mask.")
    got = head(t(x))
    assert got.shape == (3, 2 * pool, 2 * pool, 2) and got.dtype == torch.float32
    _close(got.detach(), want)


@pytest.mark.parametrize("pool", [7, 14])
def test_keypoint_head_against_flax(pool):
    rng = np.random.RandomState(10 + pool)
    x = rng.randn(2, pool, pool, 32).astype(np.float32)
    net = jkp.KeypointHead(num_keypoints=5, conv_layers=(24, 24, 24))
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = random_tree(shapes["params"], rng)
    want = net.apply({"params": params}, jnp.asarray(x))
    head = _load(pkp.KeypointHead(32, num_keypoints=5, conv_layers=(24, 24, 24)), params,
                 "keypoint_head", "roi_heads.keypoint.")
    got = head(t(x))
    assert got.shape == (2, 4 * pool, 4 * pool, 5) and got.dtype == torch.float32
    _close(got.detach(), want)


def test_conv_transpose_layout_is_a_flip():
    """flax's ConvTranspose kernel (kh, kw, in, out) is the (in, out, kh,
    kw) weight of conv_transpose2d flipped in both spatial axes: a kernel
    with one non-zero tap lands mirrored."""
    k = np.zeros((4, 4, 1, 1), np.float32)
    k[0, 1, 0, 0] = 1.0
    sd = state_dict_from_flax({"params": {"keypoint_head": {"predictor": {
        "kps_score_lowres": {"kernel": k, "bias": np.zeros(1, np.float32)}}}}})
    w = sd["roi_heads.keypoint.predictor.kps_score_lowres.weight"]
    assert w.shape == (1, 1, 4, 4) and float(w[0, 0, 3, 2]) == 1.0 and float(w.sum()) == 1.0


def test_head_init_as_flax():
    """The flagship's mask and keypoint heads start from the JAX package's
    distributions (mask_fcn kaiming-normal over fan-out, the other convs
    flax's lecun-normal, cut at two sigma; biases 0): each weight's std
    within 5/sqrt(n) relative of flax's init, and as far from 0 as flax's
    at most."""
    _, pcfg = small_cfgs("MODEL.MASK_ON", True, "MODEL.KEYPOINT_ON", True)
    model = build_detection_model(pcfg, device="cpu")
    port = {k: v for k, v in model.state_dict().items()
            if k.startswith(("roi_heads.mask.", "roi_heads.keypoint."))}
    c = model.config
    x = jnp.zeros((1, 14, 14, c.out_channels), jnp.float32)
    mask = jmh.MaskHead(num_classes=2, conv_layers=tuple(c.mask_conv_layers))
    kp = jkp.KeypointHead(num_keypoints=c.num_keypoints, conv_layers=tuple(c.kp_conv_layers))
    sd = state_dict_from_flax({"params": {
        "mask_head": mask.init(jax.random.PRNGKey(1), x)["params"],
        "keypoint_head": kp.init(jax.random.PRNGKey(2), x)["params"]}})
    assert set(port) == set(sd) and len(port) == 2 * (4 + 2 + 8 + 1)
    for k, want in sd.items():
        got = port[k]
        assert got.shape == want.shape, k
        if k.endswith(".bias"):
            assert not got.any() and not want.any(), k
            continue
        g, w = float(got.std()), float(want.std())
        assert abs(g - w) <= 5 / np.sqrt(got.numel()) * w, (k, g, w)
        assert float(got.abs().max()) <= 1.02 * float(want.abs().max()) or \
            "mask_fcn" in k and "logits" not in k, k


def test_combined_roi_heads_against_flax():
    rng = np.random.RandomState(3)
    roi = rng.randn(2, 7, 7, 256).astype(np.float32)
    supp = rng.randn(2, 7, 7, 256).astype(np.float32)
    pooled = rng.randn(2, 14, 14, 256).astype(np.float32)
    net = JaxCombined(mask_on=True, keypoint_on=True)
    args = tuple(jnp.asarray(a) for a in (roi, supp, pooled, pooled))
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), *args))
    params = random_tree(shapes["params"], rng)
    want = net.apply({"params": params}, *args)
    sd = state_dict_from_flax({"params": {"roi_head": params["box"],
                                          "mask_head": params["mask"],
                                          "keypoint_head": params["keypoint"]}})
    heads = CombinedROIHeads(mask_on=True, keypoint_on=True)
    heads.load_state_dict({k[len("roi_heads."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = heads(t(roi), t(supp), t(pooled), t(pooled))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    # without pooled features the heads run on the box head's
    with torch.no_grad():
        alone = heads(t(roi), t(supp))
    assert alone["mask_logits"].shape == (2, 14, 14, 2)
    assert alone["keypoint_logits"].shape == (2, 28, 28, 17)


def _boxes(rng, n, lo=0.0, hi=60.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(0.3, 30.0, (n, 2))
    wh[::4] *= -0.1                      # degenerate: extent clamped to one pixel
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_project_gt_rasters_and_masks_on_boxes():
    rng = np.random.RandomState(5)
    rasters = (rng.rand(9, 16, 16) > 0.5).astype(np.float32)
    gt, prop = _boxes(rng, 9), _boxes(rng, 9)
    prop[1] = gt[1]
    want = jmh.project_gt_rasters(jnp.asarray(rasters), jnp.asarray(gt), jnp.asarray(prop), 28)
    got = pmh.project_gt_rasters(t(rasters), t(gt), t(prop), 28)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0, atol=1e-6)
    masks = (rng.rand(9, 40, 50) > 0.5).astype(np.float32)
    want = jmh.project_masks_on_boxes(jnp.asarray(masks), jnp.asarray(gt), 28)
    np.testing.assert_array_equal(np_(pmh.project_masks_on_boxes(t(masks), t(gt), 28)),
                                  np.asarray(want))


def test_mask_loss_and_gradient_against_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(10, 28, 28, 2).astype(np.float32) * 3
    targets = rng.rand(10, 28, 28).astype(np.float32)
    labels = rng.randint(-1, 2, 10).astype(np.int32)
    valid = rng.rand(10) > 0.2
    f = lambda lg: jmh.mask_head_loss(lg, jnp.asarray(targets), jnp.asarray(labels),  # noqa: E731
                                      jnp.asarray(valid))
    want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got = pmh.mask_head_loss(x, t(targets), t(labels), t(valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(np_(x.grad), np.asarray(want_g), rtol=1e-5, atol=1e-9)


def test_keypoint_targets_loss_gradient_and_decode_against_jax():
    rng = np.random.RandomState(7)
    boxes = _boxes(rng, 6)
    # around the boxes: some outside, some not visible
    u = rng.uniform(-0.2, 1.2, (2, 6, 5))
    ext = np.maximum(boxes[:, 2:] - boxes[:, :2], 1.0)
    kps = np.stack([boxes[:, :1] + u[0] * ext[:, :1], boxes[:, 1:2] + u[1] * ext[:, 1:],
                    rng.randint(0, 3, (6, 5))], -1).astype(np.float32)
    want_idx, want_valid = jkp.keypoints_to_heatmap_targets(jnp.asarray(kps), jnp.asarray(boxes),
                                                            56)
    idx, valid = pkp.keypoints_to_heatmap_targets(t(kps), t(boxes), 56)
    np.testing.assert_array_equal(np_(idx), np.asarray(want_idx))
    np.testing.assert_array_equal(np_(valid), np.asarray(want_valid))
    assert bool(valid.any()) and not bool(valid.all())
    logits = rng.randn(6, 56, 56, 5).astype(np.float32) * 2
    f = lambda lg: jkp.keypoint_head_loss(lg, want_idx, want_valid)  # noqa: E731
    want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got = pkp.keypoint_head_loss(x, idx, valid)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(np_(x.grad), np.asarray(want_g), rtol=1e-5, atol=1e-9)
    want_xy, want_s = jkp.heatmaps_to_keypoints(jnp.asarray(logits), jnp.asarray(boxes))
    xy, s = pkp.heatmaps_to_keypoints(t(logits), t(boxes))
    np.testing.assert_array_equal(np_(xy), np.asarray(want_xy))
    np.testing.assert_array_equal(np_(s), np.asarray(want_s))
    # ties take the first maximum, as jnp.argmax
    flat = np.zeros((1, 56, 56, 5), np.float32)
    flat[0, 3, 7] = flat[0, 40, 2] = 1.0
    want_xy, _ = jkp.heatmaps_to_keypoints(jnp.asarray(flat), jnp.asarray(boxes[:1]))
    np.testing.assert_array_equal(np_(pkp.heatmaps_to_keypoints(t(flat), t(boxes[:1]))[0]),
                                  np.asarray(want_xy))


# (input grid, box, image (h, w)): upscales, downscales, partly outside
PASTE_CASES = [
    ((28, 28), (10.0, 20.0, 150.4, 90.6), (120, 200)),
    ((28, 28), (3.2, 5.0, 12.0, 9.4), (40, 40)),
    ((28, 28), (-20.0, -8.5, 40.0, 30.0), (50, 60)),
    ((28, 28), (35.0, 40.0, 95.0, 130.0), (100, 80)),
    ((14, 14), (0.0, 0.0, 0.0, 0.0), (10, 10)),
    ((28, 28), (5.5, 6.5, 300.0, 7.0), (20, 320)),
]


@pytest.mark.parametrize("case", PASTE_CASES, ids=[str(c[1]) for c in PASTE_CASES])
def test_paste_mask_in_image_byte_for_byte(case):
    (mh, mw), box, (h, w) = case
    rng = np.random.RandomState(mh + int(box[2]))
    mask = rng.rand(mh, mw).astype(np.float32)
    got = pmh.paste_mask_in_image(mask, box, h, w)
    want = jmh.paste_mask_in_image(mask, box, h, w)
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)


def test_overlay_mask_contours_byte_for_byte():
    rng = np.random.RandomState(8)
    image = rng.randint(0, 256, (90, 120, 3)).astype(np.uint8)
    boxes = np.array([b for _, b, _ in PASTE_CASES] + [(2.0, 3.0, 4.0, 4.0)], np.float32)
    probs = rng.rand(len(boxes), 28, 28).astype(np.float32)
    probs[1] = np.linspace(0, 1, 28)[None]
    want = JaxPredictor.overlay_mask_contours(None, image, boxes, probs)
    got = overlay_mask_contours(image, boxes, probs)
    assert not np.array_equal(got, image)
    np.testing.assert_array_equal(got, want)


RESIZE_CASES = [((28, 30), (97, 41)), ((30, 30), (5, 7)), ((1, 1), (9, 3)), ((17, 4), (17, 60)),
                ((50, 3), (2, 1)), ((12, 12), (12, 12)), ((64, 2), (64, 9))]


@pytest.mark.parametrize("shape,size", RESIZE_CASES, ids=[f"{a}->{b}" for a, b in RESIZE_CASES])
def test_resize_bilinear_is_pillows(shape, size):
    rng = np.random.RandomState(shape[0] * 7 + size[0])
    for a in (rng.randint(0, 256, shape).astype(np.uint8),
              ((rng.rand(*shape) > 0.5) * 255).astype(np.uint8)):
        want = np.asarray(Image.fromarray(a).resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear(a, size), want)


def test_roi_align_fake_at_14x14():
    g = torch.Generator().manual_seed(0)
    feats = [torch.randn(2, 12, 16, 16, generator=g), torch.randn(2, 6, 8, 16, generator=g)]
    rois = torch.tensor([[0.0, 1.0, 2.0, 40.0, 30.0], [1.0, 10.0, 10.0, 90.0, 70.0]])
    levels = ra.fpn_level_map(rois[:, 1:], 3, 4)
    args = (feats, rois, levels, torch.tensor([True, False]), [14, 14], [0.125, 0.0625], 2)
    real = library.roi_align(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = library.roi_align(*[[mode.from_tensor(f) for f in a] if isinstance(a, list)
                                   and isinstance(a[0], torch.Tensor) else
                                   mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                                   for a in args])
    assert real.shape == fake.shape == (2, 14, 14, 16) and real.dtype == fake.dtype
    assert float(real[1].abs().max()) == 0.0
    torch.library.opcheck(library.roi_align, args)


def test_nan_boxes_give_indices_in_range():
    """A diverged step's NaN boxes: the targets' gather indices stay in
    range (the JAX package's gathers clamp theirs), the keypoints are
    invalid, and nothing raises."""
    nan = float("nan")
    kps = torch.tensor([[[nan, 3.0, 2.0], [5.0, 5.0, 2.0]]])
    box = torch.tensor([[0.0, 0.0, nan, 10.0]])
    idx, valid = pkp.keypoints_to_heatmap_targets(kps, box, 56)
    assert bool(((idx >= 0) & (idx < 56 * 56)).all()) and not bool(valid.any())
    rasters = torch.rand(2, 8, 8)
    out = pmh.project_gt_rasters(rasters, torch.tensor([[0.0, 0, 10, 10], [nan, 0, 4, 4]]),
                                 torch.tensor([[nan, 0.0, 5, 5], [0.0, 0, 3, 3]]), 6)
    assert out.shape == (2, 6, 6)
    assert pmh.project_masks_on_boxes(rasters, box.expand(2, 4), 5).shape == (2, 5, 5)
