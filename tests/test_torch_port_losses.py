"""The train path's losses, targets, matching and sampling of
oneshotdet_tpu_torch against the JAX package on the CPU, in float32: every
loss of ``ops/losses.py`` (value and gradient) in each of its modes,
``masked_box_iou``, ``match_boxes``, ``balanced_sample`` and
``prepare_roi_targets`` fed JAX's own uniform draws, the FCOS targets and
losses, and ``roi_head_loss``. Indices and labels must be equal; floats
within 1e-6 relative (with an absolute floor of 1e-6 of the largest value,
for entries that are sums cancelling near zero; NaN where JAX has NaN, as
the box encoding of a degenerate padded proposal gives in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.models import fcos as jfcos
from oneshotdet_tpu.models import matcher as jmatcher
from oneshotdet_tpu.models import roi_head as jroi
from oneshotdet_tpu.ops import losses as jl
from oneshotdet_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from oneshotdet_tpu.structures import Boxes as JaxBoxes
from oneshotdet_tpu.structures.boxes import masked_box_iou as jax_masked_box_iou
from oneshotdet_tpu_torch.models import fcos, matcher
from oneshotdet_tpu_torch.models import roi_head
from oneshotdet_tpu_torch.ops import losses
from oneshotdet_tpu_torch.ops.box_coder import BoxCoder
from oneshotdet_tpu_torch.structures import Boxes, masked_box_iou

RTOL = 1e-6


def close(port, ref, rtol=RTOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.nanmax(np.abs(ref)), 1e-30))


def t(x, **kw):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).requires_grad_(
        kw.get("grad", False))


def value_and_grads(port_fn, jax_fn, *arrays):
    """Value of both functions on the float arrays, and the gradients of
    each with respect to them (argnums over every array)."""
    tensors = [t(a, grad=True) for a in arrays]
    out = port_fn(*tensors)
    grads = torch.autograd.grad(out, tensors, allow_unused=True)
    ref, ref_grads = jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return out, grads, ref, ref_grads


def _ltrb(rng, n):
    return rng.uniform(0.5, 40.0, (n, 4)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["sigmoid", "softmax"])
def test_focal_losses_match_jax(kind, masked):
    rng = np.random.RandomState(0)
    n, c = 300, 3
    logits = rng.randn(n, c).astype(np.float32) * 3
    targets = rng.randint(-1, c + 1, n).astype(np.int32)
    valid = rng.rand(n) > 0.2 if masked else None
    port = losses.sigmoid_focal_loss if kind == "sigmoid" else losses.softmax_focal_loss
    ref = jl.sigmoid_focal_loss if kind == "sigmoid" else jl.softmax_focal_loss
    out, g, r, rg = value_and_grads(
        lambda x: port(x, t(targets), 2.0, 0.25, None if valid is None else t(valid)),
        lambda x: ref(x, jnp.asarray(targets), 2.0, 0.25,
                      None if valid is None else jnp.asarray(valid)), logits)
    close(out, r)
    close(g[0], rg[0])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_loss_matches_jax(loss_type, weighted):
    """With weights, zero-weight rows hold garbage (negative distances):
    their loss and gradient must be 0, not NaN."""
    rng = np.random.RandomState(1)
    n = 200
    pred, target = _ltrb(rng, n), _ltrb(rng, n)
    w = None
    if weighted:
        w = np.where(rng.rand(n) > 0.4, rng.rand(n), 0.0).astype(np.float32)
        target[w == 0] = -5.0
    out, g, r, rg = value_and_grads(
        lambda p, q: losses.iou_loss(p, q, None if w is None else t(w), loss_type),
        lambda p, q: jl.iou_loss(p, q, None if w is None else jnp.asarray(w), loss_type),
        pred, target)
    close(out, r)
    for a, b in zip(g, rg):
        assert torch.isfinite(a).all()
        close(a, b)


def test_iou_loss_zero_weight_sum_is_zero():
    rng = np.random.RandomState(2)
    out = losses.iou_loss(t(_ltrb(rng, 5)), t(_ltrb(rng, 5)), torch.zeros(5))
    assert float(out) == 0.0


def test_smooth_l1_and_bce_match_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(2, 400).astype(np.float32) * 2
    out, g, r, rg = value_and_grads(lambda x, y: losses.smooth_l1_loss(x, y, 1.0).sum(),
                                    lambda x, y: jl.smooth_l1_loss(x, y, 1.0).sum(), a, b)
    close(out, r)
    for x, y in zip(g, rg):
        close(x, y)
    tgt = rng.rand(400).astype(np.float32)
    out, g, r, rg = value_and_grads(lambda x, y: (losses.bce_with_logits(x, y) * y).sum(),
                                    lambda x, y: (jl.bce_with_logits(x, y) * y).sum(), a * 4, tgt)
    close(out, r)
    for x, y in zip(g, rg):
        close(x, y)


@pytest.mark.parametrize("weight, masked", [(None, False), (None, True), ((0.25, 0.75), True)])
def test_cross_entropy_matches_jax(weight, masked):
    rng = np.random.RandomState(4)
    n = 256
    logits = rng.randn(n, 2).astype(np.float32) * 2
    targets = rng.randint(0, 2, n).astype(np.int32)
    valid = rng.rand(n) > 0.3 if masked else None
    wp = None if weight is None else torch.tensor(weight)
    wj = None if weight is None else jnp.asarray(weight)
    out, g, r, rg = value_and_grads(
        lambda x: losses.cross_entropy(x, t(targets), wp, None if valid is None else t(valid)),
        lambda x: jl.cross_entropy(x, jnp.asarray(targets), wj,
                                   None if valid is None else jnp.asarray(valid)), logits)
    close(out, r)
    close(g[0], rg[0])


def _boxes(rng, n, hw=(128, 160)):
    h, w = hw
    xy = rng.uniform(0, [w - 10, h - 10], (n, 2))
    wh = rng.uniform(4, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_masked_box_iou_matches_jax():
    rng = np.random.RandomState(5)
    a, b = _boxes(rng, 2 * 6).reshape(2, 6, 4), _boxes(rng, 2 * 40).reshape(2, 40, 4)
    av, bv = rng.rand(2, 6) > 0.3, rng.rand(2, 40) > 0.2
    out = masked_box_iou(t(a), t(av), t(b), t(bv))
    close(out, jax_masked_box_iou(jnp.asarray(a), jnp.asarray(av), jnp.asarray(b),
                                  jnp.asarray(bv)))
    assert (out[~(t(av)[..., :, None] & t(bv)[..., None, :])] == 0).all()


def _jittered(rng, gt, n):
    """n proposals around the GT boxes (IoU spread over [0, 1]), plus some
    exact copies, so both thresholds and ties occur."""
    g = gt[rng.randint(0, len(gt), n)]
    wh = g[:, 2:] - g[:, :2]
    out = g + rng.uniform(-0.6, 0.6, (n, 4)) * np.concatenate([wh, wh], 1)
    out[::9] = g[::9]
    return out.astype(np.float32)


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_boxes_matches_jax(low_quality):
    rng = np.random.RandomState(6)
    gt = _boxes(rng, 5)
    props = _jittered(rng, gt, 300)
    gt_valid = np.array([True, True, False, True, True])
    iou = jax_masked_box_iou(jnp.asarray(gt), jnp.asarray(gt_valid), jnp.asarray(props),
                             jnp.ones(300, bool))
    ref = jmatcher.match_boxes(iou, jnp.asarray(gt_valid), 0.5, 0.4, low_quality)
    out = matcher.match_boxes(t(np.asarray(iou)), t(gt_valid), 0.5, 0.4, low_quality)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert {-1, -2} <= set(out.tolist())


def test_match_boxes_with_no_valid_gt():
    out = matcher.match_boxes(torch.rand(3, 10), torch.zeros(3, dtype=torch.bool), 0.5, 0.5)
    assert (out == matcher.BELOW_LOW_THRESHOLD).all()


@pytest.mark.parametrize("n_pos", [5, 60])
def test_balanced_sample_matches_jax_draws(n_pos):
    """The same uniforms JAX draws from its key: equal indices and flags,
    with few positives (negatives fill in) and with more than the quota."""
    rng = np.random.RandomState(7 + n_pos)
    n = 200
    labels = np.zeros(n, np.int32)
    labels[rng.choice(n, n_pos, replace=False)] = 1
    labels[rng.choice(n, 30, replace=False)] = -1
    valid = rng.rand(n) > 0.1
    key = jax.random.PRNGKey(n_pos)
    idx, sv = jmatcher.balanced_sample(key, jnp.asarray(labels), jnp.asarray(valid), 128, 0.25)
    u = np.asarray(jax.random.uniform(key, (n,)))
    p_idx, p_sv = matcher.balanced_sample(t(u), t(labels), t(valid), 128, 0.25)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(p_sv.numpy(), np.asarray(sv))


def test_prepare_roi_targets_matches_jax_draws():
    rng = np.random.RandomState(8)
    b, g, n = 2, 4, 120
    gt = np.stack([_boxes(rng, g) for _ in range(b)])
    gt_valid = np.array([[True, True, True, False], [True, False, False, False]])
    gt_labels = gt_valid.astype(np.int32)
    props = np.stack([_jittered(rng, gt[i][gt_valid[i]], n) for i in range(b)])
    p_valid = rng.rand(b, n) > 0.1
    size = np.array([[160.0, 128.0]] * b, np.float32)
    key = jax.random.PRNGKey(3)
    ref = jroi.prepare_roi_targets(
        key, JaxBoxes(jnp.asarray(props), jnp.asarray(p_valid), jnp.asarray(size)),
        JaxBoxes(jnp.asarray(gt), jnp.asarray(gt_valid), jnp.asarray(size),
                 {"labels": jnp.asarray(gt_labels)}), JaxBoxCoder((10.0, 10.0, 5.0, 5.0)),
        32, 0.25, 0.5, 0.5)
    u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(key, b)])
    out = roi_head.prepare_roi_targets(
        t(u), Boxes(t(props), t(p_valid), t(size)),
        Boxes(t(gt), t(gt_valid), t(size), {"labels": t(gt_labels)}),
        BoxCoder((10.0, 10.0, 5.0, 5.0)), 32, 0.25, 0.5, 0.5)
    idx, sv, labels, reg, gt_idx = out
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(gt_idx.numpy(), np.asarray(ref[4]))
    close(reg, ref[3])
    assert (labels[sv] == 1).any() and (labels[sv] == 0).any()


@pytest.fixture(scope="module")
def fcos_case():
    """A 2-image 128x160 pyramid's locations, GT boxes of every size range
    and random head outputs."""
    rng = np.random.RandomState(9)
    shapes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    strides = (8, 16, 32, 64, 128)
    gt = np.zeros((2, 5, 4), np.float32)
    gt[0, :4] = [[10, 12, 40, 50], [30, 20, 150, 120], [60, 60, 70, 66], [0, 0, 159, 127]]
    gt[1, :2] = [[5, 5, 100, 90], [80, 40, 120, 110]]
    gt_valid = np.array([[True] * 4 + [False], [True, True, False, False, False]])
    gt_labels = gt_valid.astype(np.int32)
    heads = [[rng.randn(2, h, w, c).astype(np.float32) for h, w in shapes] for c in (1, 4, 1)]
    heads[1] = [np.exp(x) * 8 for x in heads[1]]
    return shapes, strides, gt, gt_valid, gt_labels, heads


@pytest.mark.parametrize("center_sample", [True, False])
def test_fcos_targets_match_jax(fcos_case, center_sample):
    shapes, strides, gt, gt_valid, gt_labels, _ = fcos_case
    jloc = jfcos.compute_locations(shapes, strides)
    ref_labels, ref_reg = jfcos.fcos_targets(jloc, strides, jnp.asarray(gt),
                                             jnp.asarray(gt_labels), jnp.asarray(gt_valid),
                                             center_sample, 1.5)
    loc = fcos.compute_locations(shapes, strides)
    labels, reg = fcos.fcos_targets(loc, strides, t(gt), t(gt_labels), t(gt_valid),
                                    center_sample, 1.5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    assert (labels > 0).sum() > 10
    close(reg, ref_reg)
    close(fcos.centerness_targets(reg), jfcos.centerness_targets(ref_reg))


@pytest.mark.parametrize("focal_mode, loc_loss", [("SIGMOID", "giou"), ("SIGMOID", "iou"),
                                                  ("SOFTMAX", "linear_iou")])
def test_fcos_losses_match_jax(fcos_case, focal_mode, loc_loss):
    """The three FCOS losses and their gradients with respect to the head's
    outputs."""
    shapes, strides, gt, gt_valid, gt_labels, heads = fcos_case
    labels, reg = fcos.fcos_targets(fcos.compute_locations(shapes, strides), strides, t(gt),
                                    t(gt_labels), t(gt_valid))
    flat = [x for h in heads for x in h]

    def split(xs):
        return xs[:5], xs[5:10], xs[10:]

    def port(*xs):
        lg, br, ct = split(xs)
        return torch.stack(fcos.fcos_losses(lg, br, ct, labels, reg, 2.0, 0.25, loc_loss,
                                            focal_mode))

    def ref(*xs):
        lg, br, ct = split(xs)
        return jnp.stack(jfcos.fcos_losses(lg, br, ct, jnp.asarray(labels.numpy()),
                                           jnp.asarray(reg.numpy()), 2.0, 0.25, loc_loss,
                                           focal_mode))

    out = port(*[t(x) for x in flat])
    close(out, ref(*[jnp.asarray(x) for x in flat]))
    tensors = [t(x, grad=True) for x in flat]
    grads = torch.autograd.grad(port(*tensors).sum(), tensors)
    ref_grads = jax.grad(lambda *xs: ref(*xs).sum(), argnums=tuple(range(15)))(
        *[jnp.asarray(x) for x in flat])
    for a, b in zip(grads, ref_grads):
        close(a, b, rtol=1e-5)


@pytest.mark.parametrize("agnostic, weighted", [(False, False), (True, False), (False, True)])
def test_roi_head_loss_matches_jax(agnostic, weighted):
    rng = np.random.RandomState(10)
    b, s = 2, 32
    logits = rng.randn(b * s, 2).astype(np.float32) * 2
    deltas = rng.randn(b * s, 8).astype(np.float32)
    labels = rng.randint(-1, 2, (b, s)).astype(np.int32)
    reg = rng.randn(b, s, 4).astype(np.float32)
    sv = rng.rand(b, s) > 0.2
    out, g, r, rg = value_and_grads(
        lambda x, d: torch.stack(roi_head.roi_head_loss(
            x, d, t(labels), t(reg), t(sv), "ce_loss", agnostic, weighted)).sum(),
        lambda x, d: sum(jroi.roi_head_loss(
            x, d, jnp.asarray(labels), jnp.asarray(reg), jnp.asarray(sv), "ce_loss",
            cls_agnostic_bbox_reg=agnostic, loss_weighted=weighted)), logits, deltas)
    close(out, r)
    for a, c in zip(g, rg):
        close(a, c)
    parts = roi_head.roi_head_loss(t(logits), t(deltas), t(labels), t(reg), t(sv), "ce_loss",
                                   agnostic, weighted)
    ref_parts = jroi.roi_head_loss(jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(labels),
                                   jnp.asarray(reg), jnp.asarray(sv), "ce_loss",
                                   cls_agnostic_bbox_reg=agnostic, loss_weighted=weighted)
    for a, c in zip(parts, ref_parts):
        close(a, c)
