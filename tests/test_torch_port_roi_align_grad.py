"""The ROIAlign gradient of oneshotdet_tpu_torch against the JAX package on
the CPU, in float32: autograd of the plain multi-level and single-level
ROIAlign against ``jax.grad`` of JAX's XLA ``multilevel_roi_align`` and
``roi_align`` (the gradient the JAX package trains with), on K1's ROI mixes
(ordinary, over 5:1, partly and wholly outside, degenerate, sub-cell,
invalid slots); ``multilevel_roi_align_backward_plain`` (the
backward kernel's plain version) against that autograd; and the op
``oneshotdet::roi_align``'s registered autograd, which runs the kernels on
the card and the plain versions on the CPU: gradients reach the features
only.

Tolerance: 1e-5 abs, times the largest gradient where that exceeds 1. A
pixel that many samples land on (gradients up to ~13 here) sums its terms in
an order that changes with the index-add's threads, which moves it by ~1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.ops.roi_align import multilevel_roi_align as jax_multilevel_roi_align
from oneshotdet_tpu.ops.roi_align import roi_align as jax_roi_align
from oneshotdet_tpu_torch.ops import roi_align as ra

SCALES = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
LEVEL_HW = ((16, 20), (8, 10), (4, 5), (2, 3), (1, 2))   # a 128x160 image
ATOL = 1e-5


def assert_close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _rois(rng, mix, n=60, batch=2, hw=(128, 160)):
    """(R, 5) ROIs of one mix and their valid flags."""
    h, w = hw
    b = rng.randint(0, batch, (n, 1)).astype(np.float32)
    xy = rng.uniform(-30, [w + 10, h + 10], (n, 2))
    wh = np.exp(rng.uniform(0, 5, (n, 2)))
    valid = np.ones(n, bool)
    if mix == "ordinary":
        wh[0::5, 0] *= 8                              # over 5:1
        wh[1::5, 1] *= 8
    elif mix == "outside":
        xy[0::2, 0] = w + 40 + rng.uniform(0, 50, n // 2)    # wholly right of it
        xy[1::2, 1] = -(wh[1::2, 1] + 40)                  # wholly above it
    elif mix == "degenerate":
        wh *= -0.3                                    # x2 < x1, y2 < y1
    elif mix == "subcell":
        wh = rng.uniform(0.05, 2.0, (n, 2))           # under one P3 cell
    elif mix == "invalid":
        valid = rng.rand(n) > 0.4
    rois = np.concatenate([b, xy, xy + wh], 1).astype(np.float32)
    return rois, valid


@pytest.fixture(scope="module")
def pyramid():
    rng = np.random.RandomState(0)
    return [rng.randn(2, h, w, 8).astype(np.float32) for h, w in LEVEL_HW]


def _levels(rois):
    """The FPN rule's level of each ROI, as the detector assigns them."""
    return ra.fpn_level_map(_t(rois[:, 1:]), 3, 7).numpy()


def _plain_grads(pyramid, rois, levels, valid, g, out_hw=(7, 7), fn=None):
    """Autograd's gradient of the plain forward (of ``fn``, the op's
    ``multilevel_roi_align``, where given)."""
    feats = [_t(f, grad=True) for f in pyramid]
    out = (fn or ra.multilevel_roi_align_plain)(feats, _t(rois), _t(levels), out_hw, SCALES,
                                                2, _t(valid))
    return torch.autograd.grad(out, feats, _t(g))


@pytest.mark.parametrize("mix", ["ordinary", "outside", "degenerate", "subcell", "invalid"])
def test_multilevel_gradient_matches_jax(pyramid, mix):
    """JAX's version has no valid flags: its output is masked with them, the
    plain version's own zeros for invalid slots."""
    rng = np.random.RandomState(["ordinary", "outside", "degenerate", "subcell",
                                 "invalid"].index(mix) + 1)
    rois, valid = _rois(rng, mix)
    levels = _levels(rois)
    g = rng.randn(len(rois), 7, 7, 8).astype(np.float32)

    def ref_loss(*feats):
        out = jax_multilevel_roi_align(list(feats), jnp.asarray(rois), jnp.asarray(levels),
                                       (7, 7), SCALES, 2)
        return (jnp.where(jnp.asarray(valid)[:, None, None, None], out, 0.0) * g).sum()

    ref = jax.grad(ref_loss, argnums=tuple(range(5)))(*[jnp.asarray(f) for f in pyramid])
    got = _plain_grads(pyramid, rois, levels, valid, g)
    for a, b in zip(got, ref):
        assert_close(a, b)
    if mix != "outside":
        assert sum(float(a.abs().sum()) for a in got) > 0


@pytest.mark.parametrize("mix", ["ordinary", "outside", "degenerate", "subcell", "invalid"])
def test_op_gradient_equals_plain_autograd(pyramid, mix):
    """The op's registered backward (the explicit sums of
    ``multilevel_roi_align_backward_plain`` on the CPU) against autograd of
    the plain forward, which the test above holds to JAX."""
    rng = np.random.RandomState(40 + ["ordinary", "outside", "degenerate", "subcell",
                                      "invalid"].index(mix))
    rois, valid = _rois(rng, mix)
    levels = _levels(rois)
    g = rng.randn(len(rois), 7, 7, 8).astype(np.float32)
    want = _plain_grads(pyramid, rois, levels, valid, g)
    got = _plain_grads(pyramid, rois, levels, valid, g, fn=ra.multilevel_roi_align)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert_close(a, b)


@pytest.mark.parametrize("out_hw, level", [((7, 7), 0), ((1, 1), 1), ((1, 1), 4)])
def test_single_level_gradient_matches_jax(pyramid, out_hw, level):
    """The fusion's 1x1 pools and the whole-support 7x7 on one level."""
    rng = np.random.RandomState(10 + level)
    rois, _ = _rois(rng, "ordinary", n=12)
    g = rng.randn(len(rois), *out_hw, 8).astype(np.float32)
    f = pyramid[level]
    ref = jax.grad(lambda x: (jax_roi_align(x, jnp.asarray(rois), out_hw, SCALES[level], 2)
                              * g).sum())(jnp.asarray(f))
    x = _t(f, grad=True)
    out = ra.roi_align(x, _t(rois), out_hw, SCALES[level], 2)
    got, = torch.autograd.grad(out, [x], _t(g))
    assert_close(got, ref)


@pytest.mark.parametrize("mix", ["ordinary", "outside", "degenerate", "subcell", "invalid"])
@pytest.mark.parametrize("out_hw", [(7, 7), (1, 1)])
def test_backward_plain_matches_autograd(pyramid, mix, out_hw):
    """The explicit scatter-add equals autograd of the plain forward, and
    the bf16 result is the float32 one rounded once (within half a bf16
    ulp, doubled for the float32 sums' order)."""
    rng = np.random.RandomState(20)
    rois, valid = _rois(rng, mix)
    levels = _levels(rois)
    g = rng.randn(len(rois), *out_hw, 8).astype(np.float32)
    want = _plain_grads(pyramid, rois, levels, valid, g, out_hw)
    shapes = [f.shape for f in pyramid]
    got = ra.multilevel_roi_align_backward_plain(_t(g), shapes, torch.float32, _t(rois),
                                                 _t(levels), out_hw, SCALES, 2, _t(valid))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert_close(a, b)
    bf = ra.multilevel_roi_align_backward_plain(_t(g), shapes, torch.bfloat16, _t(rois),
                                                _t(levels), out_hw, SCALES, 2, _t(valid))
    for a, b in zip(bf, got):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=2.0 ** -8,
                                   atol=ATOL * max(1.0, float(b.abs().max())))


def test_backward_plain_with_no_rois(pyramid):
    shapes = [f.shape for f in pyramid]
    got = ra.multilevel_roi_align_backward_plain(
        torch.zeros(0, 7, 7, 8), shapes, torch.float32, torch.zeros(0, 5),
        torch.zeros(0, dtype=torch.int32), (7, 7), SCALES, 2)
    assert [tuple(x.shape) for x in got] == [tuple(s) for s in shapes]
    assert all(float(x.abs().sum()) == 0 for x in got)


def test_function_routes_gradient_to_features_only(pyramid, monkeypatch):
    """The op ``oneshotdet::roi_align`` (``multilevel_roi_align``) on CPU
    tensors, its plain forward and backward sums counted: the features get
    autograd's gradient of the plain forward, the ROIs none, and each is
    called once."""
    calls = []
    fwd_plain = ra.multilevel_roi_align_plain
    bwd_plain = ra.multilevel_roi_align_backward_workspace

    def fwd(*args):
        calls.append("forward")
        return fwd_plain(*args)

    def bwd(*args):
        calls.append("backward")
        return bwd_plain(*args)

    monkeypatch.setattr(ra, "multilevel_roi_align_plain", fwd)
    monkeypatch.setattr(ra, "multilevel_roi_align_backward_workspace", bwd)
    rng = np.random.RandomState(30)
    rois, valid = _rois(rng, "invalid")
    levels = _levels(rois)
    g = rng.randn(len(rois), 7, 7, 8).astype(np.float32)
    feats = [_t(f, grad=True) for f in pyramid]
    r = _t(rois, grad=True)
    out = ra.multilevel_roi_align(feats, r, _t(levels), (7, 7), SCALES, 2, _t(valid))
    got = torch.autograd.grad(out, feats + [r], _t(g), allow_unused=True)
    monkeypatch.undo()
    want = _plain_grads(pyramid, rois, levels, valid, g)
    assert calls == ["forward", "backward"]
    assert got[-1] is None
    for a, b in zip(got[:-1], want):
        assert_close(a, b)
    # a level that needs no gradient gets none
    feats[2] = feats[2].detach()
    out = ra.multilevel_roi_align(feats, r, _t(levels), (7, 7), SCALES, 2, _t(valid))
    out.backward(_t(g))
    assert feats[2].grad is None and feats[0].grad is not None


def test_cpu_tensors_never_launch_and_backward_wrapper_refuses_them(pyramid):
    rng = np.random.RandomState(31)
    rois, valid = _rois(rng, "ordinary", n=10)
    levels = _levels(rois)
    before = (ra.roi_align_launches, ra.roi_align_bwd_launches)
    _plain_grads(pyramid, rois, levels, valid, rng.randn(10, 7, 7, 8).astype(np.float32))
    assert (ra.roi_align_launches, ra.roi_align_bwd_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ra.multilevel_roi_align_backward_cuda(torch.zeros(10, 7, 7, 8),
                                              [f.shape for f in pyramid], torch.float32,
                                              _t(rois), _t(levels), (7, 7), SCALES, 2)
