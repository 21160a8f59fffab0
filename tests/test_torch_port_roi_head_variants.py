"""The stage-2 training variants of oneshotdet_tpu_torch against the JAX
package on the CPU, in float32, function by function: ``compact_boxes``
(exact), ``soft_labeling_function`` (1e-7), ``make_artificial_proposals`` on
JAX's jitters (boxes within 1e-6, valid slots exact), ``prepare_roi_targets``
with soft labels on JAX's draws, ``roi_head_loss`` in every class loss with
and without soft labels and class-agnostic regression, its reverse-order
and negative-support terms (values and gradients within the tolerances of
``test_roi_head_loss_matches_jax``), the predictor's decision table, the
linear-fusion and 'rn' heads and the fused head's plain version at 9 and 14
predictor columns, and the weight conversion of those heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.models import roi_head as jroi
from oneshotdet_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from oneshotdet_tpu.ops.pallas_roi_head import pallas_roi_head, roi_head_params_from_module
from oneshotdet_tpu.structures import Boxes as JaxBoxes
from oneshotdet_tpu.structures import cat_boxes as jax_cat_boxes
from oneshotdet_tpu.utils.torch_export import export_state_dict
from oneshotdet_tpu_torch.models import build_detection_model, roi_head
from oneshotdet_tpu_torch.ops import roi_head_fused as rf
from oneshotdet_tpu_torch.ops.box_coder import BoxCoder
from oneshotdet_tpu_torch.structures import Boxes, compact_boxes, truncate_boxes
from torch_port_common import (make_setup, relation_head_setup, small_cfgs, state_dict_from_flax,
                               variant_variables)

RTOL = 1e-6     # tests/test_torch_port_losses.py


def close(port, ref, rtol=RTOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.nanmax(np.abs(ref)), 1e-30))


def t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).requires_grad_(grad)


def to_port(b: JaxBoxes) -> Boxes:
    return Boxes(t(b.xyxy), t(b.valid), t(b.size), {k: t(v) for k, v in b.fields.items()})


def assert_boxes_equal(port: Boxes, ref: JaxBoxes):
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(port.xyxy.numpy(), np.asarray(ref.xyxy))
    assert port.fields.keys() == ref.fields.keys()
    for k in ref.fields:
        np.testing.assert_array_equal(port.fields[k].numpy(), np.asarray(ref.fields[k]))


# -- compact_boxes -------------------------------------------------------------

def _cap_case():
    """The 1000-real-box cap of tests/test_roi_head_variants.py: 64 GT slots
    of which 2 are real, their artificial jitters, 900 scored proposals."""
    g = 64
    gt = JaxBoxes(xyxy=jnp.tile(jnp.array([[[8.0, 8.0, 40.0, 40.0]]]), (1, g, 1)),
                  valid=jnp.arange(g)[None] < 2, size=jnp.array([[128.0, 128.0]]),
                  fields={"scores": jnp.ones((1, g)), "objectness": jnp.ones((1, g))})
    props = JaxBoxes(xyxy=jnp.tile(jnp.array([[[1.0, 1.0, 20.0, 20.0]]]), (1, 900, 1)),
                     valid=jnp.ones((1, 900), bool), size=jnp.array([[128.0, 128.0]]),
                     fields={"scores": jnp.full((1, 900), 0.5),
                             "objectness": jnp.full((1, 900), 0.5)})
    art = jroi.make_artificial_proposals(jax.random.PRNGKey(0), gt)
    return jax_cat_boxes(jax_cat_boxes(art, gt), props), 1000


def _random_case():
    rng = np.random.RandomState(3)
    xyxy = rng.rand(3, 50, 4).astype(np.float32) * 100
    valid = rng.rand(3, 50) > 0.6
    return JaxBoxes(jnp.asarray(xyxy), jnp.asarray(valid), jnp.full((3, 2), 100.0),
                    {"scores": jnp.asarray(rng.rand(3, 50).astype(np.float32))}), 20


def _small_case():
    xyxy = jnp.arange(6 * 4, dtype=jnp.float32).reshape(1, 6, 4)
    valid = jnp.array([[False, True, False, True, True, False]])
    return JaxBoxes(xyxy, valid, jnp.array([[64.0, 64.0]]),
                    {"scores": jnp.arange(6, dtype=jnp.float32)[None]}), None


@pytest.mark.parametrize("case", [_small_case, _random_case, _cap_case],
                         ids=["small", "random_truncated", "cap_1000_real"])
def test_compact_boxes_matches_jax(case):
    boxes, cap = case()
    ref = jroi.truncate_boxes(jroi.compact_boxes(boxes), cap) if cap else \
        jroi.compact_boxes(boxes)
    port = truncate_boxes(compact_boxes(to_port(boxes)), cap) if cap else \
        compact_boxes(to_port(boxes))
    assert_boxes_equal(port, ref)
    if cap:
        np.testing.assert_array_equal(compact_boxes(to_port(boxes), cap).valid.numpy(),
                                      np.asarray(ref.valid))
    if case is _cap_case:
        assert int(port.valid.sum()) >= 900


# -- soft labels ---------------------------------------------------------------

SOFT = ("discrete", "linear", "transLinear", "trans4thLinear")


@pytest.mark.parametrize("func", SOFT)
def test_soft_labeling_function_matches_jax(func):
    grid = np.concatenate([np.linspace(0, 1, 2001), [0.1, 0.5, np.nextafter(0.5, 0),
                                                     np.nextafter(0.1, 0)]]).astype(np.float32)
    ref = jroi.soft_labeling_function(jnp.asarray(grid), func)
    np.testing.assert_allclose(roi_head.soft_labeling_function(t(grid), func).numpy(),
                               np.asarray(ref), atol=1e-7, rtol=0)


def test_soft_labeling_function_refuses_other_names():
    with pytest.raises(ValueError):
        jroi.soft_labeling_function(jnp.zeros(3), "cosine")
    with pytest.raises(ValueError):
        roi_head.soft_labeling_function(torch.zeros(3), "cosine")


def _boxes(rng, n, hw=(128, 160)):
    h, w = hw
    xy = rng.uniform(0, [w - 10, h - 10], (n, 2))
    wh = rng.uniform(4, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _jittered(rng, gt, n):
    g = gt[rng.randint(0, len(gt), n)]
    wh = g[:, 2:] - g[:, :2]
    out = g + rng.uniform(-0.6, 0.6, (n, 4)) * np.concatenate([wh, wh], 1)
    out[::9] = g[::9]
    return out.astype(np.float32)


@pytest.mark.parametrize("func", SOFT)
def test_prepare_roi_targets_soft_labels_match_jax(func):
    rng = np.random.RandomState(8)
    b, g, n = 2, 4, 120
    gt = np.stack([_boxes(rng, g) for _ in range(b)])
    gt_valid = np.array([[True, True, True, False], [True, False, False, False]])
    props = np.stack([_jittered(rng, gt[i][gt_valid[i]], n) for i in range(b)])
    p_valid = rng.rand(b, n) > 0.1
    size = np.array([[160.0, 128.0]] * b, np.float32)
    key = jax.random.PRNGKey(3)
    ref = jroi.prepare_roi_targets(
        key, JaxBoxes(jnp.asarray(props), jnp.asarray(p_valid), jnp.asarray(size)),
        JaxBoxes(jnp.asarray(gt), jnp.asarray(gt_valid), jnp.asarray(size),
                 {"labels": jnp.asarray(gt_valid.astype(np.int32))}),
        JaxBoxCoder((10.0, 10.0, 5.0, 5.0)), 32, 0.25, 0.5, 0.5,
        soft_labeling=True, soft_labeling_func=func)
    u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(key, b)])
    out = roi_head.prepare_roi_targets(
        t(u), Boxes(t(props), t(p_valid), t(size)),
        Boxes(t(gt), t(gt_valid), t(size), {"labels": t(gt_valid.astype(np.int32))}),
        BoxCoder((10.0, 10.0, 5.0, 5.0)), 32, 0.25, 0.5, 0.5, True, func)
    assert len(out) == len(ref) == 6
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]))
    close(out[3], ref[3])
    close(out[5], ref[5])
    assert float(out[5].max()) > 0.5 and float(out[5].min()) == 0.0


# -- artificial proposals ----------------------------------------------------------

def _art_gt(case):
    """(B, G) GT Boxes: boxes of the flagship's sizes, boxes at the border
    (the strict test), and rows with invalid slots."""
    rng = np.random.RandomState({"interior": 1, "border": 2, "padded": 3}[case])
    b, g = 3, 5
    size = np.array([[160.0, 128.0], [96.0, 96.0], [200.0, 120.0]], np.float32)
    xyxy = np.stack([_boxes(rng, g, (int(s[1]), int(s[0]))) for s in size])
    valid = np.ones((b, g), bool)
    if case == "border":
        xyxy[:, ::2, :2] = 0.5
        xyxy[:, 1::2, 2] = size[:, None, 0] - 1.0
    if case == "padded":
        valid[0, 3:] = valid[2, 1:] = False
    return JaxBoxes(jnp.asarray(xyxy), jnp.asarray(valid), jnp.asarray(size))


@pytest.mark.parametrize("case", ["interior", "border", "padded"])
def test_make_artificial_proposals_matches_jax(case):
    gt = _art_gt(case)
    key = jax.random.PRNGKey(11)
    ref = jroi.make_artificial_proposals(key, gt)
    b, g = gt.valid.shape
    lo, hi = roi_head.art_offset_bounds()
    offsets = np.asarray([[np.asarray(jax.random.uniform(kg, (roi_head.ART_POOL, 4),
                                                         minval=lo, maxval=hi))
                           for kg in jax.random.split(kb, g)]
                          for kb in jax.random.split(key, b)], np.float32)
    assert offsets.min() >= lo and offsets.max() < hi
    port = roi_head.make_artificial_proposals(t(offsets), to_port(gt))
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(port.xyxy.numpy(), np.asarray(ref.xyxy), atol=1e-6, rtol=0)
    for k in ("scores", "objectness"):
        np.testing.assert_array_equal(port.fields[k].numpy(), np.asarray(ref.fields[k]))
    assert port.xyxy.shape == (b, g * 4 * 3, 4)
    assert 0 < int(port.valid.sum()) < port.valid.numel()


def test_draw_art_offsets_range_and_generator():
    a = roi_head.draw_art_offsets((2, 3), torch.Generator().manual_seed(0), "cpu")
    b = roi_head.draw_art_offsets((2, 3), torch.Generator().manual_seed(0), "cpu")
    lo, hi = roi_head.art_offset_bounds()
    assert a.shape == (2, 3, roi_head.ART_POOL, 4) and torch.equal(a, b)
    assert float(a.min()) >= lo and float(a.max()) < hi


# -- roi_head_loss -------------------------------------------------------------------

def _loss_inputs(ncls, nreg, seed=10):
    rng = np.random.RandomState(seed)
    b, s = 2, 32
    return dict(logits=rng.randn(b * s, ncls).astype(np.float32) * 2,
                deltas=rng.randn(b * s, 4 * nreg).astype(np.float32),
                labels=rng.randint(-1, 2, (b, s)).astype(np.int32),
                reg=rng.randn(b, s, 4).astype(np.float32),
                sv=rng.rand(b, s) > 0.2,
                soft=rng.rand(b, s).astype(np.float32),
                other=rng.randn(b * s, ncls).astype(np.float32) * 2)


def _check_loss(loss, neg_supp, soft, agnostic, extra=None):
    """Values and gradients (logits, deltas and the extra pass's logits) of
    the port's loss against JAX's."""
    ncls, nreg = roi_head.predictor_num_classes("concat", loss, neg_supp)
    x = _loss_inputs(ncls, nreg)
    soft_j = jnp.asarray(x["soft"]) if soft else None
    soft_p = t(x["soft"]) if soft else None

    def port(lg, dl, other):
        kw = {f"{extra}_logits": other} if extra else {}
        return torch.stack(roi_head.roi_head_loss(
            lg, dl, t(x["labels"]), t(x["reg"]), t(x["sv"]), loss, agnostic,
            soft_labels=soft_p, **kw)).sum()

    def ref(lg, dl, other):
        kw = {f"{extra}_logits": other} if extra else {}
        return sum(jroi.roi_head_loss(
            lg, dl, jnp.asarray(x["labels"]), jnp.asarray(x["reg"]), jnp.asarray(x["sv"]), loss,
            cls_agnostic_bbox_reg=agnostic, soft_labels=soft_j, **kw))

    arrays = (x["logits"], x["deltas"], x["other"])
    tensors = [t(a, grad=True) for a in arrays]
    out = port(*tensors)
    grads = torch.autograd.grad(out, tensors, allow_unused=True)
    r, rg = jax.value_and_grad(ref, argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrays])
    close(out, r)
    for a, c in zip(grads, rg):
        close(torch.zeros_like(tensors[0]) if a is None else a, c)
    parts = roi_head.roi_head_loss(
        t(x["logits"]), t(x["deltas"]), t(x["labels"]), t(x["reg"]), t(x["sv"]), loss, agnostic,
        soft_labels=soft_p, **({f"{extra}_logits": t(x["other"])} if extra else {}))
    ref_parts = jroi.roi_head_loss(
        *[jnp.asarray(x[k]) for k in ("logits", "deltas", "labels", "reg", "sv")], loss,
        cls_agnostic_bbox_reg=agnostic, soft_labels=soft_j,
        **({f"{extra}_logits": jnp.asarray(x["other"])} if extra else {}))
    assert len(parts) == len(ref_parts)
    for a, c in zip(parts, ref_parts):
        close(a, c)
    return parts


@pytest.mark.parametrize("agnostic", [False, True], ids=["per_class", "agnostic"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("loss", ["ce_loss", "focal_loss", "mse_loss", "l1_loss", "cxe_loss"])
def test_roi_head_loss_modes_match_jax(loss, soft, agnostic):
    _check_loss(loss, False, soft, agnostic)


@pytest.mark.parametrize("loss, neg_supp, extra", [
    ("ce_loss", False, "rev"), ("focal_loss", False, "rev"), ("cxe_loss", False, "rev"),
    ("ce_loss", True, "neg"), ("focal_loss", True, "neg"),
])
def test_roi_head_loss_extra_terms_match_jax(loss, neg_supp, extra):
    parts = _check_loss(loss, neg_supp, False, False, extra)
    assert len(parts) == 3
    if not (loss == "focal_loss" and extra == "rev"):     # one class: rev is 0
        assert float(parts[2]) > 0


def test_roi_head_loss_reverse_takes_precedence():
    """With both extra passes only the reverse-order term is returned, as in
    the JAX package."""
    x = _loss_inputs(2, 2)
    args = [t(x[k]) for k in ("logits", "deltas", "labels", "reg", "sv")]
    both = roi_head.roi_head_loss(*args, "ce_loss", rev_logits=t(x["other"]),
                                  neg_logits=t(-x["other"]))
    rev = roi_head.roi_head_loss(*args, "ce_loss", rev_logits=t(x["other"]))
    ref = jroi.roi_head_loss(*[jnp.asarray(x[k]) for k in ("logits", "deltas", "labels", "reg",
                                                           "sv")], "ce_loss",
                             rev_logits=jnp.asarray(x["other"]),
                             neg_logits=jnp.asarray(-x["other"]))
    for a, b, c in zip(both, rev, ref):
        assert torch.equal(a, b)
        close(a, c)


def test_roi_head_loss_refuses_other_losses():
    with pytest.raises(ValueError):
        roi_head.roi_head_loss(torch.zeros(4, 2), torch.zeros(4, 8),
                               torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 4, 4),
                               torch.ones(1, 4, dtype=torch.bool), "hinge_loss")


# -- the predictor's table, the heads and their weights ---------------------------------

@pytest.mark.parametrize("method", ["concat", "rn", "matching"])
def test_predictor_num_classes_matches_jax(method):
    for loss in ("ce_loss", "focal_loss", "mse_loss", "l1_loss", "cxe_loss", "hinge_loss"):
        for neg in (False, True):
            try:
                want = jroi.predictor_num_classes(method, loss, neg)
            except ValueError:
                with pytest.raises(ValueError):
                    roi_head.predictor_num_classes(method, loss, neg)
                continue
            assert roi_head.predictor_num_classes(method, loss, neg) == want, (loss, neg)


HEADS = {   # (num_classes, num_bbox_reg, linear_fusion)
    "linear fusion": (2, 2, True),
    "linear fusion, focal": (1, 2, True),
    "rn, mse": (2, 3, False),
    "focal with neg support": (2, 3, False),
}


@pytest.mark.parametrize("per_roi", [False, True], ids=["per_image", "per_roi"])
@pytest.mark.parametrize("head", list(HEADS))
def test_head_matches_jax(head, per_roi):
    """The head loaded by a strict load of ``state_dict_from_flax`` against
    JAX's ROIBoxHeadNet, with one support per image (eval, the train pass)
    or one per ROI (the reverse-order pass), 1e-5 abs."""
    from oneshotdet_tpu.models.roi_head import ROIBoxHeadNet

    ncls, nreg, lf = HEADS[head]
    params, port, roi, supp = relation_head_setup(2, 8, seed=4, num_classes=ncls,
                                                  num_bbox_reg=nreg, linear_fusion=lf)
    if per_roi:
        supp = np.repeat(supp, 8, axis=0)[::-1].copy()
    net = ROIBoxHeadNet(in_channels=256, num_classes=ncls, num_bbox_reg=nreg, linear_fusion=lf)
    ref_l, ref_d = net.apply({"params": params}, jnp.asarray(roi), jnp.asarray(supp))
    with torch.no_grad():
        got_l, got_d = port(t(roi), t(supp))
    assert got_l.shape == (16, ncls) and got_d.shape == (16, 4 * nreg)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-5, rtol=0)
    assert hasattr(port, "compress_dim_conv") != lf


@pytest.mark.parametrize("ncls, nreg", [(1, 2), (2, 3)], ids=["9_columns", "14_columns"])
def test_fused_plain_at_new_widths_matches_jax_kernel(ncls, nreg):
    """The fused head's plain version with 9 and 14 predictor columns (the
    focal, mse and l1 heads; focal with neg support) against JAX's Pallas
    kernel in interpret mode, and against the port's unfused head."""
    params, head, roi, supp = relation_head_setup(2, 8, seed=6, num_classes=ncls,
                                                  num_bbox_reg=nreg)
    ref_l, ref_d = pallas_roi_head(jnp.asarray(roi), jnp.asarray(supp),
                                   roi_head_params_from_module(params), per_image=8,
                                   interpret=True)
    got_l, got_d = rf.fused_roi_head(t(roi), t(supp), rf.pack_roi_head_params(head), 8)
    assert got_l.shape[1] + got_d.shape[1] == ncls + 4 * nreg
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-4, rtol=0)
    with torch.no_grad():
        un_l, un_d = head(t(roi), t(supp))
    torch.testing.assert_close(got_l, un_l, atol=1e-4, rtol=0)
    torch.testing.assert_close(got_d, un_d, atol=1e-4, rtol=0)


def test_linear_fusion_never_takes_the_fused_head(monkeypatch):
    """JAX's gate: no fused kernel with linear fusion, whatever the layout;
    the opt-in is off in the config of a linear-fusion model."""
    _, head, roi, supp = relation_head_setup(2, 8, seed=4, linear_fusion=True)
    calls = []
    monkeypatch.setattr(roi_head, "fused_roi_head", lambda *a: calls.append(a))
    with torch.no_grad():
        out = head(t(roi), t(supp), use_fused=True)
        ref = head(t(roi), t(supp))
    assert not calls and torch.equal(out[0], ref[0])
    assert not rf.fused_head_applies(8, linear_fusion=True) and rf.fused_head_applies(8)
    monkeypatch.setenv("ONESHOT_PALLAS_ROI_HEAD", "1")
    for lf in (True, False):
        _, pcfg = small_cfgs("FEW_SHOT.LINEAR_FUSION", lf)
        assert build_detection_model(pcfg, device="meta").config.fused_roi_head is not lf


@pytest.fixture(scope="module")
def setup():
    return make_setup()


VARIANT_MODELS = {
    "linear fusion": ["FEW_SHOT.LINEAR_FUSION", True],
    "rn, mse": ["FEW_SHOT.SECOND_STAGE_METHOD", "rn", "FEW_SHOT.SECOND_STAGE_CLS_LOSS",
                "mse_loss"],
    "neg support, focal": ["FEW_SHOT.NEG_SUPPORT.TURN_ON", True,
                           "FEW_SHOT.SECOND_STAGE_CLS_LOSS", "focal_loss"],
}


@pytest.mark.parametrize("case", list(VARIANT_MODELS))
def test_weights_of_variant_models_match_export_state_dict(setup, case):
    """``state_dict_from_flax`` of the variant model's variables equals the
    JAX package's ``export_state_dict`` and loads strictly into the port's
    model of that config."""
    jcfg, pcfg = small_cfgs(*VARIANT_MODELS[case])
    variables = variant_variables(setup["variables"], jcfg)
    ours = state_dict_from_flax(variables)
    theirs, _, skipped = export_state_dict(variables)
    assert not skipped and ours.keys() == theirs.keys()
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(ours, strict=True)
    ncls, nreg = roi_head.predictor_num_classes(pcfg.FEW_SHOT.SECOND_STAGE_METHOD,
                                                pcfg.FEW_SHOT.SECOND_STAGE_CLS_LOSS,
                                                pcfg.FEW_SHOT.NEG_SUPPORT.TURN_ON)
    assert ours["roi_heads.box.predictor.cls_score.weight"].shape[0] == ncls
    assert ours["roi_heads.box.predictor.bbox_pred.weight"].shape[0] == 4 * nreg


def test_other_second_stage_methods_raise_value_error():
    _, pcfg = small_cfgs("FEW_SHOT.SECOND_STAGE_METHOD", "matching")
    with pytest.raises(ValueError, match="SECOND_STAGE_METHOD"):
        build_detection_model(pcfg, device="cpu")
