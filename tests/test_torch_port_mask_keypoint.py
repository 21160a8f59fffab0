"""The detector with MODEL.MASK_ON and KEYPOINT_ON (the mask and keypoint
heads over their own pools of the query pyramid) in the port against the
JAX package on the CPU, in float32, with the same seeded weights, batch 2,
64x64 queries, 32x32 supports, GT mask rasters and keypoints:

  - the eval forward on ``tests/test_mask_keypoint.py``'s small config
    (R-50-FPN at 64 channels, one backbone, 7x7 head pools, the mask pool
    over P3-P4): the detections, ``mask_probs`` within 1e-5 on the valid
    slots (the port pools zeros in invalid ones), and ``keypoints_xy``
    exactly wherever the heatmap's two largest values lie more than 1e-4
    apart (the others counted), with their scores within 1e-5;
  - the train forward on the flagship config at test size with both heads
    at their default 14x14 pools on P4: the losses (loss_mask and loss_kp
    among them) within rtol 5e-4 and every parameter's gradient within 1e-4
    relative norm of JAX's jitted ``value_and_grad`` (fed JAX's sampling
    draws; the relation head's, the FCOS towers' and the mask and keypoint
    heads' ReLUs differentiated at JAX's branch within 1e-4 of their kink).
    (The 64-channel config's GroupNorms of one and two channels a group
    leave the conv biases before them, and P6-P7 of 1 x 1 cells, gradients
    that cancel to rounding noise, which no relative bound can hold.)

One JAX train-step compile and one eval compile, shared by the module's
tests, with XLA's LLVM optimizations off (``compile_fast``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.config import cfg as jax_default_cfg
from oneshotdet_tpu.structures import Boxes as JaxBoxes
from oneshotdet_tpu_torch.config import cfg as port_default_cfg
from oneshotdet_tpu_torch.engine import batch_to_inputs
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch
from torch_port_common import (GRAD_REL, LOSS_RTOL, TOWER_KINKS, _iou, assert_same_detections,
                               capture_mask_kp_kinks, compile_fast, head_kinks_as_jax, jax_build,
                               jax_sampling_draws, jax_train_inputs, mask_kp_kink_arrays,
                               mask_kp_kinks_as_jax, np_, one_torch_thread,  # noqa: F401
                               random_variables, small_cfgs, state_dict_from_flax,
                               tower_kinks_as_jax)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_mask_keypoint.py's _small_cfg
SMALL_MK = [
    "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
    "MODEL.RETINANET.USE_C5", False,
    "MODEL.FCOS.CENTER_SAMPLE", True,
    "FEW_SHOT.SIAMESE_BACKBONE", False,
    "FEW_SHOT.SECOND_STAGE_METHOD", "concat",
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 64,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 16,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 8,
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 8,
    "TPU.MAX_GT_BOXES", 4,
    "TPU.MASK_RASTER", 16,
    "TPU.NMS_PRE_TOPK", 128,
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.MASK_ON", True,
    "MODEL.KEYPOINT_ON", True,
    "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", "(32, 32)",
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(32, 32)",
    "MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", 7,
    "MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION", 7,
    "MODEL.ROI_MASK_HEAD.POOLER_SCALES", "(0.125, 0.0625)",
    "MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES", "(0.125,)",
    "MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES", 5,
]
# the train case: the flagship at test size, both heads narrow, their pools
# the defaults (14x14 on P4, sampling ratio 0 taken as 2)
HEADS_14 = ["MODEL.MASK_ON", True, "MODEL.KEYPOINT_ON", True,
            "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", "(32, 32)",
            "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(32, 32)",
            "MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES", 5, "TPU.MASK_RASTER", 16]
MASK_ATOL = 1e-5
ARGMAX_GAP = 1e-4
RNG = jax.random.PRNGKey(2)


def cfgs(*extra):
    out = []
    for base in (jax_default_cfg, port_default_cfg):
        c = base.clone()
        c.merge_from_list(SMALL_MK + list(extra))
        out.append(c)
    return tuple(out)


def _batch():
    """Two episodes with GT mask rasters (a half-box, then random cells)
    and 5 keypoints per GT inside its box (some not visible)."""
    batch = make_episodic_batch(2, (64, 64), (32, 32), max_gt=4, seed=3)
    rng = np.random.RandomState(11)
    s = 16
    masks = (rng.rand(2, 4, s, s) > 0.5).astype(np.float32)
    masks[:, 0] = 0.0
    masks[:, 0, : s // 2] = 1.0
    gt = batch["gt_xyxy"]
    u = rng.uniform(0.0, 1.0, (2, 2, 4, 5))
    kps = np.stack([gt[..., None, 0] + u[0] * (gt[..., None, 2] - gt[..., None, 0]),
                    gt[..., None, 1] + u[1] * (gt[..., None, 3] - gt[..., None, 1]),
                    rng.choice([0, 1, 2], (2, 4, 5))], -1).astype(np.float32)
    return dict(batch, gt_masks=masks * batch["gt_valid"][..., None, None],
                gt_keypoints=kps * batch["gt_valid"][..., None, None])


def _jax_targets(batch):
    q, s, targets = jax_train_inputs(batch)
    fields = dict(targets.fields, masks=jnp.asarray(batch["gt_masks"]),
                  keypoints=jnp.asarray(batch["gt_keypoints"]))
    return q, s, JaxBoxes(xyxy=targets.xyxy, valid=targets.valid, size=targets.size,
                          fields=fields)


@pytest.fixture(scope="module")
def ref():
    """JAX's train value_and_grad (with the kinks' pre-activations) at the
    14x14 flagship config and its eval forward at the 7x7 small one, each
    on its config's seeded weights."""
    batch = _batch()
    jcfg, _ = small_cfgs(*HEADS_14)
    jm = jax_build(jcfg)
    q, s, targets = _jax_targets(batch)
    variables = random_variables(jm, (q, s))

    def loss_fn(params, q, s, targets, rng):
        losses, state = jm.apply({"params": params, "constants": variables["constants"]},
                                 q, s, targets, train=True, rng=rng,
                                 capture_intermediates=capture_mask_kp_kinks,
                                 mutable=["intermediates"])
        return sum(losses.values()), (losses, state["intermediates"])

    args = (variables["params"], q, s, targets, RNG)
    (_, (losses, inter)), grads = compile_fast(jax.value_and_grad(loss_fn, has_aux=True),
                                               *args)(*args)
    jcfg7, _ = cfgs()
    jm7 = jax_build(jcfg7)
    eval_vars = random_variables(jm7, (q, s), seed=1)
    eval_fn = compile_fast(lambda v, q, s: jm7.apply(v, q, s, train=False), eval_vars, q, s)
    return dict(batch=batch, state_dict=state_dict_from_flax(variables),
                eval_state_dict=state_dict_from_flax(eval_vars),
                losses={k: float(v) for k, v in losses.items()},
                grads=state_dict_from_flax({"params": grads}),
                kinks={name: [np.asarray(x) for x in calls["__call__"]]
                       for name, calls in inter["roi_head"].items()},
                tower_kinks={name: [np.asarray(x) for x in
                                    inter["fcos_head"][name]["GroupNorm_0"]["__call__"]]
                             for name in TOWER_KINKS},
                head_kinks=mask_kp_kink_arrays(inter),
                dets=eval_fn(eval_vars, q, s))


@pytest.fixture(scope="module")
def port_train(ref):
    _, pcfg = small_cfgs(*HEADS_14)
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(ref["state_dict"], strict=True)
    model.train()
    n = pcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + pcfg.TPU.MAX_GT_BOXES
    with head_kinks_as_jax(model.roi_heads.box, ref["kinks"]), \
            tower_kinks_as_jax(model.rpn.head, ref["tower_kinks"]), \
            mask_kp_kinks_as_jax(model, ref["head_kinks"]) as heads:
        losses = model.forward_train(*batch_to_inputs(ref["batch"]),
                                     draws=jax_sampling_draws(RNG, n))
    sum(losses.values()).backward()
    return ({k: v.detach() for k, v in losses.items()},
            {n_: p.grad for n_, p in model.named_parameters()}, heads)


@pytest.mark.parametrize("key", ["state_dict", "eval_state_dict"])
def test_weights_carry_both_heads(ref, key):
    sd = ref[key]
    assert "roi_heads.mask.predictor.conv5_mask.weight" in sd
    assert "roi_heads.mask.feature_extractor.mask_fcn2.bias" in sd
    assert "roi_heads.keypoint.predictor.kps_score_lowres.weight" in sd
    assert "roi_heads.keypoint.feature_extractor.conv_fcn1.weight" in sd


def test_train_losses_against_jax(ref, port_train):
    losses, _, heads = port_train
    assert set(losses) == set(ref["losses"]) and {"loss_mask", "loss_kp"} <= set(losses)
    for k, v in losses.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        np.testing.assert_allclose(float(v), ref["losses"][k], rtol=LOSS_RTOL, err_msg=k)
    assert ref["losses"]["loss_mask"] > 0 and ref["losses"]["loss_kp"] > 0
    # every head ReLU was matched to JAX's call
    assert set(heads.calls) == set(ref["head_kinks"])


# The heatmaps' softmax is blind to a constant added to a keypoint's whole
# heatmap, so the bias of kps_score_lowres has a zero gradient: both packages
# give rounding noise, held to 1e-6 of the layer's weight gradient instead.
SHIFT_INVARIANT = {"roi_heads.keypoint.predictor.kps_score_lowres.bias":
                   "roi_heads.keypoint.predictor.kps_score_lowres.weight"}


def test_train_gradients_against_jax(ref, port_train):
    _, grads, _ = port_train
    for name, got in grads.items():
        want = ref["grads"][name]
        got = got if got is not None else torch.zeros_like(want)
        if name in SHIFT_INVARIANT:
            scale = float(ref["grads"][SHIFT_INVARIANT[name]].norm())
            assert max(float(got.norm()), float(want.norm())) <= 1e-6 * scale, name
            continue
        if float(want.norm()) == 0.0:
            assert float(got.norm()) == 0.0, name
            continue
        rel = float((got - want).norm() / want.norm())
        assert rel <= GRAD_REL, f"{name}: {rel:.2e}"
    for head in ("roi_heads.mask.", "roi_heads.keypoint."):
        assert any(float(g.abs().sum()) > 0 for n, g in grads.items() if n.startswith(head))


@pytest.fixture(scope="module")
def port_eval(ref):
    _, pcfg = cfgs()
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(ref["eval_state_dict"], strict=True)
    heatmaps = []
    hook = model.roi_heads.keypoint.register_forward_hook(
        lambda m, i, o: heatmaps.append(o.detach()))
    images, supp, _ = batch_to_inputs(ref["batch"])
    dets = model(images, supp)
    hook.remove()
    return dets, heatmaps[0]


def _pairs(port, ref):
    """(image, JAX slot, port slot) of each valid JAX detection and the
    port's detection that overlaps it most."""
    out = []
    for i in range(ref.valid.shape[0]):
        jv, pv = np_(ref.valid[i]), np_(port.valid[i])
        pslots = np.nonzero(pv)[0]
        for j in np.nonzero(jv)[0]:
            k = pslots[int(np.argmax(_iou(np_(ref.xyxy[i, j]), np_(port.xyxy[i])[pslots])))]
            out.append((i, j, k))
    return out


def test_eval_detections_and_masks_against_jax(ref, port_eval):
    dets, _ = port_eval
    want = ref["dets"]
    assert_same_detections(dets, want)
    probs = np_(dets.get_field("mask_probs"))
    assert probs.shape == np_(want.valid).shape + (14, 14) and probs.dtype == np.float32
    jprobs = np.asarray(want.get_field("mask_probs"))
    pairs = _pairs(dets, want)
    assert pairs
    for i, j, k in pairs:
        np.testing.assert_allclose(probs[i, k], jprobs[i, j], rtol=0, atol=MASK_ATOL)
    # invalid slots pool zeros in the port
    assert np.isfinite(probs).all() and probs.min() >= 0 and probs.max() <= 1


def test_eval_keypoints_against_jax(ref, port_eval):
    dets, heatmaps = port_eval
    want = ref["dets"]
    xy, sc = np_(dets.get_field("keypoints_xy")), np_(dets.get_field("keypoints_scores"))
    jxy = np.asarray(want.get_field("keypoints_xy"))
    jsc = np.asarray(want.get_field("keypoints_scores"))
    b, k = np_(dets.valid).shape
    assert xy.shape == (b, k, 5, 2) and sc.shape == (b, k, 5)
    flat = heatmaps.permute(0, 3, 1, 2).reshape(b, k, 5, -1)
    top2 = torch.topk(flat, 2, dim=-1).values
    clear = np_(top2[..., 0] - top2[..., 1]) > ARGMAX_GAP
    exact = ties = 0
    for i, j, kk in _pairs(dets, want):
        np.testing.assert_allclose(sc[i, kk], jsc[i, j], rtol=1e-5, atol=1e-5)
        c = clear[i, kk]
        np.testing.assert_allclose(xy[i, kk][c], jxy[i, j][c], rtol=1e-6, atol=1e-4)
        exact += int(c.sum())
        ties += int((~c).sum())
    assert exact > 0
    assert ties <= exact
