"""Serving from a bundle of ``export.export_serving`` on the CPU
(``predictor.ArtifactPredictor``), and the predictor's annotated-frame API:

  - ``ArtifactPredictor`` on the ExportedProgram pair equals
    ``OneShotPredictor`` frame for frame, bit for bit, unfused and with the
    fused head (whose operands go through the bundle's save and load), with
    scalar and per-class thresholds;
  - the bundle's meta is the JAX package's input contract (``host_s2d``
    always false) plus the device;
  - ``load_compiled`` gives None for an absent package and for one built
    for another device; a bundle exported on the CPU refuses the card;
  - the compiled route (an AOTInductor pair) at the smallest capacity,
    within the detection tolerances: marked ``slow`` (two AOTInductor
    compiles of the full-width model take ~90 s on the CPU);
  - ``overlay_boxes`` and ``overlay_scores`` equal the JAX package's pixel
    for pixel; ``run_on_opencv_image`` draws the frame's detections and
    with MODEL.MASK_ON also the masks' contours (the artifact stays box-only).
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.models import mask_head as jmh
from oneshotdet_tpu.predictor import OneShotPredictor as JaxPredictor
from oneshotdet_tpu_torch import export as oexport
from oneshotdet_tpu_torch.predictor import (ArtifactPredictor, OneShotPredictor, annotate_bgr,
                                            overlay_boxes, overlay_mask_contours, overlay_scores)
from oneshotdet_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_predictor import PRED_OVERRIDES
from torch_port_common import BOX_RTOL, SCORE_RTOL, random_tree, random_variables, small_cfgs

JAX_META_KEYS = {"query_bucket", "supp_bucket", "host_s2d", "pixel_mean", "pixel_std",
                 "to_bgr255", "min_size_test", "max_size_test", "supp_min_size_test",
                 "supp_max_size_test"}


@pytest.fixture(scope="module")
def predictor():
    from oneshotdet_tpu.models import build_detection_model as jax_build
    from oneshotdet_tpu.structures import ImageBatch as JaxImageBatch

    jcfg, pcfg = small_cfgs(*PRED_OVERRIDES)
    small = JaxImageBatch(pixels=jnp.zeros((1, 64, 64, 3)), sizes=jnp.array([[64.0, 64.0]]))
    variables = random_variables(jax_build(jcfg), (small, small))
    return OneShotPredictor(pcfg, state_dict_from_flax(variables), confidence_threshold=-1.0,
                            device="cpu")


@pytest.fixture(scope="module")
def bundles(predictor, tmp_path_factory):
    root = tmp_path_factory.mktemp("bundles")
    out = {}
    for head in ("unfused", "fused"):
        predictor.model.config = dataclasses.replace(predictor.model.config,
                                                     fused_roi_head=head == "fused")
        stem = str(root / head)
        assert oexport.export_serving(predictor.cfg, predictor.model, stem,
                                      compile_executable=False) is False
        out[head] = stem
    predictor.model.config = dataclasses.replace(predictor.model.config, fused_roi_head=False)
    return out


@pytest.fixture(scope="module")
def served(bundles):
    """Each bundle loaded once (a pair is ~0.3 GB of full-width weights);
    then its programs' files go (the meta stays), so the tests hold no
    disk for them."""
    out = {head: ArtifactPredictor(stem, confidence_threshold=-1.0, device="cpu")
           for head, stem in bundles.items()}
    for stem in bundles.values():
        for ext in (".support", ".detect"):
            os.remove(stem + ext)
    return out


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (40, 52, 3), np.uint8),
            [rng.randint(0, 255, hw + (3,), np.uint8) for hw in ((100, 150), (120, 90))])


@pytest.mark.parametrize("head", ["unfused", "fused"])
def test_artifact_predictor_equals_one_shot_predictor(predictor, served, head):
    predictor.model.config = dataclasses.replace(predictor.model.config,
                                                 fused_roi_head=head == "fused")
    art = served[head]
    assert art.used_executable is False
    supp, frames = _images()
    predictor.set_support(supp)
    art.set_support(supp)
    for frame in frames:
        want, got = predictor.run_on_image(frame), art.run_on_image(frame)
        assert len(want[1]) > 0
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    predictor.model.config = dataclasses.replace(predictor.model.config, fused_roi_head=False)


def test_per_class_thresholds_as_one_shot_predictor(predictor, served):
    """A per-class vector picks the support class's entry on both sides."""
    supp, frames = _images(1)
    predictor.set_support(supp, class_id=2)
    scores = predictor.run_on_image(frames[0])[1]
    thr = np.zeros(4, np.float32)
    thr[2] = float(np.median(scores))
    art = served["unfused"]
    predictor.confidence_threshold = art.confidence_threshold = thr
    art.set_support(supp, class_id=2)
    try:
        want, got = predictor.run_on_image(frames[0]), art.run_on_image(frames[0])
    finally:
        predictor.confidence_threshold = art.confidence_threshold = -1.0
    assert 0 < len(want[1]) < len(scores)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_bundle_meta_is_the_input_contract(predictor, bundles):
    with open(bundles["unfused"] + ".meta.json") as f:
        meta = json.load(f)
    assert set(meta) == JAX_META_KEYS | {"device"}
    c = predictor.cfg
    assert meta["host_s2d"] is False and meta["device"] == "cpu"
    assert meta["query_bucket"] == list(c.TPU.QUERY_BUCKETS[0])
    assert meta["supp_bucket"] == list(c.TPU.SUPP_BUCKET)
    assert meta["pixel_mean"] == [float(v) for v in c.INPUT.PIXEL_MEAN]
    assert (meta["min_size_test"], meta["supp_max_size_test"]) == (c.INPUT.MIN_SIZE_TEST,
                                                                   c.INPUT.SUPP_MAX_SIZE_TEST)


def test_artifact_predictor_needs_a_support(served):
    art = copy.copy(served["unfused"])
    art._supp_cache = None
    with pytest.raises(RuntimeError, match="set_support"):
        art.run_on_image(np.zeros((64, 64, 3), np.uint8))


def test_a_cpu_bundle_refuses_the_card(bundles):
    with pytest.raises(ValueError, match="exported on cpu"):
        ArtifactPredictor(bundles["unfused"], device="cuda")


def test_load_compiled_is_none_for_an_absent_package(bundles, tmp_path):
    assert oexport.load_compiled(str(tmp_path / "nothing"), device="cpu") is None
    assert not os.path.exists(bundles["unfused"] + ".support.exec")
    assert oexport.load_compiled(bundles["unfused"] + ".support", device="cpu") is None


def test_load_compiled_is_none_for_another_device(tmp_path):
    stem = str(tmp_path / "x.support")
    with open(stem + ".exec", "wb") as f:
        f.write(b"not opened")
    with open(stem + ".exec.json", "w") as f:
        json.dump({"device": "cuda"}, f)
    assert oexport.load_compiled(stem, device="cpu") is None


@pytest.mark.slow
def test_compiled_round_trip(predictor, tmp_path):
    stem = str(tmp_path / "compiled")
    assert oexport.export_serving(predictor.cfg, predictor.model, stem) is True
    art = ArtifactPredictor(stem, confidence_threshold=-1.0, device="cpu")
    assert art.used_executable is True
    for f in tmp_path.iterdir():
        f.unlink()
    supp, frames = _images()
    predictor.set_support(supp)
    art.set_support(supp)
    for frame in frames:
        (wb, ws), (gb, gs) = predictor.run_on_image(frame), art.run_on_image(frame)
        assert len(gs) == len(ws) > 0
        np.testing.assert_allclose(gs, ws, rtol=SCORE_RTOL, atol=1e-6)
        np.testing.assert_allclose(gb, wb, rtol=BOX_RTOL, atol=1e-3)


# -- the annotated-frame API ------------------------------------------------------

def _boxes(rng, n=6, hw=(120, 160)):
    xy = rng.uniform(-10, [hw[1], hw[0]], (n, 2))
    return np.concatenate([xy, xy + rng.uniform(0.5, 60, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_overlay_boxes_equals_jax(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (120, 160, 3), np.uint8)
    boxes = _boxes(rng)
    want = JaxPredictor.overlay_boxes(None, img, boxes)
    assert np.array_equal(overlay_boxes(img, boxes), want)
    assert np.array_equal(OneShotPredictor.overlay_boxes(None, img, boxes, width=3), want)
    assert not np.array_equal(want, img)


@pytest.mark.parametrize("seed", [0, 1])
def test_overlay_scores_equals_jax(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (120, 160, 3), np.uint8)
    boxes, scores = _boxes(rng), rng.uniform(0, 1, 6).astype(np.float32)
    want = JaxPredictor.overlay_scores(None, img, boxes, scores)
    assert np.array_equal(overlay_scores(img, boxes, scores), want)
    assert np.array_equal(OneShotPredictor.overlay_scores(None, img, boxes, scores), want)
    assert not np.array_equal(want, img)


def test_run_on_opencv_image_draws_the_detections(predictor, served):
    supp, frames = _images(2)
    predictor.set_support(supp)
    bgr = np.ascontiguousarray(frames[0][:, :, ::-1])
    out = predictor.run_on_opencv_image(bgr)
    boxes, scores = predictor.run_on_image(frames[0])
    want = overlay_scores(overlay_boxes(frames[0], boxes), boxes, scores)[:, :, ::-1]
    assert out.shape == bgr.shape and out.dtype == np.uint8
    assert np.array_equal(out, want) and not np.array_equal(out, bgr)
    art = served["unfused"]
    art.set_support(supp)
    assert np.array_equal(art.run_on_opencv_image(bgr), out)
    assert np.array_equal(annotate_bgr(predictor.run_on_image, bgr), out)


def test_run_on_opencv_image_draws_mask_contours(predictor, tmp_path):
    """With MODEL.MASK_ON the annotated frame also carries each detection's
    mask contour, from ``run_on_image(..., return_masks=True)``; the
    serving artifact of that model stays box-only, as the JAX package's.
    The mask head's weights are numpy-seeded as the rest of the fixture's
    (``random_tree``)."""
    masked = predictor.cfg.clone()
    masked.merge_from_list(["MODEL.MASK_ON", True])
    mp = OneShotPredictor(masked, confidence_threshold=-1.0, device="cpu")
    missing, unexpected = mp.model.load_state_dict(predictor.model.state_dict(), strict=False)
    assert not unexpected and missing and all(k.startswith("roi_heads.mask.") for k in missing)
    c = mp.model.config
    net = jmh.MaskHead(num_classes=mp.model.roi_heads.mask.predictor.mask_fcn_logits.out_channels,
                       conv_layers=tuple(c.mask_conv_layers))
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 14, 14, c.out_channels))))
    head = state_dict_from_flax({"params": {"mask_head": random_tree(
        shapes["params"], np.random.RandomState(4))}})
    assert set(head) == set(missing)
    mp.model.load_state_dict(head, strict=False)
    rng = np.random.RandomState(2)
    mp.set_support(rng.randint(0, 255, (40, 52, 3), np.uint8))
    bgr = rng.randint(0, 255, (70, 90, 3), np.uint8)
    rgb = np.ascontiguousarray(bgr[:, :, ::-1])
    boxes, scores, masks = mp.run_on_image(rgb, return_masks=True)
    b2, s2 = mp.run_on_image(rgb)
    assert np.array_equal(boxes, b2) and np.array_equal(scores, s2)
    assert masks.shape == (len(boxes), 28, 28) and masks.dtype == np.float32 and len(boxes)
    want = overlay_scores(overlay_boxes(overlay_mask_contours(rgb, boxes, masks), boxes),
                          boxes, scores)[:, :, ::-1]
    out = mp.run_on_opencv_image(bgr)
    assert np.array_equal(out, want)
    assert not np.array_equal(out, annotate_bgr(mp.run_on_image, bgr))
    with pytest.raises(ValueError, match="MASK_ON"):
        predictor.run_on_image(rgb, return_masks=True)
    support, detect = oexport.export_eval(masked, mp.model, batch=1, kind="cached_support")
    assert not any("mask" in k for k in detect.state_dict)
    assert len(detect.graph_signature.user_outputs) == 3
