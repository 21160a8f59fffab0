"""The oneshotdet_tpu_torch streaming predictor against the JAX package's on
the CPU: the resize rule, on-device preprocessing (antialiased bilinear when
an axis shrinks) and one frame through set_support + run_on_image, with the
same seeded weights on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.data.transforms import get_resize_size as jax_get_resize_size
from oneshotdet_tpu.models import build_detection_model as jax_build
from oneshotdet_tpu.predictor import OneShotPredictor as JaxPredictor
from oneshotdet_tpu.predictor import preprocess_frame as jax_preprocess_frame
from oneshotdet_tpu.structures import ImageBatch as JaxImageBatch
from oneshotdet_tpu_torch.data.transforms import get_resize_size
from oneshotdet_tpu_torch.predictor import OneShotPredictor, _select_threshold, preprocess_frame
from oneshotdet_tpu_torch.utils.weights import state_dict_from_flax
from torch_port_common import random_variables, small_cfgs

MEAN, STD = [102.9801, 115.9465, 122.7717], [1.0, 1.0, 1.0]


@pytest.mark.parametrize("wh, min_size, max_size", [
    ((640, 480), 800, 1333), ((480, 640), 800, 1333), ((1200, 300), 800, 1200),
    ((400, 300), 200, 400), ((131, 97), 64, 96), ((800, 800), 800, 1333), ((50, 2000), 32, 48),
])
def test_get_resize_size_matches_jax(wh, min_size, max_size):
    assert get_resize_size(wh, min_size, max_size) == jax_get_resize_size(wh, min_size, max_size)


@pytest.mark.parametrize("in_hw", [(50, 60), (50, 300), (200, 60), (416, 416), (800, 1200)],
                         ids=["shrink", "shrink_h_grow_w", "grow_h_shrink_w", "grow", "grow_large"])
@pytest.mark.parametrize("to_bgr255", [True, False])
def test_preprocess_frame_matches_jax(in_hw, to_bgr255):
    img = np.random.RandomState(0).randint(0, 256, (97, 131, 3)).astype(np.uint8)
    out_hw = (in_hw[0] + 8, in_hw[1] + 24)
    ref = np.asarray(jax_preprocess_frame(jnp.asarray(img), in_hw, out_hw, jnp.asarray(MEAN),
                                          jnp.asarray(STD), to_bgr255))
    out = preprocess_frame(torch.from_numpy(img), in_hw, out_hw, MEAN, STD, to_bgr255)
    assert out.shape == (*out_hw, 3) and out.dtype == torch.float32
    # bilinear weights are summed in another order: within 1e-3 on the 0-255
    # scale, or float32 resolution at |mean| ~ 100 after the 1/255 scaling
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3 if to_bgr255 else 1e-5, rtol=0)


def test_select_threshold():
    assert _select_threshold(0.3, 5) == pytest.approx(0.3)
    vec = np.linspace(0, 1, 21)
    assert _select_threshold(vec, 4) == pytest.approx(0.2)
    with pytest.raises(IndexError):
        _select_threshold(vec, 21)


PRED_OVERRIDES = (
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 50, "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 16,
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 8, "TPU.NMS_PRE_TOPK", 128,
    "TPU.QUERY_BUCKETS", ((96, 128),), "TPU.SUPP_BUCKET", (64, 64),
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "INPUT.SUPP_MIN_SIZE_TEST", 32, "INPUT.SUPP_MAX_SIZE_TEST", 48, "TPU.HOST_S2D", False,
)


@pytest.fixture(scope="module")
def predictors():
    jcfg, pcfg = small_cfgs(*PRED_OVERRIDES)
    small = JaxImageBatch(pixels=jnp.zeros((1, 64, 64, 3)), sizes=jnp.array([[64.0, 64.0]]))
    variables = random_variables(jax_build(jcfg), (small, small))
    jax_pred = JaxPredictor(jcfg, variables, confidence_threshold=-1.0)
    port_pred = OneShotPredictor(pcfg, state_dict_from_flax(variables),
                                 confidence_threshold=-1.0, device="cpu")
    return jax_pred, port_pred


def test_run_on_image_matches_jax(predictors):
    jax_pred, port_pred = predictors
    rng = np.random.RandomState(0)
    supp = rng.randint(0, 255, (40, 52, 3), np.uint8)
    frame = rng.randint(0, 255, (100, 150, 3), np.uint8)
    jax_pred.set_support(supp)
    port_pred.set_support(supp)
    ref_boxes, ref_scores = jax_pred.run_on_image(frame)
    boxes, scores = port_pred.run_on_image(frame)
    assert boxes.shape == ref_boxes.shape and len(scores) > 0
    # both sorted by descending score; seeded weights leave no near-ties
    np.testing.assert_allclose(scores, ref_scores, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(boxes, ref_boxes, rtol=1e-3, atol=1e-3)
    assert boxes[:, [0, 2]].max() <= 150 and boxes[:, [1, 3]].max() <= 100


def test_run_on_image_needs_a_support(predictors):
    _, port_pred = predictors
    fresh = OneShotPredictor(port_pred.cfg, port_pred.model.state_dict(), device="cpu")
    with pytest.raises(RuntimeError, match="set_support"):
        fresh.run_on_image(np.zeros((64, 64, 3), np.uint8))
