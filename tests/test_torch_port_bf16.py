"""The oneshotdet_tpu_torch eval forward against the JAX package in bf16, the
flagship's compute dtype, at the test size of tests/torch_port_common.py.

The two packages round to bf16 at different places, so their detections
cannot agree to the float32 tolerances. The yardstick is measured in the
same run: the JAX package's own drift between its bf16 and float32
forwards on the same weights and inputs. Matched detections (best IoU at
least 0.9) of the port and JAX in bf16 must agree within twice that drift,
in score and in box coordinates.
"""

import numpy as np
import pytest
import torch

from torch_port_common import _iou, make_setup, np_, port_model

MIN_IOU = 0.9
MIN_MATCHED = 0.9     # share of the reference's detections with a partner


def _dets(d, i):
    v = np_(d.valid[i])
    return (np_(d.xyxy[i]).astype(np.float32)[v],
            np_(d.fields["scores"][i]).astype(np.float32)[v])


def _gaps(ref, other):
    """Over both images: the share of ``ref``'s detections whose best-IoU
    partner in ``other`` has IoU >= MIN_IOU, and the largest score and box
    coordinate differences of those pairs."""
    matched, total, score, box = 0, 0, 0.0, 0.0
    for i in range(ref.valid.shape[0]):
        (rb, rs), (ob, os_) = _dets(ref, i), _dets(other, i)
        assert len(rb) == len(ob) > 0
        for b, s in zip(rb, rs):
            iou = _iou(b, ob)
            j = int(np.argmax(iou))
            total += 1
            if iou[j] >= MIN_IOU:
                matched += 1
                score = max(score, float(abs(os_[j] - s)))
                box = max(box, float(np.abs(ob[j] - b).max()))
    return matched / total, score, box


@pytest.fixture(scope="module")
def forwards():
    setup = make_setup()
    jax_bf16, port_bf16 = port_model(setup, "TPU.COMPUTE_DTYPE", "bfloat16")
    jax_f32, _ = port_model(setup)
    assert port_bf16.dtype == torch.bfloat16
    return (jax_f32.apply(setup["variables"], *setup["jax"]),
            jax_bf16.apply(setup["variables"], *setup["jax"]),
            port_bf16(*setup["port"]))


def test_bf16_forward_matches_jax_within_its_own_bf16_drift(forwards):
    jax_f32, jax_bf16, port_bf16 = forwards
    assert port_bf16.xyxy.shape == tuple(jax_bf16.xyxy.shape)
    drift_share, drift_score, drift_box = _gaps(jax_f32, jax_bf16)
    share, score, box = _gaps(jax_bf16, port_bf16)
    # the yardstick is real: bf16 moves JAX's own detections
    assert drift_share >= MIN_MATCHED and drift_score > 0 and drift_box > 0
    assert share >= MIN_MATCHED
    assert score <= 2 * drift_score, (score, drift_score)
    assert box <= 2 * drift_box, (box, drift_box)
