"""The oneshotdet_tpu_torch eval forward against the JAX package on the CPU,
in float32, on the flagship config at test size (batch 2, 64x64 queries,
32x32 supports): detections in both stage-1 top-k modes, with EVAL_ROI_TOPK,
with two shots, RPN_ONLY proposals, and the cached-support entry point.
Both sides get the same seeded numpy weights (tests/torch_port_common.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.structures import ImageBatch as JaxImageBatch
from oneshotdet_tpu_torch.structures import ImageBatch
from torch_port_common import assert_same_detections, make_setup, np_, port_model, t


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("overrides", [
    (),                                         # global NMS_PRE_TOPK cap
    ("TPU.STRICT_LEVEL_TOPK", True),            # per-level pre-NMS top-k
    ("TPU.EVAL_ROI_TOPK", 16),                  # stage 2 on the top 16 proposals
], ids=["global_topk", "strict_level_topk", "eval_roi_topk16"])
def test_eval_forward_matches_jax(setup, overrides):
    jm, pm = port_model(setup, *overrides)
    ref = jm.apply(setup["variables"], *setup["jax"], target_ids=jnp.array([3, 5]))
    out = pm(*setup["port"], target_ids=torch.tensor([3, 5]))
    assert out.xyxy.shape == tuple(ref.xyxy.shape)
    assert_same_detections(out, ref)
    np.testing.assert_array_equal(np_(out.fields["labels"]), np.asarray(ref.fields["labels"]))


def test_two_shot_eval_forward_matches_jax(setup):
    """Two supports per image: shot-averaged fusion and the max-merge of the
    per-shot head outputs."""
    jm, pm = port_model(setup)
    rng = np.random.RandomState(1)
    s = rng.randn(4, 32, 32, 3).astype(np.float32)
    ss = np.array([[32.0, 32.0], [24.0, 32.0], [32.0, 24.0], [20.0, 28.0]], np.float32)
    jq, _ = setup["jax"]
    ref = jm.apply(setup["variables"], jq, JaxImageBatch(jnp.asarray(s), jnp.asarray(ss)))
    out = pm(setup["port"][0], ImageBatch(t(s), t(ss)))
    assert_same_detections(out, ref)


def test_rpn_only_proposals_match_jax(setup):
    stage1 = {k: v for k, v in setup["state_dict"].items() if not k.startswith("roi_heads.")}
    jm, pm = port_model(setup, "MODEL.RPN_ONLY", True, "TEST.DETECTIONS_PER_IMG", 50,
                     state_dict=stage1)
    variables = {"params": {k: v for k, v in setup["variables"]["params"].items()
                            if k != "roi_head"},
                 "constants": setup["variables"]["constants"]}
    ref = jm.apply(variables, *setup["jax"])
    out = pm(*setup["port"])
    assert out.xyxy.shape == (2, 50, 4)
    assert_same_detections(out, ref)


def test_detect_with_cached_support_matches_forward(setup):
    _, pm = port_model(setup)
    q, s = setup["port"]
    pooled, s7 = pm.compute_support_features(s, 2)
    cached = pm.detect_with_support(q, pooled, s7)
    full = pm(q, s)
    for a, b in ((cached.xyxy, full.xyxy), (cached.valid, full.valid),
                 (cached.fields["scores"], full.fields["scores"])):
        assert torch.equal(a, b)
