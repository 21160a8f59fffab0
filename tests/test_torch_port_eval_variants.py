"""The eval forward of the variant heads against the JAX package's on the
CPU, in float32, on the flagship config at test size (batch 2, 64x64
queries, 32x32 supports; tests/test_torch_port_forward.py): linear fusion,
the 'rn' method (with the mse loss: 2 classes, sigmoid scores) and focal with
negative supports (14 predictor columns), each also with the fused head
switched on (its plain version on the CPU; never taken with linear fusion).
Detections at the ground rules' tolerances (score rtol 5e-4, box rtol 1e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu_torch.ops import roi_head_fused as rf
from torch_port_common import (assert_same_detections, compile_fast, jax_build, make_setup, np_,
                               port_model, small_cfgs, state_dict_from_flax, variant_variables)

MODELS = {
    "linear fusion": ["FEW_SHOT.LINEAR_FUSION", True],
    "rn, mse": ["FEW_SHOT.SECOND_STAGE_METHOD", "rn", "FEW_SHOT.SECOND_STAGE_CLS_LOSS",
                "mse_loss"],
    "neg support, focal": ["FEW_SHOT.NEG_SUPPORT.TURN_ON", True,
                           "FEW_SHOT.SECOND_STAGE_CLS_LOSS", "focal_loss"],
}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def references(setup):
    """case -> (JAX variables, JAX detections), computed once per case; the
    setup's weights with the head's other leaves drawn anew."""
    cache = {}

    def get(case):
        if case not in cache:
            jcfg, _ = small_cfgs(*MODELS[case])
            variables = variant_variables(setup["variables"], jcfg)
            jm = jax_build(jcfg)

            def forward(v, images, supports):
                return jm.apply(v, images, supports, target_ids=jnp.array([3, 5]))

            cache[case] = variables, compile_fast(forward, variables, *setup["jax"])(
                variables, *setup["jax"])
        return cache[case]
    return get


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", list(MODELS))
def test_eval_forward_matches_jax(setup, references, case, fused, monkeypatch):
    from oneshotdet_tpu_torch.models import roi_head

    variables, ref = references(case)
    _, pm = port_model(setup, *MODELS[case], state_dict=state_dict_from_flax(variables))
    pm.config = dataclasses.replace(pm.config, fused_roi_head=fused)
    calls = []
    plain = rf.fused_roi_head
    monkeypatch.setattr(roi_head, "fused_roi_head", lambda *a: calls.append(1) or plain(*a))
    out = pm(*setup["port"], target_ids=torch.tensor([3, 5]))
    assert len(calls) == (fused and case != "linear fusion")
    assert out.xyxy.shape == tuple(ref.xyxy.shape)
    assert_same_detections(out, ref)
    np.testing.assert_array_equal(np_(out.fields["labels"]), np.asarray(ref.fields["labels"]))
