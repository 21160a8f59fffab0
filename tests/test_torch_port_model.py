"""The oneshotdet_tpu_torch detector's parts against the JAX package on the
CPU, in float32, on the flagship config at test size (batch 2, 64x64
queries, 32x32 supports): weight carry-over, backbone+FPN, support features,
and the config switches that are not ported. Both sides get the same seeded
numpy weights (tests/torch_port_common.py).
"""

import numpy as np
import pytest
import torch

from oneshotdet_tpu.models import build_detection_model as jax_build
from oneshotdet_tpu.utils.torch_export import export_state_dict
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.utils.weights import state_dict_from_flax
from torch_port_common import make_setup, np_, port_model, random_variables, small_cfgs


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def test_state_dict_from_flax_equals_export_and_loads_strictly(setup):
    ref, _, skipped = export_state_dict(setup["variables"])
    mine = setup["state_dict"]
    assert not skipped
    assert set(mine) == set(ref)
    for k, v in ref.items():
        assert mine[k].dtype == torch.float32
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    _, pcfg = small_cfgs()
    port = build_detection_model(pcfg, device="cpu")
    assert set(port.state_dict()) == set(ref)
    port.load_state_dict(mine, strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(v, mine[k]), k


def test_backbone_features_match_jax(setup):
    jm, pm = port_model(setup)
    jq, _ = setup["jax"]
    ref = jm.apply(setup["variables"], jq, method=lambda m, b: m.backbone_features(b))
    out = pm.backbone_features(setup["port"][0])
    assert len(out) == 5
    for p, r in zip(out, ref):
        assert p.is_contiguous(memory_format=torch.channels_last)
        r = np.asarray(r)
        np.testing.assert_allclose(np_(p.permute(0, 2, 3, 1)), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("supp_roialign", [True, False])
def test_support_features_match_jax(setup, supp_roialign):
    """1x1 pooling by ROIAlign over the whole support, or the spatial mean."""
    jm, pm = port_model(setup, "FEW_SHOT.SUPP_ROIALIGN", supp_roialign)
    _, js = setup["jax"]
    ref_pooled, ref_7x7 = jm.apply(setup["variables"], js, 2,
                                   method=lambda m, b, n: m.compute_support_features(b, n))
    pooled, s7 = pm.compute_support_features(setup["port"][1], 2)
    assert s7.shape == (2, 1, 7, 7, 256)
    for p, r in zip(list(pooled) + [s7], list(ref_pooled) + [ref_7x7]):
        r = np.asarray(r)
        np.testing.assert_allclose(np_(p), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


def test_backbone_p6_from_c5_matches_jax(setup):
    """MODEL.RETINANET.USE_C5 (the default): P6 from C5 instead of P5."""
    jcfg, pcfg = small_cfgs("MODEL.RETINANET.USE_C5", True)
    jm = jax_build(jcfg)
    variables = random_variables(jm, setup["jax"], seed=2)
    pm = build_detection_model(pcfg, device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    ref = jm.apply(variables, setup["jax"][0], method=lambda m, b: m.backbone_features(b))
    out = pm.backbone_features(setup["port"][0])
    for p, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np_(p.permute(0, 2, 3, 1)), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("switch", [
    ("FEW_SHOT.SUPP_AUG", True), ("FEW_SHOT.NEG_SUPPORT.TURN_ON", True),
    ("FEW_SHOT.LINEAR_FUSION", True), ("MODEL.MASK_ON", True),
    ("MODEL.KEYPOINT_ON", True), ("MODEL.FCOS_ON", False), ("TPU.QUANT", "int8"),
])
def test_unported_switches_raise(switch):
    _, pcfg = small_cfgs(*switch)
    with pytest.raises(NotImplementedError, match=switch[0]):
        build_detection_model(pcfg, device="cpu")


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pcfg = small_cfgs()
    with pytest.raises((RuntimeError, AssertionError)):
        build_detection_model(pcfg)
