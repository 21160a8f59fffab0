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
from torch_port_common import (compile_fast, make_setup, np_, port_model, random_variables,
                               small_cfgs)


def jax_fast(fn, *args):
    """``fn(*args)``, jitted with FAST_COMPILE (XLA's LLVM optimizations off)."""
    return compile_fast(fn, *args)(*args)


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
    ref = jax_fast(lambda v, b: jm.apply(v, b, method=lambda m, b_: m.backbone_features(b_)),
                   setup["variables"], jq)
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
    ref_pooled, ref_7x7 = jax_fast(lambda v, b: jm.apply(
        v, b, method=lambda m, b_: m.compute_support_features(b_, 2)), setup["variables"], js)
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
    ref = jax_fast(lambda v, b: jm.apply(v, b, method=lambda m, b_: m.backbone_features(b_)),
                   variables, setup["jax"][0])
    out = pm.backbone_features(setup["port"][0])
    for p, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np_(p.permute(0, 2, 3, 1)), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("switch", [("MODEL.FCOS_ON", False, "MODEL.RETINANET_ON", True,
                                     "TPU.QUANT", "int8")])
def test_unported_switches_raise(switch):
    """Every switch of the JAX package's entry points is ported: RetinaNet
    under TPU.QUANT, the last one that raised, builds with int8 towers
    (held to JAX in ``test_torch_port_retinanet_quant.py``)."""
    from oneshotdet_tpu_torch.ops.quant import QuantConv2d

    _, pcfg = small_cfgs(*switch)
    model = build_detection_model(pcfg, device="cpu")
    assert isinstance(model.rpn.head.cls_tower[0], QuantConv2d)


@pytest.mark.parametrize("switch,head", [("MODEL.MASK_ON", "mask"),
                                         ("MODEL.KEYPOINT_ON", "keypoint")])
def test_mask_keypoint_switches_build_their_head(switch, head):
    """MASK_ON and KEYPOINT_ON build their head (held to JAX in
    ``test_torch_port_mask_keypoint.py``)."""
    _, pcfg = small_cfgs(switch, True)
    model = build_detection_model(pcfg, device="cpu")
    assert hasattr(model.roi_heads, head)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pcfg = small_cfgs()
    with pytest.raises((RuntimeError, AssertionError)):
        build_detection_model(pcfg)


@pytest.mark.parametrize("mean", [0.0, 3.0])
def test_group_norm_matches_flax(mean):
    """The port's GroupNorm (``F.group_norm``, the FCOS towers' and the unfused
    head's) against flax ``nn.GroupNorm`` (the one-pass variance
    max(E[x^2] - E[x]^2, 0) in float32), 32 groups, eps 1e-5, at its initial
    scale and bias: they differ by the one-pass formula's float32 rounding in
    XLA's summation order, which grows with the input mean (a deviation the
    port keeps, ROADMAP); within 1e-4 at means 0 and 3."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from oneshotdet_tpu_torch.models.layers import GroupNorm

    x = (np.random.RandomState(17).randn(2, 13, 19, 256) + mean).astype(np.float32)
    flax_gn = fnn.GroupNorm(num_groups=32, epsilon=1e-5)
    params = flax_gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(flax_gn.apply(params, jnp.asarray(x)))
    port = GroupNorm(32, 256, eps=1e-5)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
