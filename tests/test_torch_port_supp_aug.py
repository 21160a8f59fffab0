"""The support augmentation (FEW_SHOT.SUPP_AUG: the avg, max and conv
merges of each shot's 1 + NUM_SUPP_AUG variants) and FCOS's dense points
(MODEL.FCOS.DENSE_POINTS 4 and 5) in the port's eval forward against the
JAX package's on the CPU, in float32, on the flagship config at test size
(batch 2, 64x64 queries, 32x32 supports, each followed by its flip and a
colour change, ``torch_port_common.aug_supports``), with the same seeded
weights: detections at the ground rules' tolerances (score rtol 5e-4, box
rtol 1e-3). Also every merge at 1 and 2 variants and its gradient where
variants tie against JAX's ``_merge_supp_aug``, the dense
locations, the weights of ``supp_aug_conv`` and the wider FCOS head, and
the switches' errors. The train step with these switches is held to JAX in
``tests/test_torch_port_train_{variants,combined,reverse_neg}.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.models.fcos import compute_locations as jax_compute_locations
from oneshotdet_tpu.structures import ImageBatch as JaxImageBatch
from oneshotdet_tpu.utils.torch_export import export_state_dict
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.models.detector import DetectorConfig, GeneralizedRCNN
from oneshotdet_tpu_torch.models.fcos import compute_locations
from oneshotdet_tpu_torch.structures import ImageBatch
from torch_port_common import (assert_same_detections, aug_supports, compile_fast, jax_build,
                               make_setup, np_, small_cfgs, state_dict_from_flax, supp_aug_of, t,
                               variant_variables)


def aug(method, n):
    return ["FEW_SHOT.SUPP_AUG", True, "FEW_SHOT.NUM_SUPP_AUG", n,
            "FEW_SHOT.SUPP_AUG_METHOD", method]


# the eval forward: each merge once, 1 and 2 variants, 4 and 5 dense points
# (each case is one JAX compile; every merge at 1 and 2 variants is held to
# JAX's ``_merge_supp_aug`` below, and the train step takes the others)
MODELS = {
    "avg, 1 aug": aug("avg", 1),
    "max, 2 augs, dense points 5": aug("max", 2) + ["MODEL.FCOS.DENSE_POINTS", 5],
    "conv, 2 augs, dense points 4": aug("conv", 2) + ["MODEL.FCOS.DENSE_POINTS", 4],
}
WEIGHTS = {"conv, 1 aug": aug("conv", 1), **MODELS}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _supports(setup, overrides):
    """The setup's supports with their variants: numpy (pixels, sizes)."""
    _, js = setup["jax"]
    return aug_supports(np.asarray(js.pixels), np.asarray(js.sizes), supp_aug_of(overrides))


@pytest.fixture(scope="module")
def references(setup):
    """case -> (JAX variables, JAX detections), computed once per case."""
    cache = {}

    def get(case):
        if case not in cache:
            jcfg, _ = small_cfgs(*MODELS[case])
            variables = variant_variables(setup["variables"], jcfg)
            jm = jax_build(jcfg)
            pixels, sizes = _supports(setup, MODELS[case])
            supp = JaxImageBatch(jnp.asarray(pixels), jnp.asarray(sizes))

            def forward(v, images, supports):
                return jm.apply(v, images, supports, target_ids=jnp.array([3, 5]))

            args = (variables, setup["jax"][0], supp)
            cache[case] = variables, compile_fast(forward, *args)(*args)
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(MODELS))
def test_eval_forward_matches_jax(setup, references, case):
    variables, ref = references(case)
    _, pcfg = small_cfgs(*MODELS[case])
    pm = build_detection_model(pcfg, device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    pixels, sizes = _supports(setup, MODELS[case])
    out = pm(setup["port"][0], ImageBatch(t(pixels), t(sizes)), target_ids=torch.tensor([3, 5]))
    assert out.xyxy.shape == tuple(ref.xyxy.shape)
    assert_same_detections(out, ref)
    np.testing.assert_array_equal(np_(out.fields["labels"]), np.asarray(ref.fields["labels"]))


@pytest.mark.parametrize("num_aug", [1, 2], ids=["1 aug", "2 augs"])
@pytest.mark.parametrize("method", ["avg", "max", "conv"])
def test_merge_and_its_gradient_match_jax_where_variants_tie(method, num_aug):
    """Every merge with 1 and 2 augmented variants, on two supports whose
    variants agree on a region (the padding of a support bucket is the
    same in every variant): the merged features and their gradient per
    variant against JAX's ``_merge_supp_aug`` (conv: ``supp_aug_conv`` with
    the same kernel, its gradient too); ``amax`` splits a tie's gradient
    equally, as ``jnp.max`` does (``torch.max(dim)`` would give it all to
    one variant)."""
    from oneshotdet_tpu_torch.models.layers import Conv2d

    a, c = 1 + num_aug, 256
    rng = np.random.RandomState(3 + num_aug)
    f = rng.randn(2 * a, 5, 7, c).astype(np.float32)          # NHWC
    for k in range(2):
        f[a * k + 1:a * (k + 1), :, 4:] = f[a * k, :, 4:]      # the shared padded columns
    w = rng.randn(2, 5, 7, c).astype(np.float32)
    kernel = (rng.randn(3, 3, a * c, c) / np.sqrt(9 * a * c)).astype(np.float32)
    params = {"supp_aug_conv": {"kernel": jnp.asarray(kernel)}} if method == "conv" else {}
    jcfg, _ = small_cfgs(*aug(method, num_aug))
    jm = jax_build(jcfg)

    def jax_loss(x, p):
        merged = jm.apply({"params": p}, [x], method=lambda m, fs: m._merge_supp_aug(fs))[0]
        return jnp.sum(merged * w), merged

    (_, ref), (ref_grad, ref_kgrad) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(f), params)
    model = types.SimpleNamespace(config=DetectorConfig(
        out_channels=c, supp_aug=True, num_supp_aug=num_aug, supp_aug_method=method))
    if method == "conv":
        model.supp_aug_conv = Conv2d(a * c, c, 3, padding=1, bias=False)
        with torch.no_grad():
            model.supp_aug_conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    x = torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_(True)   # channels_last NCHW
    merged = GeneralizedRCNN._merge_supp_aug(model, [x])[0]
    assert merged.shape == (2, c, 5, 7)
    assert merged.is_contiguous(memory_format=torch.channels_last)
    (merged.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5) if method == "conv" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(merged.permute(0, 2, 3, 1)), np.asarray(ref), **tol)
    grad = np_(x.grad.permute(0, 2, 3, 1))
    np.testing.assert_allclose(grad, np.asarray(ref_grad), **tol)
    if method == "conv":
        np.testing.assert_allclose(np_(model.supp_aug_conv.weight.grad).transpose(2, 3, 1, 0),
                                   np.asarray(ref_kgrad["supp_aug_conv"]["kernel"]), **tol)
    if method == "max":     # a tie's gradient shared by the support's variants
        np.testing.assert_allclose(grad[0, :, 4:], w[0, :, 4:] / a, rtol=1e-6)


def test_dense_locations_equal_jax():
    """JAX's golden case (tests/test_fcos_extras.py) and odd maps: the
    sub-point index varies fastest; other counts raise ValueError."""
    d4 = compute_locations([(2, 2)], [8], dense_points=4)[0]
    np.testing.assert_array_equal(d4[:4].numpy(), [[2, 2], [6, 2], [2, 6], [6, 6]])
    assert tuple(compute_locations([(2, 2)], [8], dense_points=5)[0][2]) == (4, 4)
    shapes, strides = [(2, 2), (3, 5), (1, 1)], [8, 16, 128]
    for dp in (1, 4, 5):
        for p, r in zip(compute_locations(shapes, strides, dense_points=dp),
                        jax_compute_locations(shapes, strides, dp)):
            assert p.dtype == torch.float32
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    for dp in (2, 3):
        with pytest.raises(ValueError, match="dense points"):
            compute_locations(shapes, strides, dense_points=dp)
        with pytest.raises(ValueError, match="dense points"):
            jax_compute_locations(shapes, strides, dp)


@pytest.mark.parametrize("case", ["conv, 1 aug", "conv, 2 augs, dense points 4",
                                  "max, 2 augs, dense points 5"])
def test_weights_carry_over_and_load_strictly(setup, case):
    """``state_dict_from_flax`` equals JAX's ``export_state_dict`` on every
    key JAX maps, adds ``supp_aug_conv.weight`` (HWIO -> OIHW, input
    channels variant-major), which JAX's exporter skips, and loads strictly
    with the FCOS head at DENSE_POINTS values per cell."""
    jcfg, pcfg = small_cfgs(*WEIGHTS[case])
    variables = variant_variables(setup["variables"], jcfg)
    ref, _, skipped = export_state_dict(variables)
    mine = state_dict_from_flax(variables)
    conv = jcfg.FEW_SHOT.SUPP_AUG_METHOD == "conv"
    assert skipped == (["params/supp_aug_conv/kernel"] if conv else [])
    assert set(mine) == set(ref) | ({"supp_aug_conv.weight"} if conv else set())
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    if conv:
        kernel = np.asarray(variables["params"]["supp_aug_conv"]["kernel"])
        a = 1 + jcfg.FEW_SHOT.NUM_SUPP_AUG
        assert mine["supp_aug_conv.weight"].shape == (256, a * 256, 3, 3)
        np.testing.assert_array_equal(mine["supp_aug_conv.weight"].numpy(),
                                      kernel.transpose(3, 2, 0, 1))
    port = build_detection_model(pcfg, device="cpu")
    port.load_state_dict(mine, strict=True)
    dp = jcfg.MODEL.FCOS.DENSE_POINTS
    head = port.rpn.head
    assert (head.cls_logits.out_channels, head.bbox_pred.out_channels,
            head.centerness.out_channels) == (dp, 4 * dp, dp)


def test_bad_switches_raise(setup):
    """A support count that is not a whole number of variant groups, and
    an unknown merge method, raise ValueError (JAX: in its reshape, and
    ValueError)."""
    _, pcfg = small_cfgs(*aug("avg", 2))
    pm = build_detection_model(pcfg, device="cpu")
    with pytest.raises(ValueError, match="NUM_SUPP_AUG"):
        pm.compute_support_features(setup["port"][1], 1)
    _, pcfg = small_cfgs(*aug("median", 1))
    pm = build_detection_model(pcfg, device="cpu")
    pixels, sizes = _supports(setup, aug("median", 1))
    with pytest.raises(ValueError, match="median"):
        pm.compute_support_features(ImageBatch(t(pixels), t(sizes)), 2)
