"""The port's fused GroupNorm (ops/group_norm.py, models/layers.py::
FusedGroupNorm) against the JAX package's ``pallas_groupnorm``: the plain
forward against the Pallas kernels ``_gn_pallas`` (interpret mode on the
CPU) and against ``group_norm_act``, the gradients of ``GroupNormAct``
against ``jax.grad`` through the JAX custom VJP, the module with flax
weights, and the CPU/CUDA dispatch. Inputs come from a numpy seed; float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from oneshotdet_tpu.models.layers import FusedGroupNorm as FlaxFusedGroupNorm
from oneshotdet_tpu.ops.pallas_groupnorm import _gn_pallas
from oneshotdet_tpu.ops.pallas_groupnorm import group_norm_act as jax_group_norm_act
from oneshotdet_tpu_torch.models.layers import FusedGroupNorm
from oneshotdet_tpu_torch.ops import group_norm as gn
from oneshotdet_tpu_torch.utils.weights import group_norm_params_from_flax

ACTS = [None, "relu", "leaky"]
# One-pass statistics in float32 on both sides; only the order of the sums
# differs. At mean 100, E[x^2] ~ 1e4, so two summation orders of
# E[x^2] - E[x]^2 differ by ~1e-3 and the outputs by ~1e-2: the formula's
# conditioning, not a fault.
ATOL_AT_MEAN = {0.0: 1e-5, 3.0: 5e-5, 100.0: 2e-2}


@pytest.fixture
def interpret(monkeypatch):
    """Pallas kernels run in interpret mode (on the CPU) for one test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, shape=(2, 24, 32, 64), mean=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + mean).astype(np.float32)
    c = shape[-1]
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    return x, gamma, beta


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("mean", sorted(ATOL_AT_MEAN))
@pytest.mark.parametrize("act", ACTS, ids=str)
def test_plain_matches_jax_pallas_kernels(interpret, act, mean):
    x, gamma, beta = _inputs(1, mean=mean)
    ref_y, ref_mean, ref_inv = (np.asarray(v) for v in _gn_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5, act, 0.2))
    y, mean_c, inv_c = gn.group_norm_act_plain(*_t(x, gamma, beta), 32, 1e-5, act, 0.2)
    assert y.shape == x.shape and y.dtype == torch.float32 and mean_c.shape == (2, 64)
    atol = ATOL_AT_MEAN[mean]
    np.testing.assert_allclose(y.numpy(), ref_y, atol=atol, rtol=0)
    np.testing.assert_allclose(mean_c.numpy(), ref_mean, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(inv_c.numpy(), ref_inv, atol=0, rtol=atol)


@pytest.mark.parametrize("shape", [(2, 24, 32, 64), (3, 40, 96), (1, 5, 6, 7, 64)],
                         ids=["NHWC", "NLC", "NDHWC"])
@pytest.mark.parametrize("act", ACTS, ids=str)
def test_group_norm_act_matches_jax(act, shape):
    x, gamma, beta = _inputs(2, shape=shape)
    ref = np.asarray(jax_group_norm_act(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                        32, 1e-5, act, 0.2))
    out = gn.group_norm_act(*_t(x, gamma, beta), 32, 1e-5, act, 0.2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("act", ACTS, ids=str)
def test_gradients_match_jax_custom_vjp(act):
    x, gamma, beta = _inputs(3, shape=(2, 12, 10, 64), mean=0.5)
    cot = np.random.RandomState(4).randn(*x.shape).astype(np.float32)

    def loss(x_, g_, b_):
        return (jax_group_norm_act(x_, g_, b_, 32, 1e-5, act, 0.2) * cot).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    xt, gt, bt = (v.requires_grad_() for v in _t(x, gamma, beta))
    (gn.group_norm_act(xt, gt, bt, 32, 1e-5, act, 0.2) * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((xt.grad, gt.grad, bt.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("act", ["", "relu", "leaky"])
def test_fused_group_norm_loads_flax_weights(act):
    x, _, _ = _inputs(5, shape=(2, 9, 11, 64), mean=1.0)
    flax_gn = FlaxFusedGroupNorm(features=64, act=act, negative_slope=0.2)
    shapes = jax.eval_shape(lambda: flax_gn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(6)
    params = {"scale": (1.0 + 0.1 * rng.randn(64)).astype(np.float32),
              "bias": (0.1 * rng.randn(64)).astype(np.float32)}
    assert {k: v.shape for k, v in shapes["params"].items()} == {k: v.shape for k, v in params.items()}
    ref = np.asarray(flax_gn.apply({"params": params}, jnp.asarray(x)))
    module = FusedGroupNorm(64, act=act, negative_slope=0.2)
    module.load_state_dict(group_norm_params_from_flax(params), strict=True)
    # an NCHW channels-last tensor permuted to NHWC goes in without a copy
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    nhwc = nchw.permute(0, 2, 3, 1)
    assert nhwc.is_contiguous()
    np.testing.assert_allclose(module(nhwc).detach().numpy(), ref, atol=1e-5, rtol=0)
    with pytest.raises(KeyError):
        group_norm_params_from_flax(dict(params, kernel=params["bias"]))


def test_bf16_input_gives_bf16_output_with_f32_statistics():
    x, gamma, beta = _inputs(7, mean=2.0)
    xt, gt, bt = _t(x, gamma, beta)
    y16, mean16, _ = gn.group_norm_act_plain(xt.bfloat16(), gt, bt, 32, 1e-5, "relu", 0.2)
    y32, _, _ = gn.group_norm_act_plain(xt.bfloat16().float(), gt, bt, 32, 1e-5, "relu", 0.2)
    assert y16.dtype == torch.bfloat16 and mean16.dtype == torch.float32
    assert torch.equal(y16, y32.bfloat16())


def test_cpu_tensors_never_launch_and_kernel_wrapper_refuses_them():
    x, gamma, beta = _t(*_inputs(8))
    before = gn.group_norm_launches
    gn.group_norm_act(x, gamma, beta)
    FusedGroupNorm(64, act="leaky")(x)
    assert gn.group_norm_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_act_cuda(x, gamma, beta)
    with pytest.raises(ValueError, match="divisible"):
        gn.group_norm_act_plain(x[..., :48], gamma[:48], beta[:48], num_groups=32)
    with pytest.raises(ValueError, match="act"):
        FusedGroupNorm(64, act="gelu")


@pytest.mark.parametrize("act", ACTS, ids=str)
def test_plain_matches_jax_pallas_kernels_at_narrow_vectors(interpret, act):
    """C = 66 takes the kernels' narrowest thread width (2 channels); 6
    groups of 11 channels."""
    x, gamma, beta = _inputs(11, shape=(3, 13, 19, 66), mean=0.5)
    ref_y, ref_mean, ref_inv = (np.asarray(v) for v in _gn_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 6, 1e-5, act, 0.2))
    y, mean_c, inv_c = gn.group_norm_act_plain(*_t(x, gamma, beta), 6, 1e-5, act, 0.2)
    np.testing.assert_allclose(y.numpy(), ref_y, atol=1e-5, rtol=0)
    np.testing.assert_allclose(mean_c.numpy(), ref_mean, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(inv_c.numpy(), ref_inv, atol=0, rtol=1e-5)


@pytest.mark.parametrize("dtype, offset", [(torch.bfloat16, 1), (torch.bfloat16, 4),
                                           (torch.float32, 2)], ids=["bf16+2B", "bf16+8B", "f32+8B"])
def test_kernel_refuses_misaligned_x_before_any_launch(dtype, offset):
    """An x whose data pointer is not aligned to the kernels' 16-byte load
    vectors (C = 64) is refused by the argument checks that run before any
    launch; the same values at an aligned address pass them."""
    x, gamma, beta = _t(*_inputs(10))
    buf = torch.zeros(x.numel() + offset, dtype=dtype)
    misaligned = buf[offset:].view(x.shape)
    misaligned.copy_(x)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 != 0
    before = gn.group_norm_launches
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        gn.kernel_plan(misaligned, gamma, beta, 32, "relu")
    assert gn.group_norm_launches == before
    assert gn.kernel_plan(x.to(dtype), gamma, beta, 32, "relu") == gn.moments_layout(2, 24 * 32, 64)
    # C = 66 loads 2 channels at a time: 4-byte (bf16) or 8-byte (f32) alignment is enough
    x66, g66, b66 = _t(*_inputs(10, shape=(2, 5, 66)))
    buf = torch.zeros(x66.numel() + 2, dtype=dtype)
    assert gn.kernel_plan(buf[2:].view(x66.shape), g66, b66, 6)[3] == 2


LAYOUT_SPATIAL = [1, 3 * 5, 7 * 10, 13 * 19, 104 * 152]


@pytest.mark.parametrize("channels", [64, 256, 66, 260, 1028, 2046])
@pytest.mark.parametrize("spatial", LAYOUT_SPATIAL)
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_moments_layout_covers_every_row(batch, spatial, channels):
    splits, rows, lanes, cpt = gn.moments_layout(batch, spatial, channels)
    assert splits * rows >= spatial > (splits - 1) * rows
    assert rows >= min(spatial, gn._MIN_LANE_ROWS * lanes)
    assert 1 <= splits <= -(-gn._TARGET_BLOCKS // batch)
    # 8 channels a thread (16-byte vectors in bf16 and f32) where C allows,
    # else 4 or 2
    assert cpt == {64: 8, 256: 8, 66: 2, 260: 4, 1028: 4, 2046: 2}[channels]
    threads = channels // cpt * lanes
    assert threads <= gn._THREADS if lanes > 1 else threads <= 1024
    assert threads > gn._THREADS // 2 or lanes == 1


def _mirror_statistics(x, groups, eps=1e-5):
    """The kernels' statistics in numpy float32, one add at a time: each
    lane's rows of a run, then the lanes (gn_moments' partial sums), then
    the runs in order and each group's channels in order (the image's last
    block)."""
    b, s, c = x.shape
    splits, rows, lanes, _ = gn.moments_layout(b, s, c)
    partial = np.zeros((b, splits, 2, c), np.float32)
    for sp in range(splits):
        for lane in range(lanes):
            a = np.zeros((b, c), np.float32)
            q = np.zeros((b, c), np.float32)
            for row in range(sp * rows + lane, min(s, (sp + 1) * rows), lanes):
                v = x[:, row]
                a = a + v
                q = q + v * v
            partial[:, sp, 0] = partial[:, sp, 0] + a
            partial[:, sp, 1] = partial[:, sp, 1] + q
    s1 = np.zeros((b, c), np.float32)
    s2 = np.zeros((b, c), np.float32)
    for sp in range(splits):
        s1 = s1 + partial[:, sp, 0]
        s2 = s2 + partial[:, sp, 1]
    cpg = c // groups
    g1 = np.zeros((b, groups), np.float32)
    g2 = np.zeros((b, groups), np.float32)
    for i in range(cpg):
        g1 = g1 + s1.reshape(b, groups, cpg)[:, :, i]
        g2 = g2 + s2.reshape(b, groups, cpg)[:, :, i]
    count = np.float32(s * cpg)
    m, m2 = g1 / count, g2 / count
    inv = np.float32(1) / np.sqrt(np.maximum(m2 - m * m, np.float32(0)) + np.float32(eps))
    return np.repeat(m, cpg, axis=1), np.repeat(inv, cpg, axis=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("channels, groups", [(64, 32), (256, 32), (66, 6)],
                         ids=["C64", "C256", "C66"])
@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (13, 19)], ids=["1x1", "3x5", "13x19"])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_plain_statistics_follow_the_kernel_order(batch, hw, channels, groups, dtype):
    """The plain version's statistics equal, bit for bit, the numpy mirror
    of the kernels' summation order, bf16 inputs summed as their float32
    values in the same order."""
    x, gamma, beta = _inputs(9, shape=(batch, *hw, channels), mean=0.3)
    xt = torch.from_numpy(x).to(dtype)
    _, mean_c, inv_c = gn.group_norm_act_plain(xt, *_t(gamma, beta), groups, 1e-5)
    want_mean, want_inv = _mirror_statistics(xt.float().numpy().reshape(batch, -1, channels), groups)
    np.testing.assert_array_equal(mean_c.numpy(), want_mean)
    np.testing.assert_array_equal(inv_c.numpy(), want_inv)


def test_plain_statistics_match_float64():
    """Summed in the kernels' order, the statistics still equal a float64
    reduction to float32 rounding."""
    x, gamma, beta = _inputs(9, shape=(3, 50, 70, 64), mean=0.3)
    _, mean_c, inv_c = gn.group_norm_act_plain(*_t(x, gamma, beta), 32, 1e-5)
    xg = x.astype(np.float64).reshape(3, -1, 32, 2)
    m = xg.mean(axis=(1, 3))
    inv = 1 / np.sqrt((xg * xg).mean(axis=(1, 3)) - m * m + 1e-5)
    np.testing.assert_allclose(mean_c.numpy()[:, ::2], m, atol=2e-6, rtol=0)
    np.testing.assert_allclose(inv_c.numpy()[:, ::2], inv, rtol=2e-5, atol=0)
