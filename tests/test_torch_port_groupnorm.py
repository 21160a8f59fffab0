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


@pytest.mark.parametrize("batch, spatial, channels",
                         [(8, 104 * 152, 256), (8, 7 * 10, 256), (1, 3, 64), (64, 4096, 2048)])
def test_moments_layout_covers_every_row(batch, spatial, channels):
    splits, rows, lanes = gn.moments_layout(batch, spatial, channels)
    assert splits * rows >= spatial > (splits - 1) * rows
    assert rows >= min(16, spatial)
    assert 1 <= (channels // 2) * lanes <= 1024


def test_plain_statistics_follow_the_kernel_order():
    """Summed in the kernels' order, the statistics still equal a float64
    reduction to float32 rounding."""
    x, gamma, beta = _inputs(9, shape=(3, 50, 70, 64), mean=0.3)
    _, mean_c, inv_c = gn.group_norm_act_plain(*_t(x, gamma, beta), 32, 1e-5)
    xg = x.astype(np.float64).reshape(3, -1, 32, 2)
    m = xg.mean(axis=(1, 3))
    inv = 1 / np.sqrt((xg * xg).mean(axis=(1, 3)) - m * m + 1e-5)
    np.testing.assert_allclose(mean_c.numpy()[:, ::2], m, atol=2e-6, rtol=0)
    np.testing.assert_allclose(inv_c.numpy()[:, ::2], inv, rtol=2e-5, atol=0)
