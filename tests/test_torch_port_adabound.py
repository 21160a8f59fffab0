"""The port's AdaBound against the JAX package's optax transform
``oneshotdet_tpu.solver.adabound.adabound`` on the CPU, in float32: five
steps of the same seeded gradients over a few parameter tensors, with and
without weight decay, every parameter within rtol 1e-6; ``amsbound`` is
accepted and changes nothing, as in the JAX transform.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oneshotdet_tpu.solver.adabound import adabound
from oneshotdet_tpu_torch.solver.adabound import AdaBound

SHAPES = [(16, 8), (8,), (3, 3, 4, 5), ()]
STEPS = 5


def run_port(params, grads, **kw):
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = AdaBound(ps, **kw)
    for step in grads:
        for p, g in zip(ps, step):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    return [p.detach().numpy() for p in ps]


def run_optax(params, grads, **kw):
    kw = dict(kw)
    if "betas" in kw:
        kw["b1"], kw["b2"] = kw.pop("betas")
    kw["learning_rate"] = kw.pop("lr")
    tx = adabound(**kw)
    ps = [jnp.asarray(p) for p in params]
    state = tx.init(ps)
    for step in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step], state, ps)
        ps = optax.apply_updates(ps, updates)
    return [np.asarray(p) for p in ps]


def draws(seed=0):
    rng = np.random.RandomState(seed)
    params = [np.asarray(rng.randn(*s), np.float32) for s in SHAPES]
    grads = [[np.asarray(rng.randn(*s) * 10.0 ** rng.randint(-4, 1), np.float32)
              for s in SHAPES] for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3),
    dict(lr=1e-2, weight_decay=1e-4),
    dict(lr=3e-3, betas=(0.8, 0.99), final_lr=0.05, gamma=1e-2, eps=1e-6, weight_decay=5e-4),
], ids=["defaults", "weight_decay", "all_options"])
def test_adabound_matches_optax(kw):
    params, grads = draws()
    ours, ref = run_port(params, grads, **kw), run_optax(params, grads, **kw)
    for a, b, p in zip(ours, ref, params):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        assert not np.array_equal(a, p)


def test_amsbound_is_ignored():
    params, grads = draws(1)
    a = run_port(params, grads, lr=1e-3, amsbound=True)
    b = run_port(params, grads, lr=1e-3)
    ref = run_optax(params, grads, lr=1e-3, amsbound=True)
    for x, y, z in zip(a, b, ref):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(x, z, rtol=1e-6, atol=0)


def test_param_groups_and_missing_grads():
    """Each group's own lr; a parameter without a gradient is left alone."""
    params, grads = draws(2)
    p0, p1 = (torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params[:2])
    opt = AdaBound([{"params": [p0], "lr": 1e-2}, {"params": [p1]}], lr=1e-3)
    p0.grad = torch.from_numpy(grads[0][0].copy())
    opt.step()
    ref = run_optax(params[:1], [grads[0][:1]], lr=1e-2)[0]
    np.testing.assert_allclose(p0.detach().numpy(), ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(p1.detach().numpy(), params[1])
