"""The port's solver against the JAX package's on the CPU: the
WarmupMultiStep schedule at counts across the warmup and every milestone,
the parameter groups against ``make_param_labels`` by state-dict name, and
two SGD steps on given gradients (per-group learning rate, momentum, weight
decay, frozen stem and layer1 of both backbones) against optax, 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oneshotdet_tpu.solver import make_optimizer as jax_make_optimizer
from oneshotdet_tpu.solver import make_param_labels
from oneshotdet_tpu.solver import warmup_multistep_schedule as jax_schedule
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.solver import (make_lr_scheduler, make_optimizer, param_label,
                                         warmup_multistep_schedule)
from oneshotdet_tpu_torch.utils.weights import map_flax_leaf, state_dict_from_flax
from torch_port_common import make_setup, random_tree, small_cfgs


@pytest.fixture(scope="module")
def setup():
    return make_setup()


COUNTS = [0, 1, 2, 99, 100, 101, 250, 499, 500, 501, 59999, 60000, 60001, 89999, 90000,
          120000, 129999]


@pytest.mark.parametrize("method, factor, iters", [("constant", 1.0 / 3, 100),
                                                   ("linear", 1.0 / 3, 500),
                                                   ("linear", 0.001, 1)])
def test_schedule_matches_jax(method, factor, iters):
    args = (0.0005, (60000, 90000, 120000), 0.1, factor, iters, method)
    port, ref = warmup_multistep_schedule(*args), jax_schedule(*args)
    for count in COUNTS:
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6, err_msg=str(count))


def _leaves(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


@pytest.mark.parametrize("overrides", [(), ("MODEL.BACKBONE.FREEZE_CONV_BODY_AT", 3),
                                       ("FEW_SHOT.UNTRAINED_KEYWORD", ("fcos_head",))],
                         ids=["default", "freeze_at_3", "untrained_fcos"])
def test_param_groups_match_jax_labels(setup, overrides):
    """Each parameter's label equals make_param_labels' for its flax leaf;
    frozen ones need no gradient and are in no group, biases are in the
    bias group at BIAS_LR_FACTOR x BASE_LR and WEIGHT_DECAY_BIAS. The
    untrained keyword is matched against each package's own names, so the
    case names a module under both (the FCOS head)."""
    jcfg, pcfg = small_cfgs(*overrides)
    if overrides and overrides[0] == "FEW_SHOT.UNTRAINED_KEYWORD":
        pcfg.FEW_SHOT.UNTRAINED_KEYWORD = ("rpn.head",)
    labels = make_param_labels(setup["variables"]["params"], jcfg.FEW_SHOT.UNTRAINED_KEYWORD,
                               jcfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT)
    want = {map_flax_leaf("params", path)[0]: label for path, label in _leaves(labels)}
    model = build_detection_model(pcfg, device="cpu")
    got = {n: param_label(n, pcfg.FEW_SHOT.UNTRAINED_KEYWORD,
                          pcfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT)
           for n, _ in model.named_parameters()}
    assert got == want
    assert "frozen" in got.values() and "bias" in got.values()
    opt = make_optimizer(pcfg, model)
    in_group = {id(p): i for i, g in enumerate(opt.param_groups) for p in g["params"]}
    for n, p in model.named_parameters():
        assert p.requires_grad == (got[n] != "frozen")
        assert in_group.get(id(p)) == {"frozen": None, "weight": 0, "bias": 1}[got[n]]
    s = pcfg.SOLVER
    assert opt.param_groups[0]["lr"] == s.BASE_LR
    assert opt.param_groups[1]["lr"] == s.BASE_LR * s.BIAS_LR_FACTOR
    assert opt.param_groups[0]["weight_decay"] == s.WEIGHT_DECAY
    assert opt.param_groups[1]["weight_decay"] == s.WEIGHT_DECAY_BIAS


@pytest.mark.parametrize("overrides", [(), ("SOLVER.WARMUP_METHOD", "linear",
                                            "SOLVER.WARMUP_ITERS", 2,
                                            "SOLVER.WEIGHT_DECAY_BIAS", 0.001,
                                            "SOLVER.BASE_LR", 0.01)],
                         ids=["flagship", "linear_warmup_bias_decay"])
def test_two_sgd_steps_match_optax(setup, overrides):
    """The same parameters and two given gradient trees: the port's SGD and
    LambdaLR leave every parameter where optax does (1e-6)."""
    jcfg, pcfg = small_cfgs(*overrides)
    params = jax.tree_util.tree_map(jnp.asarray, setup["variables"]["params"])
    rng = np.random.RandomState(5)
    grads = [random_tree(setup["variables"]["params"], rng) for _ in range(2)]
    tx, _ = jax_make_optimizer(jcfg, params)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)

    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(setup["state_dict"], strict=True)
    opt = make_optimizer(pcfg, model)
    sched = make_lr_scheduler(pcfg, opt)
    named = dict(model.named_parameters())
    for g in grads:
        for name, value in state_dict_from_flax({"params": g}).items():
            if named[name].requires_grad:
                named[name].grad = value.clone()
        opt.step()
        sched.step()
    want = state_dict_from_flax({"params": params})
    moved = 0
    for name, p in named.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-6, atol=1e-7, err_msg=name)
        moved += not np.array_equal(ref, setup["state_dict"][name].numpy())
    assert 0 < moved < len(named)
