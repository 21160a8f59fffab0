"""One config of several training variants (soft transLinear labels, the
cxe class loss, the reverse-order pass, linear fusion and the support
augmentation's max merge of a support and its flip, both cut inside their
bucket so that their padding ties) against the JAX
package on the CPU (float32, the test size and seeded weights of
``tests/test_torch_port_train.py``): ``forward_train``'s losses within rtol
5e-4 and every parameter's gradient within 1e-4 relative norm of
``jax.value_and_grad`` on JAX's own sampling draws, and two ``train_step``s
against two steps of JAX's ``make_train_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.engine.trainer import create_train_state, make_train_step
from oneshotdet_tpu.solver import make_optimizer as jax_make_optimizer
from oneshotdet_tpu_torch.engine import train_step
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.solver import make_lr_scheduler, make_optimizer
from torch_port_common import (LOSS_RTOL, TrainVariants, capture_head_kinks, compile_fast,
                               head_kinks_as_jax, jax_sampling_draws, jax_train_inputs,
                               small_cfgs, state_dict_from_flax, train_proposal_count)

COMBINED = ["FEW_SHOT.SOFT_LABELING", True, "FEW_SHOT.SOFT_LABELING_FUNC", "transLinear",
            "FEW_SHOT.SECOND_STAGE_CLS_LOSS", "cxe_loss", "FEW_SHOT.REVERSE_ORDER", True,
            "FEW_SHOT.LINEAR_FUSION", True, "FEW_SHOT.SUPP_AUG", True,
            "FEW_SHOT.NUM_SUPP_AUG", 1, "FEW_SHOT.SUPP_AUG_METHOD", "max"]
KEYS = {"loss_cls", "loss_reg", "loss_centerness", "loss_classifier", "loss_box_reg",
        "loss_reverse"}


@pytest.fixture(scope="module")
def variants():
    return TrainVariants()


def test_losses_match_jax(variants):
    variants.check_losses(COMBINED, keys=KEYS)


def test_gradients_match_jax(variants):
    variants.check_grads(COMBINED)


def test_two_train_steps_match_jax(variants):
    """The combined config (soft transLinear labels, cxe, reverse order,
    linear fusion, the max merge): JAX's make_train_step folds the step count into its rng,
    the port's train_step takes the draws that rng gives. Losses of both
    steps within rtol 5e-4; every parameter within 1e-6 of JAX's after the
    two steps and its update within 1e-3 of the update's norm plus two
    float32 spacings, as in ``tests/test_torch_port_train.py``; the head's
    kinks at JAX's branch where within rounding of 0, JAX's pre-activations
    taken at each step's parameters."""
    jcfg, pcfg = small_cfgs(*COMBINED)
    jm, variables = variants.weights(COMBINED)
    tx, _ = jax_make_optimizer(jcfg, variables["params"])
    state = create_train_state(jm, tx, variables)
    episodes = [variants.batch(k, COMBINED) for k in range(2)]
    batches = [{n: jnp.asarray(v) for n, v in b.items()} for b in episodes]
    step = compile_fast(make_train_step(jm, tx), state, batches[0], variants.rng)

    def kinks_at(params, batch, rng):
        _, inter = jm.apply({"params": params, "constants": variables["constants"]},
                            *jax_train_inputs(batch), train=True, rng=rng,
                            capture_intermediates=capture_head_kinks, mutable=["intermediates"])
        return inter["intermediates"]["roi_head"]

    kinks_at = compile_fast(kinks_at, state.params, episodes[0], variants.rng)
    ref_metrics, kinks = [], []
    for k, batch in enumerate(episodes):
        inter = kinks_at(state.params, batch, jax.random.fold_in(variants.rng, k))
        kinks.append({n: [np.asarray(x) for x in c["__call__"]] for n, c in inter.items()})
        state, m = step(state, batches[k], variants.rng)
        ref_metrics.append({n: float(v) for n, v in m.items()})
    ref = state_dict_from_flax({"params": state.params})
    start = state_dict_from_flax(variables)

    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(start, strict=True)
    model.train()
    opt = make_optimizer(pcfg, model)
    sched = make_lr_scheduler(pcfg, opt)
    n = train_proposal_count(pcfg)
    for k, batch in enumerate(episodes):
        draws = jax_sampling_draws(jax.random.fold_in(variants.rng, k), n)
        with head_kinks_as_jax(model.roi_heads.box, kinks[k]):
            metrics = train_step(model, opt, sched, batch, draws=draws)
        assert "loss_reverse" in metrics
        for name, want in ref_metrics[k].items():
            np.testing.assert_allclose(float(metrics[name]), want, rtol=LOSS_RTOL,
                                       err_msg=f"step {k}: {name}")
    n_moved = 0
    for name, p in model.named_parameters():
        want = ref[name]
        np.testing.assert_allclose(p.detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        moved = (want - start[name]).norm()
        n_moved += float(moved) > 0
        rounding = torch.from_numpy(2 * np.spacing(np.abs(want.numpy()))).norm()
        assert float((p.detach() - want).norm()) <= 1e-3 * float(moved) + float(rounding), name
    assert n_moved > 150
