"""The port's train forward with the training variants against the JAX
package's on the CPU, in float32, at the test size of
``tests/test_torch_port_train.py`` with the same seeded weights and JAX's own
draws (the sampling uniforms of ``fold_in(rng, 1)`` and the artificial
jitters of ``fold_in(rng, 3)``): the losses within rtol 5e-4 and every
parameter's gradient within 1e-4 relative norm of ``jax.value_and_grad``.
Two configs that between them take artificial proposals, remat, the
discrete and linear soft labels, the mse and l1 class losses, the 'rn'
method (2 classes, 3 regression slots), FCOS's dense points (5 and 4) and
the support augmentation's conv merge of 2 variants (``supp_aug_conv``'s
gradient included; the other soft-label shapes and merges are in
``test_torch_port_train_{combined,reverse_neg}.py``); and remat on the port
bit for bit against the same model without it.

Remat is held to JAX's step of the same config without remat: XLA's
recomputed float32 forward rounds otherwise, so JAX's own remat and plain
gradients differ by more than the 1e-4 relative norm bound,
while the port's remat is bit for bit its plain step.
"""

import pytest
import torch

from oneshotdet_tpu_torch.engine import batch_to_inputs
from oneshotdet_tpu_torch.models import build_detection_model
from torch_port_common import (TrainVariants, jax_sampling_draws, small_cfgs, state_dict_from_flax,
                               train_proposal_count)
from torch_port_common import one_torch_thread  # noqa: F401  (the fixture)

# torch on one thread: the tier-1 run's six workers share the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SOFT = ["FEW_SHOT.SOFT_LABELING", True, "FEW_SHOT.SOFT_LABELING_FUNC"]
LOSS = "FEW_SHOT.SECOND_STAGE_CLS_LOSS"
ART = ["FEW_SHOT.ADD_ARTIFICIAL_PROPOSALS", True, *SOFT, "discrete", LOSS, "mse_loss",
       "MODEL.FCOS.DENSE_POINTS", 5]
CONV_AUG = ["FEW_SHOT.SUPP_AUG", True, "FEW_SHOT.NUM_SUPP_AUG", 2,
            "FEW_SHOT.SUPP_AUG_METHOD", "conv", "MODEL.FCOS.DENSE_POINTS", 4]
CASES = {   # name -> (the port's overrides, JAX's where they differ); the
    # first also takes 5 dense points, the second 4 and the conv merge
    "artificial proposals, remat, soft discrete, mse": (
        [*ART, "TPU.REMAT_BACKBONE", True], ART),
    "rn, soft linear, l1": (
        ["FEW_SHOT.SECOND_STAGE_METHOD", "rn", *SOFT, "linear", LOSS, "l1_loss", *CONV_AUG],
        None),
}
FIVE = {"loss_cls", "loss_reg", "loss_centerness", "loss_classifier", "loss_box_reg"}


@pytest.fixture(scope="module")
def variants():
    return TrainVariants()


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax(variants, case):
    overrides, ref = CASES[case]
    variants.check_losses(overrides, keys=FIVE, ref_overrides=ref)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(variants, case):
    overrides, ref = CASES[case]
    variants.check_grads(overrides, ref_overrides=ref)


def test_remat_is_bit_for_bit(variants):
    """TPU.REMAT_BACKBONE recomputes the backbones' forwards in the
    backward pass: the same losses and gradients, bit for bit on the CPU;
    the backbones keep no activations for the backward (fewer tensors saved
    by autograd)."""
    state_dict = state_dict_from_flax(variants.weights([])[1])
    out = []
    for remat in (False, True):
        _, pcfg = small_cfgs("TPU.REMAT_BACKBONE", remat)
        model = build_detection_model(pcfg, device="cpu")
        model.load_state_dict(state_dict, strict=True)
        model.train()
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x,
                                                      lambda x: x):
            losses = model.forward_train(
                *batch_to_inputs(variants.batches[0]),
                draws=jax_sampling_draws(variants.rng, train_proposal_count(pcfg)))
        sum(losses.values()).backward()
        out.append((losses, {n: p.grad for n, p in model.named_parameters()}, len(saved)))
    (l0, g0, n0), (l1, g1, n1) = out
    assert l0.keys() == l1.keys()
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert n1 < n0
