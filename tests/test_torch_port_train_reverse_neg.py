"""The port's train forward with negative supports against the JAX
package's on the CPU (float32, the test size and seeded weights of
``tests/test_torch_port_train.py``, JAX's own sampling draws; the negative
supports are a third ``make_episodic_batch``'s): the losses within rtol 5e-4
and every parameter's gradient within 1e-4 relative norm of
``jax.value_and_grad``, with the focal class loss (2 classes with negative
supports), and with the reverse-order pass too (and trans4thLinear soft
labels with the cxe loss, and the support augmentation's avg merge of 3
variants, on the negative supports too), where only loss_reverse is
returned, as in the JAX package, while the negative pass still runs.
"""

import pytest

from oneshotdet_tpu_torch.models import build_detection_model
from torch_port_common import TrainVariants, jax_sampling_draws, small_cfgs, train_proposal_count
from torch_port_common import one_torch_thread  # noqa: F401  (the fixture)

# torch on one thread: the tier-1 run's six workers share the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

FCOS = {"loss_cls", "loss_reg", "loss_centerness"}
STAGE2 = {"loss_classifier", "loss_box_reg"}
CASES = {
    "neg support, focal": (["FEW_SHOT.NEG_SUPPORT.TURN_ON", True,
                            "FEW_SHOT.SECOND_STAGE_CLS_LOSS", "focal_loss"], True,
                           FCOS | STAGE2 | {"loss_cls_suppress"}),
    "reverse order and neg support, soft trans4thLinear, cxe": (
        ["FEW_SHOT.REVERSE_ORDER", True, "FEW_SHOT.NEG_SUPPORT.TURN_ON", True,
         "FEW_SHOT.SOFT_LABELING", True, "FEW_SHOT.SOFT_LABELING_FUNC", "trans4thLinear",
         "FEW_SHOT.SECOND_STAGE_CLS_LOSS", "cxe_loss", "FEW_SHOT.SUPP_AUG", True,
         "FEW_SHOT.NUM_SUPP_AUG", 2], True, FCOS | STAGE2 | {"loss_reverse"}),
}


@pytest.fixture(scope="module")
def variants():
    return TrainVariants()


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax(variants, case):
    overrides, neg, keys = CASES[case]
    variants.check_losses(overrides, neg, keys=keys)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(variants, case):
    overrides, neg, _ = CASES[case]
    variants.check_grads(overrides, neg)


def test_neg_pass_runs_one_more_roi_align(variants, monkeypatch):
    """The negative supports' 7x7 pool is one more ROIAlign call (a K1
    launch on the card): 8 in the step; without negative supports given, 7
    and no loss_cls_suppress."""
    from oneshotdet_tpu_torch.engine import batch_to_inputs
    from oneshotdet_tpu_torch.models import detector

    calls = []
    for name in ("roi_align", "multilevel_roi_align"):
        fn = getattr(detector, name)
        monkeypatch.setattr(detector, name,
                            lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k))
    overrides = CASES["neg support, focal"][0]
    _, pcfg = small_cfgs(*overrides)
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(variants.reference(overrides, True)["state_dict"], strict=True)
    model.train()
    images, supp, targets = batch_to_inputs(variants.batches[0])
    draws = jax_sampling_draws(variants.rng, train_proposal_count(pcfg))
    counts = []
    for neg in (batch_to_inputs(variants.batches[2])[1], None):
        calls.clear()
        losses = model.forward_train(images, supp, targets, draws=draws, images_neg_supp=neg)
        counts.append(len(calls))
        assert ("loss_cls_suppress" in losses) == (neg is not None)
    assert counts == [8, 7]
