"""The port's one-shot train step against the JAX package's on the CPU, in
float32, on the flagship config at test size (batch 2, 64x64 queries, 32x32
supports, the tests' small capacities) with the same seeded weights:

  - ``forward_train``'s losses against ``apply(train=True)`` with the same
    sampling draws (JAX's uniforms of ``fold_in(rng, 1)`` split per image,
    as its ``prepare_roi_targets`` draws them), rtol 5e-4;
  - every parameter's gradient against ``jax.grad``, carried over by
    ``state_dict_from_flax``, within 1e-4 relative norm (float32 sums in
    another order: ~1e-5 measured);
  - two ``train_step``s against two steps of JAX's ``make_train_step``;
  - ``do_train`` with a ``MetricLogger`` and ``make_episodic_batch`` against
    JAX's. The training variants are in ``test_torch_port_train_{variants,
    combined,reverse_neg}.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.engine.trainer import create_train_state, make_train_step
from oneshotdet_tpu.solver import make_optimizer as jax_make_optimizer
from oneshotdet_tpu.structures import Boxes as JaxBoxes
from oneshotdet_tpu.structures import ImageBatch as JaxImageBatch
from oneshotdet_tpu.utils.synthetic import make_episodic_batch as jax_make_episodic_batch
from oneshotdet_tpu_torch.engine import batch_to_inputs, do_train, train_step
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.solver import make_lr_scheduler, make_optimizer
from oneshotdet_tpu_torch.utils import MetricLogger
from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch
from torch_port_common import jax_build, random_variables, small_cfgs, state_dict_from_flax

LOSS_RTOL = 5e-4
GRAD_REL = 1e-4
B, QUERY, SUPP, MAX_GT = 2, (64, 64), (32, 32), 4
N_PROPOSALS = 64 + MAX_GT     # FPN_POST_NMS_TOP_N_TRAIN + the GT boxes


def jax_inputs(batch):
    q = JaxImageBatch(jnp.asarray(batch["query_pixels"]), jnp.asarray(batch["query_sizes"]))
    s = JaxImageBatch(jnp.asarray(batch["supp_pixels"]), jnp.asarray(batch["supp_sizes"]))
    targets = JaxBoxes(xyxy=jnp.asarray(batch["gt_xyxy"]), valid=jnp.asarray(batch["gt_valid"]),
                       size=q.sizes_wh(), fields={"labels": jnp.asarray(batch["gt_labels"])})
    return q, s, targets


def jax_draws(rng):
    """The uniforms JAX's prepare_roi_targets draws under ``rng``."""
    keys = jax.random.split(jax.random.fold_in(rng, 1), B)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (N_PROPOSALS,)))
                                      for k in keys]))


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = small_cfgs()
    batches = [make_episodic_batch(B, QUERY, SUPP, max_gt=MAX_GT, seed=s) for s in (3, 4)]
    jm = jax_build(jcfg)
    variables = random_variables(jm, jax_inputs(batches[0])[:2])
    rng = jax.random.PRNGKey(2)

    def loss_fn(params, batch, key):
        losses = jm.apply({"params": params, "constants": variables["constants"]},
                          *jax_inputs(batch), train=True, rng=key)
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], batches[0], rng)
    return dict(jcfg=jcfg, pcfg=pcfg, jm=jm, variables=variables, batches=batches, rng=rng,
                losses={k: float(v) for k, v in losses.items()},
                grads=state_dict_from_flax({"params": grads}),
                state_dict=state_dict_from_flax(variables))


def port_model(setup, *overrides):
    _, pcfg = small_cfgs(*overrides)
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(setup["state_dict"], strict=True)
    return model.train(), pcfg


def test_forward_train_losses_match_jax(setup):
    model, _ = port_model(setup)
    losses = model.forward_train(*batch_to_inputs(setup["batches"][0]),
                                 draws=jax_draws(setup["rng"]))
    assert set(losses) == set(setup["losses"]) == {
        "loss_cls", "loss_reg", "loss_centerness", "loss_classifier", "loss_box_reg"}
    for k, v in losses.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        np.testing.assert_allclose(float(v), setup["losses"][k], rtol=LOSS_RTOL, err_msg=k)


def test_gradients_match_jax(setup):
    model, _ = port_model(setup)
    losses = model.forward_train(*batch_to_inputs(setup["batches"][0]),
                                 draws=jax_draws(setup["rng"]))
    sum(losses.values()).backward()
    for name, p in model.named_parameters():
        ref = setup["grads"][name]
        assert p.grad is not None, name
        rel = float((p.grad - ref).norm() / ref.norm().clamp(min=1e-30))
        assert rel <= GRAD_REL, f"{name}: {rel:.2e}"
    supp = [p.grad for n, p in model.named_parameters()
            if n.startswith("supp_backbone.body.layer4")]
    assert all(float(g.abs().sum()) > 0 for g in supp)


def test_two_train_steps_match_jax(setup):
    """JAX's make_train_step folds the step count into its rng; the port's
    train_step takes the draws that rng gives. Losses of both steps within
    rtol 5e-4, each parameter's update within 1e-3 of its norm plus two
    float32 spacings of the parameter (the stored values' rounding),
    each parameter within 1e-6 (~1% of a step's update: a gradient entry
    near zero differs by more, relatively, than the gradient's norm) and
    the frozen ones unchanged."""
    jm, variables = setup["jm"], setup["variables"]
    tx, _ = jax_make_optimizer(setup["jcfg"], variables["params"])
    state = create_train_state(jm, tx, variables)
    step = jax.jit(make_train_step(jm, tx))
    ref_metrics = []
    for batch in setup["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, setup["rng"])
        ref_metrics.append({k: float(v) for k, v in m.items()})
    ref = state_dict_from_flax({"params": state.params})

    model, pcfg = port_model(setup)
    opt = make_optimizer(pcfg, model)
    sched = make_lr_scheduler(pcfg, opt)
    for k, batch in enumerate(setup["batches"]):
        draws = jax_draws(jax.random.fold_in(setup["rng"], k))
        metrics = train_step(model, opt, sched, batch, draws=draws)
        assert all(v.device.type == "cpu" and not v.requires_grad for v in metrics.values())
        for name, want in ref_metrics[k].items():
            np.testing.assert_allclose(float(metrics[name]), want, rtol=LOSS_RTOL,
                                       err_msg=f"step {k}: {name}")
    frozen = n_moved = 0
    for name, p in model.named_parameters():
        start, want = setup["state_dict"][name], ref[name]
        np.testing.assert_allclose(p.detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        if not p.requires_grad:
            frozen += 1
            assert torch.equal(p.detach(), start) and torch.equal(want, start), name
            continue
        moved = (want - start).norm()
        n_moved += float(moved) > 0
        # the updates, less the float32 rounding of the stored parameters
        rounding = torch.from_numpy(2 * np.spacing(np.abs(want.numpy()))).norm()
        assert float((p.detach() - want).norm()) <= 1e-3 * float(moved) + float(rounding), name
    assert frozen == 22      # stem and layer1 of both backbones
    assert n_moved > 150


def test_do_train_with_metric_logger(setup, capsys):
    """Three synthetic batches, read back at log_period 2 and at MAX_ITER;
    a fourth is never taken."""
    model, pcfg = port_model(setup)
    pcfg.SOLVER.MAX_ITER = 3
    opt = make_optimizer(pcfg, model)
    sched = make_lr_scheduler(pcfg, opt)
    meters = MetricLogger()
    loader = [make_episodic_batch(B, QUERY, SUPP, max_gt=MAX_GT, seed=10 + i) for i in range(4)]
    it = do_train(pcfg, model, opt, sched, loader, meters=meters, log_period=2,
                  generator=torch.Generator().manual_seed(0))
    assert it == 3
    assert set(meters.meters) == set(setup["losses"]) | {"loss_total"}
    for m in meters.meters.values():
        assert m.count == 3 and np.isfinite(m.global_avg)
    assert sched.last_epoch == 3
    out = capsys.readouterr().out
    assert "iter 2/3" in out and "iter 3/3" in out and "loss_total" in str(meters)


def test_forward_train_rpn_only_gives_the_fcos_losses(setup):
    stage1 = {k: v for k, v in setup["state_dict"].items() if not k.startswith("roi_heads.")}
    _, pcfg = small_cfgs("MODEL.RPN_ONLY", True)
    model = build_detection_model(pcfg, device="cpu")
    model.load_state_dict(stage1, strict=True)
    losses = model.train().forward_train(*batch_to_inputs(setup["batches"][0]))
    assert set(losses) == {"loss_cls", "loss_reg", "loss_centerness"}
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), setup["losses"][k], rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("args", [(2, (64, 64), (32, 32), 4, 1, 0),
                                  (3, (96, 80), (48, 40), 8, 2, 5),
                                  (1, (128, 128), (64, 64), 2, 1, 11)])
def test_make_episodic_batch_matches_jax(args):
    b, q, s, g, shot, seed = args
    port = make_episodic_batch(b, q, s, max_gt=g, num_shot=shot, seed=seed)
    ref = jax_make_episodic_batch(b, q, s, max_gt=g, num_shot=shot, seed=seed)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
