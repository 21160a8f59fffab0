"""The port's RetinaNet stage 1 (MODEL.FCOS_ON False, RETINANET_ON) against the
JAX package on the CPU, in float32, at tests/test_stage1_dispatch.py's
capacities:

  - the head (twin towers, cls_logits, bbox_pred) on a random pyramid;
  - ``retinanet_losses``, rtol 5e-4;
  - inference (per-level top-k, decode, one NMS over the levels) slot by
    slot, score rtol 5e-4 and box rtol 1e-3;
  - the detector with RPN_ONLY: eval detections, ``forward_train``'s losses
    (rtol 5e-4) and every gradient a train step computes (1e-4 relative
    norm) against JAX's ``value_and_grad``, the towers' ReLUs at JAX's
    branch within 1e-4 of their kink; without RPN_ONLY: eval detections through stage 2 and the
    same stage-1 losses (RetinaNet trains stage 1 only); the predictor
    against ``forward``;
  - the weights against ``export_state_dict`` and the flax tree, the init
    against flax's, a ``.pth`` overlay through the ``Checkpointer``;
  - what once raised: export (the pair), TPU.QUANT (int8 towers).

One jitted JAX compile per detector mode (``compile_fast``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.models import retinanet as jret
from oneshotdet_tpu.utils.torch_export import export_state_dict
from oneshotdet_tpu_torch.engine import batch_to_inputs
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.models import retinanet as pret
from oneshotdet_tpu_torch.solver import make_param_groups
from torch_port_common import (RETINA, anchor_kinks_as_jax, anchor_train_reference,  # noqa: F401
                               assert_same_detections, assert_same_slots, check_train_against,
                               compile_fast, np_, one_torch_thread, random_tree, stage1_cfgs,
                               stage1_port, stage1_setup, state_dict_from_flax, t, train_batches)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]     # the 64x64 query's P3-P7
ONLY = RETINA + ["MODEL.RPN_ONLY", True]


def jax_fast(fn, *args):
    return compile_fast(fn, *args)(*args)


@pytest.fixture(scope="module")
def setup():
    return stage1_setup(*ONLY)


def _pyramid(seed, channels=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, w, channels).astype(np.float32) for h, w in SHAPES]


def _module_params(seed):
    """Seeded flax params of a RetinaNetModule over a 64-wide pyramid."""
    module = jret.RetinaNetModule(num_classes=1, pre_nms_top_n=64, detections_per_img=32)
    feats = [jnp.asarray(f) for f in _pyramid(0)]
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), feats,
                                                jnp.ones((2, 2))))
    return module, random_tree(shapes["params"], np.random.RandomState(seed))


def _port_head(params):
    head = pret.RetinaNetHead(64, 1, 9)
    sd = state_dict_from_flax({"params": {"retinanet_module": params}})
    head.load_state_dict({k[len("rpn.head."):]: v for k, v in sd.items()}, strict=True)
    return head


def _nchw(f):
    return t(f).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def test_head_matches_flax():
    module, params = _module_params(1)
    feats = _pyramid(2)
    want = jret.RetinaNetHead(num_classes=1, num_anchors=9).apply(
        {"params": params["head"]}, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = _port_head(params)([_nchw(f) for f in feats])
    for g_lvls, w_lvls in zip(got, want):
        for g, w in zip(g_lvls, w_lvls):
            assert g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_retinanet_losses_match_jax(seed):
    from oneshotdet_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
    from oneshotdet_tpu_torch.ops.box_coder import BoxCoder

    gen = pret.RetinaNetModule(64, 1, (32, 64, 128, 256, 512), (8, 16, 32, 64, 128),
                               (0.5, 1.0, 2.0)).generator
    anchors = torch.cat(gen.grid_anchors(SHAPES))
    rng = np.random.RandomState(seed)
    logits = [rng.randn(2, h, w, 9).astype(np.float32) for h, w in SHAPES]
    reg = [0.3 * rng.randn(2, h, w, 36).astype(np.float32) for h, w in SHAPES]
    xy = rng.uniform(0, 40, (2, 4, 2))
    gt = np.concatenate([xy, xy + rng.uniform(6, 40, (2, 4, 2))], -1).astype(np.float32)
    valid = np.array([[True, True, False, True], [True, False, False, False]])
    labels = valid.astype(np.int32)
    got = pret.retinanet_losses(anchors, [t(x) for x in logits], [t(x) for x in reg], t(gt),
                                t(labels), t(valid), BoxCoder((10.0, 10.0, 5.0, 5.0)), 1)
    want = jret.retinanet_losses(jnp.asarray(np_(anchors)), [jnp.asarray(x) for x in logits],
                                 [jnp.asarray(x) for x in reg], jnp.asarray(gt),
                                 jnp.asarray(labels), jnp.asarray(valid),
                                 JaxBoxCoder((10.0, 10.0, 5.0, 5.0)), 1)
    for g, w in zip(got, want):
        assert float(w) > 0
        np.testing.assert_allclose(float(g), float(w), rtol=5e-4)


@pytest.mark.parametrize("inference_th", [0.0, 0.5])
def test_inference_matches_jax(inference_th):
    """The module's eval: per level the top 64 of 192 / 48 / 12 / 3 / 3 ...
    and one NMS at 0.4 over every level's candidates, the top 32."""
    module, params = _module_params(3)
    module = module.clone(inference_th=inference_th)
    feats = _pyramid(4)
    sizes = np.array([[64.0, 64.0], [56.0, 48.0]], np.float32)
    want, _ = module.apply({"params": params}, [jnp.asarray(f) for f in feats],
                           jnp.asarray(sizes))
    head = _port_head(params)
    gen = pret.RetinaNetModule(64, 1, (32, 64, 128, 256, 512), (8, 16, 32, 64, 128),
                               (0.5, 1.0, 2.0)).generator
    with torch.no_grad():
        logits, reg = head([_nchw(f) for f in feats])
    got = pret.retinanet_postprocess(gen.grid_anchors(SHAPES), logits, reg, t(sizes),
                                     pret.BoxCoder(pret.RETINA_BOX_WEIGHTS), 1, 64, inference_th,
                                     0.4, 32)
    assert got.xyxy.shape == tuple(want.xyxy.shape) == (2, 32, 4)
    assert_same_slots(got, want)


# -- the detector -------------------------------------------------------------------

def test_rpn_only_eval_detections_match_jax(setup):
    pm = stage1_port(setup)
    assert type(pm.rpn).__name__ == "RetinaNetModule" and not hasattr(pm, "roi_heads")
    ref = jax_fast(lambda v, q, s: setup["jm"].apply(v, q, s), setup["variables"], *setup["jax"])
    out = pm(*setup["port"])
    assert out.xyxy.shape == tuple(ref.xyxy.shape) == (2, 32, 4)
    assert_same_slots(out, ref)
    q, supp = setup["port"]
    pooled, s7 = pm.compute_support_features(supp, 2)
    cached = pm.detect_with_support(q, pooled, s7)
    assert torch.equal(cached.xyxy, out.xyxy) and torch.equal(cached.fields["scores"],
                                                              out.fields["scores"])


def test_two_stage_eval_detections_match_jax():
    """Without RPN_ONLY RetinaNet's detections are stage 2's proposals."""
    s = stage1_setup(*RETINA)
    pm = stage1_port(s)
    ref = jax_fast(lambda v, q, s_: s["jm"].apply(v, q, s_), s["variables"], *s["jax"])
    out = pm(*s["port"])
    assert out.xyxy.shape == tuple(ref.xyxy.shape)
    assert_same_detections(out, ref)
    np.testing.assert_array_equal(np_(out.fields["labels"]), np.asarray(ref.fields["labels"]))


@pytest.fixture(scope="module")
def train_ref(setup):
    batch = train_batches()[0]
    return batch, anchor_train_reference(setup, batch, jax.random.PRNGKey(2))


def _port_train(model, batch, ref, pcfg):
    """The losses and the gradients a train step computes: those of every
    parameter but the frozen stem and layer1 (FREEZE_CONV_BODY_AT 2), which
    get none."""
    make_param_groups(pcfg, model)
    model.train()
    with anchor_kinks_as_jax(model.rpn.head, ref["anchor_kinks"]):
        losses = model.forward_train(*batch_to_inputs(batch))
    sum(losses.values()).backward()
    assert all(p.grad is None for p in model.parameters() if not p.requires_grad)
    return losses, {name: p.grad for name, p in model.named_parameters() if p.requires_grad}


def test_forward_train_losses_and_gradients_match_jax(setup, train_ref):
    batch, ref = train_ref
    assert set(ref["losses"]) == {"loss_retina_cls", "loss_retina_reg"}
    losses, grads = _port_train(stage1_port(setup), batch, ref, setup["pcfg"])
    check_train_against(ref, losses, grads)
    assert all(g is not None and float(g.norm()) > 0 for n, g in grads.items()
               if n.startswith("rpn.head."))


def test_two_stage_model_trains_stage1_only(setup, train_ref):
    """Without RPN_ONLY the model holds a relation head, but the train step
    returns RetinaNet's losses alone, as with RPN_ONLY, and the head gets
    no gradient."""
    batch, ref = train_ref
    s = stage1_setup(*RETINA)
    model = build_detection_model(s["pcfg"], device="cpu")
    model.load_state_dict(dict(s["state_dict"], **setup["state_dict"]), strict=True)
    losses, grads = _port_train(model, batch, ref, s["pcfg"])
    check_train_against(ref, losses, {n: g for n, g in grads.items()
                                      if not n.startswith("roi_heads.")})
    assert all(g is None for n, g in grads.items() if n.startswith("roi_heads."))


def test_predictor_matches_forward(setup):
    from oneshotdet_tpu_torch.predictor import OneShotPredictor, _select

    _, pcfg = stage1_cfgs(*ONLY, "TPU.QUERY_BUCKETS", "((64, 96),)", "TPU.SUPP_BUCKET",
                          "(32, 32)", "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
                          "INPUT.SUPP_MIN_SIZE_TEST", 32, "INPUT.SUPP_MAX_SIZE_TEST", 32,
                          "TPU.HOST_S2D", False)
    pred = OneShotPredictor(pcfg, setup["state_dict"], device="cpu")
    rng = np.random.RandomState(6)
    supp = rng.randint(0, 256, (36, 28, 3), dtype=np.uint8)
    pred.set_support(supp)
    for hw in ((64, 80), (40, 90)):
        frame = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
        boxes, scores = pred.run_on_image(frame)
        q, resized = pred._batch(frame, 64, 96, (64, 96))
        s, _ = pred._batch(supp, 32, 32, (32, 32))
        dets = pred.model(q, s)
        want = _select(np_(dets.xyxy[0]), np_(dets.fields["scores"][0]), np_(dets.valid[0]), 0.0,
                       1, hw, resized)
        assert len(scores) > 0
        np.testing.assert_allclose(boxes, want[0], rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(scores, want[1], rtol=1e-6, atol=1e-7)
    assert len(pred.model.rpn.generator._grids) == 5


# -- weights ------------------------------------------------------------------------

def test_weights_match_export_state_dict(setup):
    ref, exported, skipped = export_state_dict(setup["variables"])
    sd = setup["state_dict"]
    for k in exported:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    head = setup["variables"]["params"]["retinanet_module"]["head"]
    assert sorted(skipped) == sorted(f"params/retinanet_module/head/{m}/{leaf}"
                                     for m in head for leaf in head[m])
    names = {"cls_logits": "cls_logits", "bbox_pred": "bbox_pred",
             **{f"{tw}_{i}": f"{tw}.{2 * i}" for tw in ("cls_tower", "bbox_tower")
                for i in range(4)}}
    assert set(head) == set(names)
    assert set(sd) - set(exported) == {f"rpn.head.{names[m]}.{w}" for m in head
                                       for w in ("weight", "bias")}
    for m, port in names.items():
        np.testing.assert_array_equal(sd[f"rpn.head.{port}.weight"].numpy(),
                                      np.asarray(head[m]["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"rpn.head.{port}.bias"].numpy(),
                                      np.asarray(head[m]["bias"]))


def test_head_init_as_flax():
    """N(0, 0.01) kernels, zero biases but cls_logits' prior bias
    -log(99), whatever MODEL.RETINANET.PRIOR_PROB says (the JAX package
    passes none of NUM_CONVS, PRIOR_PROB to the head)."""
    _, pcfg = stage1_cfgs(*ONLY, "MODEL.RETINANET.PRIOR_PROB", 0.2)
    port = {k: v for k, v in build_detection_model(pcfg, device="cpu").state_dict().items()
            if k.startswith("rpn.head.")}
    params = jret.RetinaNetHead(num_classes=1, num_anchors=9).init(
        jax.random.PRNGKey(1), [jnp.zeros((1, h, w, 64)) for h, w in SHAPES])["params"]
    sd = state_dict_from_flax({"params": {"retinanet_module": {"head": params}}})
    assert set(port) == set(sd) and len(port) == 2 * 10
    for k, want in sd.items():
        got = port[k]
        if k.endswith(".bias"):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, err_msg=k)
            assert ("cls_logits" in k) == bool(got.any()), k
            continue
        g, w = float(got.std()), float(want.std())
        assert abs(g - w) <= 5 / np.sqrt(got.numel()) * w, (k, g, w)


def test_pth_overlay_loads_through_checkpointer(setup, tmp_path):
    from oneshotdet_tpu_torch.utils.checkpoint import Checkpointer

    model = build_detection_model(setup["pcfg"], device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    head = {k: v for k, v in setup["state_dict"].items() if k.startswith("rpn.head.")}
    path = tmp_path / "retina_head.pth"
    torch.save({"model": head}, path)
    Checkpointer(str(tmp_path / "out")).load(model, f=str(path), prefer_tag=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, head[k] if k in head else before[k]), k


# -- once refused ------------------------------------------------------------------

def test_export_raises(setup, monkeypatch):
    """Export no longer raises: RetinaNet RPN_ONLY's ``full`` program keeps
    the model's modules, none of them a relation head, and the query
    bucket's anchor grids are built before the trace (``export._export``
    stubbed here; the traced programs, their grid constants and their
    outputs are held in ``test_torch_port_anchor_export.py``)."""
    from oneshotdet_tpu_torch import export as oexport

    pm = stage1_port(setup)
    traced = []
    monkeypatch.setattr(oexport, "_export", lambda model, entry, keep, args: traced.append(
        (set(keep), dict(model.rpn.generator._grids))) or "program")
    assert oexport.export_eval(setup["pcfg"], pm, batch=1, query_hw=(64, 64),
                               supp_hw=(32, 32)) == "program"
    (keep, grids), = traced
    assert keep == {"backbone", "rpn"}
    want = pm.rpn.generator.grid_anchors(SHAPES)
    assert len(grids) == 5 and all(torch.equal(g, w) for g, w in zip(grids.values(), want))


@pytest.mark.parametrize("mode", ["int8", "int8_weight"])
def test_quant_raises(mode):
    """TPU.QUANT no longer raises for RetinaNet: the towers are int8 layers
    (held to JAX in ``test_torch_port_retinanet_quant.py``)."""
    from oneshotdet_tpu_torch.ops.quant import QuantConv2d, WeightQuantConv2d

    _, pcfg = stage1_cfgs(*ONLY, "TPU.QUANT", mode)
    model = build_detection_model(pcfg, device="cpu")
    layer = QuantConv2d if mode == "int8" else WeightQuantConv2d
    assert all(type(model.rpn.head.cls_tower[2 * i]) is layer for i in range(4))


def test_engine_takes_rpn_only_output(setup):
    """The engine's steps over RetinaNet's RPN_ONLY detections, which carry
    no 'labels' (labelled 1), per batch and with cached supports."""
    from oneshotdet_tpu_torch.engine import compute_on_dataset, make_eval_step

    pm = stage1_port(setup)
    q, s = setup["port"]
    batch = {"query_pixels": np_(q.pixels), "query_sizes": np_(q.sizes),
             "supp_pixels": np_(s.pixels), "supp_sizes": np_(s.sizes),
             "target_ids": np.array([1, 2]), "img_ids": np.array([7, 8]), "idxs": np.array([0, 1])}
    xyxy, scores, labels, valid = make_eval_step(pm)(batch)
    dets = pm(q, s)
    assert torch.equal(xyxy, dets.xyxy) and torch.equal(scores, dets.fields["scores"])
    assert labels.dtype == torch.int32 and bool((labels == 1).all())
    for cache in (False, True):
        results = compute_on_dataset(pm, [batch], cache_supports=cache)
        assert sorted(results) == [0, 1]
        for i in (0, 1):
            v = np_(dets.valid[i])
            np.testing.assert_array_equal(results[i]["boxes"], np_(dets.xyxy[i])[v])
