"""The port's anchor RPN (MODEL.FCOS_ON False) against the JAX package on the
CPU, in float32:

  - cell and grid anchors and the straddle mask bit for bit, RetinaNet's
    octave anchors too;
  - ``rpn_targets``: labels exactly, regression targets to 1e-6;
  - ``rpn_losses`` fed JAX's own uniforms, rtol 5e-4;
  - ``rpn_postprocess`` at the train and test capacities, slot by slot
    (score rtol 5e-4, box rtol 1e-3);
  - the detector at tests/test_stage1_dispatch.py's capacities: eval
    detections, RPN_ONLY proposals ('objectness' and 'scores'), and
    ``forward_train``'s losses (rtol 5e-4) and every gradient a train step
    computes (1e-4 relative norm) against JAX's ``value_and_grad`` on JAX's draws (the relation
    head's and the RPN head's ReLUs taken at JAX's branch within 1e-4 of
    their kink); the predictor against ``forward``;
  - the weights: the names JAX's ``export_state_dict`` maps, the RPN head's
    leaf by leaf, the init against flax's, a ``.pth`` overlay through the
    ``Checkpointer``;
  - the plain NMS's chunks bit for bit against the batched keep mask;
  - what once raised: export of a non-FCOS model (the bundle), RetinaNet
    under TPU.QUANT (int8 towers).

One jitted JAX compile per detector mode (``compile_fast``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.models import anchor_generator as jag
from oneshotdet_tpu.models import rpn as jrpn
from oneshotdet_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from oneshotdet_tpu.utils.torch_export import export_state_dict
from oneshotdet_tpu_torch.engine import batch_to_inputs
from oneshotdet_tpu_torch.models import anchor_generator as pag
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.models import rpn as prpn
from oneshotdet_tpu_torch.ops import nms as pnms
from oneshotdet_tpu_torch.ops.box_coder import BoxCoder
from oneshotdet_tpu_torch.solver import make_param_groups
from torch_port_common import (RETINA, STAGE1_SMALL, anchor_kinks_as_jax,  # noqa: F401
                               anchor_proposal_count, anchor_train_reference,
                               assert_same_detections, assert_same_slots, check_train_against,
                               compile_fast, head_kinks_as_jax, jax_rpn_draws,
                               jax_sampling_draws, np_, one_torch_thread, stage1_cfgs,
                               stage1_port, stage1_setup, t, train_batches)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]     # the 64x64 query's P3-P7
ODD_SHAPES = [(13, 19), (7, 10), (4, 5), (2, 3), (1, 2)]


def jax_fast(fn, *args):
    return compile_fast(fn, *args)(*args)


@pytest.fixture(scope="module")
def setup():
    return stage1_setup()


# -- anchors ------------------------------------------------------------------------

@pytest.mark.parametrize("stride,sizes,ratios", [
    (16, (32.0,), (1.0,)), (8, (32.0,), (0.5, 1.0, 2.0)), (128, (512.0,), (0.5, 1.0, 2.0)),
    (16, (32.0, 64.0, 128.0, 256.0, 512.0), (0.5, 1.0, 2.0)), (32, (100.0, 37.5), (0.3, 3.0))])
def test_cell_anchors_bit_for_bit(stride, sizes, ratios):
    want = jag.generate_cell_anchors(stride, sizes, ratios)
    got = pag.generate_cell_anchors(stride, sizes, ratios)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rpn", "retinanet"])
@pytest.mark.parametrize("shapes", [SHAPES, ODD_SHAPES], ids=["square", "odd"])
def test_grid_anchors_and_visibility_bit_for_bit(kind, shapes):
    """The RPN's one size a level and RetinaNet's octave anchors (from each
    package's cfg), and the straddle mask at thresholds 0, 5 and -1 for
    two image sizes."""
    jcfg, pcfg = stage1_cfgs(*RETINA)
    if kind == "rpn":
        r = jcfg.MODEL.RPN
        ref = jag.AnchorGenerator(r.ANCHOR_SIZES, r.ASPECT_RATIOS, r.ANCHOR_STRIDE)
        pcfg.MODEL.RPN.USE_FPN = True
        gen = pag.make_anchor_generator(pcfg)
    else:
        ref = jag.make_anchor_generator_retinanet(jcfg)
        gen = pag.make_anchor_generator_retinanet(pcfg)
    assert gen.num_anchors_per_location == ref.num_anchors_per_location
    for a, b in zip(gen.cell_anchors, ref.cell_anchors):
        np.testing.assert_array_equal(a, b)
    got, want = gen.grid_anchors(shapes), ref.grid_anchors(shapes)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    anchors = torch.cat(got)
    sizes = [(64.0, 64.0), (56.0, 48.0)]
    for thresh in (0.0, 5.0, -1.0):
        gen.straddle_thresh = ref.straddle_thresh = thresh
        vis = gen.visibility(anchors, torch.tensor(sizes))
        for i, wh in enumerate(sizes):
            np.testing.assert_array_equal(np_(vis[i]),
                                          np.asarray(ref.visibility(jnp.asarray(np_(anchors)), wh)))


def test_grid_anchors_cached_by_shape():
    gen = pag.rpn_anchor_generator((32, 64), (0.5, 1.0, 2.0), (8, 16))
    first = gen.grid_anchors([(4, 4), (2, 2)])
    again = gen.grid_anchors([(4, 4), (2, 2)])
    assert all(a is b for a, b in zip(first, again))
    other = gen.grid_anchors([(5, 3), (3, 2)])
    assert other[0].shape == (5 * 3 * 3, 4) and len(gen._grids) == 4


def test_anchor_strides_must_match_sizes():
    """MODEL.RPN.ANCHOR_STRIDE's default (16,) against five sizes: the JAX
    package's assertion, a ValueError naming both keys here."""
    _, pcfg = stage1_cfgs("MODEL.RPN.ANCHOR_STRIDE", "(16,)")
    with pytest.raises(ValueError, match=r"MODEL\.RPN\.ANCHOR_SIZES.*MODEL\.RPN\.ANCHOR_STRIDE"):
        build_detection_model(pcfg, device="cpu")
    jcfg, _ = stage1_cfgs("MODEL.RPN.ANCHOR_STRIDE", "(16,)")
    jcfg.MODEL.RPN.USE_FPN = True
    with pytest.raises(AssertionError):
        jag.make_anchor_generator(jcfg)


# -- targets, losses, postprocess ---------------------------------------------------

def _anchors():
    gen = pag.rpn_anchor_generator((32, 64, 128, 256, 512), (0.5, 1.0, 2.0), (8, 16, 32, 64, 128))
    return torch.cat(gen.grid_anchors(SHAPES)), gen


def _gt(seed, b=2, g=4):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (b, g, 2))
    wh = rng.uniform(6, 40, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.array([[True, True, False, True], [True, False, False, False]])[:b, :g]
    return boxes, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rpn_targets_match_jax(seed):
    anchors, gen = _anchors()
    boxes, valid = _gt(seed)
    sizes = torch.tensor([[64.0, 64.0], [56.0, 48.0]])
    vis = gen.visibility(anchors, sizes)
    labels, reg = prpn.rpn_targets(anchors, vis, t(boxes), t(valid), BoxCoder((1.0,) * 4))
    jl, jr = jrpn.rpn_targets(jnp.asarray(np_(anchors)), jnp.asarray(np_(vis)), jnp.asarray(boxes),
                              jnp.asarray(valid), JaxBoxCoder((1.0,) * 4))
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(np_(labels), np.asarray(jl))
    assert {-1, 0, 1} <= set(np.unique(np_(labels)).tolist())
    np.testing.assert_allclose(np_(reg), np.asarray(jr), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_rpn_losses_match_jax(seed):
    """Balanced sampling of 16 anchors an image fed the uniforms JAX's
    ``rpn_losses`` draws from the split of its key, BCE and smooth-L1."""
    anchors, gen = _anchors()
    boxes, valid = _gt(seed)
    vis = gen.visibility(anchors, torch.tensor([[64.0, 64.0], [56.0, 48.0]]))
    labels, reg_t = prpn.rpn_targets(anchors, vis, t(boxes), t(valid), BoxCoder((1.0,) * 4))
    rng = np.random.RandomState(seed + 10)
    obj = [rng.randn(2, h, w, 3).astype(np.float32) for h, w in SHAPES]
    reg = [0.3 * rng.randn(2, h, w, 12).astype(np.float32) for h, w in SHAPES]
    key = jax.random.PRNGKey(seed)
    n = anchors.shape[0]
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n,)))
                                   for k in jax.random.split(key, 2)]))
    got = prpn.rpn_losses(u, [t(o) for o in obj], [t(r) for r in reg], labels, reg_t, 16, 0.5)
    want = jrpn.rpn_losses(key, [jnp.asarray(o) for o in obj], [jnp.asarray(r) for r in reg],
                           jnp.asarray(np_(labels)), jnp.asarray(np_(reg_t)), 16, 0.5)
    for g, w in zip(got, want):
        assert float(w) > 0
        np.testing.assert_allclose(float(g), float(w), rtol=5e-4)


@pytest.mark.parametrize("caps", [(12000, 32, 32), (64, 32, 32), (40, 16, 24)],
                         ids=["train", "test", "narrow"])
def test_rpn_postprocess_matches_jax(caps):
    pre, post, fpn_post = caps
    anchors, gen = _anchors()
    per_level = gen.grid_anchors(SHAPES)
    rng = np.random.RandomState(sum(caps))
    obj = [rng.randn(2, h, w, 3).astype(np.float32) for h, w in SHAPES]
    reg = [0.3 * rng.randn(2, h, w, 12).astype(np.float32) for h, w in SHAPES]
    sizes = np.array([[64.0, 64.0], [56.0, 48.0]], np.float32)
    got = prpn.rpn_postprocess(per_level, [t(o) for o in obj], [t(r) for r in reg], t(sizes),
                               BoxCoder((1.0,) * 4), pre, post, 0.7, fpn_post)
    want = jrpn.rpn_postprocess([jnp.asarray(np_(a)) for a in per_level],
                                [jnp.asarray(o) for o in obj], [jnp.asarray(r) for r in reg],
                                jnp.asarray(sizes), JaxBoxCoder((1.0,) * 4), pre, post, 0.7,
                                fpn_post)
    assert got.xyxy.shape == tuple(want.xyxy.shape)
    assert_same_slots(got, want, ("scores", "objectness"))


# -- NMS in chunks ------------------------------------------------------------------

def test_nms_chunks_bit_for_bit(monkeypatch):
    """Random overlapping boxes, 5 images of 60: the keep mask in chunks of
    2, 1 and 3 images equals the batched one bit for bit. The capacities of
    the card's cells: FCOS's 8 x 8192 keeps the batched route, the anchor
    RPN's training 8 x 12000 and RetinaNet's 8 x 27 429 take chunks."""
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(5, 60, 2, generator=g) * 50
    boxes = torch.cat([xy, xy + 5 + torch.rand(5, 60, 2, generator=g) * 30], -1)
    scores = torch.rand(5, 60, generator=g)
    valid = torch.rand(5, 60, generator=g) > 0.2
    batched = pnms.nms_keep_mask_plain(boxes, scores, valid, 0.5)
    assert 0 < int(batched.sum()) < int(valid.sum())
    for per_chunk in (2, 1, 3):
        monkeypatch.setattr(pnms, "BATCHED_PAIRS", per_chunk * 60 * 60)
        assert pnms.nms_chunk(5, 60) == per_chunk
        assert torch.equal(pnms.nms_keep_mask_plain(boxes, scores, valid, 0.5), batched)
        two_lead = pnms.nms_keep_mask_plain(boxes[:4].reshape(2, 2, 60, 4),
                                            scores[:4].reshape(2, 2, 60),
                                            valid[:4].reshape(2, 2, 60), 0.5)
        assert torch.equal(two_lead.reshape(4, 60), batched[:4])
    monkeypatch.undo()
    assert pnms.nms_chunk(8, 8192) == 8
    assert pnms.nms_chunk(8, 12000) == 7
    assert pnms.nms_chunk(8, 8192 * 3 + 2223 + 630) == 1


# -- the detector -------------------------------------------------------------------

def test_eval_detections_match_jax(setup):
    pm = stage1_port(setup)
    assert type(pm.rpn).__name__ == "RPNModule"
    ref = jax_fast(lambda v, q, s: setup["jm"].apply(v, q, s), setup["variables"], *setup["jax"])
    out = pm(*setup["port"])
    assert out.xyxy.shape == tuple(ref.xyxy.shape)
    assert_same_detections(out, ref)
    np.testing.assert_array_equal(np_(out.fields["labels"]), np.asarray(ref.fields["labels"]))


def test_rpn_only_proposals_match_jax():
    s = stage1_setup("MODEL.RPN_ONLY", True)
    pm = stage1_port(s)
    assert not hasattr(pm, "roi_heads")
    ref = jax_fast(lambda v, q, s_: s["jm"].apply(v, q, s_), s["variables"], *s["jax"])
    out = pm(*s["port"])
    assert out.xyxy.shape == tuple(ref.xyxy.shape) == (2, 32, 4)
    assert_same_slots(out, ref, ("scores", "objectness"))
    q, supp = s["port"]
    pooled, s7 = pm.compute_support_features(supp, 2)
    cached = pm.detect_with_support(q, pooled, s7)
    for k in ("scores", "objectness"):
        assert torch.equal(cached.fields[k], out.fields[k])
    assert torch.equal(cached.xyxy, out.xyxy)


@pytest.fixture(scope="module")
def train_ref(setup):
    batch = train_batches()[0]
    rng = jax.random.PRNGKey(2)
    return batch, rng, anchor_train_reference(setup, batch, rng)


def _port_train(setup, batch, rng, ref):
    """The losses and the gradients a train step computes: those of every
    parameter but the frozen stem and layer1 (FREEZE_CONV_BODY_AT 2), which
    get none."""
    pm = stage1_port(setup).train()
    make_param_groups(setup["pcfg"], pm)
    a = sum(h * w * 3 for h, w in SHAPES)
    n = anchor_proposal_count(setup["pcfg"], SHAPES) + setup["pcfg"].TPU.MAX_GT_BOXES
    with head_kinks_as_jax(pm.roi_heads.box, ref["head_kinks"]), \
            anchor_kinks_as_jax(pm.rpn.head, ref["anchor_kinks"]):
        losses = pm.forward_train(*batch_to_inputs(batch), rpn_draws=jax_rpn_draws(rng, a),
                                  draws=jax_sampling_draws(rng, n))
    sum(losses.values()).backward()
    assert all(p.grad is None for p in pm.parameters() if not p.requires_grad)
    return losses, {name: p.grad for name, p in pm.named_parameters() if p.requires_grad}


def test_forward_train_losses_and_gradients_match_jax(setup, train_ref):
    batch, rng, ref = train_ref
    assert set(ref["losses"]) == {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
                                  "loss_box_reg"}
    losses, grads = _port_train(setup, batch, rng, ref)
    check_train_against(ref, losses, grads)
    assert all(g is not None and float(g.norm()) > 0 for n, g in grads.items()
               if n.startswith("rpn.head."))


def test_forward_train_draws_rpn_draws_first(setup):
    """Without ``rpn_draws`` the step's generator gives them first, then the
    ROI sampling's: the same losses as the two drawn by hand."""
    pm = stage1_port(setup).train()
    batch = train_batches()[1]
    a = sum(h * w * 3 for h, w in SHAPES)
    n = anchor_proposal_count(setup["pcfg"], SHAPES) + setup["pcfg"].TPU.MAX_GT_BOXES
    g = torch.Generator().manual_seed(5)
    by_hand = pm.forward_train(*batch_to_inputs(batch), rpn_draws=torch.rand((2, a), generator=g),
                               draws=torch.rand((2, n), generator=g))
    drawn = pm.forward_train(*batch_to_inputs(batch), generator=torch.Generator().manual_seed(5))
    assert by_hand.keys() == drawn.keys()
    for k in by_hand:
        assert torch.equal(by_hand[k], drawn[k]), k


def test_predictor_matches_forward(setup):
    """``OneShotPredictor`` (the anchor grids built once for the bucket's
    shapes) against ``forward`` on the same preprocessed frame and support."""
    from oneshotdet_tpu_torch.predictor import OneShotPredictor, _select

    _, pcfg = stage1_cfgs("TPU.QUERY_BUCKETS", "((64, 96),)", "TPU.SUPP_BUCKET", "(32, 32)",
                          "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
                          "INPUT.SUPP_MIN_SIZE_TEST", 32, "INPUT.SUPP_MAX_SIZE_TEST", 32,
                          "TPU.HOST_S2D", False)
    pred = OneShotPredictor(pcfg, setup["state_dict"], device="cpu")
    rng = np.random.RandomState(4)
    supp = rng.randint(0, 256, (30, 40, 3), dtype=np.uint8)
    pred.set_support(supp)
    for hw in ((48, 64), (70, 90)):
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
    """The names JAX's ``export_state_dict`` maps carry its arrays; the RPN
    head's, which it skips, are the flax kernels as OIHW and the biases."""
    ref, exported, skipped = export_state_dict(setup["variables"])
    sd = setup["state_dict"]
    for k in exported:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    head = setup["variables"]["params"]["rpn_module"]["head"]
    assert sorted(skipped) == sorted(f"params/rpn_module/head/{m}/{leaf}"
                                     for m in head for leaf in head[m])
    added = set(sd) - set(exported)
    assert added == {f"rpn.head.{m}.{w}" for m in ("conv", "cls_logits", "bbox_pred")
                     for w in ("weight", "bias")}
    for m in ("conv", "cls_logits", "bbox_pred"):
        np.testing.assert_array_equal(sd[f"rpn.head.{m}.weight"].numpy(),
                                      np.asarray(head[m]["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"rpn.head.{m}.bias"].numpy(), np.asarray(head[m]["bias"]))


def test_head_init_as_flax():
    """The RPN head starts from the JAX package's N(0, 0.01) kernels and zero
    biases (no prior bias): each weight's std within 5/sqrt(n) of flax's."""
    _, pcfg = stage1_cfgs()
    port = {k: v for k, v in build_detection_model(pcfg, device="cpu").state_dict().items()
            if k.startswith("rpn.head.")}
    feats = [jnp.zeros((1, h, w, 64)) for h, w in SHAPES]
    params = jrpn.RPNHead(num_anchors=3).init(jax.random.PRNGKey(1), feats)["params"]
    sd = {k.replace("rpn_module.", ""): v for k, v in {
        f"rpn.head.{m}.{'weight' if leaf == 'kernel' else 'bias'}":
            np.asarray(params[m][leaf]) for m in params for leaf in params[m]}.items()}
    assert set(port) == set(sd) and len(port) == 6
    for k, want in sd.items():
        got = port[k].numpy()
        if k.endswith(".bias"):
            assert not got.any() and not want.any(), k
            continue
        g, w = float(got.std()), float(want.std())
        assert abs(g - w) <= 5 / np.sqrt(got.size) * w, (k, g, w)


def test_pth_overlay_loads_through_checkpointer(setup, tmp_path):
    """A reference-layout .pth of the RPN head alone overlays those tensors
    and leaves every other one as it was."""
    from oneshotdet_tpu_torch.utils.checkpoint import Checkpointer

    _, pcfg = stage1_cfgs()
    model = build_detection_model(pcfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    head = {k: v for k, v in setup["state_dict"].items() if k.startswith("rpn.head.")}
    path = tmp_path / "rpn_head.pth"
    torch.save({"model": head}, path)
    Checkpointer(str(tmp_path / "out")).load(model, f=str(path), prefer_tag=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, head[k] if k in head else before[k]), k


# -- once refused ------------------------------------------------------------------

def test_export_of_an_anchor_stage1_model_raises(setup, monkeypatch):
    """Export no longer raises for the anchor RPN: ``export_eval`` builds the
    query bucket's five anchor grids before it traces the whole model
    (``export._export`` stubbed here; the traced programs are held to the
    eager model and to JAX in ``test_torch_port_anchor_export.py``); an
    unknown kind still raises."""
    from oneshotdet_tpu_torch import export as oexport

    pm = stage1_port(setup)
    with pytest.raises(ValueError, match="unknown export kind"):
        oexport.export_eval(setup["pcfg"], pm, batch=1, query_hw=(64, 64), supp_hw=(32, 32),
                            kind="detect")
    traced = []
    monkeypatch.setattr(oexport, "_export", lambda model, entry, keep, args: traced.append(
        (set(keep), len(model.rpn.generator._grids))) or "program")
    assert oexport.export_eval(setup["pcfg"], pm, batch=1, query_hw=(64, 96),
                               supp_hw=(32, 32)) == "program"
    assert traced == [({"backbone", "rpn", "roi_heads"}, 5)]
    assert sorted(k[1:3] for k in pm.rpn.generator._grids) == sorted(
        oexport.level_shapes((64, 96)))


def test_retinanet_under_quant_raises_and_the_rpn_does_not():
    """Neither raises now: RetinaNet's towers are int8 under TPU.QUANT, the
    anchor RPN's head stays float (the JAX package's RPN head has no int8
    layer)."""
    from oneshotdet_tpu_torch.ops.quant import QuantConv2d, WeightQuantConv2d

    for mode in ("int8", "int8_weight"):
        _, pcfg = stage1_cfgs(*RETINA, "TPU.QUANT", mode)
        model = build_detection_model(pcfg, device="cpu")
        assert isinstance(model.rpn.head.bbox_tower[0], (QuantConv2d, WeightQuantConv2d))
    _, pcfg = stage1_cfgs("TPU.QUANT", "int8_weight")
    model = build_detection_model(pcfg, device="cpu")
    assert model.config.stage1 == "rpn"
    assert not any(isinstance(m, (QuantConv2d, WeightQuantConv2d))
                   for m in model.rpn.modules())


def test_stage1_small_is_the_dispatch_tests_base():
    """STAGE1_SMALL reproduces tests/test_stage1_dispatch.py::_small_base."""
    from test_stage1_dispatch import _small_base

    want = _small_base()
    jcfg, _ = stage1_cfgs()
    for key in STAGE1_SMALL[2::2]:
        node_w, node_j = want, jcfg
        for part in key.split("."):
            node_w, node_j = node_w[part], node_j[part]
        assert node_j == node_w, key
