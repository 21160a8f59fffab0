"""Export of a model whose stage 1 is the anchor RPN or RetinaNet (MODEL.FCOS_ON
False) on the CPU, at tests/test_stage1_dispatch.py's capacities
(``stage1_setup``, 64 FPN channels), weights drawn from a numpy seed:

  - for the anchor RPN feeding stage 2 and for RetinaNet with RPN_ONLY, the
    ``full`` program and the ``cached_support`` pair bit for bit against
    the eager port model; the programs hold the query bucket's anchor
    grids as constants, and RPN_ONLY's programs no relation head;
  - the ``full`` programs' detections against the JAX package's
    ``export_eval`` of the same weights (its ``full`` artifact, called
    through ``jax.export``), within the detection tolerances;
  - the anchor RPN's pair as a serving bundle written by ``tools.
    export_model --serving --no-compile`` with ``--ckpt`` (the CLI's seeded
    init overlaid by the set-up's weights), served by ``ArtifactPredictor``
    (the ExportedProgram route) against ``OneShotPredictor``, bit for bit;
    RetinaNet's pair is ``export_eval``'s, in memory.

A program's trace takes ~10 s here and its save and load ~10 s more, so
each program is exported once.

The NMS of both stage-1 kinds (the RPN's five per-level calls, RetinaNet's
chunked one) is the op ``oneshotdet::nms_keep_mask`` in the traced graphs.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu_torch import export as oexport
from oneshotdet_tpu_torch.structures import ImageBatch
from torch_port_common import (RETINA, assert_same_detections, assert_same_slots,  # noqa: F401
                               compile_fast, one_torch_thread, stage1_port, stage1_setup)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]     # the 64x64 query's P3-P7
BUCKETS = ["TPU.QUERY_BUCKETS", "((64, 64),)", "TPU.SUPP_BUCKET", "(32, 32)",
           "TPU.HOST_S2D", False]
KINDS = {"rpn": BUCKETS, "retinanet": RETINA + ["MODEL.RPN_ONLY", True] + BUCKETS}
TIDS = [3, 5]


@pytest.fixture(scope="module", params=sorted(KINDS))
def kind(request):
    """One stage-1 kind's set-up, its eager model and its eager outputs on
    the set-up's batch of 2 (``full``) and on its first image and support
    (the pair's batch of 1)."""
    setup = stage1_setup(*KINDS[request.param])
    pm = stage1_port(setup)
    q, s = setup["port"]
    dets = pm(q, s, target_ids=torch.tensor(TIDS))
    q1, s1 = ImageBatch(q.pixels[:1], q.sizes[:1]), ImageBatch(s.pixels[:1], s.sizes[:1])
    pooled, s7 = pm.compute_support_features(s1, 1)
    one = pm.detect_with_support(q1, pooled, s7, torch.tensor(TIDS[:1]))
    return dict(setup, name=request.param, model=pm, dets=dets, one=one,
                pair_inputs=(q1, s1, pooled, s7))


def _outputs(dets):
    return dets.xyxy, dets.get_field("scores"), dets.valid


def _assert_equal(got, want):
    for g, w in zip(got, _outputs(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _check_grids(ep, model):
    grids = model.rpn.generator.grid_anchors(SHAPES)
    consts = sorted(ep.constants.values(), key=lambda v: -v.shape[0])
    assert len(consts) == len(grids) and all(torch.equal(c, g) for c, g in zip(consts, grids))
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert "oneshotdet.nms_keep_mask.default" in targets
    return targets


def _full_call(ep, setup):
    q, s = setup["port"]
    with torch.inference_mode():
        return ep.module()(q.pixels, q.sizes, s.pixels, s.sizes,
                           torch.tensor(TIDS, dtype=torch.int32))


@pytest.fixture(scope="module")
def full(kind):
    return oexport.export_eval(kind["pcfg"], kind["model"], batch=2, kind="full")


def test_full_program_equals_eager(kind, full):
    targets = _check_grids(full, kind["model"])
    assert "oneshotdet.roi_align.default" in targets
    assert any(k.startswith("model.roi_heads.") for k in full.state_dict) == (
        kind["name"] == "rpn")
    _assert_equal(_full_call(full, kind), kind["dets"])


def test_full_program_matches_jax_export(kind, full):
    """JAX's ``export_eval(kind='full')`` of the same variables, called
    through its ``jax.export`` artifact (compiled with XLA's LLVM
    optimizations off): the detections within the detection tolerances,
    slot by slot for RetinaNet's stage-1 output."""
    from oneshotdet_tpu import export as jexport

    exp = jexport.export_eval(kind["jcfg"], kind["variables"], batch=2, query_hw=(64, 64),
                              supp_hw=(32, 32), kind="full")
    jq, js = kind["jax"]
    args = (jq.pixels, jq.sizes, js.pixels, js.sizes, jnp.asarray(TIDS, jnp.int32))
    xyxy, scores, valid = compile_fast(exp.call, *args)(*args)
    got = _full_call(full, kind)
    ref = SimpleNamespace(xyxy=xyxy, valid=valid, fields={"scores": scores})
    out = SimpleNamespace(xyxy=got[0], valid=got[2], fields={"scores": got[1]})
    if kind["name"] == "retinanet":
        assert_same_slots(out, ref)
    else:
        assert_same_detections(out, ref)


@pytest.fixture(scope="module")
def pair(kind, tmp_path_factory):
    """The batch-1 cached_support pair as (support, detect) callables, and
    for the anchor RPN the ``ArtifactPredictor`` serving them from the
    bundle ``tools.export_model --serving --no-compile --ckpt`` wrote."""
    from oneshotdet_tpu_torch.predictor import ArtifactPredictor
    from oneshotdet_tpu_torch.tools import export_model
    from torch_port_common import STAGE1_SMALL

    if kind["name"] != "rpn":
        support, detect = oexport.export_eval(kind["pcfg"], kind["model"], batch=1,
                                              kind="cached_support")
        _check_grids(detect, kind["model"])
        assert not any(k.startswith("model.roi_heads.") for k in detect.state_dict)
        return support.module(), detect.module(), None
    root = tmp_path_factory.mktemp("export_model")
    ckpt = str(root / "weights.pth")
    torch.save({"model": kind["state_dict"]}, ckpt)
    argv = ["--out", str(root / "rpn"), "--serving", "--no-compile", "--device", "cpu",
            "--ckpt", ckpt] + [str(v) for v in STAGE1_SMALL + KINDS["rpn"]]
    assert export_model.main(argv) == 0
    served = ArtifactPredictor(str(root / "rpn"), confidence_threshold=-1.0, device="cpu")
    assert not served.used_executable
    return served._sup_call, served._det_call, served


def test_cached_support_pair_and_served_bundle_equal_eager(kind, pair):
    """The pair bit for bit against ``compute_support_features`` and
    ``detect_with_support``; for the anchor RPN also its bundle served by
    ``ArtifactPredictor`` (the ExportedProgram route) against
    ``OneShotPredictor`` on the same support and frames, bit for bit."""
    from oneshotdet_tpu_torch.predictor import OneShotPredictor

    support, detect, served = pair
    assert not any(k.startswith(("model.rpn.", "model.roi_heads."))
                   for k in support.state_dict())
    q1, s1, pooled, s7 = kind["pair_inputs"]
    with torch.inference_mode():
        got_pooled, got_s7 = support(s1.pixels, s1.sizes)
        for g, w in zip(list(got_pooled) + [got_s7], list(pooled) + [s7]):
            assert torch.equal(g, w)
        got = detect(q1.pixels, q1.sizes, got_pooled, got_s7,
                     torch.tensor(TIDS[:1], dtype=torch.int32))
    _assert_equal(got, kind["one"])
    if served is None:
        return
    eager = OneShotPredictor(kind["pcfg"], kind["state_dict"], confidence_threshold=-1.0,
                             device="cpu")
    rng = np.random.RandomState(9)
    supp = rng.randint(0, 256, (30, 26, 3), dtype=np.uint8)
    eager.set_support(supp)
    served.set_support(supp)
    for hw in ((64, 80), (50, 40)):
        frame = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
        (wb, ws), (gb, gs) = eager.run_on_image(frame), served.run_on_image(frame)
        assert len(ws) > 0
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gs, ws)
