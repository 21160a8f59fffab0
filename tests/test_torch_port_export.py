"""The port's serving export (``oneshotdet_tpu_torch/export.py``) on the CPU,
on the flagship config at test size (batch 2, 64x64 queries, 32x32
supports, float32) with the seeded weights of ``torch_port_common``:

  - the ``full`` and ``cached_support`` ExportedPrograms equal the eager
    port bit for bit, saved and loaded with the unfused head, and with the
    fused head (its plain version behind the op, its operands the program's
    own buffers);
  - their detections equal the JAX package's ``export_eval`` artifacts
    (``jax.export``, run on the CPU with ``TPU.HOST_S2D`` off) within score
    rtol 5e-4 and box rtol 1e-3, matched by IoU;
  - the programs call the port's kernels as the custom ops of
    ``ops.library``, hold no profiler range, and each holds only the
    weights of the submodules it runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu import export as jax_export
from oneshotdet_tpu.structures import Boxes as JaxBoxes
from oneshotdet_tpu_torch import export as oexport
from oneshotdet_tpu_torch.structures import Boxes
from torch_port_common import assert_same_detections, make_setup, port_model, small_cfgs

QUERY_HW, SUPP_HW, BATCH = (64, 64), (32, 32), 2
TARGETS = [3, 5]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def models(setup):
    """(JAX cfg, port model unfused, port model with the fused head)."""
    _, unfused = port_model(setup, "TPU.HOST_S2D", False)
    _, fused = port_model(setup, "TPU.HOST_S2D", False)
    fused.config = dataclasses.replace(fused.config, fused_roi_head=True)

    jcfg, pcfg = small_cfgs("TPU.HOST_S2D", False)
    return dict(jcfg=jcfg, pcfg=pcfg, unfused=unfused, fused=fused)


def _inputs(setup):
    images, supps = setup["port"]
    return (images.pixels, images.sizes, supps.pixels, supps.sizes,
            torch.tensor(TARGETS, dtype=torch.int32))


def _boxes(out, size):
    xyxy, scores, valid = out
    return Boxes(xyxy=xyxy, valid=valid, size=size, fields={"scores": scores})


@pytest.fixture(scope="module")
def artifacts(setup, models, tmp_path_factory):
    """Each kind and head, exported; the unfused ones saved and loaded back
    (a save and a load take seconds each on a CPU; the fused head's operands go
    through a save in test_torch_port_serving.py's bundles)."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for head in ("unfused", "fused"):
        model, cfg = models[head], models["pcfg"]
        full = oexport.export_eval(cfg, model, batch=BATCH, query_hw=QUERY_HW, supp_hw=SUPP_HW,
                                   kind="full")
        pair = oexport.export_eval(cfg, model, batch=BATCH, query_hw=QUERY_HW, supp_hw=SUPP_HW,
                                   kind="cached_support")
        out[head] = dict(full=full, pair=pair, traced=(full, pair))
    oexport.save(out["unfused"]["full"], str(root / "unfused.eval"))
    oexport.save(out["unfused"]["pair"], str(root / "unfused.serve"))
    out["unfused"].update(full=oexport.load(str(root / "unfused.eval")),
                          pair=(oexport.load(str(root / "unfused.serve.support")),
                                oexport.load(str(root / "unfused.serve.detect"))))
    for f in root.iterdir():      # 0.1-0.3 GB each: full-width weights
        f.unlink()
    return out


def _run(artifact, kind, setup):
    pixels, sizes, supp_pixels, supp_sizes, tids = _inputs(setup)
    with torch.inference_mode():
        if kind == "full":
            return artifact["full"].module()(pixels, sizes, supp_pixels, supp_sizes, tids)
        support, detect = (ep.module() for ep in artifact["pair"])
        pooled, supp_7x7 = support(supp_pixels, supp_sizes)
        return detect(pixels, sizes, pooled, supp_7x7, tids)


@pytest.mark.parametrize("head", ["unfused", "fused"])
@pytest.mark.parametrize("kind", ["full", "cached_support"])
def test_loaded_artifact_equals_eager_port(setup, models, artifacts, kind, head):
    images, supps = setup["port"]
    ref = models[head](images, supps, target_ids=torch.tensor(TARGETS))
    got = _run(artifacts[head], kind, setup)
    want = (ref.xyxy, ref.get_field("scores"), ref.valid)
    assert int(ref.valid.sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("kind", ["full", "cached_support"])
def test_artifact_detections_match_jax_export(setup, models, artifacts, kind):
    variables = {k: setup["variables"][k] for k in ("params", "constants")}
    jq, js = setup["jax"]
    tids = jnp.array(TARGETS, jnp.int32)
    if kind == "full":
        exp = jax_export.export_eval(models["jcfg"], variables, batch=BATCH, query_hw=QUERY_HW,
                                     supp_hw=SUPP_HW, kind="full")
        xyxy, scores, valid = exp.call(jq.pixels, jq.sizes, js.pixels, js.sizes, tids)
    else:
        sup, det = jax_export.export_eval(models["jcfg"], variables, batch=BATCH,
                                          query_hw=QUERY_HW, supp_hw=SUPP_HW,
                                          kind="cached_support")
        pooled, supp_7x7 = sup.call(js.pixels, js.sizes)
        xyxy, scores, valid = det.call(jq.pixels, jq.sizes, pooled, supp_7x7, tids)
    ref = JaxBoxes(xyxy=xyxy, valid=valid, size=jq.sizes[:, ::-1], fields={"scores": scores})
    got = _run(artifacts["unfused"], kind, setup)
    assert_same_detections(_boxes(got, setup["port"][0].sizes.flip(-1)), ref)


@pytest.mark.parametrize("head", ["unfused", "fused"])
def test_programs_call_the_port_ops_and_no_profiler_range(artifacts, head):
    full, (support, detect) = artifacts[head]["traced"]
    targets = {kind: [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
               for kind, ep in (("full", full), ("support", support), ("detect", detect))}
    count = {kind: {op: sum(op in t for t in ts) for op in
                    ("oneshotdet.roi_align.", "oneshotdet.roi_head_fused.",
                     "oneshotdet.nms_keep_mask.", "profiler")}
             for kind, ts in targets.items()}
    fused = int(head == "fused")
    # 5 one-level 1x1 pools and the support 7x7, then the proposals' 7x7; NMS
    # in stage 1 and stage 2
    assert count["support"] == {"oneshotdet.roi_align.": 6, "oneshotdet.roi_head_fused.": 0,
                                "oneshotdet.nms_keep_mask.": 0, "profiler": 0}
    assert count["detect"] == {"oneshotdet.roi_align.": 1, "oneshotdet.roi_head_fused.": fused,
                               "oneshotdet.nms_keep_mask.": 2, "profiler": 0}
    assert count["full"] == {"oneshotdet.roi_align.": 7, "oneshotdet.roi_head_fused.": fused,
                             "oneshotdet.nms_keep_mask.": 2, "profiler": 0}
    # the fused head's operands are the program's own buffers
    names = set(full.state_dict)
    assert any(n.startswith("head_operands.") for n in names) == bool(fused)


@pytest.mark.parametrize("head", ["unfused", "fused"])
def test_each_program_holds_only_the_weights_it_runs(models, artifacts, head):
    """The support program the support backbone's, the detect program the
    query backbone's, the FCOS head's and the relation head's (and K3's
    operands with the fused head), the full program every weight."""
    full, (support, detect) = artifacts[head]["traced"]
    tops = {kind: {k.split(".")[1] if k.startswith("model.") else k.split(".")[0]
                   for k in ep.state_dict}
            for kind, ep in (("full", full), ("support", support), ("detect", detect))}
    fused = {"head_operands"} if head == "fused" else set()
    assert tops["support"] == {"supp_backbone"}
    assert tops["detect"] == {"backbone", "rpn", "roi_heads"} | fused
    assert tops["full"] == {"backbone", "supp_backbone", "rpn", "roi_heads"} | fused
    n = sum(v.numel() for v in models[head].state_dict().values())
    assert sum(v.numel() for k, v in full.state_dict.items() if k.startswith("model.")) == n


def test_export_eval_refuses_an_unknown_kind(models):
    with pytest.raises(ValueError, match="unknown export kind"):
        oexport.export_eval(models["pcfg"], models["unfused"], kind="stablehlo")


def test_exporting_leaves_the_model_as_it_was(setup, models, artifacts):
    """The fused head's operand override is cleared after each trace, and
    the eager model still runs with its own cached operands."""
    head = models["fused"].roi_heads.box
    assert head.operands_override is None
    images, supps = setup["port"]
    out = models["fused"](images, supps)
    assert int(out.valid.sum()) > 0
    assert np.all(np.isfinite(out.get_field("scores").numpy()))
