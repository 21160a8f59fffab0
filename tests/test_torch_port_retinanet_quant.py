"""RetinaNet under TPU.QUANT ('int8', 'int8_weight') in the port against the
JAX package on the CPU, in float32, at tests/test_stage1_dispatch.py's
capacities (``stage1_setup``, 64 FPN channels, RPN_ONLY):

  - the eight tower convs are the int8 layers and the two predictors stay
    float, as in the JAX package (``retinanet.py:44-57``);
  - the detections of ``detect_from_features`` (fusion, the int8 towers on
    five levels, inference) on a seeded pyramid, slot by slot within the
    detection tolerances: 'int8' replayed on JAX's int8 inputs
    (test_torch_port_quant.py's ``forced``: every tower conv's output bit
    for bit), 'int8_weight' with float weights (fake-quant per call) and
    from JAX's ``quantize_weights_int8`` tree (int8 codes), JAX op by op;
  - ``state_dict_from_flax`` of that tree: strict, equal to the port's own
    ``quantize_weights_int8``;
  - ``tools.quant_drift`` on a RetinaNet cfg.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.ops import quant as jq
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.ops import quant as pq
from test_torch_port_quant import JaxInt8Calls, forced
from torch_port_common import (RETINA, assert_same_slots, one_torch_thread,  # noqa: F401
                               stage1_cfgs, stage1_setup, state_dict_from_flax, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ONLY = RETINA + ["MODEL.RPN_ONLY", True]
SHAPES = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]     # the 64x64 query's P3-P7
TOWERS = [f"rpn.head.{tw}.{2 * i}" for tw in ("cls_tower", "bbox_tower") for i in range(4)]


@pytest.fixture(scope="module")
def setup():
    return stage1_setup(*ONLY)


@pytest.fixture(scope="module")
def after_backbone():
    """A seeded pyramid of a 64x64 batch of 2 (NHWC), per-level pooled
    supports, a 7x7 support shot and the images' (w, h)."""
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, h, w, 64).astype(np.float32) for h, w in SHAPES]
    pooled = [np.abs(rng.randn(2, 1, 1, 64)).astype(np.float32) for _ in SHAPES]
    s7 = rng.randn(2, 1, 7, 7, 64).astype(np.float32)
    sizes = np.array([[64.0, 64.0], [56.0, 48.0]], np.float32)
    return feats, sizes, pooled, s7


def models(setup, mode, variables=None):
    """(JAX model, port model) of RetinaNet RPN_ONLY under ``mode``, the
    port loaded strictly with ``variables`` (default the setup's)."""
    from oneshotdet_tpu.models import build_detection_model as jax_build

    jcfg, pcfg = stage1_cfgs(*ONLY, "TPU.QUANT", mode)
    pm = build_detection_model(pcfg, device="cpu")
    sd = setup["state_dict"] if variables is None else state_dict_from_flax(variables)
    pm.load_state_dict(sd, strict=True)
    return jax_build(jcfg), pm


def jax_dets(jm, variables, inputs):
    feats, sizes, pooled, s7 = inputs
    return jm.apply(variables, [jnp.asarray(f) for f in feats], jnp.asarray(sizes),
                    [jnp.asarray(p) for p in pooled], jnp.asarray(s7),
                    method=lambda m, *a: m.detect_from_features(*a))


def port_dets(pm, inputs):
    feats, sizes, pooled, s7 = inputs
    return pm.detect_from_features([t(f).permute(0, 3, 1, 2) for f in feats], t(sizes),
                                   [t(p) for p in pooled], t(s7))


@pytest.mark.parametrize("mode,layer", [("int8", pq.QuantConv2d),
                                        ("int8_weight", pq.WeightQuantConv2d)])
def test_towers_are_the_int8_layers(setup, mode, layer):
    _, pm = models(setup, mode)
    mods = dict(pm.named_modules())
    assert all(type(mods[name]) is layer for name in TOWERS)
    for name in ("rpn.head.cls_logits", "rpn.head.bbox_pred"):
        assert not isinstance(mods[name], (pq.QuantConv2d, pq.WeightQuantConv2d)), name
    assert sum(isinstance(m, (pq.QuantConv2d, pq.WeightQuantConv2d))
               for n, m in mods.items() if n.startswith("rpn.")) == len(TOWERS)


def test_int8_detections_match_jax(setup, after_backbone):
    """'int8': each tower conv quantizes its input per call, so per level
    (40 calls); replayed, each gives JAX's output bit for bit."""
    jm, pm = models(setup, "int8")
    with JaxInt8Calls() as rec:
        ref = jax_dets(jm, setup["variables"], after_backbone)
    assert sorted(len(v) for v in rec.calls.values()) == [5] * len(TOWERS)
    with forced(pm, rec.calls) as f:
        out = port_dets(pm, after_backbone)
    assert f.layers == 5 * len(TOWERS)
    assert out.xyxy.shape == tuple(ref.xyxy.shape) == (2, 32, 4)
    assert_same_slots(out, ref)


@pytest.fixture(scope="module")
def int8_tree(setup):
    """JAX's ``quantize_weights_int8`` of the setup's variables, with the
    ``quant_scales`` collection an 'int8_weight' init declares."""
    jcfg, _ = stage1_cfgs(*ONLY, "TPU.QUANT", "int8_weight")
    from oneshotdet_tpu.models import build_detection_model as jax_build

    jm = jax_build(jcfg)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, *setup["jax"],
                                            train=False))
    scales = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                    shapes[jq.QUANT_SCALES_COLLECTION])
    return jq.quantize_weights_int8(dict(setup["variables"], quant_scales=scales))


def test_int8_weight_detections_match_jax(setup, after_backbone, int8_tree):
    """'int8_weight' from float weights and from JAX's transformed tree (int8
    codes and their scales): each against JAX's apply of the same
    variables, and the two port models equal bit for bit."""
    jm, pm = models(setup, "int8_weight")
    out = port_dets(pm, after_backbone)
    assert_same_slots(out, jax_dets(jm, setup["variables"], after_backbone))
    _, codes = models(setup, "int8_weight", int8_tree)
    assert all(dict(codes.named_modules())[n].weight.dtype == torch.int8 for n in TOWERS)
    got = port_dets(codes, after_backbone)
    assert_same_slots(got, jax_dets(jm, int8_tree, after_backbone))
    assert torch.equal(got.xyxy, out.xyxy) and torch.equal(got.fields["scores"],
                                                            out.fields["scores"])


def test_int8_tree_loads_strictly_and_equals_the_port_transform(setup, int8_tree):
    sd = state_dict_from_flax(int8_tree)
    codes = sorted(k for k, v in sd.items() if v.dtype == torch.int8)
    heads = [k for k in codes if k.startswith("rpn.")]
    assert heads == sorted(f"{n}.weight" for n in TOWERS)
    assert sorted(k for k in sd if k.endswith(".weight_scale")) == [k + "_scale" for k in codes]
    _, pcfg = stage1_cfgs(*ONLY, "TPU.QUANT", "int8_weight")
    own = build_detection_model(pcfg, device="cpu")
    own.load_state_dict(setup["state_dict"], strict=True)
    pq.quantize_weights_int8(own)
    mine = own.state_dict()
    assert set(mine) == set(sd)
    for k, v in sd.items():
        assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k


def test_quant_drift_runs_on_a_retinanet_cfg(capsys):
    """The drift tool's cfg overrides take RetinaNet with RPN_ONLY, 'int8'
    against float, at test size."""
    import json

    from oneshotdet_tpu_torch.tools import quant_drift as qd

    argv = ["--device", "cpu", "--batch", "1", "--query-hw", "64", "96", "--supp-hw", "32", "32",
            "--dtype", "float32", "--pre-nms", "64", "--post-nms", "32", "--dets", "32",
            "MODEL.FCOS_ON", "False", "MODEL.RETINANET_ON", "True", "MODEL.RPN_ONLY", "True",
            "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "64", "MODEL.RETINANET.PRE_NMS_TOP_N", "64",
            "TPU.NMS_PRE_TOPK", "128"]
    cfg = qd.make_cfg("int8", opts=argv[argv.index("MODEL.FCOS_ON"):])
    assert cfg.MODEL.RETINANET_ON and not cfg.MODEL.FCOS_ON and cfg.TPU.QUANT == "int8"
    assert qd.main(argv) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["metric"] == "drift_int8_vs_float32" and report["images"] == 1
    assert report["mean_valid_float"] > 0 and report["mean_valid_variant"] > 0
