"""Shared set-up of the ``test_torch_port_*`` files: the flagship config at
test size for both packages, seeded weights handed to both, and numpy/torch
conversions. Importing this module imports JAX; the port itself never does.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.config import cfg as jax_default_cfg
from oneshotdet_tpu.models import build_detection_model as jax_build
from oneshotdet_tpu.structures import ImageBatch as JaxImageBatch
from oneshotdet_tpu_torch.config import cfg as port_default_cfg
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.structures import ImageBatch
from oneshotdet_tpu_torch.utils.weights import state_dict_from_flax

SCORE_RTOL, BOX_RTOL = 5e-4, 1e-3       # tests/test_e2e_parity.py

FLAGSHIP = os.path.join(os.path.dirname(__file__), os.pardir, "configs", "oneshot_fcos_r50.yaml")

# capacities of tests/test_detector.py, float32 compute
SMALL = [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 200,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 100,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 64,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 32,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 32,
    "TPU.MAX_GT_BOXES", 4,
    "TPU.NMS_PRE_TOPK", 256,
    "TPU.COMPUTE_DTYPE", "float32",
]


def small_cfgs(*overrides):
    """(JAX cfg, port cfg): the flagship yaml, test capacities, overrides."""
    out = []
    for base in (jax_default_cfg, port_default_cfg):
        c = base.clone()
        c.merge_from_file(FLAGSHIP)
        c.merge_from_list(SMALL + list(overrides))
        out.append(c)
    return tuple(out)


def _leaves(tree, prefix=()):
    if hasattr(tree, "items"):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def random_tree(shapes, rng):
    """Seeded numpy leaves in the structure of a tree of shapes: kernels
    N(0, 1/fan_in), scales 1 + 0.1 N, variances 1 + 0.2 |N|, biases and
    means 0.1 N, drawn in sorted path order."""
    out = {}
    for path, leaf in _leaves(shapes):
        shape, name = tuple(leaf.shape), path[-1]
        n = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            val = n * np.float32(np.sqrt(1.0 / fan_in))
        elif name in ("scale", "weight"):
            val = 1.0 + 0.1 * n
        elif name == "running_var":
            val = 1.0 + 0.2 * np.abs(n)
        else:   # bias, running_mean
            val = 0.1 * n
        _set(out, path, val.astype(np.float32))
    return out


def random_variables(jax_model, example_args, seed: int = 0):
    """Seeded numpy weights in the JAX variables' structure. Every leaf is
    drawn (none left at its initializer's constant), so near-equal scores
    and the tie order of top-k do not decide the comparisons."""
    shapes = jax.eval_shape(
        lambda: jax_model.init({"params": jax.random.PRNGKey(0)}, *example_args, train=False))
    rng = np.random.RandomState(seed)
    return {coll: random_tree(shapes[coll], rng) for coll in ("params", "constants")}


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor."""
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(a if dtype is None else a.astype(dtype)))


def relation_head_setup(b, p, seed=0):
    """Seeded flax params of the relation head, the port's ``ROIBoxHead``
    loaded with them, and (B * P, 7, 7, 256) ROI and (B, 7, 7, 256) support
    features (numpy float32)."""
    from oneshotdet_tpu.models.roi_head import ROIBoxHeadNet
    from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead

    rng = np.random.RandomState(seed)
    roi = rng.randn(b * p, 7, 7, 256).astype(np.float32)
    supp = rng.randn(b, 7, 7, 256).astype(np.float32)
    net = ROIBoxHeadNet(in_channels=256, num_classes=2, num_bbox_reg=2)
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.asarray(roi),
                                             jnp.asarray(supp)))
    params = random_tree(shapes["params"], rng)
    head = ROIBoxHead()
    prefix = "roi_heads.box."
    head.load_state_dict({k[len(prefix):]: v for k, v in state_dict_from_flax(
        {"params": {"roi_head": params}}).items()}, strict=True)
    return params, head, roi, supp


def make_setup():
    """Seeded inputs and weights for both packages: batch 2, 64x64 queries,
    32x32 supports, the flagship config at test capacities."""
    rng = np.random.RandomState(0)
    q = rng.randn(2, 64, 64, 3).astype(np.float32)
    qs = np.array([[64.0, 64.0], [48.0, 56.0]], np.float32)
    s = rng.randn(2, 32, 32, 3).astype(np.float32)
    ss = np.array([[32.0, 32.0], [32.0, 24.0]], np.float32)
    jcfg, _ = small_cfgs()
    jq, js = JaxImageBatch(jnp.asarray(q), jnp.asarray(qs)), JaxImageBatch(jnp.asarray(s), jnp.asarray(ss))
    variables = random_variables(jax_build(jcfg), (jq, js))
    return dict(variables=variables, state_dict=state_dict_from_flax(variables),
                jax=(jq, js), port=(ImageBatch(t(q), t(qs)), ImageBatch(t(s), t(ss))))


def port_model(setup, *overrides, state_dict=None):
    """(JAX model, port model on the CPU with the setup's weights)."""
    jcfg, pcfg = small_cfgs(*overrides)
    port = build_detection_model(pcfg, device="cpu")
    port.load_state_dict(setup["state_dict"] if state_dict is None else state_dict, strict=True)
    return jax_build(jcfg), port


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _iou(box, boxes):
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    inter = np.prod(np.clip(rb - lt + 1, 0, None), axis=1)
    area = lambda b: (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    return inter / (area(box) + area(boxes) - inter)


def assert_same_detections(port, ref, score_field="scores"):
    """Valid detections agree as sets, matched by IoU: same count, and each
    JAX box has a port box whose score and coordinates are within tolerance."""
    for i in range(ref.valid.shape[0]):
        jv, pv = np_(ref.valid[i]), np_(port.valid[i])
        jb, pb = np_(ref.xyxy[i])[jv], np_(port.xyxy[i])[pv]
        js, ps = np_(ref.fields[score_field][i])[jv], np_(port.fields[score_field][i])[pv]
        assert len(jb) == len(pb) > 0
        for box, score in zip(jb, js):
            j = int(np.argmax(_iou(box, pb)))
            np.testing.assert_allclose(pb[j], box, rtol=BOX_RTOL, atol=1e-3)
            np.testing.assert_allclose(ps[j], score, rtol=SCORE_RTOL, atol=1e-6)


# the data path at test size: 60x80 / 80x60 images into 64x96 / 96x64 query
# buckets, supports into 48x48; no class held out in training
DATA_OPTS = [
    "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MAX_SIZE_TRAIN", 96,
    "INPUT.SUPP_MIN_SIZE_TRAIN", "(32,)", "INPUT.SUPP_MAX_SIZE_TRAIN", 48,
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "INPUT.SUPP_MIN_SIZE_TEST", 32, "INPUT.SUPP_MAX_SIZE_TEST", 48,
    "INPUT.SUPP_AREA_THRESHOLD", 100,
    "TPU.QUERY_BUCKETS", "((64, 96), (96, 64))", "TPU.SUPP_BUCKET", "(48, 48)",
    "TPU.HOST_S2D", False,
    "FEW_SHOT.TRAINING_EXCL_CATS", "[]",
    "DATASETS.TRAIN", "('custom',)", "DATASETS.TEST", "('custom',)",
    "DATALOADER.NUM_WORKERS", 0,
    "TEST.IMS_PER_BATCH", 3, "SOLVER.IMS_PER_BATCH", 3, "SOLVER.MAX_ITER", 4,
]
DATA_IMAGE_SIZES = ((60, 80), (80, 60), (60, 80))


def write_dataset(root, num_images=16, seed=0):
    """(image dir, annotation file) of a synthetic PPM dataset at test size."""
    from oneshotdet_tpu_torch.utils.synthetic import write_synthetic_coco

    return write_synthetic_coco(root, num_images=num_images, sizes=DATA_IMAGE_SIZES,
                                num_categories=3, box_side=(12.0, 40.0), seed=seed)


def data_cfgs(*overrides):
    """(JAX cfg, port cfg) of the data path at test size."""
    return small_cfgs(*DATA_OPTS, *overrides)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Torch ops on one thread for a module's tests (restored after): the
    data-path tests run many small ops, which the tier-1 run's parallel
    workers slow down when each also spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
