"""Shared set-up of the ``test_torch_port_*`` files: the flagship config at
test size for both packages, seeded weights handed to both, and numpy/torch
conversions. Importing this module imports JAX; the port itself never does.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
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


def random_variables(jax_model, example_args, seed: int = 0):
    """Seeded numpy weights in the JAX variables' structure. Every leaf is
    drawn (none left at its initializer's constant), so near-equal scores
    and the tie order of top-k do not decide the comparisons."""
    shapes = jax.eval_shape(
        lambda: jax_model.init({"params": jax.random.PRNGKey(0)}, *example_args, train=False))
    rng = np.random.RandomState(seed)
    out = {}
    for coll in ("params", "constants"):
        for path, leaf in _leaves(shapes[coll]):
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
            _set(out.setdefault(coll, {}), path, val.astype(np.float32))
    return out


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor."""
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(a if dtype is None else a.astype(dtype)))


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
