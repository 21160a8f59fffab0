"""Shared set-up of the ``test_torch_port_*`` files: the flagship config at
test size for both packages, seeded weights handed to both, and numpy/torch
conversions. Importing this module imports JAX; the port itself never does.
"""

from __future__ import annotations

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

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


def relation_head_setup(b, p, seed=0, num_classes=2, num_bbox_reg=2, linear_fusion=False):
    """Seeded flax params of the relation head, the port's ``ROIBoxHead``
    loaded with them, and (B * P, 7, 7, 256) ROI and (B, 7, 7, 256) support
    features (numpy float32)."""
    from oneshotdet_tpu.models.roi_head import ROIBoxHeadNet
    from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead

    rng = np.random.RandomState(seed)
    roi = rng.randn(b * p, 7, 7, 256).astype(np.float32)
    supp = rng.randn(b, 7, 7, 256).astype(np.float32)
    kw = dict(num_classes=num_classes, num_bbox_reg=num_bbox_reg, linear_fusion=linear_fusion)
    net = ROIBoxHeadNet(in_channels=256, **kw)
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.asarray(roi),
                                             jnp.asarray(supp)))
    params = random_tree(shapes["params"], rng)
    head = ROIBoxHead(**kw)
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


# -- the train step's variants: JAX's reference and its random draws ---------

TRAIN_B, TRAIN_QUERY, TRAIN_SUPP, TRAIN_MAX_GT = 2, (64, 64), (32, 32), 4
LOSS_RTOL, GRAD_REL = 5e-4, 1e-4        # tests/test_torch_port_train.py


def jax_train_inputs(batch, supp_only=False):
    """A flat batch dict -> JAX (images, supports, targets), or the
    supports alone."""
    from oneshotdet_tpu.structures import Boxes as JaxBoxes

    s = JaxImageBatch(jnp.asarray(batch["supp_pixels"]), jnp.asarray(batch["supp_sizes"]))
    if supp_only:
        return s
    q = JaxImageBatch(jnp.asarray(batch["query_pixels"]), jnp.asarray(batch["query_sizes"]))
    targets = JaxBoxes(xyxy=jnp.asarray(batch["gt_xyxy"]), valid=jnp.asarray(batch["gt_valid"]),
                       size=q.sizes_wh(), fields={"labels": jnp.asarray(batch["gt_labels"])})
    return q, s, targets


def jax_sampling_draws(rng, n, b=TRAIN_B):
    """The (B, n) uniforms JAX's prepare_roi_targets draws under the train
    rng ``rng``."""
    keys = jax.random.split(jax.random.fold_in(rng, 1), b)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys]))


def jax_art_offsets(rng, b=TRAIN_B, g=TRAIN_MAX_GT, pool=64, lower=0.5999):
    """The (B, G, pool, 4) jitters JAX's make_artificial_proposals draws
    under the train rng ``rng``."""
    thres = lower + 0.25
    out = []
    for kb in jax.random.split(jax.random.fold_in(rng, 3), b):
        out.append([np.asarray(jax.random.uniform(kg, (pool, 4), minval=thres - 1.0,
                                                  maxval=1.0 - thres))
                    for kg in jax.random.split(kb, g)])
    return torch.from_numpy(np.asarray(out, np.float32))


def train_proposal_count(pcfg):
    """N, the proposals the sampling draws cover: the train capacity plus
    the GT boxes, with artificial proposals capped at 1000."""
    g, post = pcfg.TPU.MAX_GT_BOXES, pcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN
    if pcfg.FEW_SHOT.ADD_ARTIFICIAL_PROPOSALS:
        return min(1000, 12 * g + g + post)
    return post + g


def train_batches():
    """The train tests' two episodes and a third whose supports serve as
    negative supports."""
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    return [make_episodic_batch(TRAIN_B, TRAIN_QUERY, TRAIN_SUPP, max_gt=TRAIN_MAX_GT, seed=s)
            for s in (3, 4, 9)]


# The relation head's kinks: the inputs of its LeakyReLU(0.2)s (the outputs of
# compress_gn0, compress_gn1 and aggreg_gn) and ReLUs (of fc6 and fc7). An
# input within float32 rounding of 0 can fall on either side in two programs
# that sum in different orders, and its derivative (1 or 0.2, 1 or 0) then
# differs; one such element among the head's ~10^5 moves every gradient
# upstream of it past the 1e-4 relative norm bound. The comparison takes JAX's
# side for those elements only (|x| < KINK_TOL, well above the two forwards'
# rounding differences) and requires the same side everywhere else.
KINK_TOL = 1e-4
HEAD_KINKS = ("compress_gn0", "compress_gn1", "aggreg_gn", "fc6", "fc7")


def capture_head_kinks(mdl, method):
    """``capture_intermediates`` filter: the relation head's pre-activations."""
    return method == "__call__" and mdl.name in HEAD_KINKS and \
        mdl.parent is not None and getattr(mdl.parent, "name", None) == "roi_head"


# The FCOS towers' ReLUs, whose inputs are their GroupNorms' outputs, have
# the same kinks: one tower element within rounding of 0 moves the towers',
# the backbones' and the FPNs' gradients past 1e-4 (seen with the support
# augmentation's avg merge).
TOWER_KINKS = tuple(f"{t}_{i}" for t in ("cls_tower", "bbox_tower") for i in range(4))


def capture_kinks(mdl, method):
    """``capture_intermediates`` filter: the relation head's and the FCOS
    towers' pre-activations."""
    parent = getattr(mdl.parent, "name", None) if mdl.parent is not None else None
    return capture_head_kinks(mdl, method) or (
        method == "__call__" and mdl.name == "GroupNorm_0" and parent in TOWER_KINKS)


class _Kink(torch.autograd.Function):
    """relu (slope 0) or leaky_relu: the forward as the port computes it; the
    backward's branch from ``positive`` (a bool mask)."""

    @staticmethod
    def forward(ctx, x, slope, positive):
        ctx.save_for_backward(positive)
        ctx.slope = slope
        return F.leaky_relu(x, slope) if slope else F.relu(x)

    @staticmethod
    def backward(ctx, g):
        (positive,) = ctx.saved_tensors
        return torch.where(positive, g, g * ctx.slope), None, None


class head_kinks_as_jax:
    """Context: the head's activations take JAX's branch (leaky: x >= 0,
    relu: x > 0, from JAX's captured pre-activations, call by call) where
    the port's input is within KINK_TOL of 0, and raise where the two sides
    differ farther from it. ``overridden`` counts the elements taken from
    JAX."""

    def __init__(self, head, kinks):
        self.head, self.kinks = head, kinks
        self.calls = {}
        self.overridden = 0

    def _positive(self, name, x, slope):
        k = self.calls.get(name, 0)
        self.calls[name] = k + 1
        ref = torch.from_numpy(self.kinks[name][k])
        if name == "aggreg_gn" or name in TOWER_KINKS:
            ref = ref.permute(0, 3, 1, 2)            # the port's conv layout, NCHW
        ref = ref.reshape(x.shape)
        own = x > 0
        theirs = ref >= 0 if slope else ref > 0
        near = x.detach().abs() < KINK_TOL
        far = (own != theirs) & ~near
        if bool(far.any()):
            raise AssertionError(f"{name}: {int(far.sum())} activations on another side "
                                 f"of the kink than JAX's, farther than {KINK_TOL}")
        self.overridden += int(((own != theirs) & near).sum())
        return torch.where(near, theirs, own)

    def __enter__(self):
        import oneshotdet_tpu_torch.models.roi_head as rh

        acts = []
        if hasattr(self.head, "compress_dim_conv"):
            acts += [(self.head.compress_dim_conv, 2, "compress_gn0"),
                     (self.head.compress_dim_conv, 5, "compress_gn1")]
        acts.append((self.head.feature_aggreg, 2, "aggreg_gn"))
        self._restore = [(seq, i, seq[i]) for seq, i, _ in acts]
        outer = self

        class Leaky(nn.Module):
            def __init__(self, name):
                super().__init__()
                self.kink = name

            def forward(self, x):
                return _Kink.apply(x, 0.2, outer._positive(self.kink, x, 0.2))

        for seq, i, name in acts:
            seq[i] = Leaky(name)
        relus = iter(())

        def relu(x):
            nonlocal relus
            name = next(relus, None)
            if name is None:                         # each head call: fc6, then fc7
                relus = iter(("fc7",))
                name = "fc6"
            return _Kink.apply(x, 0.0, self._positive(name, x, 0.0))

        self._rh, self._f = rh, rh.F
        rh.F = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                        if not k.startswith("__")})
        rh.F.relu = relu
        return self

    def __exit__(self, *exc):
        for seq, i, mod in self._restore:
            seq[i] = mod
        self._rh.F = self._f


class tower_kinks_as_jax(head_kinks_as_jax):
    """The same for the FCOS head's towers (``kinks`` by TOWER_KINKS name,
    one call per level): each tower block's ReLU (``nn.Sequential`` index
    3 i + 2) differentiated at JAX's branch within KINK_TOL of 0."""

    def __enter__(self):
        outer = self

        class Relu(nn.Module):
            def __init__(self, name):
                super().__init__()
                self.kink = name

            def forward(self, x):
                return _Kink.apply(x, 0.0, outer._positive(self.kink, x, 0.0))

        self._restore = []
        for name in TOWER_KINKS:
            tower, i = name.rsplit("_", 1)
            seq, j = getattr(self.head, tower), 3 * int(i) + 2
            self._restore.append((seq, j, seq[j]))
            seq[j] = Relu(name)
        return self

    def __exit__(self, *exc):
        for seq, i, mod in self._restore:
            seq[i] = mod


# XLA's CPU backend without its LLVM optimizations: the train programs compile
# in about two thirds of the time and run in about a second at this size
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def compile_fast(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def head_shapes(jcfg):
    """The flax shapes of the config's relation head (ROIBoxHeadNet alone)."""
    from oneshotdet_tpu.models.roi_head import ROIBoxHeadNet, predictor_num_classes

    f = jcfg.FEW_SHOT
    ncls, nreg = predictor_num_classes(f.SECOND_STAGE_METHOD, f.SECOND_STAGE_CLS_LOSS,
                                       f.NEG_SUPPORT.TURN_ON)
    net = ROIBoxHeadNet(in_channels=256, num_classes=ncls, num_bbox_reg=nreg,
                        linear_fusion=f.LINEAR_FUSION)
    x = jnp.zeros((2, 7, 7, 256), jnp.float32)
    return jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), x, x))["params"]


def variant_variables(base, jcfg):
    """Seeded flax variables of a config: ``base`` (the default config's
    draws) with the relation head's leaves of another path or shape (the
    predictor's, or linear fusion's 3x3 conv) drawn anew (seed 5), and,
    where the config has them, ``supp_aug_conv`` (SUPP_AUG_METHOD 'conv')
    and the FCOS head's final convs at DENSE_POINTS values per cell drawn
    anew (seed 7)."""
    shapes = head_shapes(jcfg)
    old = dict(_leaves(base["params"]["roi_head"]))
    fresh = dict(_leaves(random_tree(shapes, np.random.RandomState(5))))
    head = {}
    for path, leaf in _leaves(shapes):
        same = path in old and old[path].shape == tuple(leaf.shape)
        _set(head, path, old[path] if same else fresh[path])
    params = dict(base["params"], roi_head=head)
    rng = np.random.RandomState(7)
    dp, c = jcfg.MODEL.FCOS.DENSE_POINTS, jcfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
    if dp != 1:
        fcos = dict(params["fcos_head"])
        for name, out in (("bbox_pred", 4 * dp), ("centerness", dp), ("cls_logits", dp)):
            fcos[name] = random_tree({"bias": np.empty((out,)),
                                      "kernel": np.empty((3, 3, c, out))}, rng)
        params["fcos_head"] = fcos
    if jcfg.FEW_SHOT.SUPP_AUG and jcfg.FEW_SHOT.SUPP_AUG_METHOD == "conv":
        a = 1 + jcfg.FEW_SHOT.NUM_SUPP_AUG
        params["supp_aug_conv"] = random_tree({"kernel": np.empty((3, 3, a * c, c))}, rng)
    return {"params": params, "constants": base["constants"]}


class TrainVariants:
    """Per config (the cfg overrides and whether negative supports are
    given): JAX's value_and_grad of the train apply on the first episode
    (its supports expanded by ``aug_batch`` under FEW_SHOT.SUPP_AUG)
    with the train rng PRNGKey(2), with the relation head's and the FCOS
    towers' pre-activations;
    and the port's forward_train and backward of that config with the same
    weights, fed JAX's draws, its head's and towers' kinks at JAX's branch.
    Each is
    computed once and shared by the config's tests (one instance per test
    module, a module-scoped fixture)."""

    def __init__(self):
        self.batches = train_batches()
        self.rng = jax.random.PRNGKey(2)
        self._refs, self._ports = {}, {}
        self._variables = None

    def batch(self, k, overrides):
        """Episode batch ``k`` as the config takes it: with SUPP_AUG its
        supports cut inside their bucket and expanded by ``aug_batch``."""
        n = supp_aug_of(overrides)
        return aug_batch(self.batches[k], n) if n else self.batches[k]

    def weights(self, overrides):
        """(JAX model, variables) of the config (``variant_variables``)."""
        if self._variables is None:
            jcfg, _ = small_cfgs()
            self._variables = random_variables(jax_build(jcfg),
                                               jax_train_inputs(self.batches[0])[:2])
        jcfg, _ = small_cfgs(*overrides)
        return jax_build(jcfg), variant_variables(self._variables, jcfg)

    def reference(self, overrides, neg=False):
        key = (tuple(overrides), neg)
        if key not in self._refs:
            jm, variables = self.weights(overrides)
            neg_supp = jax_train_inputs(self.batch(2, overrides), supp_only=True) if neg else None

            def loss_fn(params, batch, rng):
                losses, state = jm.apply(
                    {"params": params, "constants": variables["constants"]},
                    *jax_train_inputs(batch), train=True, rng=rng, images_neg_supp=neg_supp,
                    capture_intermediates=capture_kinks, mutable=["intermediates"])
                return sum(losses.values()), (losses, state["intermediates"])

            args = (variables["params"], self.batch(0, overrides), self.rng)
            (_, (losses, kinks)), grads = compile_fast(
                jax.value_and_grad(loss_fn, has_aux=True), *args)(*args)
            self._refs[key] = dict(
                losses={k: float(v) for k, v in losses.items()},
                grads=state_dict_from_flax({"params": grads}),
                state_dict=state_dict_from_flax(variables),
                kinks={name: [np.asarray(x) for x in calls["__call__"]]
                       for name, calls in kinks["roi_head"].items()},
                tower_kinks={name: [np.asarray(x) for x in
                                    kinks["fcos_head"][name]["GroupNorm_0"]["__call__"]]
                             for name in TOWER_KINKS})
        return self._refs[key]

    def port(self, overrides, neg=False, ref_overrides=None):
        """The port's (losses, gradients by name, support layer4 gradients)
        of forward_train and its backward on JAX's draws, with the head's
        and the towers' kinks at JAX's branch (of the config
        ``ref_overrides`` where given)."""
        from oneshotdet_tpu_torch.engine import batch_to_inputs

        key = (tuple(overrides), neg, None if ref_overrides is None else tuple(ref_overrides))
        if key in self._ports:
            return self._ports[key]
        ref = self.reference(overrides if ref_overrides is None else ref_overrides, neg)
        _, pcfg = small_cfgs(*overrides)
        model = build_detection_model(pcfg, device="cpu")
        model.load_state_dict(ref["state_dict"], strict=True)
        model.train()
        neg_supp = batch_to_inputs(self.batch(2, overrides))[1] if neg else None
        art = jax_art_offsets(self.rng) if pcfg.FEW_SHOT.ADD_ARTIFICIAL_PROPOSALS else None
        with head_kinks_as_jax(model.roi_heads.box, ref["kinks"]), \
                tower_kinks_as_jax(model.rpn.head, ref["tower_kinks"]):
            losses = model.forward_train(
                *batch_to_inputs(self.batch(0, overrides)),
                draws=jax_sampling_draws(self.rng, train_proposal_count(pcfg)),
                images_neg_supp=neg_supp, art_offsets=art)
        sum(losses.values()).backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        self._ports[key] = ({k: v.detach() for k, v in losses.items()}, grads)
        return self._ports[key]

    def check_losses(self, overrides, neg=False, keys=None, ref_overrides=None):
        """Each loss within LOSS_RTOL of JAX's, the same keys (``keys``)."""
        ref = self.reference(overrides if ref_overrides is None else ref_overrides, neg)["losses"]
        losses, _ = self.port(overrides, neg, ref_overrides)
        assert set(losses) == set(ref)
        if keys is not None:
            assert set(losses) == set(keys)
        for k, v in losses.items():
            assert v.dtype == torch.float32 and v.dim() == 0
            np.testing.assert_allclose(float(v), ref[k], rtol=LOSS_RTOL, err_msg=k)

    def check_grads(self, overrides, neg=False, ref_overrides=None):
        """Every parameter's gradient within GRAD_REL relative norm of JAX's
        (a parameter JAX gives an all-zero gradient must get zeros), with
        the relation head's and the FCOS towers' activations differentiated
        at JAX's branch where their input lies within float32 rounding of
        the kink (``head_kinks_as_jax``, ``tower_kinks_as_jax``); the support backbone's layer4, reached only
        through the ROIAlign backward, gets a non-zero one.
        ``ref_overrides``: JAX's config, where it is not the port's."""
        ref = self.reference(overrides if ref_overrides is None else ref_overrides, neg)["grads"]
        _, grads = self.port(overrides, neg, ref_overrides)
        for name, got in grads.items():
            want = ref[name]
            got = got if got is not None else torch.zeros_like(want)
            if float(want.norm()) == 0.0:
                assert float(got.norm()) == 0.0, name
                continue
            rel = float((got - want).norm() / want.norm())
            assert rel <= GRAD_REL, f"{name}: {rel:.2e}"
        supp = [g for n, g in grads.items() if n.startswith("supp_backbone.body.layer4")]
        assert all(g is not None and float(g.abs().sum()) > 0 for g in supp)


# -- support augmentation (FEW_SHOT.SUPP_AUG) ---------------------------------

def aug_supports(pixels, sizes, num_aug):
    """Each support (N, h, w, 3) of true size (h, w) followed by its
    ``num_aug`` variants, as the loader lays them out: the flip of its true
    extent (the padding stays where it was), then a colour change standing
    in for the jitter. Returns the (N * (1 + num_aug), ...) pixels and
    sizes (float32 numpy)."""
    pixels, sizes = np.asarray(pixels, np.float32), np.asarray(sizes, np.float32)
    out = []
    for s, (h, w) in zip(pixels, sizes.astype(int)):
        flip = s.copy()
        flip[:h, :w] = s[:h, :w][:, ::-1]
        jit = s.copy()
        jit[:h, :w] = s[:h, :w] * np.float32(0.7) + np.float32(0.1)
        out += [s, flip, jit][:1 + num_aug]
    return np.stack(out), np.repeat(sizes, 1 + num_aug, axis=0)


def aug_batch(batch, num_aug, true_hw=(26, 30)):
    """A flat batch dict whose supports, cut to ``true_hw`` inside their
    bucket (zeros beyond, the padding every variant shares), are expanded
    by ``aug_supports``."""
    (h, w), pixels = true_hw, np.array(batch["supp_pixels"], np.float32)
    pixels[:, h:] = 0.0
    pixels[:, :, w:] = 0.0
    sizes = np.tile(np.array([[h, w]], np.float32), (len(pixels), 1))
    pixels, sizes = aug_supports(pixels, sizes, num_aug)
    return dict(batch, supp_pixels=pixels, supp_sizes=sizes)


def supp_aug_of(overrides):
    """NUM_SUPP_AUG of a list of cfg overrides with FEW_SHOT.SUPP_AUG on,
    else 0."""
    opts = dict(zip(overrides[::2], overrides[1::2]))
    return int(opts.get("FEW_SHOT.NUM_SUPP_AUG", 1)) if opts.get("FEW_SHOT.SUPP_AUG") else 0


# -- the mask and keypoint heads (MODEL.MASK_ON / KEYPOINT_ON) ----------------

# Their ReLUs, by the flax name of the conv whose output they take: the mask
# head's mask_fcn{i} and conv5_mask, the keypoint head's conv_fcn{i}.
MASK_KP_KINK = r"^(mask_fcn\d+|conv5_mask|conv_fcn\d+)$"


def capture_mask_kp_kinks(mdl, method):
    """``capture_intermediates`` filter: the relation head's and the FCOS
    towers' pre-activations (``capture_kinks``) and the mask and keypoint
    heads' convs' outputs."""
    import re

    return capture_kinks(mdl, method) or (
        method == "__call__" and mdl.name is not None
        and re.match(MASK_KP_KINK, mdl.name) is not None)


def mask_kp_kink_arrays(intermediates):
    """{conv name: [one array per call]} of the mask and keypoint heads in
    a flax ``intermediates`` tree ('mask_head' / 'keypoint_head' ->
    'feature_extractor' / 'predictor' -> name -> '__call__')."""
    out = {}
    for head in ("mask_head", "keypoint_head"):
        for part in intermediates.get(head, {}).values():
            for name, calls in part.items():
                out[name] = [np.asarray(x) for x in calls["__call__"]]
    return out


class mask_kp_kinks_as_jax(head_kinks_as_jax):
    """The mask and keypoint heads' ReLUs differentiated at JAX's branch
    where their input lies within KINK_TOL of 0 (``head_kinks_as_jax``'s
    rule; ``kinks`` from ``mask_kp_kink_arrays``). The heads call ``F.relu``
    in order: mask_fcn1.., conv5_mask; conv_fcn1.."""

    def __init__(self, model, kinks):
        super().__init__(None, kinks)
        self.model = model

    def __enter__(self):
        import oneshotdet_tpu_torch.models.keypoint_head as kh
        import oneshotdet_tpu_torch.models.mask_head as mh

        heads = self.model.roi_heads
        orders = []
        if hasattr(heads, "mask"):
            n = heads.mask.feature_extractor.num_layers
            orders.append((mh, [f"mask_fcn{i + 1}" for i in range(n)] + ["conv5_mask"]))
        if hasattr(heads, "keypoint"):
            n = heads.keypoint.feature_extractor.num_layers
            orders.append((kh, [f"conv_fcn{i + 1}" for i in range(n)]))
        self._saved = []
        for mod, names in orders:
            seq = {"i": 0}

            def relu(x, names=names, seq=seq):
                name = names[seq["i"] % len(names)]
                seq["i"] += 1
                return _Kink.apply(x, 0.0, self._positive(name, x, 0.0))

            self._saved.append((mod, mod.F))
            mod.F = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                             if not k.startswith("__")})
            mod.F.relu = relu
        return self

    def _positive(self, name, x, slope):
        k = self.calls.get(name, 0)
        self.calls[name] = k + 1
        ref = torch.from_numpy(np.array(self.kinks[name][k])).permute(0, 3, 1, 2)  # NCHW
        own = x > 0
        theirs = ref > 0
        near = x.detach().abs() < KINK_TOL
        far = (own != theirs) & ~near
        if bool(far.any()):
            raise AssertionError(f"{name}: {int(far.sum())} activations on another side "
                                 f"of the kink than JAX's, farther than {KINK_TOL}")
        self.overridden += int(((own != theirs) & near).sum())
        return torch.where(near, theirs, own)

    def __exit__(self, *exc):
        for mod, f in self._saved:
            mod.F = f


# -- the anchor stage 1 (MODEL.FCOS_ON False: the anchor RPN, RetinaNet) -------

# tests/test_stage1_dispatch.py::_small_base: the packages' defaults at 64 FPN
# channels, one backbone, small capacities, the anchor RPN's five strides
STAGE1_SMALL = [
    "MODEL.FCOS_ON", False,
    "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
    "MODEL.RETINANET.USE_C5", False,
    "FEW_SHOT.SIAMESE_BACKBONE", False,
    "FEW_SHOT.SECOND_STAGE_METHOD", "concat",
    "FEW_SHOT.SECOND_STAGE_CLS_LOSS", "ce_loss",
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 64,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 32,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.RPN.ANCHOR_STRIDE", "(8, 16, 32, 64, 128)",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 8,
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 16,
    "TPU.MAX_GT_BOXES", 4,
    "TPU.NMS_PRE_TOPK", 128,
    "TPU.COMPUTE_DTYPE", "float32",
]
# RetinaNet as tests/test_stage1_dispatch.py builds it
RETINA = ["MODEL.RETINANET_ON", True, "MODEL.RETINANET.PRE_NMS_TOP_N", 64]


def stage1_cfgs(*overrides):
    """(JAX cfg, port cfg): the defaults, STAGE1_SMALL, overrides."""
    out = []
    for base in (jax_default_cfg, port_default_cfg):
        c = base.clone()
        c.merge_from_list(STAGE1_SMALL + list(overrides))
        out.append(c)
    return tuple(out)


def stage1_inputs(seed=0):
    """numpy (queries (2, 64, 64, 3), their (h, w), supports (2, 32, 32, 3),
    their (h, w)), the second image of each smaller than its bucket."""
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 64, 64, 3).astype(np.float32),
            np.array([[64.0, 64.0], [48.0, 56.0]], np.float32),
            rng.randn(2, 32, 32, 3).astype(np.float32),
            np.array([[32.0, 32.0], [32.0, 24.0]], np.float32))


def stage1_setup(*overrides):
    """Seeded weights of the config's JAX model (``random_variables`` on
    ``stage1_inputs``) for both packages: dict(jcfg, pcfg, jm, variables,
    state_dict, jax=(images, supports), port=(images, supports))."""
    q, qs, s, ss = stage1_inputs()
    jcfg, pcfg = stage1_cfgs(*overrides)
    jm = jax_build(jcfg)
    jq = JaxImageBatch(jnp.asarray(q), jnp.asarray(qs))
    js = JaxImageBatch(jnp.asarray(s), jnp.asarray(ss))
    variables = random_variables(jm, (jq, js))
    head = variables["params"].get("retinanet_module", {}).get("head", {})
    for conv in head.values():
        # RetinaNet's towers have no norm: at N(0, 1/fan_in) their logits
        # reach +-5000 on the fused pyramid, where the sigmoid saturates and
        # JAX's jitted focal loss rounds log(1 - p + 1e-6) 0.3% away from its
        # own op-by-op value; the head's init scale, N(0, 0.01), keeps them
        # near +-10
        k = conv["kernel"]
        conv["kernel"] = (k * np.float32(0.01 * np.sqrt(np.prod(k.shape[:-1])))).astype(np.float32)
    return dict(jcfg=jcfg, pcfg=pcfg, jm=jm, variables=variables,
                state_dict=state_dict_from_flax(variables), jax=(jq, js),
                port=(ImageBatch(t(q), t(qs)), ImageBatch(t(s), t(ss))))


def stage1_port(setup):
    """The port's model of a ``stage1_setup`` on the CPU, its weights loaded
    strictly."""
    model = build_detection_model(setup["pcfg"], device="cpu")
    model.load_state_dict(setup["state_dict"], strict=True)
    return model


def jax_rpn_draws(rng, n, b=TRAIN_B):
    """The (B, n) uniforms JAX's anchor RPN loss draws under the train rng
    ``rng``: ``fold_in(rng, 7)`` split per image."""
    keys = jax.random.split(jax.random.fold_in(rng, 7), b)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys]))


def anchor_proposal_count(pcfg, feature_shapes, anchors_per_cell=3):
    """The anchor RPN's train proposal capacity for these level shapes."""
    r = pcfg.MODEL.RPN
    per_level = [min(r.POST_NMS_TOP_N_TRAIN, r.PRE_NMS_TOP_N_TRAIN, h * w * anchors_per_cell)
                 for h, w in feature_shapes]
    return min(r.FPN_POST_NMS_TOP_N_TRAIN, sum(per_level))


def _stage1_kink(mdl, method):
    """``capture_intermediates`` filter: the relation head's pre-activations
    and the outputs of the anchor heads' convs that a ReLU takes (the RPN
    head's ``conv``, RetinaNet's ``{cls,bbox}_tower_i``)."""
    import re

    if method != "__call__" or mdl.parent is None:
        return False
    if capture_head_kinks(mdl, method):
        return True
    head = mdl.parent
    stage1 = getattr(head.parent, "name", None) if head.parent is not None else None
    return head.name == "head" and (
        (stage1 == "rpn_module" and mdl.name == "conv")
        or (stage1 == "retinanet_module" and re.match(r"^(cls|bbox)_tower_\d$", mdl.name or "")
            is not None))


class anchor_kinks_as_jax(mask_kp_kinks_as_jax):
    """The anchor heads' ReLUs (the RPN head's one, RetinaNet's tower ReLUs)
    differentiated at JAX's branch where their input lies within KINK_TOL of
    0 (``head_kinks_as_jax``'s rule; ``kinks`` by the flax conv's name, one
    array per level)."""

    def __init__(self, head, kinks):
        super().__init__(None, kinks)
        self.head = head

    def __enter__(self):
        outer = self

        class Relu(nn.Module):
            def __init__(self, name):
                super().__init__()
                self.kink = name

            def forward(self, x):
                return _Kink.apply(x, 0.0, outer._positive(self.kink, x, 0.0))

        self._restore = []
        if hasattr(self.head, "relu"):                     # the RPN head
            self._restore.append((self.head, "relu", self.head.relu))
            self.head.relu = Relu("conv")
        else:                                              # RetinaNet's towers
            for tower in ("cls_tower", "bbox_tower"):
                seq = getattr(self.head, tower)
                for i in range(len(seq) // 2):
                    self._restore.append((seq, 2 * i + 1, seq[2 * i + 1]))
                    seq[2 * i + 1] = Relu(f"{tower}_{i}")
        return self

    def __exit__(self, *exc):
        for owner, key, mod in self._restore:
            if isinstance(key, int):
                owner[key] = mod
            else:
                setattr(owner, key, mod)


def anchor_train_reference(setup, batch, rng):
    """JAX's value_and_grad of the config's train apply on ``batch`` under
    ``rng`` (one FAST_COMPILE jit): dict(losses, grads by port name, kinks
    of the relation head, kinks of the anchor head)."""
    jm, variables = setup["jm"], setup["variables"]

    def loss_fn(params, batch, rng):
        losses, state = jm.apply({"params": params, "constants": variables["constants"]},
                                 *jax_train_inputs(batch), train=True, rng=rng,
                                 capture_intermediates=_stage1_kink, mutable=["intermediates"])
        return sum(losses.values()), (losses, state["intermediates"])

    args = (variables["params"], batch, rng)
    (_, (losses, inter)), grads = compile_fast(
        jax.value_and_grad(loss_fn, has_aux=True), *args)(*args)
    stage1 = "rpn_module" if "rpn_module" in inter else "retinanet_module"
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads=state_dict_from_flax({"params": grads}),
                head_kinks={name: [np.asarray(x) for x in calls["__call__"]]
                            for name, calls in inter.get("roi_head", {}).items()},
                anchor_kinks={name: [np.asarray(x) for x in calls["__call__"]]
                              for name, calls in inter[stage1]["head"].items()})


# At 64 FPN channels the relation head's aggreg conv has 32 outputs, one to a
# GroupNorm group: the norm removes the conv's bias, whose gradient is 0 in
# exact arithmetic and rounding noise on both sides (~1e-7 against its
# weight's ~10). It is held to 1e-6 of its weight's gradient instead.
SHIFT_INVARIANT_64 = {
    "roi_heads.box.feature_aggreg.0.bias": "roi_heads.box.feature_aggreg.0.weight"}


def check_train_against(ref, losses, grads):
    """Each loss within LOSS_RTOL of JAX's (the same keys) and each
    gradient within GRAD_REL relative norm (a parameter JAX gives an
    all-zero gradient gets none, or zeros; SHIFT_INVARIANT_64's biases
    within 1e-6 of their weight's gradient on both sides)."""
    assert set(losses) == set(ref["losses"])
    for k, v in losses.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        np.testing.assert_allclose(float(v.detach()), ref["losses"][k], rtol=LOSS_RTOL, err_msg=k)
    for name, got in grads.items():
        want = ref["grads"][name]
        got = got if got is not None else torch.zeros_like(want)
        if name in SHIFT_INVARIANT_64 and float(want.norm()) > 0:
            scale = float(ref["grads"][SHIFT_INVARIANT_64[name]].norm())
            assert max(float(want.norm()), float(got.norm())) <= 1e-6 * scale, name
            continue
        if float(want.norm()) == 0.0:
            assert float(got.norm()) == 0.0, name
            continue
        rel = float((got - want).norm() / want.norm())
        assert rel <= GRAD_REL, f"{name}: {rel:.2e}"


def assert_same_slots(port, ref, fields=("scores",)):
    """Padded Boxes equal slot by slot: the same valid slots, and in them
    the boxes within BOX_RTOL and each field within SCORE_RTOL. Stage-1
    outputs sort by score with ties in index order on both sides, so their
    slots line up; a set comparison by IoU cannot tell apart the identical
    boxes that clipping gives several anchors."""
    np.testing.assert_array_equal(np_(port.valid), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    assert v.any()
    np.testing.assert_allclose(np_(port.xyxy)[v], np.asarray(ref.xyxy)[v], rtol=BOX_RTOL,
                               atol=1e-3)
    for name in fields:
        np.testing.assert_allclose(np_(port.fields[name])[v], np.asarray(ref.fields[name])[v],
                                   rtol=SCORE_RTOL, atol=1e-6, err_msg=name)
