"""TPU.QUANT ('int8', 'int8_weight') in the port against the JAX package on
the CPU, in float32, on the same seeded weights (tests/torch_port_common.py):

  - the quantizers' int8 codes and scales bit for bit, rounding ties among
    the inputs; ``int8_conv`` (1x1, 3x3, stride 2) and ``int8_dot``: int32
    accumulators equal to JAX's int32 products of the same codes, and equal
    dequantized outputs;
  - the eval forward of the flagship with both heads, 'int8' (global top-k)
    and 'int8_weight' (two shots, per-level top-k, EVAL_ROI_TOPK): each
    module's outputs (both backbones + FPN, the FCOS head, the relation
    head, the mask and keypoint heads) within 1e-5 of their maximum, the
    detections within the detection tolerances, the masks and keypoint
    scores within 1e-5; the cached-support entry point from a transformed
    tree; all against JAX's op-by-op (un-jitted) apply, whose scales are
    the source's true division (``jax.jit`` rewrites them);
  - the offline transform: JAX's ``quantize_weights_int8`` tree through
    ``state_dict_from_flax`` into the port (strict), equal to the port's own
    ``quantize_weights_int8``, and a float state dict into an 'int8_weight'
    model (strict);
  - the invalid-slot scale, the train raise, the modes' ValueError, the
    fused head on int8 codes, the drift tool and an exported 'int8' program.

'int8' is discontinuous in its inputs: a float rounding difference of 1e-7
between the two packages (another summation order in a float conv, GroupNorm
or ROIAlign before a quantizer) moves an activation code across a rounding
boundary now and then, and the step it makes (1/127 of the tensor's
maximum) moves every code after it. So the 'int8' model comparisons run
``forced``: JAX's forward records the input and output of every int8 layer
(``nn.intercept_methods``); the port's forward checks each int8 layer's own
input against JAX's within FORCE_RTOL of the input's maximum, then computes
the layer on JAX's input, whose output must then equal JAX's bit for bit.
Every float op between two int8 layers is held to FORCE_RTOL, every int8
layer is held exactly, and the detections to the detection tolerances. The
unforced gap is in ``test_unforced_int8_gap_is_quantization_noise``: as
large as the int8 noise itself.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from oneshotdet_tpu.ops import quant as jq
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.ops import quant as pq
from oneshotdet_tpu_torch.utils.weights import map_flax_leaf, state_dict_from_flax
from torch_port_common import (assert_same_detections, jax_build, make_setup, np_,
                               one_torch_thread, port_model,  # noqa: F401
                               random_variables, small_cfgs, t)

# torch on one thread: the tier-1 run's six workers share the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# a float op chain between two int8 layers, of max|input|: a GroupNorm among
# them differs from flax's by its one-pass variance's rounding, which
# test_torch_port_model.py::test_group_norm_matches_flax bounds by 1e-4
FORCE_RTOL = 1e-4
MODULE_RTOL = 1e-5
# a stage-2 score threshold that leaves detection slots invalid
INVALID_DETS = ("MODEL.ROI_HEADS.SCORE_THRESH", 0.5)
# the mask and keypoint heads on the flagship at test size: narrow fcn convs,
# the default 14x14 pools on P4
HEADS = ["MODEL.MASK_ON", True, "MODEL.KEYPOINT_ON", True,
         "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", "(32, 32)",
         "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(32, 32)",
         "MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES", 5]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


# -- forcing: JAX's int8 layer inputs into the port's ---------------------------

_JAX_INT8 = (jq.QuantConv8, jq.QuantDense8)


# the detector's modules whose outputs the forward tests compare: JAX's
# top-level name -> the port's module
MODULES = {"backbone": "backbone", "supp_backbone": "supp_backbone", "fcos_head": "rpn.head",
           "roi_head": "roi_heads.box", "mask_head": "roi_heads.mask",
           "keypoint_head": "roi_heads.keypoint"}


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _flat(x)]
    return [tree]


class JaxInt8Calls:
    """Context: records (inputs, output) of every int8 layer call of JAX's
    forward, by module path, in call order (compress_0's halves at
    ``_ConcatConv1x1.__call__``, its two inputs), and the outputs of the
    MODULES' calls (``outputs``, flattened)."""

    def __init__(self):
        self.calls, self.outputs = {}, {}

    def _intercept(self, next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        from oneshotdet_tpu.models.roi_head import _ConcatConv1x1

        if context.method_name != "__call__":
            return out
        path = tuple(mod.path)
        if isinstance(mod, _JAX_INT8) or (isinstance(mod, _ConcatConv1x1)
                                          and mod.quant == "int8"):
            self.calls.setdefault(path, []).append(
                ([np.asarray(a) for a in args], None if isinstance(out, tuple)
                 else np.asarray(out)))
        elif len(path) == 1 and path[0] in MODULES:
            self.outputs.setdefault(path[0], []).append([np.asarray(x) for x in _flat(out)])
        return out

    def __enter__(self):
        self._ctx = fnn.intercept_methods(self._intercept)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


def _port_name(jpath):
    """A JAX module path -> the port module's name (through the weight map)."""
    key, _ = map_flax_leaf("params", tuple(jpath) + ("kernel",))
    return key[: -len(".weight")]


def _close(own, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(own - ref).max())
    assert err <= FORCE_RTOL * scale, f"{what}: {err} > {FORCE_RTOL} x {scale}"


class forced:
    """Context over a port model: every int8 layer checks its own input
    against JAX's recorded one for that call (within FORCE_RTOL of its
    maximum), takes JAX's, and must give JAX's output bit for bit; the
    relation head (compress_0's halves) takes JAX's ROI and support
    features the same way. ``layers`` counts the forced calls."""

    def __init__(self, model, calls):
        self.model, self.calls = model, calls
        self.layers = 0

    def _take(self, jpath):
        seen = self._seen.get(jpath, 0)
        self._seen[jpath] = seen + 1
        return self.calls[jpath][seen]

    def __enter__(self):
        self._seen, self._handles = {}, []
        mods = dict(self.model.named_modules())
        for jpath in self.calls:
            if jpath[-1] == "compress_0":
                name = _port_name(jpath)[: -len(".compress_dim_conv.0")]
                self._handles.append(mods[name].register_forward_pre_hook(
                    self._head_pre(jpath)))
                continue
            mod = mods[_port_name(jpath)]
            self._handles.append(mod.register_forward_pre_hook(self._pre(jpath)))
            self._handles.append(mod.register_forward_hook(self._post(jpath)))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        if exc[0] is None:
            for jpath, recorded in self.calls.items():
                assert self._seen.get(jpath, 0) == len(recorded), jpath

    def _pre(self, jpath):
        def hook(mod, args):
            (x_ref,), _ = self._take(jpath)
            x = args[0]
            if x.dim() == 4:                       # the port's conv input is NCHW
                x_ref = x_ref.transpose(0, 3, 1, 2)
            _close(np_(x), x_ref, f"{jpath} input")
            self.layers += 1
            return (torch.from_numpy(np.ascontiguousarray(x_ref)).to(x.dtype).contiguous(
                memory_format=torch.channels_last if x.dim() == 4 else torch.contiguous_format),)
        return hook

    def _post(self, jpath):
        def hook(mod, args, out):
            _, y_ref = self.calls[jpath][self._seen[jpath] - 1]
            y = np_(out.permute(0, 2, 3, 1) if out.dim() == 4 else out)
            np.testing.assert_array_equal(y, y_ref, err_msg=str(jpath))
        return hook

    def _head_pre(self, jpath):
        def hook(mod, args):
            (a_ref, b_ref), _ = self._take(jpath)
            _close(np_(args[0]), a_ref, f"{jpath} query input")
            _close(np_(args[1]), b_ref, f"{jpath} support input")
            self.layers += 1
            return (torch.from_numpy(a_ref), torch.from_numpy(b_ref)) + tuple(args[2:])
        return hook


def run_both(jax_fn, port_model_, port_fn, quant):
    """(JAX's result, the port's): under 'int8' the port runs ``forced`` by
    JAX's int8 layers (and at least one is forced)."""
    if quant != "int8":
        return jax_fn(), port_fn()
    with JaxInt8Calls() as rec:
        ref = jax_fn()
    with forced(port_model_, rec.calls) as f:
        out = port_fn()
    assert f.layers > 0
    return ref, out


# -- the eval forward --------------------------------------------------------

class port_outputs:
    """Context: the outputs of the port model's MODULES' calls, flattened,
    the backbones' NCHW levels as NHWC (``outputs``)."""

    def __init__(self, model):
        self.model, self.outputs = model, {}

    def __enter__(self):
        mods = dict(self.model.named_modules())
        self.handles = []
        for jname, name in MODULES.items():
            if name in mods:
                def hook(mod, args, out, jname=jname):
                    flat = [x.permute(0, 2, 3, 1) if jname.endswith("backbone") else x
                            for x in _flat(out)]
                    self.outputs.setdefault(jname, []).append([np_(x) for x in flat])
                self.handles.append(mods[name].register_forward_hook(hook))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def _compare_modules(out, ref, head_rows=None):
    """Every recorded module call's outputs within MODULE_RTOL of their
    maximum (the mask and keypoint heads' in the rows ``head_rows`` only,
    where given); returns the modules compared."""
    assert set(out) == set(ref)
    for name, calls in ref.items():
        assert len(out[name]) == len(calls), name
        rows = head_rows if name in ("mask_head", "keypoint_head") else None
        for k, (got, want) in enumerate(zip(out[name], calls)):
            assert len(got) == len(want), name
            for i, (g, w) in enumerate(zip(got, want)):
                if rows is not None:
                    g, w = g[rows], np.asarray(w)[rows]
                _rel_close(g, w, f"{name} call {k} output {i}")
    return set(ref)


@pytest.fixture(scope="module")
def mk(setup):
    """Seeded JAX variables (seed 1) of the flagship with both heads."""
    jcfg, _ = small_cfgs(*HEADS)
    variables = random_variables(jax_build(jcfg), setup["jax"], seed=1)
    return dict(variables=variables, state_dict=state_dict_from_flax(variables))


def mk_model(setup, mk, *overrides):
    return port_model(setup, *HEADS, *overrides, state_dict=mk["state_dict"])


@pytest.fixture(scope="module")
def int8_ref(setup, mk):
    """JAX's 'int8' forward of the flagship with both heads (global top-k;
    a score threshold that leaves detection slots invalid): its detections,
    its int8 layers' calls and its modules' outputs."""
    jm, _ = mk_model(setup, mk, "TPU.QUANT", "int8", *INVALID_DETS)
    with JaxInt8Calls() as rec:
        ref = jm.apply(mk["variables"], *setup["jax"], target_ids=jnp.array([3, 5]))
    return ref, rec


def test_int8_eval_forward_matches_jax(setup, mk, int8_ref):
    """Replayed on JAX's int8 layer inputs: every module's outputs (both
    backbones + FPN, the FCOS head, the relation head, the mask and keypoint
    heads) within 1e-5, the detections within the detection tolerances, and
    mask_probs and keypoint scores within 1e-5 in every slot, the invalid
    ones too (the heads pool every slot, as JAX does, and the slots hold
    JAX's boxes)."""
    ref, rec = int8_ref
    _, pm = mk_model(setup, mk, "TPU.QUANT", "int8", *INVALID_DETS)
    with forced(pm, rec.calls) as f, port_outputs(pm) as mods:
        out = pm(*setup["port"], target_ids=torch.tensor([3, 5]))
    assert f.layers > 100
    assert _compare_modules(mods.outputs, rec.outputs) == set(MODULES)
    assert_same_detections(out, ref)
    valid = np_(out.valid)
    assert (~valid).any() and valid.any()
    for field in ("mask_probs", "keypoints_scores"):
        np.testing.assert_allclose(np_(out.get_field(field)), np.asarray(ref.get_field(field)),
                                   rtol=0, atol=1e-5, err_msg=field)


@pytest.fixture(scope="module")
def two_shot(setup):
    """Two supports per image (batch-4 supports) for both packages."""
    from oneshotdet_tpu.structures import ImageBatch as JaxImageBatch
    from oneshotdet_tpu_torch.structures import ImageBatch

    rng = np.random.RandomState(1)
    s = rng.randn(4, 32, 32, 3).astype(np.float32)
    ss = np.array([[32.0, 32.0], [24.0, 32.0], [32.0, 24.0], [20.0, 28.0]], np.float32)
    return dict(jax=(setup["jax"][0], JaxImageBatch(jnp.asarray(s), jnp.asarray(ss))),
                port=(setup["port"][0], ImageBatch(t(s), t(ss))))


def test_int8_weight_eval_forward_matches_jax(setup, mk, two_shot):
    """Two shots (the shot-averaged fusion, a head pass per shot), the
    per-level stage-1 top-k, EVAL_ROI_TOPK 16 and both heads: every
    module's outputs within 1e-5 (the heads' in the valid slots: the port
    pools zeros in the others outside 'int8'), the detections, and
    mask_probs and keypoint scores within 1e-5 in the valid slots."""
    jm, pm = mk_model(setup, mk, "TPU.QUANT", "int8_weight", "TPU.STRICT_LEVEL_TOPK", True,
                      "TPU.EVAL_ROI_TOPK", 16, *INVALID_DETS)
    with JaxInt8Calls() as rec:
        ref = jm.apply(mk["variables"], *two_shot["jax"], target_ids=jnp.array([3, 5]))
    with port_outputs(pm) as mods:
        out = pm(*two_shot["port"], target_ids=torch.tensor([3, 5]))
    assert out.xyxy.shape == (2, 16, 4)
    assert len(mods.outputs["roi_head"]) == 2                 # one pass per shot
    valid = np_(out.valid)
    assert _compare_modules(mods.outputs, rec.outputs, valid.reshape(-1)) == set(MODULES)
    assert_same_detections(out, ref)
    for field in ("mask_probs", "keypoints_scores"):
        np.testing.assert_allclose(np_(out.get_field(field))[valid],
                                   np.asarray(ref.get_field(field))[valid], rtol=0, atol=1e-5,
                                   err_msg=field)


def _rel_close(got, want, what=""):
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= MODULE_RTOL * float(np.abs(want).max()), f"{what}: {err}"


# -- the quantizers, bit for bit ---------------------------------------------

def _tie_inputs():
    """(activation (2, 5, 6, 16), weight HWIO (3, 3, 16, 24)) from a seed,
    with exact rounding ties: the activation's maximum is 127, so its scale
    is 1 (1e-12 is below its last bit) and its halves are ties; each
    weight column's maximum is 127 * 2^-k, with ties at (n + 1/2) 2^-k."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 6, 16).astype(np.float32) * 30
    x.reshape(-1)[:40] = np.arange(-20, 20) + 0.5
    x.reshape(-1)[40] = 127.0
    w = rng.randn(3, 3, 16, 24).astype(np.float32) * 0.05
    for o in range(24):
        k = float(2.0 ** -(o % 7 + 3))
        w[0, 0, : 10, o] = (np.arange(-5, 5) + 0.5) * k
        w[1, 1, 0, o] = 127 * k
    return x, w


def test_quantizers_give_jax_codes_and_scales_bit_for_bit():
    x, w = _tie_inputs()
    jxq, jxs = jq.quantize_activation(jnp.asarray(x))
    xq, xs = pq.quantize_activation(t(x))
    assert xq.dtype == torch.int8 and xs.dtype == torch.float32 and xs.dim() == 0
    np.testing.assert_array_equal(np_(xq), np.asarray(jxq))
    np.testing.assert_array_equal(np_(xs), np.asarray(jxs))
    # the ties round half to even
    np.testing.assert_array_equal(np_(xq).reshape(-1)[:40],
                                  np.round(np.arange(-20, 20) + 0.5).astype(np.int8))
    w_oihw = t(w.transpose(3, 2, 0, 1))
    jwq, jws = jq.quantize_weight_per_channel(jnp.asarray(w))
    wq, ws = pq.quantize_weight_per_channel(w_oihw)
    np.testing.assert_array_equal(np_(wq), np.asarray(jwq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(np_(ws), np.asarray(jws))
    for shape in ((3, 3, 16, 24), (144, 24)):                # a conv and a dense kernel
        jfq, jfs = jq.fake_quant_weight(jnp.asarray(w.reshape(shape)))
        port_w = w.reshape(shape).transpose(*reversed(range(len(shape))))
        fq, fs = pq.fake_quant_weight(t(port_w))
        np.testing.assert_array_equal(np_(fq), np.asarray(jfq).transpose(
            *reversed(range(len(shape)))))
        np.testing.assert_array_equal(np_(fs), np.asarray(jfs))


@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1), (3, 2)],
                         ids=["1x1", "1x1_s2", "3x3", "3x3_s2"])
def test_int8_conv_accumulates_as_jax(kernel, stride):
    """The int32 sums of the port's GEMMs equal JAX's int32 conv of the same
    codes, and the dequantized outputs are equal."""
    x, w = _tie_inputs()
    w = np.ascontiguousarray(w[:kernel, :kernel])
    p = kernel // 2
    jxq, jxs = jq.quantize_activation(jnp.asarray(x))
    jwq, jws = jq.quantize_weight_per_channel(jnp.asarray(w))
    acc = jax.lax.conv_general_dilated(jxq, jwq, (stride, stride), [(p, p)] * 2,
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    xq, xs = pq.quantize_activation(t(x).permute(0, 3, 1, 2))
    wq, ws = pq.quantize_weight_per_channel(t(w.transpose(3, 2, 0, 1)))
    ones = torch.ones(())
    mine = pq.int8_conv_codes(xq, ones, wq, torch.ones(24), stride, p)   # the raw sums
    np.testing.assert_array_equal(np_(mine.permute(0, 2, 3, 1)), np.asarray(acc, np.float32))
    ref = jq.int8_conv(jnp.asarray(x), jnp.asarray(w), (stride, stride), [(p, p)] * 2)
    out = pq.int8_conv(t(x).permute(0, 3, 1, 2), t(w.transpose(3, 2, 0, 1)), stride, p)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(np_(out.permute(0, 2, 3, 1)), np.asarray(ref))


def test_int8_dot_accumulates_as_jax():
    x, w = _tie_inputs()
    wd = w.reshape(-1, 24)[:16]                                 # (K = 16, F = 24)
    jxq, _ = jq.quantize_activation(jnp.asarray(x))
    wq, _ = pq.fake_quant_weight(t(wd.T))
    jwq, _ = jq.fake_quant_weight(jnp.asarray(wd))
    acc = jax.lax.dot_general(jxq, jwq, (((3,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    mine = pq.int_mm(t(np.asarray(jxq)).reshape(-1, 16), wq)
    np.testing.assert_array_equal(np_(mine).reshape(acc.shape), np.asarray(acc))
    ref = jq.int8_dot(jnp.asarray(x), jnp.asarray(wd))
    out = pq.int8_dot(t(x), t(wd.T))
    np.testing.assert_array_equal(np_(out), np.asarray(ref))


def test_int_mm_pads_to_its_shape_rules():
    """m <= 16 and k, n not multiples of 8 run, padded with zeros: exact."""
    rng = np.random.RandomState(3)
    a = rng.randint(-127, 128, (5, 13)).astype(np.int8)
    b = rng.randint(-127, 128, (11, 13)).astype(np.int8)
    got = pq.int_mm(t(a), t(b))
    assert got.dtype == torch.int32 and got.shape == (5, 11)
    np.testing.assert_array_equal(np_(got), a.astype(np.int64) @ b.astype(np.int64).T)
    with pytest.raises(TypeError):
        pq.int_mm(t(a).float(), t(b))


def _cached_support(jm, variables, pm, jax_in, port_in, shots=1):
    (jq_, js), (q, s) = jax_in, port_in

    def jax_fn():
        pooled, s7 = jm.apply(variables, js, 2,
                              method=lambda m, b, n: m.compute_support_features(b, n))
        return jm.apply(variables, jq_, pooled, s7,
                        method=lambda m, b, p, s7_: m.detect_with_support(b, p, s7_))

    def port_fn():
        pooled, s7 = pm.compute_support_features(s, 2)
        assert s7.shape[1] == shots
        return pm.detect_with_support(q, pooled, s7)

    return jax_fn, port_fn


# -- weights: the offline transform and strict loads ---------------------------

def _jax_int8_tree(setup):
    """JAX's ``quantize_weights_int8`` of the setup's variables, with the
    ``quant_scales`` collection an 'int8_weight' init declares."""
    jcfg, _ = small_cfgs("TPU.QUANT", "int8_weight")
    jm = jax_build(jcfg)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, *setup["jax"],
                                            train=False))
    scales = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                    shapes[jq.QUANT_SCALES_COLLECTION])
    return jm, jq.quantize_weights_int8(dict(setup["variables"], quant_scales=scales))


def test_jax_int8_tree_loads_strictly_and_equals_the_port_transform(setup):
    jm, tree = _jax_int8_tree(setup)
    sd = state_dict_from_flax(tree)
    codes = [k for k, v in sd.items() if v.dtype == torch.int8]
    scales = [k for k in sd if k.endswith(".weight_scale")]
    assert codes and sorted(k + "_scale" for k in codes) == sorted(scales)
    assert not any("compress_dim_conv.0" in k or "predictor" in k or "stem" in k
                   for k in codes)
    _, pcfg = small_cfgs("TPU.QUANT", "int8_weight")
    loaded = build_detection_model(pcfg, device="cpu")
    loaded.load_state_dict(sd, strict=True)
    own = build_detection_model(pcfg, device="cpu")
    own.load_state_dict(setup["state_dict"], strict=True)
    pq.quantize_weights_int8(own)
    mine = own.state_dict()
    assert set(mine) == set(sd) == set(loaded.state_dict())
    for k, v in sd.items():
        assert mine[k].dtype == v.dtype, k
        assert torch.equal(mine[k], v), k
    # and the float weights load back strictly (float storage again)
    loaded.load_state_dict(setup["state_dict"], strict=True)
    assert all(v.dtype == torch.float32 for v in loaded.state_dict().values())
    assert not any(k.endswith(".weight_scale") for k in loaded.state_dict())


def test_int8_tree_forward_matches_jax(setup, two_shot):
    """The transformed tree's cached-support forward (two shots) against
    JAX's apply of the same tree, and equal to the float tree's (fake-quant)
    forward."""
    jm, tree = _jax_int8_tree(setup)
    _, pcfg = small_cfgs("TPU.QUANT", "int8_weight")
    pm = build_detection_model(pcfg, device="cpu")
    pm.load_state_dict(state_dict_from_flax(tree), strict=True)
    jax_fn, port_fn = _cached_support(jm, tree, pm, two_shot["jax"], two_shot["port"], shots=2)
    out = port_fn()
    assert_same_detections(out, jax_fn())
    fake = build_detection_model(pcfg, device="cpu")
    fake.load_state_dict(setup["state_dict"], strict=True)
    _, fake_fn = _cached_support(jm, tree, fake, two_shot["jax"], two_shot["port"], shots=2)
    want = fake_fn()
    for a, b in ((out.xyxy, want.xyxy), (out.get_field("scores"), want.get_field("scores"))):
        assert torch.equal(a, b)


def test_fused_head_refuses_int8_codes(setup):
    """JAX's fused-head operands of a transformed tree are the raw int8 codes
    without their scales, and its kernel (interpret mode) computes logits
    more than 1e3 times the head's (a fault of the reference, ROADMAP Queue
    3); the
    port's fused head raises for int8 codes."""
    from oneshotdet_tpu.models.roi_head import ROIBoxHeadNet
    from oneshotdet_tpu.ops.pallas_roi_head import pallas_roi_head, roi_head_params_from_module
    from oneshotdet_tpu_torch.ops.roi_head_fused import pack_roi_head_params

    _, tree = _jax_int8_tree(setup)
    head_tree = {c: tree[c]["roi_head"] for c in ("params", jq.QUANT_SCALES_COLLECTION)}
    ops = roi_head_params_from_module(head_tree["params"])
    assert {k for k, v in ops.items() if np.asarray(v).dtype == np.int8} == {
        "c1", "ag", "fc6", "fc7"}
    rng = np.random.RandomState(6)
    roi = jnp.asarray(rng.randn(16, 7, 7, 256).astype(np.float32))
    supp = jnp.asarray(rng.randn(2, 7, 7, 256).astype(np.float32))
    want, _ = ROIBoxHeadNet(in_channels=256, quant="int8_weight").apply(head_tree, roi, supp)
    got, _ = pallas_roi_head(roi, supp, ops, per_image=8, interpret=True)
    assert float(np.abs(np.asarray(got)).max()) > 1e3 * float(np.abs(np.asarray(want)).max())
    _, pcfg = small_cfgs("TPU.QUANT", "int8_weight")
    pm = build_detection_model(pcfg, device="cpu")
    pm.load_state_dict(state_dict_from_flax(tree), strict=True)
    with pytest.raises(ValueError, match="int8"):
        pack_roi_head_params(pm.roi_heads.box)


# -- the invalid slots' share of the activation scale ---------------------------

def test_invalid_slot_sets_the_int8_scale_as_in_jax(setup):
    """An invalid proposal slot whose box covers the pyramid's hot spot
    pools a maximum above every valid slot's. Under 'int8' the port pools
    it (as JAX's ROIAlign does), so compress_0's query scale is JAX's and
    the head's outputs are JAX's (forced); with the slot pooled as zeros
    (the port's pools outside 'int8', and the JAX package's TPU kernel) the
    scale drops and the valid slots' logits move beyond the tolerance."""
    from oneshotdet_tpu.structures import Boxes as JaxBoxes
    from oneshotdet_tpu_torch.structures import Boxes

    jm, pm = port_model(setup, "TPU.QUANT", "int8")
    rng = np.random.RandomState(4)
    feats = [rng.randn(2, s, s, 256).astype(np.float32) for s in (8, 4, 2, 1, 1)]
    feats[0][:, 5:8, 5:8] *= 20.0                              # the hot spot (P3)
    xyxy = rng.uniform(0, 20, (2, 8, 4)).astype(np.float32)
    xyxy[..., 2:] = xyxy[..., :2] + 6.0                        # small boxes: P3, cold
    xyxy[:, 7] = [40.0, 40.0, 63.0, 63.0]                       # the hot spot's box
    valid = np.ones((2, 8), bool)
    valid[:, 7] = False
    s7 = rng.randn(2, 7, 7, 256).astype(np.float32)
    size = np.array([[64.0, 64.0], [64.0, 64.0]], np.float32)
    jbox = JaxBoxes(xyxy=jnp.asarray(xyxy), valid=jnp.asarray(valid), size=jnp.asarray(size))
    pbox = Boxes(xyxy=t(xyxy), valid=t(valid), size=t(size))

    def jax_fn():
        return jm.apply(setup["variables"], [jnp.asarray(f) for f in feats], jbox,
                        jnp.asarray(s7), method=lambda m, f, b, s: m.roi_head(
                            m._pool_rois(f, b), s))

    pfeats = [t(f).permute(0, 3, 1, 2) for f in feats]
    with torch.inference_mode():
        pooled = pm._pool_rois(pfeats, pbox)
        ref, out = run_both(jax_fn, pm, lambda: pm.roi_heads.box(pooled, t(s7)), "int8")
        amax = pooled.abs().amax(dim=(1, 2, 3)).reshape(2, 8)
        assert float(amax[:, 7].min()) > float(amax[:, :7].max())
        zeroed = torch.where(t(valid).reshape(-1, 1, 1, 1), pooled, 0.0)
        _, scale_all = pq.quantize_activation(pooled)
        _, scale_valid = pq.quantize_activation(zeroed)
        assert float(scale_valid) < 0.5 * float(scale_all)
        unforced = pm.roi_heads.box(pooled, t(s7))
        with_zeros = pm.roi_heads.box(zeroed, t(s7))
    v = valid.reshape(-1)
    for o, r in zip(out, ref):
        _rel_close(o[v], np.asarray(r)[v], "valid slots")
    moved = float((with_zeros[0] - unforced[0])[v].abs().max() / unforced[0][v].abs().max())
    assert moved > 5e-4


# -- switches -----------------------------------------------------------------

def test_forward_train_refuses_quant(setup):
    _, pcfg = small_cfgs("TPU.QUANT", "int8_weight")
    model = build_detection_model(pcfg, device="cpu").train()
    from oneshotdet_tpu_torch.engine import batch_to_inputs
    from oneshotdet_tpu_torch.utils.synthetic import make_episodic_batch

    images, supp, targets = batch_to_inputs(make_episodic_batch(2, (64, 64), (32, 32), seed=3))
    with pytest.raises(ValueError, match="TPU.QUANT is an eval-time flag"):
        model.forward_train(images, supp, targets)


def test_unknown_quant_mode_raises_value_error():
    with pytest.raises(ValueError, match="unknown TPU.QUANT mode"):
        pq.make_conv("int4", 8, 8, 3)
    with pytest.raises(ValueError, match="unknown TPU.QUANT mode"):
        pq.make_dense("fp8", 8, 8)
    _, pcfg = small_cfgs("TPU.QUANT", "int4")
    with pytest.raises(ValueError, match="unknown TPU.QUANT mode"):
        build_detection_model(pcfg, device="cpu")


def test_not_ported_lists_only_the_anchor_stage_one():
    """Nothing is left unported under TPU.QUANT: the anchor RPN builds with
    its head float, RetinaNet with int8 towers."""
    anchor = ("TPU.QUANT", "int8", "MODEL.FCOS_ON", False, "MODEL.RPN.ANCHOR_STRIDE",
              "(8, 16, 32, 64, 128)")
    _, pcfg = small_cfgs(*anchor)
    model = build_detection_model(pcfg, device="cpu")
    assert not any(isinstance(m, pq.QuantConv2d) for m in model.rpn.modules())
    _, pcfg = small_cfgs(*anchor, "MODEL.RETINANET_ON", True)
    model = build_detection_model(pcfg, device="cpu")
    assert sum(isinstance(m, pq.QuantConv2d) for m in model.rpn.modules()) == 8


# -- the unforced gap and the drift tool -----------------------------------------

def _arrays(dets):
    return tuple(np_(x) for x in (dets.xyxy, dets.fields["scores"], dets.valid))


def test_unforced_int8_gap_is_quantization_noise(setup, mk, int8_ref):
    """Unforced, the port's 'int8' detections drift from JAX's by no more
    than JAX's own 'int8' drifts from float (the port's float forward, equal
    to JAX's within 1e-6): the codes that rounding moves are quantization
    noise, not another scheme. Measured by ``tools.quant_drift``, whose
    matching equals the JAX tool's."""
    import importlib.util
    import os

    from oneshotdet_tpu_torch.tools import quant_drift as qd

    spec = importlib.util.spec_from_file_location(
        "jax_quant_drift", os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                                        "quant_drift.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    _, pm = mk_model(setup, mk, "TPU.QUANT", "int8", *INVALID_DETS)
    _, pm_float = mk_model(setup, mk, *INVALID_DETS)
    ref = _arrays(int8_ref[0])
    out, base = _arrays(pm(*setup["port"])), _arrays(pm_float(*setup["port"]))
    for i in range(2):
        a, b = ref[0][i][ref[2][i]], out[0][i][out[2][i]]
        for th in qd.THRESHOLDS:
            assert qd.greedy_match(a, b, th) == jtool.greedy_match(a, b, th)
    gap, own = qd.drift_report(ref, out), qd.drift_report(base, ref)
    assert abs(gap["count_delta_mean"]) <= max(abs(own["count_delta_mean"]), 0.5)
    for th in qd.THRESHOLDS:
        assert gap[f"match_rate@{th}"] >= min(own[f"match_rate@{th}"], 0.98) - 0.02
    for key in ("matched_score_mae", "matched_box_mae_px"):
        assert 0.0 < gap[key] <= 1.5 * own[key]


def test_quant_drift_report_fields():
    from oneshotdet_tpu_torch.tools import quant_drift as qd

    xyxy = np.array([[[0, 0, 10, 10], [20, 20, 30, 30], [0, 0, 1, 1]]], np.float32)
    scores = np.array([[0.9, 0.8, 0.0]], np.float32)
    valid = np.array([[True, True, False]])
    moved = xyxy.copy()
    moved[0, 1] += 1.0
    r = qd.drift_report((xyxy, scores, valid), (moved, scores + 0.01, valid))
    assert {"match_rate@0.5", "match_rate@0.75", "match_rate@0.9", "matched_score_mae",
            "matched_box_mae_px", "count_delta_mean"} <= set(r)
    assert r["match_rate@0.5"] == 1.0 and r["match_rate@0.9"] == 0.5
    np.testing.assert_allclose(r["matched_score_mae"], 0.01, rtol=1e-5)
    np.testing.assert_allclose(r["matched_box_mae_px"], 0.5)
    assert r["count_delta_mean"] == 0.0


# -- export ------------------------------------------------------------------------

def test_exported_int8_program_equals_eager(setup):
    """The ``full`` ExportedProgram of an 'int8' model holds the int8 GEMMs
    and equals the eager model bit for bit. (An 'int8_weight' bundle with
    int8 codes is exported, saved, loaded and compiled on the card,
    ``chip_smoke.py`` phase 14d.)"""
    from oneshotdet_tpu_torch import export as oexport

    _, pm = port_model(setup, "TPU.QUANT", "int8", "TPU.HOST_S2D", False)
    _, pcfg = small_cfgs("TPU.QUANT", "int8", "TPU.HOST_S2D", False)
    ep = oexport.export_eval(pcfg, pm, batch=2, query_hw=(64, 64), supp_hw=(32, 32),
                             kind="full")
    assert "aten._int_mm.default" in {str(n.target) for n in ep.graph.nodes
                                      if n.op == "call_function"}
    images, supps = setup["port"]
    ref = pm(images, supps, target_ids=torch.tensor([3, 5]))
    with torch.inference_mode():
        got = ep.module()(images.pixels, images.sizes, supps.pixels, supps.sizes,
                          torch.tensor([3, 5], dtype=torch.int32))
    for g, w in zip(got, (ref.xyxy, ref.get_field("scores"), ref.valid)):
        assert torch.equal(g, w)
