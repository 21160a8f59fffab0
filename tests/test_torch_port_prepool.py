"""ONESHOT_PREPOOL_COMPRESS=1 in the port against the JAX package on the CPU:
compress_0's query half (a 1x1 map C -> 2C) hoisted onto the full FPN maps
before the eval ROI pool, K1 over the 2C-channel maps, the support half
added in the head. The flagship at test capacities (``SMALL``) with 64 FPN
channels, seeded weights for both packages (tests/torch_port_common.py):

  - float32: the port's hoisted detections against JAX's hoisted ones
    (``detect_from_features``, the cached-support path after the query
    backbone, where the hoist is, on a seeded 64-channel pyramid), and the
    port's hoisted eval forward against its un-hoisted one, slot by slot
    within the JAX package's own bounds (tests/test_roi_head_variants.py::
    test_prepool_compress_parity: boxes atol 1e-3, scores atol 1e-4, valid
    equal);
  - 'int8': the same path replayed on JAX's int8 inputs as
    test_torch_port_quant.py does (``forced``), and the hoist's per-level
    ``int8_dot`` calls and the support half's too (``hoist_forced``): each
    checks its own input within FORCE_RTOL of JAX's, takes JAX's and gives
    JAX's output bit for bit. JAX runs op by op (``jax.jit`` rewrites the
    int8 scales' division); its first apply compiles every primitive,
    which the float32 apply before it shares;
  - 'int8_weight': the hoist takes compress_0's float query kernel, as
    JAX's does (its un-hoisted head fake-quantizes it), against JAX's
    hoisted detections;
  - the fused head is not taken under the hoist, the read-at-build switch
    and its linear-fusion gate;
  - K1's plain version at C = 512 in float32 against JAX's ROIAlign, and the
    kernel's plan mirror there: two channel slices, every item within the
    staging budget, every bin covered once.
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.ops import quant as jq
from oneshotdet_tpu_torch.models import build_detection_model
from oneshotdet_tpu_torch.models import detector as pdet
from oneshotdet_tpu_torch.models import roi_head as phead
from oneshotdet_tpu_torch.ops import quant as pq
from oneshotdet_tpu_torch.ops import roi_align as ra
from test_torch_port_quant import FORCE_RTOL, JaxInt8Calls, forced
from torch_port_common import (assert_same_detections, jax_build, np_,
                               one_torch_thread, random_variables, small_cfgs,  # noqa: F401
                               state_dict_from_flax, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64]
PREPOOL = "ONESHOT_PREPOOL_COMPRESS"
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4       # tests/test_roi_head_variants.py


@pytest.fixture(scope="module")
def mk():
    """Seeded inputs (batch 2, 64x64 queries, 32x32 supports) and weights
    of the narrow flagship for both packages."""
    from oneshotdet_tpu.structures import ImageBatch as JaxImageBatch
    from oneshotdet_tpu_torch.structures import ImageBatch

    rng = np.random.RandomState(0)
    q = rng.randn(2, 64, 64, 3).astype(np.float32)
    qs = np.array([[64.0, 64.0], [48.0, 56.0]], np.float32)
    s = rng.randn(2, 32, 32, 3).astype(np.float32)
    ss = np.array([[32.0, 32.0], [32.0, 24.0]], np.float32)
    jax_in = (JaxImageBatch(jnp.asarray(q), jnp.asarray(qs)),
              JaxImageBatch(jnp.asarray(s), jnp.asarray(ss)))
    jcfg, _ = small_cfgs(*NARROW)
    variables = random_variables(jax_build(jcfg), jax_in, seed=2)
    return dict(variables=variables, state_dict=state_dict_from_flax(variables), jax=jax_in,
                port=(ImageBatch(t(q), t(qs)), ImageBatch(t(s), t(ss))))


def models(mk, monkeypatch, hoist, *overrides):
    """(JAX model, port model with the weights) built with the switch set
    or not; JAX reads it at each apply, so it stays set for the caller."""
    if hoist:
        monkeypatch.setenv(PREPOOL, "1")
    else:
        monkeypatch.delenv(PREPOOL, raising=False)
    jcfg, pcfg = small_cfgs(*NARROW, *overrides)
    pm = build_detection_model(pcfg, device="cpu")
    pm.load_state_dict(mk["state_dict"], strict=True)
    assert pm.config.prepool_compress == hoist
    return jax_build(jcfg), pm


def assert_same_slots(got, want):
    """Slot by slot within the JAX package's own hoist bounds."""
    np.testing.assert_array_equal(np_(got.valid), np.asarray(want.valid))
    assert np.asarray(want.valid).any()
    np.testing.assert_allclose(np_(got.xyxy), np.asarray(want.xyxy), rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(np_(got.get_field("scores")), np.asarray(want.get_field("scores")),
                               rtol=0, atol=SCORE_ATOL)


@pytest.fixture(scope="module")
def after_backbone():
    """Seeded inputs of ``detect_from_features``: a 64-channel pyramid of a
    64x64 batch of 2 (NHWC), per-level pooled supports, one 7x7 support
    shot, the images' (w, h) and target ids, as numpy."""
    rng = np.random.RandomState(8)
    feats = [rng.randn(2, h, w, 64).astype(np.float32)
             for h, w in ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))]
    pooled = [np.abs(rng.randn(2, 1, 1, 64)).astype(np.float32) for _ in feats]
    s7 = rng.randn(2, 1, 7, 7, 64).astype(np.float32)
    sizes = np.array([[64.0, 64.0], [56.0, 48.0]], np.float32)
    return feats, sizes, pooled, s7, np.array([3, 5], np.int32)


def jax_after_backbone(jm, variables, inputs):
    feats, sizes, pooled, s7, tids = inputs
    return jm.apply(variables, [jnp.asarray(f) for f in feats], jnp.asarray(sizes),
                    [jnp.asarray(p) for p in pooled], jnp.asarray(s7), jnp.asarray(tids),
                    method=lambda m, *a: m.detect_from_features(*a))


def port_after_backbone(pm, inputs):
    feats, sizes, pooled, s7, tids = inputs
    return pm.detect_from_features([t(f).permute(0, 3, 1, 2) for f in feats], t(sizes),
                                   [t(p) for p in pooled], t(s7), t(tids))


def test_hoisted_forward_matches_jax(mk, after_backbone, monkeypatch):
    jm, pm = models(mk, monkeypatch, True)
    ref = jax_after_backbone(jm, mk["variables"], after_backbone)
    out = port_after_backbone(pm, after_backbone)
    assert out.xyxy.shape == tuple(ref.xyxy.shape)
    assert_same_slots(out, ref)
    np.testing.assert_array_equal(np_(out.fields["labels"]), np.asarray(ref.fields["labels"]))


def test_hoisted_forward_matches_unhoisted(mk, monkeypatch):
    """The eval forward: the 1x1 map commutes with the bilinear pool, so
    only rounding moves."""
    _, pm = models(mk, monkeypatch, True)
    out = pm(*mk["port"], target_ids=torch.tensor([3, 5]))
    _, plain = models(mk, monkeypatch, False)
    base = plain(*mk["port"], target_ids=torch.tensor([3, 5]))
    assert_same_slots(out, base)
    assert not torch.equal(out.get_field("scores"), base.get_field("scores"))


# -- 'int8': the hoist's int8_dot calls replayed -----------------------------------

HOIST_TAGS = ("_eval_roi_pool", "supp_half")


class hoist_forced:
    """Record JAX's ``int8_dot`` calls of the hoist (one per level map, from
    ``_eval_roi_pool``) and of compress_0's support half (``supp_half``), in
    call order (``calls`` None); or replay them into the port's hoist
    (``models.detector.int8_dot``) and support half
    (``models.roi_head.int8_dot``): each call's input within FORCE_RTOL of
    JAX's maximum, then JAX's input taken and JAX's output given bit for
    bit. ``taken`` counts the replayed calls by tag."""

    def __init__(self, calls=None):
        self.mp, self.calls = pytest.MonkeyPatch(), calls
        self.taken = {tag: 0 for tag in HOIST_TAGS}

    def __enter__(self):
        if self.calls is None:
            self.calls = {tag: [] for tag in HOIST_TAGS}
            real = jq.int8_dot

            def record(x, w):
                out = real(x, w)
                frame = sys._getframe(1)
                for _ in range(12):
                    if frame is None or frame.f_code.co_name in HOIST_TAGS:
                        break
                    frame = frame.f_back
                if frame is not None and frame.f_code.co_name in HOIST_TAGS:
                    self.calls[frame.f_code.co_name].append((np.asarray(x), np.asarray(out)))
                return out

            self.mp.setattr(jq, "int8_dot", record)
        else:
            self.mp.setattr(pdet, "int8_dot", self._replay("_eval_roi_pool"))
            self.mp.setattr(phead, "int8_dot", self._replay("supp_half"))
        return self

    def __exit__(self, *exc):
        self.mp.undo()

    def _replay(self, tag):
        def replay(x, w):
            x_ref, y_ref = self.calls[tag][self.taken[tag]]
            self.taken[tag] += 1
            scale = max(float(np.abs(x_ref).max()), 1e-30)
            err = float(np.abs(np_(x) - x_ref).max())
            assert err <= FORCE_RTOL * scale, f"{tag} input: {err} > {FORCE_RTOL} x {scale}"
            y = pq.int8_dot(t(x_ref).to(x.dtype), w)
            np.testing.assert_array_equal(np_(y), y_ref, err_msg=tag)
            return y
        return replay


def test_int8_hoisted_forward_matches_jax(mk, after_backbone, monkeypatch):
    """Replayed on JAX's int8 inputs: the five hoisted level maps, the
    support half and every int8 layer after the backbone (the FCOS towers,
    compress_1, the 3x3 conv, fc6, fc7) bit for bit, the detections within
    the detection tolerances. Under the hoist JAX never calls compress_0
    whole, so the head's query half is the pooled map. (The backbones' int8
    layers are replayed in test_torch_port_quant.py.)"""
    jm, pm = models(mk, monkeypatch, True, "TPU.QUANT", "int8")
    with JaxInt8Calls() as rec, hoist_forced() as hrec:
        ref = jax_after_backbone(jm, mk["variables"], after_backbone)
    assert rec.calls and not any(path[-1] == "compress_0" for path in rec.calls)
    assert [len(hrec.calls[tag]) for tag in HOIST_TAGS] == [5, 1]
    assert [c[0].shape[-1] for c in hrec.calls["_eval_roi_pool"]] == [64] * 5
    with forced(pm, rec.calls) as f, hoist_forced(hrec.calls) as h:
        out = port_after_backbone(pm, after_backbone)
    assert f.layers >= 20 and h.taken == {"_eval_roi_pool": 5, "supp_half": 1}
    assert_same_detections(out, ref)


def test_int8_weight_hoist_takes_the_float_query_kernel_as_jax(mk, after_backbone,
                                                               monkeypatch):
    """Under 'int8_weight' JAX's hoist multiplies by compress_0's raw float
    query kernel (``detector.py:524-534``) where its un-hoisted head
    fake-quantizes it per output channel (``roi_head.py:100-108``): the
    port does the same and matches JAX's hoisted detections, and in both
    packages the hoisted scores move from the un-hoisted ones by more than
    the float hoist's bound (ROADMAP Queue 3)."""
    jm, pm = models(mk, monkeypatch, True, "TPU.QUANT", "int8_weight")
    ref = jax_after_backbone(jm, mk["variables"], after_backbone)
    out = port_after_backbone(pm, after_backbone)
    assert_same_detections(out, ref)
    jm0, pm0 = models(mk, monkeypatch, False, "TPU.QUANT", "int8_weight")
    ref0 = jax_after_backbone(jm0, mk["variables"], after_backbone)
    base = port_after_backbone(pm0, after_backbone)
    for hoisted, plain in ((ref, ref0), (out, base)):
        v = np.asarray(hoisted.valid) & np.asarray(plain.valid)
        gap = np.abs(np_(hoisted.fields["scores"]) - np_(plain.fields["scores"]))[v].max()
        assert gap > 2 * SCORE_ATOL


# -- the switch -----------------------------------------------------------------

def test_fused_head_not_taken_under_hoist(mk, monkeypatch):
    """With ONESHOT_PALLAS_ROI_HEAD=1 as well the head runs through its
    layers (the JAX package's gate, roi_head.py:172), equal to the hoisted
    unfused forward; without the hoist the same model takes the fused head."""
    monkeypatch.setenv("ONESHOT_PALLAS_ROI_HEAD", "1")
    _, pm = models(mk, monkeypatch, True)
    assert pm.config.fused_roi_head
    calls = []
    real = phead.fused_roi_head
    monkeypatch.setattr(phead, "fused_roi_head", lambda *a: calls.append(1) or real(*a))
    out = pm(*mk["port"])
    assert calls == []
    want = dataclasses.replace(pm.config, fused_roi_head=False)
    pm.config, fused_cfg = want, pm.config
    same = pm(*mk["port"])
    assert torch.equal(out.xyxy, same.xyxy) and torch.equal(out.get_field("scores"),
                                                             same.get_field("scores"))
    pm.config = dataclasses.replace(fused_cfg, prepool_compress=False)
    pm(*mk["port"])
    assert calls == [1]


def test_switch_is_read_at_build_and_gated_by_linear_fusion(monkeypatch):
    monkeypatch.setenv(PREPOOL, "1")
    _, pcfg = small_cfgs(*NARROW)
    model = build_detection_model(pcfg, device="cpu")
    assert model.config.prepool_compress
    monkeypatch.delenv(PREPOOL)
    assert model.config.prepool_compress                 # read once, at build
    monkeypatch.setenv(PREPOOL, "1")
    _, pcfg = small_cfgs(*NARROW, "FEW_SHOT.LINEAR_FUSION", True)
    assert not build_detection_model(pcfg, device="cpu").config.prepool_compress
    with pytest.raises(ValueError, match="linear-fusion"):
        phead.ROIBoxHead(64, linear_fusion=True)(None, torch.zeros(1, 7, 7, 64),
                                                 prepooled_query=torch.zeros(2, 7, 7, 128))


# -- K1 at C = 512 in float32 ------------------------------------------------------

def _pyramid_512(rng, hw=(64, 96)):
    h, w = hw
    shapes = [(-(-h // 2 ** k), -(-w // 2 ** k)) for k in range(3, 8)]
    return [rng.randn(2, a, b, 512).astype(np.float32) for a, b in shapes]


def test_k1_plain_at_512_channels_matches_jax():
    """The plain ROIAlign at C = 512 (the hoisted maps of the flagship's
    256-channel FPN) against JAX's multilevel ROIAlign, and equal channel
    by channel to itself over the two 256-channel halves the kernel stages
    apart."""
    from oneshotdet_tpu.ops.roi_align import multilevel_roi_align as jax_pool

    rng = np.random.RandomState(7)
    feats = _pyramid_512(rng)
    xy = rng.uniform(-8, 90, (40, 2)).astype(np.float32)
    wh = rng.uniform(1, 60, (40, 2)).astype(np.float32)
    rois = np.concatenate([rng.randint(0, 2, (40, 1)).astype(np.float32), xy, xy + wh], 1)
    levels = ra.fpn_level_map(t(rois[:, 1:]), 3, 7)
    scales = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
    got = ra.multilevel_roi_align_plain([t(f) for f in feats], t(rois), levels, (7, 7),
                                        scales, 2)
    want = jax.jit(lambda f, r, lv: jax_pool(f, r, lv, (7, 7), scales, 2))(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(np_(levels)))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0, atol=1e-5)
    halves = [ra.multilevel_roi_align_plain([t(f[..., i:i + 256]) for f in feats], t(rois),
                                            levels, (7, 7), scales, 2) for i in (0, 256)]
    assert torch.equal(got, torch.cat(halves, -1))


def test_k1_plan_at_512_channels_fits_the_staging_buffer():
    """At C = 512 in float32 one bin's 16 pixels (32 KB) exceed a 24 KB
    buffer: the plan takes two channel slices of 1 KB a pixel (24 pixels a
    buffer), and on the flagship's query pyramid every item of every ROI
    (the proposals' random mix, the edge cases, the predictor's image) fits
    it and the items cover every bin once. In bf16 a whole pixel fits."""
    import chip_smoke

    assert ra.channel_slices(512, torch.float32) == 2
    assert ra.channel_slices(512, torch.bfloat16) == 1
    budget = ra.stage_budget(512, torch.float32)
    assert budget == ra.STAGE_BYTES // (256 * 4) == 24
    feats = [torch.empty((chip_smoke.BATCH, h, w, 512), dtype=torch.float32, device="meta")
             for h, w in chip_smoke.pyramid_shapes(*chip_smoke.QUERY_HW)]
    gen = torch.Generator().manual_seed(3)
    rois, valid = chip_smoke.random_rois(1024, chip_smoke.BATCH, chip_smoke.QUERY_HW, gen, "cpu")
    cases = [(rois, None, valid)] + [(r, lv, v) for _, r, lv, v in
                                     chip_smoke.edge_case_rois(gen, "cpu")]
    items = 0
    for r, lv, v in cases:
        lv = ra.fpn_level_map(r[:, 1:], 3, 7) if lv is None else lv
        for plan in ra.roi_align_plan(feats, r, lv, (7, 7), chip_smoke.SCALES_Q, 2, v):
            if plan is None:
                continue
            cover = np.zeros((7, 7), int)
            for ph0, ph1, pw0, pw1, r0, r1, c0, c1 in plan.items:
                assert (r1 - r0) * (c1 - c0) <= budget
                cover[ph0:ph1, pw0:pw1] += 1
            assert (cover == 1).all()
            items += len(plan.items)
    assert items > 1024
