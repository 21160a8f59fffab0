"""The port's cross-ROI ROIAlign variants against the JAX package's Pallas
kernels, in float32 on the CPU: v3 (ops/roi_align_v3.py) against
``pallas_multilevel_roi_align_v3`` and v4 (ops/roi_align_v4.py) against
``pallas_multilevel_roi_align_v4``, both in interpret mode, with invalid
slots, degenerate and wide boxes; v3 against the port's exact ROIAlign; v4's
window clamp on a wide ROI; the weight functions; the slab grouping; the
CPU/CUDA dispatch; and the inputs and cuts of the card tools.
"""

import functools
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from oneshotdet_tpu.ops import pallas_roi_align_v3 as jax_v3
from oneshotdet_tpu.ops import pallas_roi_align_v4 as jax_v4
from oneshotdet_tpu.ops.roi_align import multilevel_roi_align as jax_roi_align
from oneshotdet_tpu_torch.ops import roi_align as ra
from oneshotdet_tpu_torch.ops import roi_align_v3 as v3
from oneshotdet_tpu_torch.ops import roi_align_v4 as v4
from oneshotdet_tpu_torch.tools import ablate_v4, tune_roialign_v3

# float32 on both sides; only the order of the sums differs (the JAX tool's
# own tolerance, tools/tune_roialign_v3.py)
ATOL = 2e-5
SCALES = (0.125, 0.0625, 0.03125)
# a 128x720 image: P3 wider than the 64-column window, P5 narrower; distinct
# heights, since the JAX v4 kernel picks its branch by a level's height
LEVEL_HW = ((16, 90), (8, 45), (4, 23))


@pytest.fixture
def interpret(monkeypatch):
    """Pallas kernels run in interpret mode (on the CPU) for one test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _rois(rng, n, batch, hw=(128, 720)):
    """Ordinary boxes, boxes over 5:1 (both ways), boxes partly outside the
    image and degenerate ones (x2 < x1)."""
    h, w = hw
    xy = rng.uniform(-30, [w + 10, h + 10], (n, 2))
    wh = np.exp(rng.uniform(0, 5, (n, 2)))
    wh[0::5, 0] *= 8
    wh[1::5, 1] *= 8
    wh[2::7] *= -0.3
    b = rng.randint(0, batch, (n, 1))
    return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, h, w, 8).astype(np.float32) for h, w in LEVEL_HW]
    rois = _rois(rng, 80, 2)
    levels = rng.randint(0, 3, 80).astype(np.int32)
    valid = rng.rand(80) > 0.15
    return feats, rois, levels, valid


def _jax(fn, feats, rois, levels, valid, scales=SCALES):
    kw = {} if valid is None else {"valid": jnp.asarray(valid)}
    return np.asarray(fn([jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(levels),
                         (7, 7), scales, 2, **kw))


def _port(fn, feats, rois, levels, valid, scales=SCALES):
    return fn([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
              torch.from_numpy(levels), (7, 7), scales, 2,
              None if valid is None else torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("port_fn, jax_fn", [
    (v3.multilevel_roi_align_v3, jax_v3.pallas_multilevel_roi_align_v3),
    (v4.multilevel_roi_align_v4, jax_v4.pallas_multilevel_roi_align_v4)], ids=["v3", "v4"])
def test_plain_matches_jax_kernel(interpret, case, port_fn, jax_fn):
    feats, rois, levels, valid = case
    ref = _jax(jax_fn, feats, rois, levels, valid)
    out = _port(port_fn, feats, rois, levels, valid)
    assert out.shape == (80, 7, 7, 8)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert not out[~valid].any()


def test_v3_plain_matches_exact_roi_align(case):
    feats, rois, levels, valid = case
    ref = _port(ra.multilevel_roi_align_plain, feats, rois, levels, valid)
    np.testing.assert_allclose(_port(v3.multilevel_roi_align_v3, feats, rois, levels, valid),
                               ref, atol=ATOL, rtol=0)
    oracle = _jax(jax_roi_align, feats, rois, levels, None)
    np.testing.assert_allclose(ref[valid], oracle[valid], atol=1e-5, rtol=0)


def test_v4_window_clamp_on_wide_rois(interpret):
    """One level (2, 20, 100, 16) at 1/8: ROIs of 86 and 61 cells reach past
    v4's 64-column window, a 40-cell one does not."""
    rng = np.random.RandomState(9)
    feats = [rng.randn(2, 20, 100, 16).astype(np.float32)]
    rois = np.array([[0, 16.0, 8.0, 16.0 + 86 * 8, 120.0],
                     [1, 40.0, 16.0, 40.0 + 61 * 8, 150.0],
                     [1, 300.0, 0.0, 300.0 + 40 * 8, 90.0]], np.float32)
    levels = np.zeros(3, np.int32)
    oracle = _jax(jax_roi_align, feats, rois, levels, None, (0.125,))
    ref = _jax(jax_v4.pallas_multilevel_roi_align_v4, feats, rois, levels, None, (0.125,))
    out = _port(v4.multilevel_roi_align_v4, feats, rois, levels, None, (0.125,))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    gap = np.abs(out - oracle).max(axis=(1, 2, 3))
    assert gap[0] > 1.0 and gap[1] > 0.5 and gap[2] < ATOL, gap
    np.testing.assert_allclose(_port(v3.multilevel_roi_align_v3, feats, rois, levels, None,
                                     (0.125,)), oracle, atol=ATOL, rtol=0)


def _geometry(rng, n):
    start = rng.uniform(-20, 90, n).astype(np.float32)
    bin_sz = rng.uniform(0.1, 12, n).astype(np.float32)
    dim = rng.choice([7.0, 23.0, 90.0], n).astype(np.float32)
    return start, bin_sz, dim


def test_interp_params_match_jax():
    start, bin_sz, dim = _geometry(np.random.RandomState(1), 64)
    ref_i, ref_w = jax_v3._interp_params(jnp.asarray(start), jnp.asarray(bin_sz),
                                         jnp.asarray(dim), 2, 7)
    idx, w = v3.interp_params(*(torch.from_numpy(a) for a in (start, bin_sz, dim)), 2, 7)
    assert idx.shape == (64, 7, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-7, rtol=0)


def test_dense_weights_and_window_origin_match_jax():
    rng = np.random.RandomState(2)
    start, bin_sz, dim = _geometry(rng, 64)
    origin = (np.floor(np.clip(np.floor(start), 0, 26) / 8) * 8).astype(np.float32)
    ref = jax_v4._dense_weights(jnp.asarray(start), jnp.asarray(bin_sz), jnp.asarray(origin),
                                jnp.asarray(dim), 2, 7, 64)
    got = v4.dense_weights(*(torch.from_numpy(a) for a in (start, bin_sz, origin, dim)), 2, 7, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7, rtol=0)
    # w_l_of = min(max(ceil8(W_l), 72), w_pad), w_pad = max(ceil8 widths, 72)
    feats = [torch.zeros(1, 1, w, 2) for w in (152, 76, 38, 19, 10)]
    assert v4.window_widths(feats) == [152, 80, 72, 72, 72]
    assert v4.window_widths([torch.zeros(1, 1, 20, 2)]) == [72]


@pytest.mark.parametrize("t", [1, 4, 16])
def test_slab_blocks_put_each_roi_in_one_block_of_its_map(case, t):
    _, rois, levels, valid = case
    r, b, nl = len(rois), 2, 3
    rt, lt = torch.from_numpy(rois), torch.from_numpy(levels)
    ok = v3.live_rois(rt, lt, torch.from_numpy(valid), b, nl)
    block_group, slot_roi = v3.slab_blocks(rt, lt, ok, b, nl, t)
    nb = -(-r // t) + b * nl + 1
    assert block_group.shape == (nb,) and slot_roi.shape == (nb * t,)
    slots = slot_roi.numpy()
    assert sorted(slots[slots >= 0].tolist()) == list(range(r))
    groups = block_group.numpy()
    for k in range(nb):
        for s in slots[k * t:(k + 1) * t]:
            if s < 0:
                continue
            want = int(rois[s, 0]) * nl + int(levels[s]) if valid[s] else b * nl
            assert groups[k] == want
    assert (np.diff(groups) >= 0).all() and groups.max() <= b * nl + 1


def test_invalid_image_or_level_gives_zeros():
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, h, w, 8).astype(np.float32) for h, w in LEVEL_HW]
    rois = _rois(rng, 6, 2)
    rois[0, 0] = 5          # no such image
    levels = np.array([0, 7, 1, 2, 0, -1], np.int32)   # no level 7 or -1
    for fn in (v3.multilevel_roi_align_v3, v4.multilevel_roi_align_v4):
        out = _port(fn, feats, rois, levels, None)
        assert not out[[0, 1, 5]].any() and out[[2, 3, 4]].any()


def test_cpu_tensors_never_launch_and_kernel_wrappers_refuse_them(case):
    feats, rois, levels, valid = case
    args = ([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
            torch.from_numpy(levels), (7, 7), SCALES, 2, torch.from_numpy(valid))
    before = (v3.roi_align_v3_launches, v4.roi_align_v4_launches)
    v3.multilevel_roi_align_v3(*args)
    v4.multilevel_roi_align_v4(*args)
    assert (v3.roi_align_v3_launches, v4.roi_align_v4_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        v3.multilevel_roi_align_v3_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        v4.multilevel_roi_align_v4_cuda(*args)


def test_tool_inputs_are_the_kernels_dtypes():
    feats, rois, levels, scales = tune_roialign_v3.make_inputs(7, torch.device("cpu"), small=True,
                                                               dtype=torch.float32)
    assert [tuple(f.shape) for f in feats] == [(8, 13, 19, 256), (8, 7, 10, 256)]
    assert rois.dtype == torch.float32 and rois.shape == (64, 5) and rois.is_contiguous()
    assert levels.dtype == torch.int32 and set(levels.tolist()) <= {0, 1}
    assert scales == tune_roialign_v3.SCALES[3:]


def test_ablation_cuts_match_the_kernel_source_once():
    csrc = pathlib.Path(v4.__file__).parents[1] / "csrc"
    for kernel, name, patches in ablate_v4.VARIANTS:
        for path, old, _ in patches:
            assert (csrc / path).read_text().count(old) == 1, (kernel, name, path)


@pytest.mark.parametrize("tool", ["tune_roialign_v3", "ablate_v4", "tune_roi_head"])
def test_card_tools_exit_nonzero_without_cuda(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"oneshotdet_tpu_torch.tools.{tool}")
    assert module.main([]) == 1
    assert "no CUDA" in capsys.readouterr().err
