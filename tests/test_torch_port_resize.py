"""The resize + normalize + pad of the port's data path
(``oneshotdet_tpu_torch.ops.resize``, the plain version of the CUDA kernel
``csrc/resize_normalize_pad.cu``) against the JAX package's native C++ pass
``oneshotdet_tpu.csrc.resize_normalize_pad`` on the CPU.

The native library is built with ``g++ -O3 -march=native``, which contracts
``acc += k * p`` into fused multiply-adds; the plain version (and the
kernel, built with ``-fmad=false``) rounds each multiply and add. So the two
may differ where the float64 sum lies within a rounding of a .5 tie, and
there by exactly one uint8 step: that is the bound against the library as
it loads (over these cases 6 of 13.3 M values differ, 3 in each "voc
portrait up" case, every one at a tie; a 120x300 -> 200x400 downscale gave
47 of 240 000). Built from the same source with
``-ffp-contract=off`` the C++ pass equals the plain version bit for bit
(tolerance 0).
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from oneshotdet_tpu import csrc as jax_csrc
from oneshotdet_tpu_torch.ops import resize
from torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MEAN_BGR, STD_1 = [102.9801, 115.9465, 122.7717], [1.0, 1.0, 1.0]
MEAN_RGB, STD_RGB = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]

# (source (h0, w0), target (oh, ow), slot (pad_h, pad_w))
CASES = {
    "voc landscape up": ((375, 500), (800, 1066), (832, 1216)),
    "voc portrait up": ((500, 375), (1066, 800), (1216, 832)),
    "support down": ((120, 300), (160, 400), (416, 416)),
    "steep down": ((400, 97), (61, 17), (64, 32)),
    "odd up": ((37, 53), (101, 147), (128, 160)),
    "one column": ((9, 1), (27, 3), (32, 8)),
    "one row": ((1, 7), (3, 20), (8, 24)),
    "one pixel": ((1, 1), (4, 5), (4, 8)),
    "exact size": ((13, 17), (13, 17), (13, 17)),
    "down to one pixel": ((6, 9), (1, 1), (2, 2)),
}
NORMS = {"bgr255": (True, MEAN_BGR, STD_1), "rgb01 std": (False, MEAN_RGB, STD_RGB)}


def _source(h0, w0, seed):
    return np.random.RandomState(seed).randint(0, 256, (h0, w0, 3)).astype(np.uint8)


def _native(lib, src, out_hw, pad_hw, mean, std, bgr):
    dst = np.zeros(pad_hw + (3,), np.float32)
    m, s = np.float32(mean), np.float32(std)
    lib.resize_normalize_pad(src.ctypes.data, src.shape[0], src.shape[1], dst.ctypes.data,
                             out_hw[0], out_hw[1], pad_hw[0], pad_hw[1],
                             m.ctypes.data, s.ctypes.data, int(bgr))
    return dst


def _plain(src, out_hw, pad_hw, mean, std, bgr):
    packed = resize.pack_images([src], [out_hw], "cpu")
    return resize.resize_normalize_pad(packed, pad_hw, mean, std, bgr)[0].numpy()


@pytest.fixture(scope="module")
def native_lib():
    lib = jax_csrc.load()
    assert lib is not None, "the JAX package's native library did not load"
    return lib


@pytest.fixture(scope="module")
def uncontracted_lib(tmp_path_factory):
    """The JAX package's C++ pass built from its source with every multiply
    and add rounded on its own (no fused multiply-adds)."""
    so = tmp_path_factory.mktemp("native") / "fast_collate_nofma.so"
    subprocess.run(["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
                    jax_csrc._SRC], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.resize_normalize_pad.argtypes = jax_csrc.load().resize_normalize_pad.argtypes
    return lib


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_uncontracted_native_pass(uncontracted_lib, case, norm):
    (h0, w0), out_hw, pad_hw = CASES[case]
    bgr, mean, std = NORMS[norm]
    src = _source(h0, w0, list(CASES).index(case))
    want = _native(uncontracted_lib, src, out_hw, pad_hw, mean, std, bgr)
    got = _plain(src, out_hw, pad_hw, mean, std, bgr)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_native_library_up_to_ties(native_lib, case, norm):
    (h0, w0), (oh, ow), pad_hw = CASES[case]
    bgr, mean, std = NORMS[norm]
    src = _source(h0, w0, list(CASES).index(case))
    want = _native(native_lib, src, (oh, ow), pad_hw, mean, std, bgr)
    got = _plain(src, (oh, ow), pad_hw, mean, std, bgr)
    diff = got != want
    assert diff.sum() <= 1e-3 * diff.size
    if not diff.any():
        return
    ys, xs, cs = np.nonzero(diff)
    assert (ys < oh).all() and (xs < ow).all()      # the padding is zeros on both sides
    # one uint8 step in the normalized units of each channel
    step = np.float32(1.0) if bgr else np.float32(1.0) / np.float32(255.0)
    std_c = np.float32(std)
    np.testing.assert_allclose(np.abs(got - want)[diff], (step / std_c)[cs], rtol=1e-5)
    # ... and only where the float64 sum is at a .5 tie
    acc = resize._resample(torch.from_numpy(src), oh, ow).numpy()
    ch = (2 - cs) if bgr else cs
    frac = acc[ys, xs, ch] - np.floor(acc[ys, xs, ch])
    assert np.abs(frac - 0.5).max() < 1e-9


def test_batched_call_equals_per_image_calls():
    shapes = [((375, 500), (300, 400)), ((17, 5), (60, 18)), ((64, 64), (64, 64)),
              ((1, 1), (3, 3)), ((200, 90), (50, 22))]
    srcs = [_source(h, w, i) for i, ((h, w), _) in enumerate(shapes)]
    targets = [t for _, t in shapes]
    pad = (320, 416)
    batch = resize.resize_normalize_pad(resize.pack_images(srcs, targets, "cpu"), pad,
                                        MEAN_BGR, STD_1)
    assert batch.shape == (len(srcs),) + pad + (3,) and batch.dtype == torch.float32
    for i, (src, (oh, ow)) in enumerate(zip(srcs, targets)):
        alone = _plain(src, (oh, ow), pad, MEAN_BGR, STD_1, True)
        np.testing.assert_array_equal(batch[i].numpy(), alone)
        assert not batch[i, oh:].any() and not batch[i, :, ow:].any()


def test_filters_match_pil_rule():
    # downscale 3:1: 7 taps, support widened by the scale; weights sum to 1
    first, count, k = resize.filters(300, 100)
    assert k.shape == (100, resize.filter_size(300, 100)) == (100, 7)
    assert int(first[0]) == 0 and int(count.max()) <= 7
    np.testing.assert_allclose(k.sum(1).numpy(), 1.0, rtol=1e-12)
    # upscale: at most 3 taps of the unwidened triangle
    first, count, k = resize.filters(10, 25)
    assert k.shape[1] == 3 and int(count.min()) >= 1


def test_wrapper_dispatch_and_checks():
    src = _source(8, 8, 0)
    packed = resize.pack_images([src], [(8, 8)], "cpu")
    before = resize.resize_launches
    out = resize.resize_normalize_pad(packed, (8, 8), MEAN_BGR, STD_1)
    assert resize.resize_launches == before and out.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA"):
        resize.resize_normalize_pad_cuda(packed, (8, 8), MEAN_BGR, STD_1)
    with pytest.raises(ValueError, match="exceeds the slot"):
        resize.resize_normalize_pad(packed, (4, 8), MEAN_BGR, STD_1)
    with pytest.raises(ValueError, match="uint8"):
        resize.pack_images([src.astype(np.float32)], [(8, 8)], "cpu")
    with pytest.raises(ValueError, match="empty"):
        resize.pack_images([src], [(0, 8)], "cpu")
    with pytest.raises(ValueError, match="3 values"):
        resize.resize_normalize_pad(packed, (8, 8), [1.0, 2.0], STD_1)


# -- one launch for several outputs (the collator's queries and supports) -------------

# (source (h0, w0), target (oh, ow)) of a batch's queries and supports: the
# supports' bucket differs from the queries'
QUERIES = [((375, 500), (800, 1066)), ((500, 375), (1066, 800)), ((37, 53), (101, 147))]
SUPPORTS = [((120, 300), (160, 400)), ((294, 218), (269, 200)), ((9, 1), (27, 3))]
SLOTS = {"queries": (1216, 1216), "supports": (416, 416)}


def _batch_sources(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for (h, w), _ in QUERIES + SUPPORTS]


@pytest.mark.parametrize("norms", [("bgr255", "bgr255"), ("bgr255", "rgb01 std"),
                                   ("rgb01 std", "bgr255")])
def test_slots_plain_equals_uncontracted_native_pass(uncontracted_lib, norms):
    srcs = _batch_sources(11)
    targets = [t for _, t in QUERIES + SUPPORTS]
    outputs = [0] * len(QUERIES) + [1] * len(SUPPORTS)
    packed = resize.pack_images(srcs, targets, "cpu", outputs=outputs)
    specs = [(NORMS[n][1], NORMS[n][2], NORMS[n][0]) for n in norms]
    slots = [resize.slot(SLOTS[kind], *spec) for kind, spec in zip(SLOTS, specs)]
    got = resize.resize_normalize_pad_slots(packed, slots)
    assert [tuple(g.shape) for g in got] == [(3, 1216, 1216, 3), (3, 416, 416, 3)]
    for i, (src, out_hw, o) in enumerate(zip(srcs, targets, outputs)):
        mean, std, bgr = specs[o]
        want = _native(uncontracted_lib, src, out_hw, SLOTS[list(SLOTS)[o]], mean, std, bgr)
        k = i - outputs.index(o)
        np.testing.assert_array_equal(got[o][k].numpy().view(np.int32), want.view(np.int32))


def test_slots_plain_equals_one_output_calls():
    srcs = _batch_sources(12)
    targets = [t for _, t in QUERIES + SUPPORTS]
    n = len(QUERIES)
    both = resize.pack_images(srcs, targets, "cpu", outputs=[0] * n + [1] * len(SUPPORTS))
    slots = (resize.slot(SLOTS["queries"], MEAN_BGR, STD_1, True),
             resize.slot(SLOTS["supports"], MEAN_RGB, STD_RGB, False))
    got = resize.resize_normalize_pad_slots_plain(both, slots)
    queries = resize.resize_normalize_pad_plain(resize.pack_images(srcs[:n], targets[:n], "cpu"),
                                                SLOTS["queries"], MEAN_BGR, STD_1, True)
    supports = resize.resize_normalize_pad_plain(
        resize.pack_images(srcs[n:], targets[n:], "cpu"), SLOTS["supports"], MEAN_RGB, STD_RGB,
        False)
    for g, w in zip(got, (queries, supports)):
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.numpy().view(np.int32))


def test_pack_meta_layout_and_slot_checks():
    srcs = _batch_sources(13)[:4]
    targets = [t for _, t in (QUERIES + SUPPORTS)[:4]]
    packed = resize.pack_images(srcs, targets, "cpu", outputs=[0, 0, 1, 1])
    assert packed.meta.shape == (4, resize.META_FIELDS) and packed.meta.dtype == torch.int64
    assert packed.outputs == (0, 0, 1, 1) and len(packed) == 4
    # meta and sources share one buffer: one upload on the card
    assert packed.meta.untyped_storage().data_ptr() == packed.pixels.untyped_storage().data_ptr()
    offsets = np.cumsum([0] + [s.size for s in srcs[:-1]])
    for i, (src, (oh, ow), row) in enumerate(zip(srcs, targets, packed.meta.tolist())):
        assert row == [offsets[i], *src.shape[:2], oh, ow, [0, 0, 1, 1][i], [0, 1, 0, 1][i]]
        np.testing.assert_array_equal(
            packed.pixels[row[0]:row[0] + src.size].numpy().reshape(src.shape), src)
    slots = (resize.slot((1216, 1216), MEAN_BGR, STD_1), resize.slot((416, 416), MEAN_BGR, STD_1))
    with pytest.raises(ValueError, match="count up from 0"):
        resize.pack_images(srcs, targets, "cpu", outputs=[0, 1, 0, 1])
    with pytest.raises(ValueError, match="count up from 0"):
        resize.pack_images(srcs, targets, "cpu", outputs=[1, 1, 1, 1])
    with pytest.raises(ValueError, match="count up from 0"):
        resize.pack_images(srcs, targets, "cpu", outputs=[0, 0, 1])
    with pytest.raises(ValueError, match="2 outputs, 1 slots"):
        resize.resize_normalize_pad_slots(packed, slots[:1])
    with pytest.raises(ValueError, match="2 outputs, 1 slots"):
        resize.resize_normalize_pad(packed, (1216, 1216), MEAN_BGR, STD_1)
    with pytest.raises(ValueError, match="exceeds the slot"):
        resize.resize_normalize_pad_slots(packed, (slots[0], resize.slot((100, 416), MEAN_BGR,
                                                                         STD_1)))
    with pytest.raises(ValueError, match="resize.slot"):
        resize.resize_normalize_pad_slots(packed, ((1216, 1216), (416, 416)))
    with pytest.raises(ValueError, match="3 values"):
        resize.slot((416, 416), MEAN_BGR, [1.0, 1.0])
    with pytest.raises(ValueError, match="CUDA"):
        resize.resize_normalize_pad_slots_cuda(packed, slots)


def _parent_accepts(h0, w0, oh, ow):
    """The refusal of the first kernel's wrapper: a 32 x 8 tile's filter
    table and a 16-row chunk in a block's shared memory."""
    kw, kh = resize.filter_size(w0, ow), resize.filter_size(h0, oh)
    return (32 * kw + 8 * kh) * 8 + 16 * 32 * 3 * 4 <= 232448 - 1024


SIZES = (1, 2, 3, 7, 40, 300, 1000, 1750, 3000, 9000)


@pytest.mark.parametrize("h0", SIZES)
def test_launch_plan_takes_what_the_first_kernel_took(h0):
    for w0 in SIZES:
        for oh in (1, 2, 5, 100, 800, 1066):
            for ow in (1, 2, 7, 100, 1200):
                if not _parent_accepts(h0, w0, oh, ow):
                    continue
                plan = resize.launch_plan([(h0, w0, oh, ow)])
                assert plan.smem <= resize.DYNAMIC_LIMIT
                assert plan.strip in (1, 2, 4, 8, 16, 32, 64)
                assert plan.row_filters in (resize.RUN_MAX, resize.GROUP)
                for v in (plan.ring_rows, plan.stage_rows):
                    assert v >= 1 and v & (v - 1) == 0
                assert all(o % 16 == 0 for o in plan.offsets) and plan.row_bytes % 16 == 0
                assert plan.offsets == tuple(sorted(plan.offsets))


@pytest.mark.parametrize("in_size,out_size", [(375, 800), (500, 1066), (294, 269), (3000, 300),
                                              (1, 5), (300, 2), (37, 811), (1780, 1), (97, 17)])
def test_span_bound_covers_the_filters(in_size, out_size):
    # the kernel stages [first of a strip's first column, end of its last)
    # in row_bytes and holds a group's source rows in the ring: both sized
    # from _span, which must cover every run of n consecutive filters
    first, count, _ = resize.filters(in_size, out_size)
    end = first + count
    for n in (1, 2, resize.GROUP, 16, resize.STRIP_MAX):
        n = min(n, out_size)
        spans = end[n - 1:] - first[:out_size - n + 1]
        assert int(spans.max()) <= resize._span(in_size, out_size, n)
    assert int(count.max()) <= resize.filter_size(in_size, out_size)
    # first taps and ends ascend (the kernel's ring walks rows in order)
    assert bool((first[1:] >= first[:-1]).all()) and bool((end[1:] >= end[:-1]).all())
