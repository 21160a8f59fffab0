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
