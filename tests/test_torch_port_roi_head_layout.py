"""Layouts the bf16 route of the fused-head kernel
(oneshotdet_tpu_torch/csrc/roi_head.cu) relies on, checked on the CPU: the pre-tiled weights of ``kernel_operands``
unpack exactly to ``pack_roi_head_params``'s matrices, the kernel's blocks of
G ROIs never span two images at any per-image count the gate admits, and the
ctypes mirror of ``struct HeadArgs`` matches the C struct field for field.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead
from oneshotdet_tpu_torch.ops import roi_head_fused as rf

KERNEL_SRC = (Path(rf.__file__).resolve().parents[1] / "csrc" / "roi_head.cu").read_text()


def untile(tiled: np.ndarray, k: int, n: int, kd: int, nb: int) -> np.ndarray:
    """The (k, n) matrix of a sequence of kd x nb tiles, column-block major,
    each in no-swizzle K-major core-matrix order, by the position of every
    element: tile (col // nb, row // kd), then core matrix (col % nb // 8,
    row % kd // 8), then (col % 8, row % 8)."""
    row = np.arange(k)[:, None]
    col = np.arange(n)[None, :]
    pos = (((col // nb) * (k // kd) + row // kd) * (kd * nb)
           + (col % nb // 8) * (kd * 8) + (row % kd // 8) * 64 + (col % 8) * 8 + row % 8)
    assert np.array_equal(np.sort(pos.ravel()), np.arange(k * n))    # a permutation
    return tiled[pos]


@pytest.fixture(scope="module")
def packed():
    rng = np.random.RandomState(5)
    head = ROIBoxHead()
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)
                                     / math.sqrt(p[0].numel() if p.dim() > 1 else 1)))
    return rf.pack_roi_head_params(head)


def _source(w, key):
    c = w["c0"].shape[0] // 2
    return {"c0aT": w["c0"][:c], "c1T": w["c1"], "agT": w["ag"].reshape(-1, w["ag"].shape[-1]),
            "fc6T": w["fc6"], "fc7T": w["fc7"]}[key]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("key", sorted(rf.ROUTE_TILES[torch.bfloat16]))
def test_tiled_operands_unpack_to_the_packed_matrices(packed, key, dtype):
    """The bf16 kernel's tiles; float32 operands carry none of them (the
    float32 kernel reads its own, tests/test_torch_port_roi_head_tf32.py)."""
    ops = rf.kernel_operands(packed, dtype)
    if dtype == torch.float32:
        assert ops.get(key) is None
        return
    want = _source(packed, key).to(dtype)
    src, kd, nb = rf.TILES[key]
    tiled = ops[key]
    assert tiled.dtype == dtype and tiled.dim() == 1 and tiled.is_contiguous()
    assert tiled.numel() == want.numel()
    got = untile(tiled.float().numpy(), *want.shape, kd, nb)
    np.testing.assert_array_equal(got, want.float().numpy())
    # each tile is one 8 KB head_front slice or one 32 KB B tile of the GEMM
    assert kd * nb * 2 in (8192, 32768)


def test_tile_depths_match_the_kernel_constants():
    const = {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", KERNEL_SRC)}
    slot = int(const["SLOT"])
    assert rf.TILES["c0aT"][1:] == (slot // (2 * int(const["CH"])), int(const["CH"]))
    assert rf.TILES["c1T"][1:] == (slot // (2 * 256), 256)
    assert rf.TILES["agT"][1:] == (slot // (2 * 128), 128)
    gemm = re.search(r"constexpr int GBM = (\d+), GBN = (\d+), GBK = (\d+);", KERNEL_SRC)
    gbm, gbn, gbk = map(int, gemm.groups())
    assert rf.TILES["fc6T"][1:] == rf.TILES["fc7T"][1:] == (gbk, gbn)
    assert rf.FC_TILE_N == gbn and rf.A_TILE_ROWS == gbm


def test_fc_tiles_only_where_hidden_fits_the_gemm(packed):
    narrow = dict(packed, fc6=packed["fc6"][:, :128], fc6b=packed["fc6b"][:128],
                  fc7=packed["fc7"][:128, :128], fc7b=packed["fc7b"][:128],
                  cls=packed["cls"][:128], box=packed["box"][:128])
    ops = rf.kernel_operands(narrow, torch.bfloat16)
    assert ops["fc6T"] is None and ops["fc7T"] is None
    assert ops["c0aT"] is not None


@pytest.mark.parametrize("per_image", [8, 16, 24, 512, 2000])
def test_roi_blocks_cover_every_roi_once_within_one_image(per_image):
    """head_front_bf16 gives block b's consumer g ROI G b + g (none past the
    end): every ROI once, and for the per-image counts the gate admits no
    block holds ROIs of two images."""
    g = int(re.search(r"constexpr int G = (\d+);", KERNEL_SRC).group(1))
    assert rf.fused_head_applies(per_image)
    rois = 3 * per_image
    blocks = -(-rois // g)
    seen = np.zeros(rois, int)
    for b in range(blocks):
        members = [g * b + k for k in range(g) if g * b + k < rois]
        assert members
        seen[members] += 1
        assert len({r // per_image for r in members}) == 1
    assert (seen == 1).all()


def test_ctypes_args_mirror_the_c_struct():
    body = re.search(r"struct HeadArgs \{(.*?)\};", KERNEL_SRC, re.S).group(1)
    fields = re.findall(r"^\s*(const void\*|const float\*|void\*|float\*|int)\s+(\w+);",
                        body, re.M)
    mirror = rf._HeadArgs._fields_
    assert [n for _, n in fields] == [n for n, _ in mirror]
    for (ctype, _), (_, ptype) in zip(fields, mirror):
        assert (ptype is rf.ctypes.c_int) == (ctype == "int")
