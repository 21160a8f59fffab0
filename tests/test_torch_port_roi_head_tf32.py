"""The float32 route of the fused-head kernel (oneshotdet_tpu_torch/csrc/
roi_head.cu, 3xTF32 on wgmma), checked on the CPU: its hi | lo weight tiles
unpack exactly to the packed matrices in the kernel's row order, the tf32
split is exact, the compress_0 accumulator fragments read as compress_1's A
fragments give the product with the permuted rows, each route builds only
its own tiles, and a plain mirror of the kernel's three-term products stays
within 1e-4 abs of the plain float32 head and of the JAX kernel (interpret
mode, HIGHEST-precision matmuls) at C = 256.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oneshotdet_tpu.ops.pallas_roi_head import pallas_roi_head, roi_head_params_from_module
from oneshotdet_tpu_torch.models.roi_head import ROIBoxHead
from oneshotdet_tpu_torch.ops import roi_head_fused as rf
from torch_port_common import relation_head_setup, t

# Both sides run float32-accurate chains; the 3xTF32 products drop only
# a_lo w_lo (relative 2^-22) and sum in another order, on outputs of order 1.
ATOL = 1e-4
F32_TILES = rf.ROUTE_TILES[torch.float32]


@pytest.fixture(scope="module")
def two_images():
    return relation_head_setup(2, 16)


def _kernel_order(packed, key):
    """The (K, N) matrix of the float32 tiles ``key``, built here from the
    packed params: compress_1's rows in each block of 8 as 0 2 4 6 1 3 5 7,
    the 3x3 rows by (channel half, tap, channel)."""
    c = packed["c0"].shape[0] // 2
    if key == "c0aS":
        return packed["c0"][:c]
    if key == "c1S":
        perm = [8 * b + j for b in range(packed["c1"].shape[0] // 8) for j in (0, 2, 4, 6, 1, 3, 5, 7)]
        return packed["c1"][perm]
    if key == "agS":
        ag = packed["ag"]                                      # (9, C, C/2)
        return torch.cat([ag[tap, h * (c // 2):(h + 1) * (c // 2)]
                          for h in range(2) for tap in range(9)])
    return packed[key[:-1]]


def untile_split(tiled, k, n, kd, nb):
    """(hi, lo) (k, n) matrices of hi | lo tile pairs, column-block major,
    each tile in tf32 no-swizzle K-major core-matrix order: core matrix
    (col % nb // 8, row % kd // 4), then (col % 8, row % 4)."""
    row = np.arange(k)[:, None]
    col = np.arange(n)[None, :]
    pos = (((col // nb) * (k // kd) + row // kd) * (2 * kd * nb)
           + (col % nb // 8) * (kd * 8) + (row % kd // 4) * 32 + (col % 8) * 4 + row % 4)
    both = np.concatenate([pos.ravel(), pos.ravel() + kd * nb])
    assert np.array_equal(np.sort(both), np.arange(2 * k * n))    # a permutation
    return tiled[pos], tiled[pos + kd * nb]


@pytest.mark.parametrize("key", F32_TILES)
def test_f32_tiles_unpack_to_the_packed_matrices(two_images, key):
    _, head, _, _ = two_images
    packed = rf.pack_roi_head_params(head)
    ops = rf.kernel_operands(packed, torch.float32)
    want = _kernel_order(packed, key)
    _, kd, nb = rf.TILES[key]
    tiled = ops[key]
    assert tiled.dtype == torch.float32 and tiled.dim() == 1 and tiled.numel() == 2 * want.numel()
    hi, lo = untile_split(tiled.numpy(), *want.shape, kd, nb)
    np.testing.assert_array_equal(hi, rf.tf32_round(want).numpy())
    np.testing.assert_array_equal((torch.from_numpy(hi) + torch.from_numpy(lo)).numpy(),
                                  want.numpy())
    # a hi | lo pair is one 16 KB head_front slice or one B stage of the GEMM
    assert 2 * kd * nb * 4 == 16384


def test_f32_tile_shapes_match_the_kernel_constants():
    """Depths of the *S tiles as head_front_tf32 (T_TILE bytes of hi per
    slice over the 64-, 256- and 128-column products) and fc_gemm_tf32
    (TBK x TBN) read them, and compress_1's A fragments in the order that
    A_FRAG_COLUMNS states."""
    src = (Path(rf.__file__).resolve().parents[1] / "csrc" / "roi_head.cu").read_text()
    tile = int(re.search(r"constexpr int T_TILE = (\d+);", src).group(1))
    assert rf.TILES["c0aS"][1:] == (tile // (4 * 64), 64)
    assert rf.TILES["c1S"][1:] == (tile // (4 * 256), 256)
    assert rf.TILES["agS"][1:] == (tile // (4 * 128), 128)
    tbm, tbn, tbk = map(int, re.search(
        r"constexpr int TBM = (\d+), TBN = (\d+), TBK = (\d+);", src).groups())
    assert rf.TILES["fc6S"][1:] == rf.TILES["fc7S"][1:] == (tbk, tbn)
    assert rf.A_TILE_ROWS == tbm and rf.F32_A_TILE_K == tbk and rf.FC_TILE_N % tbn == 0
    reads = re.findall(r"raw\[(\d)\] = __float_as_uint\(h0\[4 \* kb(?: \+ (\d))?\]\);", src)
    # raw[i] holds A column q (i = 0, 1) or q + 4 (i = 2, 3) of the block,
    # which is accumulator column 2q + e for h0[4 kb + e] with e in {0, 1}
    cols = {int(i): int(e or 0) % 2 for i, e in reads}
    assert len(cols) == 4 and [cols[i] for i in range(4)] == [0, 0, 1, 1]
    assert [rf.A_FRAG_COLUMNS[k] % 2 for k in range(8)] == [0] * 4 + [1] * 4


def test_f32_a_operand_layout_is_a_bank_conflict_free_permutation():
    """fc_gemm_tf32's A operand (a_tile_offset_f32, mirrored in Python): a
    permutation of the rows padded to 128, whose 16-byte chunks that one
    ldmatrix reads (8 consecutive rows, one logical chunk) fall in 8 distinct
    bank groups; untile_f32_rows inverts it."""
    rows, cols = 256, 64
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    off = rf.a_tile_offset_f32(r, c, cols // 16)
    assert torch.equal(off.reshape(-1).sort().values, torch.arange(rows * cols))
    for row0 in range(0, rows, 8):
        for chunk in range(cols // 4):
            groups = (off[row0:row0 + 8, 4 * chunk] * 4 // 16) % 8
            assert len(set(groups.tolist())) == 8
    m = torch.randn(rows, cols)
    tiled = torch.empty(rows * cols)
    tiled[off.reshape(-1)] = m.reshape(-1)
    assert torch.equal(rf.untile_f32_rows(tiled, 200, cols), m[:200])


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("scale", [1.0, 1e-30, 3e30, 1e-40], ids=["unit", "tiny", "huge", "subnormal"])
def test_split_is_exact_with_hi_on_the_tf32_grid(scale):
    rng = np.random.RandomState(3)
    w = torch.from_numpy((rng.randn(4096) * scale).astype(np.float32))
    hi, lo = rf.split_tf32(w)
    assert torch.equal(_bits(hi + lo), _bits(w))
    assert int((_bits(hi) & 0x1FFF).abs().sum()) == 0
    # round to nearest: |lo| is at most half a tf32 step of |w| (among the
    # subnormals, half of the fixed step 2^-136)
    half_step = torch.clamp(rf.tf32_truncate(w.abs()) * 2.0 ** -11, min=2.0 ** -137)
    assert bool((lo.abs() <= half_step).all())


def test_tf32_round_breaks_ties_away_from_zero():
    # 1 + 2^-11 is half a tf32 step above 1; 1 + 3 * 2^-11 half a step below 1 + 2^-9
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0])
    assert torch.equal(rf.tf32_round(x), want)
    assert torch.equal(rf.tf32_truncate(x), torch.tensor([1.0, -1.0, 1 + 2 ** -10, 1.0]))


def test_accumulator_fragments_as_a_fragments_take_the_permuted_rows():
    """head_front_tf32 passes each normalized compress_0 chunk (64 rows x 64
    columns, in wgmma's accumulator layout) to compress_1 as A fragments
    {d[4kb], d[4kb + 2], d[4kb + 1], d[4kb + 3]}. With wgmma's tf32 A layout
    (a0, a1: column q of rows g, g + 8; a2, a3: column q + 4) the product with
    compress_1's rows in A_FRAG_COLUMNS order equals chunk @ c1 rows."""
    rng = np.random.RandomState(9)
    chunk = rng.randn(64, 64)
    c1 = rng.randn(64, 32)
    perm = [8 * b + j for b in range(8) for j in rf.A_FRAG_COLUMNS]
    a = np.zeros((64, 64))                        # the A matrix the fragments spell
    for thread in range(128):
        warp, lane = divmod(thread, 32)
        g, q = 16 * warp + lane // 4, lane % 4
        for kb in range(8):
            # accumulator: d[4 j + e] at row g + 8 (e // 2), column 8 j + 2 q + e % 2
            d = {e: chunk[g + 8 * (e // 2), 8 * kb + 2 * q + e % 2] for e in range(4)}
            frag = (d[0], d[2], d[1], d[3])
            for i, (row, col) in enumerate(((g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4))):
                a[row, 8 * kb + col] = frag[i]
    np.testing.assert_allclose(a @ c1[perm], chunk @ c1, rtol=1e-12, atol=1e-12)


def test_each_route_builds_only_its_tiles_once_per_dtype(two_images):
    _, head, _, _ = two_images
    packed = rf.pack_roi_head_params(head)
    f32 = rf.kernel_operands(packed, torch.float32)
    bf16 = rf.kernel_operands(packed, torch.bfloat16)
    for ops, own, other in ((f32, F32_TILES, rf.ROUTE_TILES[torch.bfloat16]),
                            (bf16, rf.ROUTE_TILES[torch.bfloat16], F32_TILES)):
        assert all(ops[k] is not None for k in own)
        assert not any(k in ops for k in other)
    assert not any(k in rf.kernel_operands(packed, torch.float32, tiles=False)
                   for k in F32_TILES)
    # the module packs each dtype once, and keeps both
    h = ROIBoxHead()
    h.load_state_dict(head.state_dict())
    first = h._fused_operands(torch.float32)
    h._fused_operands(torch.bfloat16)
    assert h._fused_operands(torch.float32) is first


def test_3xtf32_product_is_float32_accurate():
    """The mirror's product is near float64; one tf32 pass is not."""
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(64, 2304).astype(np.float32))
    w = torch.from_numpy((rng.randn(2304, 128) / 48).astype(np.float32))
    exact = a.double() @ w.double()
    three = float((rf.mm_3xtf32(a, w).double() - exact).abs().max())
    f32 = float(((a @ w).double() - exact).abs().max())
    one = float(((rf.tf32_truncate(a) @ rf.tf32_truncate(w)).double() - exact).abs().max())
    assert three < 4 * f32 + 1e-6 and three < one / 100


@pytest.mark.parametrize("b, p", [(2, 16), (4, 8)], ids=["B2xP16", "B4xP8"])
def test_3xtf32_mirror_matches_plain_and_jax_kernel(b, p):
    params, head, roi, supp = relation_head_setup(b, p, seed=b)
    w = rf.pack_roi_head_params(head)
    got_l, got_d = rf.fused_roi_head_tf32_mirror(t(roi), t(supp), w, p)
    plain_l, plain_d = rf.fused_roi_head_plain(t(roi), t(supp), w, p)
    ref_l, ref_d = pallas_roi_head(jnp.asarray(roi), jnp.asarray(supp),
                                   roi_head_params_from_module(params), per_image=p,
                                   interpret=True)
    for got, want in ((got_l, plain_l), (got_d, plain_d)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=ATOL, rtol=0)
    # the split is not idle: the mirror differs from the plain chain
    assert float((got_l - plain_l).abs().max()) > 0
