"""The fused relation head: plain PyTorch version and the CUDA kernel's wrapper.

Counterpart of ``oneshotdet_tpu/ops/pallas_roi_head.py``
(``roi_head_params_from_module`` and the Pallas kernel ``pallas_roi_head``).
The whole eval head of the 'concat' method runs on pooled ROI features
``(R, 7, 7, C)`` (NHWC, image-major: ROI r belongs to image r // per_image)
and one support ``(B, 7, 7, C)`` per image, and returns float32 logits
``(R, ncls)`` and deltas ``(R, 4 * nreg)``.

With ``mm(a, w)`` = the products of ``a`` and ``w`` rounded to the input
dtype, summed in float32, and GN = GroupNorm(32, eps 1e-5) with float32
statistics per (ROI, group):

1. ``yb = (supp @ c0[C:] + c0b).to(dtype)``, once per image;
2. ``h = leaky(GN0(mm(x, c0[:C]) + yb[image]))``, slope 0.2;
3. ``h = leaky(GN1(mm(h, c1) + c1b)).to(dtype)``;
4. ``a = leaky(GN(agb + sum over the 9 taps of mm(shift(h), ag[tap]))).to(dtype)``,
   a zero-padded 3x3 conv that never crosses ROIs;
5. ``f = relu(mm(a, fc6) + fc6b)``, ``f = relu(mm(f, fc7) + fc7b)``, with ``a``
   flattened in (p, q, c) order and fc6's rows permuted to match;
6. ``logits = mm(f, cls) + clsb``, ``deltas = mm(f, box) + boxb``.

``fused_roi_head`` calls the op ``oneshotdet::roi_head_fused``
(``ops.library``), which dispatches on the device of its inputs: CPU tensors
take ``fused_roi_head_plain``; CUDA tensors launch the kernel of
``csrc/roi_head.cu`` or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

GROUPS = 32
EPS = 1e-5
MAX_PRED = 16     # ncls + 4 * nreg the kernel takes (csrc/roi_head.cu)

# Kernel launches since the count was last reset (set it to 0 to reset).
fused_roi_head_launches = 0


def fused_head_applies(per_image: int) -> bool:
    """Whether an image's ROI count admits the fused head: a positive
    multiple of 8, the choice of the JAX package's block-size rule
    (``_pick_t(per_image) > 0`` at its default cap)."""
    return per_image > 0 and per_image % 8 == 0


def pack_roi_head_params(head) -> Dict[str, torch.Tensor]:
    """The port's ``ROIBoxHead`` -> the fused head's float32 operands, under
    the keys and layouts of ``roi_head_params_from_module``: (in, out)
    matrices, the 3x3 conv as 9 (C, C/2) taps in (ky, kx) order, and fc6's
    rows permuted from the checkpoint's (c, p, q) flatten to (p, q, c)."""
    conv0, gn0, _, conv1, gn1, _ = head.compress_dim_conv
    aggreg, aggreg_gn, _ = head.feature_aggreg
    ca = aggreg.weight.shape[0]
    hidden = head.fc6.weight.shape[0]
    f32 = lambda t: t.detach().to(torch.float32)
    fc6 = f32(head.fc6.weight).t().reshape(ca, 7, 7, hidden).permute(1, 2, 0, 3)
    return {
        "c0": f32(conv0.weight)[:, :, 0, 0].t().contiguous(),        # (2C, 2C)
        "c0b": f32(conv0.bias),
        "gn0g": f32(gn0.weight),
        "gn0b": f32(gn0.bias),
        "c1": f32(conv1.weight)[:, :, 0, 0].t().contiguous(),        # (2C, C)
        "c1b": f32(conv1.bias),
        "gn1g": f32(gn1.weight),
        "gn1b": f32(gn1.bias),
        "ag": f32(aggreg.weight).permute(2, 3, 1, 0).reshape(9, -1, ca).contiguous(),
        "agb": f32(aggreg.bias),
        "gng": f32(aggreg_gn.weight),
        "gnb": f32(aggreg_gn.bias),
        "fc6": fc6.reshape(49 * ca, hidden).contiguous(),
        "fc6b": f32(head.fc6.bias),
        "fc7": f32(head.fc7.weight).t().contiguous(),
        "fc7b": f32(head.fc7.bias),
        "cls": f32(head.predictor.cls_score.weight).t().contiguous(),
        "clsb": f32(head.predictor.cls_score.bias),
        "box": f32(head.predictor.bbox_pred.weight).t().contiguous(),
        "boxb": f32(head.predictor.bbox_pred.bias),
    }


# The pre-tiled weights of each route, as its kernel reads them
# (csrc/roi_head.cu): key -> (matrix, tile depth, tile width). bf16 (*T):
# one 8 KB weight slice of head_front (KD0, KD1, KDA) or one GBK x GBN B tile
# of the fc6/fc7 GEMM. float32 (*S, 3xTF32): each tile is a hi | lo pair
# (``tile_operand_split``) of one 16 KB slice (TKD0, TKD1, TKDA) or one
# TBK x TBN B stage; compress_1's rows and the 3x3's taps in the kernel's
# order (``tf32_tile_source``).
TILES = {"c0aT": ("c0a", 64, 64), "c1T": ("c1", 16, 256), "agT": ("ag", 32, 128),
         "fc6T": ("fc6", 64, 256), "fc7T": ("fc7", 64, 256),
         "c0aS": ("c0a", 32, 64), "c1S": ("c1", 8, 256), "agS": ("ag", 16, 128),
         "fc6S": ("fc6", 16, 128), "fc7S": ("fc7", 16, 128)}
# the tiles each route's kernel reads, in HeadArgs' order (c0aT, c1T, agT,
# fc6T, fc7T)
ROUTE_TILES = {torch.bfloat16: ("c0aT", "c1T", "agT", "fc6T", "fc7T"),
               torch.float32: ("c0aS", "c1S", "agS", "fc6S", "fc7S")}
FC_TILE_N = 256   # hidden must be a multiple of the GEMM's tile width
A_TILE_ROWS = 128  # the GEMM's A operand: rows padded to whole tiles
F32_A_TILE_K = 16  # ... and in float32 cut into blocks of 16 columns
KERNEL_CHANNELS = 256   # the C the kernel takes; its 3x3 conv writes C // 2
# head_front_tf32 feeds each normalized compress_0 block of 8 columns to
# compress_1 straight from its accumulator registers, where a thread's A
# columns q and q + 4 hold accumulator columns 2q and 2q + 1: A column k of a
# block is accumulator column A_FRAG_COLUMNS[k], and compress_1's rows are
# taken in that order.
A_FRAG_COLUMNS = (0, 2, 4, 6, 1, 3, 5, 7)
TF32_MASK = -(1 << 13)   # 0xffffe000: the 19 bits of a tf32 in a float32


def check_kernel_widths(in_channels: int, conv_out: int, hidden: int) -> None:
    """Raise NotImplementedError unless the CUDA kernel takes these widths:
    C = 256, a 3x3 output of 128 and a hidden width that is a multiple of
    FC_TILE_N. The plain version (CPU tensors) takes any width."""
    if not (in_channels == KERNEL_CHANNELS and conv_out == KERNEL_CHANNELS // 2
            and hidden > 0 and hidden % FC_TILE_N == 0):
        raise NotImplementedError(
            f"the fused relation head's CUDA kernel takes C = {KERNEL_CHANNELS}, a 3x3 "
            f"output of {KERNEL_CHANNELS // 2} and MLP_HEAD_DIM % {FC_TILE_N} == 0, not C = "
            f"{in_channels}, {conv_out} and {hidden}")


def tile_operand(w: torch.Tensor, kd: int, nb: int) -> torch.Tensor:
    """(K, N) weights -> the 1-D sequence of their kd x nb tiles, column
    block major (tile [n // nb][k // kd]), each in wgmma's no-swizzle
    K-major core-matrix order: element (k, n) of a tile at
    (n // 8) kd 8 + (k // 8) 64 + (n % 8) 8 + k % 8."""
    k, n = w.shape
    t = w.reshape(k // kd, kd // 8, 8, n // nb, nb // 8, 8)   # kb, kh, kl, nb, nh, nl
    return t.permute(3, 0, 4, 1, 5, 2).contiguous().reshape(-1)


def tile_operand_tf32(w: torch.Tensor, kd: int, nb: int) -> torch.Tensor:
    """(K, N) float32 -> the 1-D sequence of their kd x nb tiles, column
    block major, each in wgmma's no-swizzle K-major core-matrix order for
    tf32 (a core matrix is 8 columns of 4 rows): element (k, n) of a tile at
    (n // 8) kd 8 + (k // 4) 32 + (n % 8) 4 + k % 4."""
    k, n = w.shape
    t = w.reshape(k // kd, kd // 4, 4, n // nb, nb // 8, 8)   # kb, kh, kl, nb, nh, nl
    return t.permute(3, 0, 4, 1, 5, 2).contiguous().reshape(-1)


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous().view(torch.int32)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32; the low 13 bits are zero. Finite inputs."""
    bits = _as_bits(t)
    sign = bits & (-(1 << 31))
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & TF32_MASK
    return (sign | mag).view(torch.float32)


def tf32_truncate(t: torch.Tensor) -> torch.Tensor:
    """The tf32 value the tensor cores read from a float32 operand: its low
    13 bits dropped."""
    return (_as_bits(t) & TF32_MASK).view(torch.float32)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32_round(t) and lo = t - hi: hi + lo == t exactly."""
    hi = tf32_round(t)
    return hi, t.to(torch.float32) - hi


def tile_operand_split(w: torch.Tensor, kd: int, nb: int) -> torch.Tensor:
    """(K, N) float32 -> its kd x nb tiles as in ``tile_operand_tf32``, each
    tile of hi followed by the same tile of lo (``split_tf32``)."""
    hi, lo = (tile_operand_tf32(v, kd, nb).reshape(-1, kd * nb) for v in split_tf32(w))
    return torch.stack([hi, lo], dim=1).reshape(-1)


def a_tile_offset_f32(row: torch.Tensor, col: torch.Tensor, ksteps: int) -> torch.Tensor:
    """Where the float32 route keeps element (row, col) of fc6's and fc7's A
    operand (csrc/roi_head.cu a_tile_offset_f32): 128 x 16 blocks, row-block
    major, each row-major with 16-byte chunk c of row r at c ^ (r / 2 % 4)."""
    rr, kb = row % A_TILE_ROWS, F32_A_TILE_K
    return ((((row // A_TILE_ROWS) * ksteps + col // kb) * A_TILE_ROWS + rr) * kb
            + ((((col % kb) >> 2) ^ ((rr >> 1) & 3)) << 2) + (col & 3))


def untile_f32_rows(tiled: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The first ``rows`` rows of a float32 A operand in the layout of
    ``a_tile_offset_f32`` with ``cols`` columns, as a (rows, cols) matrix."""
    r = torch.arange(rows, device=tiled.device)[:, None]
    c = torch.arange(cols, device=tiled.device)[None, :]
    return tiled.reshape(-1)[a_tile_offset_f32(r, c, cols // F32_A_TILE_K)]


def tf32_tile_source(ops: Dict, key: str) -> torch.Tensor:
    """The (K, N) matrix that the float32 tiles ``key`` hold, rows in the
    order head_front_tf32 reads them: compress_1's rows within each block of
    8 in ``A_FRAG_COLUMNS`` order; the 3x3 conv's rows by channel half, then
    tap, then channel (k = 9 (C/2) half + (C/2) tap + c)."""
    src = ops[TILES[key][0]]
    if key == "c1S":
        order = torch.arange(src.shape[0]).reshape(-1, 8)[:, list(A_FRAG_COLUMNS)].reshape(-1)
        return src[order]
    if key == "agS":
        taps, c, ca = src.shape
        return src.reshape(taps, 2, c // 2, ca).permute(1, 0, 2, 3).reshape(taps * c, ca)
    return src.reshape(-1, src.shape[-1])


def kernel_operands(w: Dict[str, torch.Tensor], dtype: torch.dtype,
                    tiles: bool = True) -> Dict:
    """Packed float32 params -> the operands of one dtype: matrices in
    ``dtype``, biases and GN factors float32, the query and support halves of
    compress_0 apart, cls and box side by side, and, with ``tiles``, the
    pre-tiled weights that this dtype's kernel reads (``ROUTE_TILES``; each
    only where its matrix is whole tiles, so fc6's and fc7's only where
    hidden is a multiple of ``FC_TILE_N``). Operands already of ``dtype``
    (with tiles, if asked) are returned as they are."""
    if w.get("dtype") == dtype and (w.get("tiled") or not tiles):
        return w
    c = w["c0"].shape[0] // 2
    mat = lambda t: t.to(dtype).contiguous()
    vec = lambda t: t.to(torch.float32).contiguous()
    ops = {
        "dtype": dtype,
        "tiled": tiles,
        "ncls": w["cls"].shape[1],
        "c0a": mat(w["c0"][:c]), "c0s": mat(w["c0"][c:]), "c0b": vec(w["c0b"]),
        "gn0g": vec(w["gn0g"]), "gn0b": vec(w["gn0b"]),
        "c1": mat(w["c1"]), "c1b": vec(w["c1b"]),
        "gn1g": vec(w["gn1g"]), "gn1b": vec(w["gn1b"]),
        "ag": mat(w["ag"]), "agb": vec(w["agb"]),
        "gng": vec(w["gng"]), "gnb": vec(w["gnb"]),
        "fc6": mat(w["fc6"]), "fc6b": vec(w["fc6b"]),
        "fc7": mat(w["fc7"]), "fc7b": vec(w["fc7b"]),
        "pred": mat(torch.cat([w["cls"], w["box"]], dim=1)),
        "predb": vec(torch.cat([w["clsb"], w["boxb"]])),
    }
    for key in ROUTE_TILES.get(dtype, ()) if tiles else ():
        _, kd, nb = TILES[key]
        split = dtype == torch.float32
        m = tf32_tile_source(ops, key) if split else ops[TILES[key][0]].reshape(
            -1, ops[TILES[key][0]].shape[-1])                 # ag: (9 C, C/2), k = C tap + c
        whole = m.shape[0] % kd == 0 and m.shape[1] % nb == 0
        ops[key] = None if not whole else (
            tile_operand_split(m, kd, nb) if split else tile_operand(m, kd, nb))
    return ops


def support_half(supp_7x7: torch.Tensor, ops: Dict) -> torch.Tensor:
    """Step 1, once per image: (B, 7, 7, C) -> (B, 49, 2C) in the input dtype."""
    b, c = supp_7x7.shape[0], supp_7x7.shape[-1]
    s = supp_7x7.reshape(b, 49, c).to(torch.float32)
    return (s @ ops["c0s"].to(torch.float32) + ops["c0b"]).to(supp_7x7.dtype)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _gn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """GroupNorm(32) of (R, 49, ch) float32, statistics per (ROI, group)."""
    r, s, ch = x.shape
    g = x.reshape(r, s, GROUPS, ch // GROUPS)
    d = g - g.mean(dim=(1, 3), keepdim=True)
    var = (d * d).mean(dim=(1, 3), keepdim=True)
    return (d * torch.rsqrt(var + EPS)).reshape(r, s, ch) * gamma + beta


def head_front_chain(roi_feats, supp_7x7, ops, per_image, mm):
    """Steps 1-4 on ``ops`` with the product ``mm(a, w)`` (float32 out):
    ``a`` (R, 49 C/2) in the input dtype, (p, q, c) order."""
    dtype = roi_feats.dtype
    r, c = roi_feats.shape[0], roi_feats.shape[-1]
    b = supp_7x7.shape[0]
    f32 = torch.float32
    yb = support_half(supp_7x7, ops).to(f32)
    h = mm(roi_feats.reshape(b, per_image, 49, c), ops["c0a"]) + yb[:, None]
    h = _leaky(_gn(h.reshape(r, 49, 2 * c), ops["gn0g"], ops["gn0b"]))
    h = _leaky(_gn(mm(h, ops["c1"]) + ops["c1b"], ops["gn1g"], ops["gn1b"])).to(dtype)
    grid = F.pad(h.reshape(r, 7, 7, c), (0, 0, 1, 1, 1, 1))    # zero border
    acc = ops["agb"]
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        acc = acc + mm(grid[:, ky:ky + 7, kx:kx + 7].reshape(r, 49, c), ops["ag"][tap])
    return _leaky(_gn(acc, ops["gng"], ops["gnb"])).to(dtype).reshape(r, -1)


def _head_chain(roi_feats, supp_7x7, ops, per_image, mm):
    """The head's chain on ``ops`` with the product ``mm(a, w)`` (float32
    out) for compress_0's query half, compress_1, the 3x3 taps, fc6 and fc7;
    the predictor is a float32 product."""
    dtype = roi_feats.dtype
    a = head_front_chain(roi_feats, supp_7x7, ops, per_image, mm)
    f = torch.relu(mm(a, ops["fc6"]) + ops["fc6b"])
    f = torch.relu(mm(f, ops["fc7"]) + ops["fc7b"])
    out = f.to(dtype).float() @ ops["pred"].float() + ops["predb"]
    return out[:, :ops["ncls"]], out[:, ops["ncls"]:]


def fused_roi_head_plain(roi_feats: torch.Tensor, supp_7x7: torch.Tensor, w: Dict,
                         per_image: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch fused head (any device): the kernel's arithmetic,
    with the products' inputs rounded to the input dtype and float32 sums."""
    dtype = roi_feats.dtype

    def mm(a, m):
        return a.to(dtype).to(torch.float32) @ m.to(torch.float32)

    return _head_chain(roi_feats, supp_7x7, kernel_operands(w, dtype, tiles=False),
                       per_image, mm)


def mm_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A plain mirror of the float32 kernel's product (for the tests):
    a @ w as a_lo w_hi + a_hi w_lo + a_hi w_hi, in that order, with hi and lo
    from ``split_tf32`` and each lo truncated to tf32 where the tensor cores
    read it; each product's terms are exact in float32 and summed in
    float32."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    a_lo, w_lo = tf32_truncate(a_lo), tf32_truncate(w_lo)
    return (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi


def fused_roi_head_tf32_mirror(roi_feats: torch.Tensor, supp_7x7: torch.Tensor, w: Dict,
                               per_image: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 head with the kernel's 3xTF32 products (``mm_3xtf32``),
    for the tests: float32 inputs only."""
    if roi_feats.dtype != torch.float32:
        raise ValueError("the 3xTF32 mirror takes float32 inputs")
    return _head_chain(roi_feats, supp_7x7,
                       kernel_operands(w, torch.float32, tiles=False), per_image, mm_3xtf32)


class _HeadArgs(ctypes.Structure):
    # mirrors `struct HeadArgs` in csrc/roi_head.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "yb", "c0aT", "gn0g", "gn0b", "c1T", "c1b", "gn1g", "gn1b",
        "agT", "agb", "gng", "gnb", "fc6T", "fc6b", "fc7T", "fc7b",
        "pred", "predb",
        "a", "f6", "f7", "logits", "deltas")] + [(n, ctypes.c_int) for n in (
        "rois", "per_image", "hidden", "ncls", "nreg4", "dtype")]


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    from .. import csrc

    lib = csrc.load("roi_head")
    fn = lib.oneshot_roi_head_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.oneshot_roi_head_error_string.argtypes = [ctypes.c_int]
        lib.oneshot_roi_head_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"roi_head kernel: {msg}")


def fused_roi_head_cuda(roi_feats: torch.Tensor, supp_7x7: torch.Tensor, w: Dict,
                        per_image: int, scratch: Dict = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on any input it does not take. A
    ``scratch`` dict receives the kernel's intermediates: ``a`` (fc6's input)
    and ``f6`` in the tiled layout (float32: ``untile_f32_rows``), ``f7``
    row-major."""
    global fused_roi_head_launches
    dev = roi_feats.device
    _check(dev.type == "cuda", "roi_feats must be a CUDA tensor")
    dtype = roi_feats.dtype
    _check(dtype in _DTYPE_CODE, f"dtype {dtype} (float32 or bfloat16)")
    r = roi_feats.shape[0]
    _check(roi_feats.shape[1:] == (7, 7, 256) and roi_feats.is_contiguous(),
           f"roi_feats {tuple(roi_feats.shape)} must be contiguous (R, 7, 7, 256)")
    _check(supp_7x7.device == dev and supp_7x7.dtype == dtype
           and supp_7x7.shape[1:] == (7, 7, 256),
           "supp_7x7 must be (B, 7, 7, 256) of the ROIs' device and dtype")
    b = supp_7x7.shape[0]
    _check(per_image > 0 and r == b * per_image, f"R={r} != B={b} x per_image={per_image}")
    ops = kernel_operands(w, dtype)
    hidden, npred = ops["fc7"].shape[0], ops["pred"].shape[1]
    _check(ops["fc6"].shape == (49 * 128, hidden) and hidden % FC_TILE_N == 0,
           f"fc6 {tuple(ops['fc6'].shape)} must be (6272, hidden), hidden % {FC_TILE_N} == 0")
    _check(npred <= MAX_PRED, f"{npred} predictor outputs (at most {MAX_PRED})")
    tiles = ROUTE_TILES[dtype]
    _check(all(ops.get(k) is not None for k in tiles),
           f"operands {tiles} (kernel_operands with tiles) must be present")
    # the kernels bulk-copy the input rows, the GN parameters and the weight
    # tiles: 16-byte aligned sources
    _check(roi_feats.data_ptr() % 16 == 0, "roi_feats must be 16-byte aligned")
    for k, v in ops.items():
        if isinstance(v, torch.Tensor):
            _check(v.device == dev and v.is_contiguous() and v.data_ptr() % 16 == 0,
                   f"operand {k} must be contiguous, 16-byte aligned, on {dev}")
    ncls = ops["ncls"]
    logits = torch.empty((r, ncls), dtype=torch.float32, device=dev)
    deltas = torch.empty((r, npred - ncls), dtype=torch.float32, device=dev)
    if r == 0:
        return logits, deltas
    yb = support_half(supp_7x7, ops).contiguous()
    # fc6's and fc7's A operands are tiled in blocks of 128 rows
    rows = -(-r // A_TILE_ROWS) * A_TILE_ROWS
    a = torch.empty((rows, 49 * 128), dtype=dtype, device=dev)
    f6 = torch.empty((rows, hidden), dtype=dtype, device=dev)
    f7 = torch.empty((r, hidden), dtype=dtype, device=dev)
    if scratch is not None:
        scratch.update(a=a, f6=f6, f7=f7)

    c0, c1, ag, fc6, fc7 = tiles
    args = _HeadArgs(
        roi_feats.data_ptr(), yb.data_ptr(), *(ops[k].data_ptr() for k in (
            c0, "gn0g", "gn0b", c1, "c1b", "gn1g", "gn1b", ag, "agb", "gng", "gnb",
            fc6, "fc6b", fc7, "fc7b", "pred", "predb")),
        a.data_ptr(), f6.data_ptr(), f7.data_ptr(), logits.data_ptr(), deltas.data_ptr(),
        r, per_image, hidden, ncls, npred - ncls, _DTYPE_CODE[dtype])
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.oneshot_roi_head_forward(ctypes.addressof(args), stream)
    if rc != 0:
        err = lib.oneshot_roi_head_error_string(rc).decode()
        raise RuntimeError(f"roi_head kernel launch failed: {err} ({rc})")
    fused_roi_head_launches += 1
    return logits, deltas


def fused_roi_head(roi_feats: torch.Tensor, supp_7x7: torch.Tensor, w: Dict,
                   per_image: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused head through the op ``oneshotdet::roi_head_fused``: the
    kernel for CUDA tensors, the plain version for CPU tensors. ``w``:
    ``pack_roi_head_params`` or ``kernel_operands``."""
    from .library import head_operand_lists, roi_head_fused as op

    ops = kernel_operands(w, roi_feats.dtype, tiles=roi_feats.device.type != "cpu")
    operands, tiles = head_operand_lists(ops)
    if roi_feats.device.type == "cpu":
        tiles = []
    return op(roi_feats, supp_7x7, operands, tiles, ops["ncls"], per_image)
