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

``fused_roi_head`` dispatches on the device of its inputs: CPU tensors take
``fused_roi_head_plain``; CUDA tensors launch the kernel of
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


# Depth and width of the tiles of each pre-tiled operand, as the bf16 kernel
# reads them (csrc/roi_head.cu: KD0, KD1, KDA; GBK x GBN): one 8 KB weight
# slice of head_front, or one B tile of the fc6/fc7 GEMM.
TILES = {"c0aT": ("c0a", 64, 64), "c1T": ("c1", 16, 256), "agT": ("ag", 32, 128),
         "fc6T": ("fc6", 64, 256), "fc7T": ("fc7", 64, 256)}
FC_TILE_N = 256   # hidden must be a multiple of the GEMM's tile width
A_TILE_ROWS = 128  # the GEMM's A operand: rows padded to whole tiles
KERNEL_CHANNELS = 256   # the C the kernel takes; its 3x3 conv writes C // 2


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


def kernel_operands(w: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict:
    """Packed float32 params -> the operands of one dtype: matrices in
    ``dtype``, biases and GN factors float32, the query and support halves of
    compress_0 apart, cls and box side by side, and the bf16 kernel's
    pre-tiled weights (``TILES``; each only where its matrix is whole tiles,
    so fc6's and fc7's only where hidden is a multiple of ``FC_TILE_N``).
    Operands already of ``dtype`` are returned as they are."""
    if w.get("dtype") == dtype:
        return w
    c = w["c0"].shape[0] // 2
    mat = lambda t: t.to(dtype).contiguous()
    vec = lambda t: t.to(torch.float32).contiguous()
    ops = {
        "dtype": dtype,
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
    for key, (src, kd, nb) in TILES.items():
        m = ops[src].reshape(-1, ops[src].shape[-1])        # ag: (9 C, C/2), k = C tap + c
        whole = m.shape[0] % kd == 0 and m.shape[1] % nb == 0
        ops[key] = tile_operand(m, kd, nb) if whole else None
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


def fused_roi_head_plain(roi_feats: torch.Tensor, supp_7x7: torch.Tensor, w: Dict,
                         per_image: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch fused head (any device): the kernel's arithmetic."""
    dtype = roi_feats.dtype
    ops = kernel_operands(w, dtype)
    r, c = roi_feats.shape[0], roi_feats.shape[-1]
    b = supp_7x7.shape[0]
    f32 = torch.float32

    def mm(a, m):
        return a.to(dtype).to(f32) @ m.to(f32)

    yb = support_half(supp_7x7, ops).to(f32)
    h = mm(roi_feats.reshape(b, per_image, 49, c), ops["c0a"]) + yb[:, None]
    h = _leaky(_gn(h.reshape(r, 49, 2 * c), ops["gn0g"], ops["gn0b"]))
    h = _leaky(_gn(mm(h, ops["c1"]) + ops["c1b"], ops["gn1g"], ops["gn1b"])).to(dtype)
    grid = F.pad(h.reshape(r, 7, 7, c), (0, 0, 1, 1, 1, 1))    # zero border
    acc = ops["agb"]
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        acc = acc + mm(grid[:, ky:ky + 7, kx:kx + 7].reshape(r, 49, c), ops["ag"][tap])
    a = _leaky(_gn(acc, ops["gng"], ops["gnb"])).to(dtype)
    f = torch.relu(mm(a.reshape(r, -1), ops["fc6"]) + ops["fc6b"])
    f = torch.relu(mm(f, ops["fc7"]) + ops["fc7b"])
    out = mm(f, ops["pred"]) + ops["predb"]
    return out[:, :ops["ncls"]], out[:, ops["ncls"]:]


class _HeadArgs(ctypes.Structure):
    # mirrors `struct HeadArgs` in csrc/roi_head.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "yb", "c0a", "c0aT", "gn0g", "gn0b", "c1", "c1T", "c1b", "gn1g", "gn1b",
        "ag", "agT", "agb", "gng", "gnb", "fc6", "fc6T", "fc6b", "fc7", "fc7T", "fc7b",
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
                        per_image: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on any input it does not take."""
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
    # the bf16 kernel bulk-copies the input rows, the GN parameters and the
    # weight tiles: 16-byte aligned sources
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
    # bf16: fc6's and fc7's A operands are tiled in blocks of 128 rows
    rows = -(-r // A_TILE_ROWS) * A_TILE_ROWS
    a = torch.empty((rows, 49 * 128), dtype=dtype, device=dev)
    f6 = torch.empty((rows, hidden), dtype=dtype, device=dev)
    f7 = torch.empty((r, hidden), dtype=dtype, device=dev)

    args = _HeadArgs(
        roi_feats.data_ptr(), yb.data_ptr(), *(ops[k].data_ptr() for k in (
            "c0a", "c0aT", "gn0g", "gn0b", "c1", "c1T", "c1b", "gn1g", "gn1b", "ag", "agT",
            "agb", "gng", "gnb", "fc6", "fc6T", "fc6b", "fc7", "fc7T", "fc7b", "pred",
            "predb")),
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
    """The fused head: the kernel for CUDA tensors, the plain version for CPU
    tensors. ``w``: ``pack_roi_head_params`` or ``kernel_operands``."""
    if roi_feats.device.type == "cpu" and supp_7x7.device.type == "cpu":
        return fused_roi_head_plain(roi_feats, supp_7x7, w, per_image)
    return fused_roi_head_cuda(roi_feats, supp_7x7, w, per_image)
